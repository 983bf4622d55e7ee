"""PyTorch port, the training forwards against the JAX package's:
``layers.attention_scores`` forward and backward (``jax.vjp`` against
autograd), ``softmax_xent``, the gradients of the WKV and SSD forms, and
each family's ``loss`` at the converted init with every leaf's gradient
(f32 SMOKE): qwen2, gemma2 (windows, softcaps), arctic (MoE, padded
experts too), paligemma (VLM prefix), rwkv6 and zamba2 at S 64 (chunked
forms) and S 40 (the scans), whisper at S 64; whisper at S 32 raises."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro.train.data import DataConfig as JDataConfig  # noqa: E402
from repro.train.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402

# relative L2 of a gradient, against the larger of the leaf's norm and
# FLOOR of the whole gradient's: whisper's key biases have an analytically
# zero gradient (a bias on K shifts every logit of a query's row alike), and
# both packages leave rounding noise of about 1e-9 there
GRAD_TOL = 1e-4
FLOOR = 1e-4
LOSS_RTOL = 1e-5


def _rel(t, j, scale=None):
    t = t.detach().float().numpy()
    j = np.asarray(j, np.float32)
    den = max(np.linalg.norm(j), scale or 0.0)
    return np.linalg.norm(t - j) / den


def _assert_grads(got: dict, want: dict):
    """Every leaf within ``GRAD_TOL``; a leaf JAX leaves exactly zero
    (padding experts) is exactly zero here too."""
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(w, np.float32))))
                        for w in want.values()))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        w = np.asarray(want[key], np.float32)
        if not w.any():
            assert not g.any(), f"{key}: JAX's gradient is zero, not ours"
            continue
        rel = _rel(g, w, FLOOR * total)
        assert rel <= GRAD_TOL, f"{key}: relative L2 {rel:.3e}"


def _jax_leaves(tree):
    return {"/".join(str(p.key) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out |= _torch_leaves(v, key) if isinstance(v, dict) else {key: v}
    return out


def _vjp_pair(jf, tf, inputs, seed):
    """(torch grads, jax grads) of <f(inputs), ct> for a seeded cotangent
    ct over every output; ``inputs`` as numpy f32."""
    jin = [jnp.asarray(a) for a in inputs]
    jout, vjp = jax.vjp(jf, *jin)
    rng = np.random.default_rng(seed)
    cts = jax.tree.map(lambda o: np.asarray(
        rng.normal(size=o.shape), np.float32), jout)
    jg = vjp(jax.tree.map(jnp.asarray, cts))
    tin = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    tout = tf(*tin)
    touts = tout if isinstance(tout, tuple) else (tout,)
    tcts = [torch.from_numpy(c) for c in jax.tree.leaves(cts)]
    tg = torch.autograd.grad(touts, tin, tcts)
    for t, j in zip(touts, jax.tree.leaves(jout)):
        assert _rel(t, j) <= 1e-5
    return tg, jg


# ------------------------------------------------------------ attention


ATTENTION_CASES = {
    # name: (B, S, Hq, Hkv, D, mask, softcap)
    "causal": (2, 40, 4, 4, 16, JL.MaskSpec("causal"), None),
    "causal_gqa_window": (2, 40, 6, 2, 16, JL.MaskSpec("causal", window=8),
                          None),
    "causal_softcap": (1, 33, 4, 2, 16, JL.MaskSpec("causal"), 5.0),
    "full_gqa": (2, 24, 4, 1, 16, JL.MaskSpec("full"), None),
    "causal_two_query_chunks": (1, 1024, 2, 1, 16,
                                JL.MaskSpec("causal", window=300), None),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_scores_forward_and_vjp_match_jax(case):
    b, s, hq, hkv, d, jmask, cap = ATTENTION_CASES[case]
    tmask = TL.MaskSpec(jmask.kind, jmask.window)
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    tg, jg = _vjp_pair(
        lambda q, k, v: JL.attention_scores(q, k, v, jmask,
                                            attn_softcap=cap),
        lambda q, k, v: TL.attention_scores(q, k, v, tmask, cap),
        [q, k, v], seed=1)
    for t, j in zip(tg, jg):
        assert _rel(t, j) <= GRAD_TOL


def test_attention_without_a_cache_refuses_cache_masks():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="'causal' or 'full'"):
        TL.attention_scores(q, q, q, TL.MaskSpec("lengths"))


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    jl, jg = jax.value_and_grad(JL.softmax_xent)(jnp.asarray(logits),
                                                 jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    tl = TL.softmax_xent(t, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(tl, t)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert _rel(tg, jg) <= GRAD_TOL


# ------------------------------------------------------------ WKV, SSD


def _wkv_inputs(seed, t, b=2, h=2, d=64):
    """r, k, v, w (the model's decay range, clipped as the model clips
    it), u and a non-zero s0, as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, d)) for _ in range(3))
    w = np.exp(-np.exp(np.clip(rng.normal(size=(b, t, h, d)) * 2 - 4,
                               -20.0, 0.5)))
    u = rng.normal(size=(h, d)) * 0.5
    s0 = rng.normal(size=(b, h, d, d)) * 0.1
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("form,t", [("wkv_chunked", 128), ("wkv_scan", 40)])
def test_wkv_form_gradients_match_jax(form, t):
    tg, jg = _vjp_pair(getattr(JR, form), getattr(TR, form),
                       _wkv_inputs(t, t), seed=2)
    for name, a, b in zip("rkvwus", tg, jg):
        assert _rel(a, b) <= GRAD_TOL, name


def _ssd_inputs(seed, t, b=2, h=3, p=64, n=16):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, t, h, p)),
            np.log1p(np.exp(rng.normal(size=(b, t, h)) - 1.0)),
            -np.exp(rng.normal(size=(h,)) * 0.5),
            rng.normal(size=(b, t, n)), rng.normal(size=(b, t, n)),
            rng.normal(size=(h,)), rng.normal(size=(b, h, p, n)) * 0.5]
    return [np.asarray(a, np.float32) for a in arrs]


@pytest.mark.parametrize("form,t", [("ssd_chunked", 128), ("ssd_scan", 40)])
def test_ssd_form_gradients_match_jax(form, t):
    tg, jg = _vjp_pair(getattr(JM2, form), getattr(TM2, form),
                       _ssd_inputs(t, t), seed=3)
    for name, a, b in zip(("x", "dt", "A", "B", "C", "D", "s0"), tg, jg):
        assert _rel(a, b) <= GRAD_TOL, name


# ------------------------------------------------------------ families


FAMILIES = {
    # case: (arch, seq, config changes)
    "qwen2": ("qwen2-1.5b", 32, {}),
    "gemma2": ("gemma2-2b", 32, {}),
    "arctic": ("arctic-480b", 32, {}),
    "arctic_padded_experts": ("arctic-480b", 32, {"expert_pad_to": 3}),
    "paligemma": ("paligemma-3b", 32, {}),
    "rwkv6_s64": ("rwkv6-7b", 64, {}),
    "rwkv6_s40": ("rwkv6-7b", 40, {}),
    "zamba2_s64": ("zamba2-2.7b", 64, {}),
    "zamba2_s40": ("zamba2-2.7b", 40, {}),
    "whisper_s64": ("whisper-medium", 64, {}),
}


def _family(case):
    arch, seq, changes = FAMILIES[case]
    jcfg = dataclasses.replace(jax_smoke(arch), **changes)
    tcfg = dataclasses.replace(get_smoke(arch), **changes)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jb = JSyntheticLM(jcfg, JDataConfig(batch=2, seq=seq)).batch_at(0)
    tb = SyntheticLM(tcfg, DataConfig(batch=2, seq=seq), "cpu").batch_at(0)
    return jm, tm, jp, tp, jb, tb


@pytest.mark.parametrize("case", list(FAMILIES))
def test_family_loss_and_gradients_match_jax(case):
    """``api.loss`` at the converted init within rtol 1e-5 of JAX's, every
    leaf's gradient within relative L2 1e-4 (zero where JAX's is zero: the
    padding experts). MoE: the routes of this batch agree between the
    packages (a flip would move the loss far past its tolerance)."""
    jm, tm, jp, tp, jb, tb = _family(case)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tl, tg = topt.loss_and_grads(tm.loss, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _assert_grads(_torch_leaves(tg), _jax_leaves(jg))
    if case == "arctic_padded_experts":
        pad = _torch_leaves(tg)["blocks/moe/w_gate"][:, 8:]
        assert pad.shape[1] == 1 and not pad.any()


def test_whisper_refuses_tokens_and_labels_of_different_widths():
    """At seq 32 < dec_len 64 the stream gives 33 token columns against 32
    labels: JAX fails on the shapes, the port raises ValueError."""
    tcfg = get_smoke("whisper-medium")
    tm = tapi.build(tcfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(tcfg, DataConfig(batch=2, seq=32), "cpu").batch_at(0)
    assert batch["tokens"].shape[1] == 33 and batch["labels"].shape[1] == 32
    with pytest.raises(ValueError, match="33 token columns against 32"):
        tm.loss(tp, batch)


def test_loss_with_expert_parallelism_raises():
    """``loss(ep=...)`` runs the MoE blocks expert-parallel
    (``tests/test_torch_moe_ep.py``); an ``ep`` that is not an ``EPInfo``
    raises where the first MoE block reads it."""
    tcfg = get_smoke("arctic-480b")
    tm = tapi.build(tcfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(tcfg, DataConfig(batch=2, seq=8), "cpu").batch_at(0)
    with pytest.raises(TypeError, match="EPInfo"):
        tm.loss(tp, batch, ep=object())
