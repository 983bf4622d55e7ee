"""PyTorch port, dense model: the weight converter, each ``layers``
function against its JAX counterpart, and teacher-forced logits of
``prefill``, ``prefill_chunk`` (with ``take``) and ``decode`` against the
JAX model on the qwen2 and deepseek SMOKE configs (f32, atol = rtol =
1e-4: the same math, summed in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2-1.5b", "deepseek-7b"]
# the logits test also covers LayerNorm (stablelm) and head_dim 8 (internlm)
LOGIT_ARCHS = ARCHS + ["stablelm-1.6b", "internlm-20b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _models(arch):
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jm, tm, jp, tp


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-7b",
                                  "stablelm-1.6b", "internlm-20b",
                                  "rwkv6-7b", "gemma2-2b"])
def test_configs_match_the_jax_package(arch):
    from repro.configs import get_config as jax_config
    for get_t, get_j in ((get_config, jax_config), (get_smoke, jax_smoke)):
        t, j = get_t(arch), get_j(arch)
        for field in j.__dataclass_fields__:
            if field != "dtype":
                assert getattr(t, field) == getattr(j, field), field
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


def test_unported_archs_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_config("arctic-480b")
    import dataclasses
    # the fp8 cache is served since the fp8 slice; gemma2's ring is not
    cfg = dataclasses.replace(get_smoke("gemma2-2b"), scan_layers=False,
                              window_sized_cache=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tapi.build(cfg)


# -------------------------------------------------------- converter + init


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_keeps_tree_layouts_and_values(arch):
    jcfg, tcfg, jm, tm, jp, tp = _models(arch)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == tcfg.dtype
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_torch_init_matches_jax_tree_and_scales():
    """Same tree, shapes and dtypes as the JAX init; the same distributions
    (a std within 10% of the JAX draw's on every weight)."""
    jcfg, tcfg, jm, tm, jp, _ = _models("qwen2-1.5b")
    tp = tm.init(torch.Generator().manual_seed(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == tcfg.dtype
        js, ts = float(np.std(leaf)), float(node.float().std())
        assert abs(ts - js) <= 0.1 * js + 1e-12, (path, ts, js)


# ---------------------------------------------------------------- layers


def test_norms_rope_mlp_embed_unembed_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(scale), 1e-6), JL.rms_norm(x, scale, 1e-6))
    _close(TL.layer_norm(_t(x), _t(scale), _t(bias), 1e-5),
           JL.layer_norm(x, scale, bias, 1e-5))

    h = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 5)).astype(np.int32)
    _close(TL.apply_rope(_t(h), _t(pos), 1e6), JL.apply_rope(h, pos, 1e6))

    cfg_j, cfg_t = jax_smoke("qwen2-1.5b"), get_smoke("qwen2-1.5b")
    mlp = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
           (("w_gate", (96, 192)), ("w_up", (96, 192)),
            ("w_down", (192, 96)))}
    xm = rng.normal(size=(2, 3, 96)).astype(np.float32)
    tm = {k: _t(v) for k, v in mlp.items()}
    _close(TL.apply_mlp(tm, _t(xm), cfg_t), JL.apply_mlp(mlp, xm, cfg_j))
    import dataclasses
    gj = dataclasses.replace(cfg_j, mlp_activation="gelu")
    gt = dataclasses.replace(cfg_t, mlp_activation="gelu")
    _close(TL.apply_mlp(tm, _t(xm), gt), JL.apply_mlp(mlp, xm, gj))

    table = rng.normal(size=(512, 96)).astype(np.float32)
    toks = rng.integers(0, 512, size=(2, 4)).astype(np.int32)
    _close(TL.embed({"table": _t(table)}, _t(toks), cfg_t),
           JL.embed({"table": table}, toks, cfg_j))
    capped_j = dataclasses.replace(cfg_j, final_softcap=30.0)
    capped_t = dataclasses.replace(cfg_t, final_softcap=30.0)
    _close(TL.unembed({"table": _t(table)}, _t(xm), capped_t),
           JL.unembed({"table": table}, xm, capped_j))


@pytest.mark.parametrize("kind", ["causal", "chunk", "lengths"])
def test_apply_attention_matches_jax(kind):
    """Each mask kind through the ops (plain versions on the CPU) against
    the JAX XLA attention; the torch cache is written in place."""
    jcfg, tcfg, jm, tm, jp, tp = _models("qwen2-1.5b")
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tb = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    rng = np.random.default_rng(1)
    b, smax = 2, 32
    s = 1 if kind == "lengths" else 8
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    cache = rng.normal(size=(2, b, smax, jcfg.num_kv_heads,
                             jcfg.head_dim)).astype(np.float32)
    starts = np.array([0, 11], np.int32) if kind != "causal" \
        else np.zeros(b, np.int32)
    positions = starts[:, None] + np.arange(s, dtype=np.int32)[None]
    kw = dict(positions=positions, mask=JL.MaskSpec(kind),
              kv_cache=(cache[0], cache[1]), cache_positions=starts,
              lengths=starts if kind != "causal" else None)
    jout, (jk, jv) = JL.apply_attention(jb, x, jcfg, **kw)
    tk, tv = _t(cache[0]), _t(cache[1])
    tout, _ = TL.apply_attention(
        tb, _t(x), tcfg, positions=_t(positions), mask=TL.MaskSpec(kind),
        kv_cache=(tk, tv), cache_positions=_t(starts),
        lengths=_t(starts) if kind != "causal" else None)
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


# ------------------------------------------------------- end-to-end logits


@pytest.mark.parametrize("arch", LOGIT_ARCHS)
def test_teacher_forced_logits_match_jax(arch):
    jcfg, tcfg, jm, tm, jp, tp = _models(arch)
    rng = np.random.default_rng(0)
    b, max_len = 2, 48
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, 20)).astype(np.int32)
    lengths = np.array([20, 13], np.int32)

    # full prefill
    jc = jm.init_cache(b, max_len)
    tc = tm.init_cache(b, max_len, "cpu")
    jl, jc = jm.prefill(jp, jc, prompt, lengths)
    tl, tc = tm.prefill(tp, tc, _t(prompt), _t(lengths))
    _close(tl, jl)

    # a chunk continuing row 0 at 20 and row 1 at 13, with take
    chunk = rng.integers(0, jcfg.vocab_size, size=(b, 8)).astype(np.int32)
    take = np.array([8, 5], np.int32)
    jl, jc = jm.prefill_chunk(jp, jc, chunk, lengths, take=take)
    tl, tc = tm.prefill_chunk(tp, tc, _t(chunk), _t(lengths), take=_t(take))
    _close(tl, jl)
    pos = lengths + take

    # decode steps, teacher-forced with the JAX model's greedy tokens
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, _t(tok), _t(pos))
        _close(tl, jl)
        pos = pos + 1
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
