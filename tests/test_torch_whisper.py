"""PyTorch port, whisper (encdec): the sinusoid table, the encoder, the
cross-K/V precompute and ``MaskSpec("full")`` attention against the JAX
package's, the init and the converter, ``prefill({"frames", "tokens"})``
then decode logits and the whole cache (self and cross K/V) against the
JAX model (f32 SMOKE, atol = rtol = 1e-4: the same math summed in another
order), and the executors and the serve CLI's real mode refusing the
family, as the JAX executor cannot serve it."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.executor import (ClusterRealExecutors,  # noqa: E402
                                          RealExecutor)

ARCH = "whisper-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
S_ENC = 24


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _node(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_smoke(ARCH), get_smoke(ARCH)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jm, tm, jp, tp


def _frames(cfg, b=2, s=S_ENC, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("s,d", [(24, 64), (300, 1024)])
def test_sinusoid_positions_match_jax(s, d):
    got = TW.sinusoid_positions(s, d, torch.float32)
    _close(got, JW.sinusoid_positions(s, d, jnp.float32))
    assert got.shape == (s, d)


def test_encode_matches_jax(models):
    jcfg, tcfg, jm, tm, jp, tp = models
    fr = _frames(jcfg)
    got = TW.encode(tp, torch.from_numpy(fr), tcfg)
    _close(got, JW.encode(jp, jnp.asarray(fr), jcfg))


def test_compute_cross_kv_matches_jax(models):
    jcfg, tcfg, jm, tm, jp, tp = models
    enc = _frames(jcfg, seed=3)
    k, v = TW.compute_cross_kv(tp, torch.from_numpy(enc), tcfg)
    jk, jv = JW.compute_cross_kv(jp, jnp.asarray(enc), jcfg)
    assert k.shape == (jcfg.num_layers, 2, S_ENC, jcfg.num_kv_heads,
                       jcfg.head_dim)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["g1", "g4"])
def test_full_mask_attention_matches_jax(cross, heads):
    """``apply_attention(..., MaskSpec("full"))`` over x itself (no cache:
    the encoder) or over fixed K/V (``cross_kv``: the decoder's
    cross-attention), qkv biases on, no rope, against JAX."""
    hq, hkv = heads
    jcfg = dataclasses.replace(jax_smoke(ARCH), num_heads=hq,
                               num_kv_heads=hkv)
    tcfg = dataclasses.replace(get_smoke(ARCH), num_heads=hq,
                               num_kv_heads=hkv)
    jp = JL.init_attention(jax.random.PRNGKey(1), jcfg)
    jp = {k: v + 0.1 for k, v in jp.items()}            # non-zero biases
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11)[None], (2, 11))
    kw = dict(mask=JL.MaskSpec("full"), rope=False)
    tkw = dict(mask=TL.MaskSpec("full"), rope=False)
    if cross:
        kv = [rng.normal(size=(2, 19, hkv, jcfg.head_dim)).astype(np.float32)
              for _ in range(2)]
        kw["cross_kv"] = tuple(jnp.asarray(a) for a in kv)
        tkw["cross_kv"] = tuple(torch.from_numpy(a) for a in kv)
    out, new = TL.apply_attention(tp, torch.from_numpy(x), tcfg,
                                  positions=torch.from_numpy(pos.copy()),
                                  **tkw)
    jout, jnew = JL.apply_attention(jp, jnp.asarray(x), jcfg,
                                    positions=jnp.asarray(pos), **kw)
    _close(out, jout)
    if cross:
        assert new is None and jnew is None
    else:
        _close(new[0], jnew[0])
        _close(new[1], jnew[1])


def test_attention_without_a_cache_takes_only_the_full_mask(models):
    """Without a cache, attention takes the kinds that need none: "full"
    (the encoder, cross-attention) and, since the training forwards, the
    causal mask (held to the JAX ``apply_attention`` here); a cache's kind
    ("lengths") raises, for self- and cross-attention."""
    jcfg, tcfg, jm, tm, jp, tp = models
    x = np.random.default_rng(5).normal(size=(1, 3, tcfg.d_model)).astype(
        np.float32)
    attn = {k: v[0] for k, v in tp["enc_blocks"]["attn"].items()}
    jattn = jax.tree.map(lambda a: a[0], jp["enc_blocks"]["attn"])
    pos = torch.arange(3)[None]
    got, _ = TL.apply_attention(attn, torch.from_numpy(x), tcfg,
                                positions=pos, mask=TL.MaskSpec("causal"),
                                rope=False)
    want, _ = JL.apply_attention(jattn, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos.numpy()),
                                 mask=JL.MaskSpec("causal"), rope=False)
    _close(got, want)
    with pytest.raises(ValueError, match="full"):
        TL.apply_attention(attn, torch.from_numpy(x), tcfg, positions=pos,
                           mask=TL.MaskSpec("lengths"), rope=False)
    kv = (torch.zeros((1, 5, 4, 16)),) * 2
    with pytest.raises(ValueError, match="full"):
        TL.apply_attention(attn, torch.from_numpy(x), tcfg, positions=pos,
                           mask=TL.MaskSpec("lengths"), cross_kv=kv)


# ------------------------------------------------------ init + converter


def test_converter_keeps_tree_layouts_and_values(models):
    jcfg, tcfg, jm, tm, jp, tp = models
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = _node(tp, path)
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert set(tp) == {"embed", "enc_blocks", "dec_blocks", "enc_norm",
                       "final_norm"}
    assert "w_gate" not in tp["dec_blocks"]["mlp"]
    assert "bq" in tp["dec_blocks"]["cross_attn"]


def test_converter_refuses_another_familys_tree(models):
    jcfg, tcfg, jm, tm, jp, tp = models
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"] = tree.pop("dec_blocks")
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax(tree, tcfg, "cpu")


def test_torch_init_matches_jax_tree_and_scales(models):
    """Same tree, shapes and dtypes as the JAX init; a std within 10% of
    the JAX draw's on every weight, and equal constants (norms, biases)."""
    jcfg, tcfg, jm, tm, jp, _ = models
    tp = tm.init(torch.Generator().manual_seed(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = _node(tp, path)
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == tcfg.dtype
        jl = np.asarray(leaf, np.float32)
        js, ts = float(np.std(jl)), float(node.float().std())
        assert abs(ts - js) <= 0.1 * js + 1e-12, (path, ts, js)
        if js == 0:
            np.testing.assert_array_equal(node.numpy(), jl)


def test_init_cache_takes_enc_len_defaulting_as_jax(models):
    jcfg, tcfg, jm, tm, jp, tp = models
    for enc_len in (0, 40):
        jc = jm.init_cache(2, 96, enc_len=enc_len)
        tc = tm.init_cache(2, 96, "cpu", enc_len=enc_len)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: v.shape for k, v in jc.items()}
    assert tc["cross_k"].shape[2] == 40
    assert tm.init_cache(1, 96, "cpu")["cross_v"].shape[2] == 24
    full = tapi.build(get_config(ARCH))
    assert full.prefill_chunk is None and full.cfg.family == "encdec"


# ------------------------------------------------------- end-to-end logits


@pytest.mark.parametrize("t", [16, 11])
def test_prefill_then_decode_logits_and_cache_match_jax(models, t):
    """``prefill({"frames", "tokens"})`` (ragged lengths) then 4 decode
    steps, teacher-forced; the logits of each, and the self and cross K/V
    after each phase."""
    jcfg, tcfg, jm, tm, jp, tp = models
    rng = np.random.default_rng(t)
    b = 2
    toks = rng.integers(0, jcfg.vocab_size, size=(b, t)).astype(np.int32)
    fr = _frames(jcfg, seed=t)
    lengths = np.array([t, t - 3], np.int32)
    jc = jm.init_cache(b, 48, enc_len=S_ENC)
    tc = tm.init_cache(b, 48, "cpu", enc_len=S_ENC)
    jl, jc = jm.prefill(jp, jc, {"frames": jnp.asarray(fr), "tokens": toks},
                        lengths)
    tl, tc = tm.prefill(tp, tc, {"frames": torch.from_numpy(fr),
                                 "tokens": torch.from_numpy(toks)},
                        torch.from_numpy(lengths))
    _close(tl, jl)
    for name in jc:
        _close(tc[name], jc[name])
    pos = lengths.copy()
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos.copy()))
        _close(tl, jl)
        pos = pos + 1
    for name in jc:
        _close(tc[name], jc[name])


# ------------------------------------------ refused where JAX cannot serve


def test_executors_refuse_encdec_naming_the_roadmap(models):
    *_, tp = models
    cfg = get_smoke(ARCH)
    with pytest.raises(NotImplementedError, match=r"encdec.*ROADMAP\.md"):
        ClusterRealExecutors(cfg, 1, max_len=64, warmup=False, device="cpu",
                             params=tp)
    with pytest.raises(NotImplementedError, match=r"encdec.*ROADMAP\.md"):
        RealExecutor(cfg, max_len=64, params=tp, device="cpu")


def test_serve_real_mode_refuses_encdec():
    with pytest.raises(NotImplementedError, match=r"encdec.*ROADMAP\.md"):
        tserve.run(["--mode", "real", "--arch", ARCH, "--device", "cpu",
                    "--duration", "2", "--workers", "1", "--json"])
