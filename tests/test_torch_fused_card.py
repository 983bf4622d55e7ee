"""PyTorch port, the fused pointwise passes on the card (``kernels/fused.py``,
``csrc/fused.cu``): each pass against its plain version in ``kernels.ref``
on the same card (the gated activation and the rope / cache write bit for
bit, the e4m3 NaN rule included; the norm within one unit in the last place
of a bf16 output, ``NORM_ULPS``, its sum of squares taken in another
order), then a reduced-depth deepseek-7b-shaped model decoding 32 greedy
steps through the executor's CUDA graph against the plain ops, token for
token, with the fused launches a replay counts.

These tests need a CUDA card and skip without one (the ``card`` marker);
run them there with ``python -m pytest -q -m card tests``. They import no
JAX."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused, ops, ref  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.layers import ModelConfig  # noqa: E402

E4M3 = torch.float8_e4m3fn
pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gen(card, seed=0):
    return torch.Generator(device=card).manual_seed(seed)


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of t, so NaNs compare too."""
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units in the last place of want."""
    g, w = got.float(), want.float()
    tiny = torch.finfo(want.dtype).tiny
    ulp = torch.finfo(want.dtype).eps * torch.exp2(
        torch.floor(torch.log2(w.abs().clamp_min(tiny))))
    return float(((g - w).abs() / ulp).max())


# The norm's sum of squares is taken in another order than ATen's reduction
# (a few units of f32 in the variance, halved by the square root, then two
# roundings alike): in bf16 that moves an output by at most one unit, in
# f32 by a few
NORM_ULPS = {torch.bfloat16: 1, torch.float32: 8}


@pytest.mark.parametrize("rows,d,dtype", [
    (16, 4096, torch.bfloat16), (8192, 4096, torch.bfloat16),
    (3, 2304, torch.bfloat16), (5, 7168, torch.bfloat16),
    (4, 100, torch.bfloat16), (6, 64, torch.float32),
    (7, 1536, torch.float32)])
@pytest.mark.parametrize("residual", [True, False])
def test_add_rms_norm_holds_to_the_plain_norm(card, rows, d, dtype,
                                              residual):
    gen = _gen(card)
    x = _randn(gen, (rows, 1, d), dtype, 3.0)
    r = _randn(gen, (rows, 1, d), dtype, 3.0) if residual else None
    w = _randn(gen, (d,), dtype, 0.5)
    total, out = fused.add_rms_norm(x, r, w, 1e-6)
    want_total, want = ref.add_rms_norm_ref(x, r, w, 1e-6)
    assert torch.equal(_bits(total), _bits(want_total))
    assert out.dtype == dtype and _ulps(out, want) <= NORM_ULPS[dtype]


# (B, S, Hq, Hkv, D): deepseek-7b's decode and prefill, qwen2 (G = 6),
# zamba2's D = 80, gemma2's D = 256 and paligemma's single KV head, a
# width that takes no 16-byte vectors
ROPE_CASES = [(16, 1, 32, 32, 128), (2, 7, 32, 32, 128), (3, 1, 12, 2, 128),
              (2, 5, 32, 32, 80), (2, 3, 8, 4, 256), (2, 1, 8, 1, 256),
              (2, 3, 4, 4, 16), (2, 2, 4, 2, 12)]


@pytest.mark.parametrize("b,s,hq,hkv,d", ROPE_CASES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cache_dtype", [None, E4M3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_cache_write_is_bit_equal(card, b, s, hq, hkv, d, bias,
                                       cache_dtype, dtype):
    gen = _gen(card, 1)
    smax = 24
    q = _randn(gen, (b, s, hq, d), dtype, 2.0)
    k = _randn(gen, (b, s, hkv, d), dtype, 200.0)    # past e4m3's 464
    v = _randn(gen, (b, s, hkv, d), dtype, 200.0)
    # a NaN only where no arithmetic touches it (the sign of a NaN that
    # arithmetic passes on is the hardware's: x86 and the card differ)
    v[0, 0, 0, 1] = -float("inf")
    if not bias:
        v[0, 0, 0, 0] = float("nan")
    positions = torch.randint(0, 4096, (b, s), generator=gen,
                              device=card)
    cos, sin = L.rope_tables(positions, d, 10_000.0)
    biases = [_randn(gen, (h, d), dtype) for h in (hq, hkv, hkv)] \
        if bias else [None] * 3
    # the last row's write runs past Smax: clamped back, as the plain one
    write_pos = torch.tensor([smax - s - 1, smax - 1, 0][:b] + [3] * (b - 3),
                             dtype=torch.int32, device=card)
    cdt = cache_dtype or dtype
    caches = [_randn(gen, (b, smax, hkv, d), dtype).to(cdt) for _ in "kv"]
    got_caches = [c.clone() for c in caches]
    got = fused.rope_cache_write(q, k, v, cos, sin, *got_caches, write_pos,
                                 *biases)
    if cache_dtype == E4M3:
        # the rule's bytes from the plain ops on the CPU: on the card they
        # lose the sign of a bf16 value past 464 (CUDA's float-to-bf16 cast
        # inside copysign makes every NaN positive), which the kernel keeps
        args = [t if t is None else t.cpu() for t in
                (q, k, v, cos, sin, *caches, write_pos, *biases)]
        want = ref.rope_cache_write_ref(*args)
        caches = args[5:7]
        got, got_caches = got.cpu(), [c.cpu() for c in got_caches]
    else:
        want = ref.rope_cache_write_ref(q, k, v, cos, sin, *caches,
                                        write_pos, *biases)
    assert torch.equal(_bits(got), _bits(want))
    for g, w in zip(got_caches, caches):
        assert torch.equal(_bits(g), _bits(w))
    assert fused.launches_by_variant[
        "rope_cache_write_e4m3" if cache_dtype else "rope_cache_write"] > 0


@pytest.mark.parametrize("shape,dtype", [
    ((16, 1, 11008), torch.bfloat16), ((16, 512, 11008), torch.bfloat16),
    ((3, 1, 9216), torch.bfloat16), ((3, 1, 100), torch.bfloat16),
    ((5, 2, 128), torch.float32), ((3, 1, 7), torch.float32)])
@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_gated_act_is_bit_equal(card, shape, dtype, kind):
    gen = _gen(card, 2)
    g = _randn(gen, shape, dtype, 4.0)
    u = _randn(gen, shape, dtype, 2.0)
    got = fused.gated_act(g, u, kind)
    assert torch.equal(_bits(got), _bits(ref.gated_act_ref(g, u, kind)))


# deepseek-7b's widths (4096, 32 / 32 heads of 128, d_ff 11008, vocab
# 102400, untied), two layers
DEEPSEEK_2L = ModelConfig(
    name="deepseek-7b-2l", family="dense", num_layers=2, d_model=4096,
    num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
    vocab_size=102400, tie_embeddings=False, dtype=torch.bfloat16)
SLOTS, MAX_LEN, STEPS = 16, 1024, 32


def test_graphed_decode_gives_the_plain_tokens(card, monkeypatch):
    """32 greedy decode steps of 16 slots: CUDA graph replays of the step
    with the fused passes against eager steps with the plain ops, from the
    same caches; a replay launches 4 passes a layer and the final norm."""
    from repro_torch.serving.executor import ExecutorKernels
    cfg = DEEPSEEK_2L
    api = model_api.build(cfg)
    with torch.no_grad():
        params = api.prepare(api.init(_gen(card, 3)))
        gen = _gen(card, 4)
        tokens = torch.randint(0, cfg.vocab_size, (SLOTS,), generator=gen,
                               device=card, dtype=torch.int32)
        lengths = torch.randint(0, 400, (SLOTS,), generator=gen,
                                device=card, dtype=torch.int32)
        fused_cache = api.init_cache(SLOTS, MAX_LEN, card)
        plain_cache = api.init_cache(SLOTS, MAX_LEN, card)
        graphs = ExecutorKernels(api, SLOTS, MAX_LEN, card)
        got_tok, want_tok = tokens.clone(), tokens.clone()
        got_seq, want_seq, per_replay = [], [], []
        for i in range(STEPS):
            n = lengths + i
            before = dict(fused.launches_by_variant)
            got_tok = graphs.step(params, fused_cache, ("decode",),
                                  torch.cat([got_tok, n])).clone()
            per_replay.append({v: c - before[v] for v, c in
                               fused.launches_by_variant.items()})
            with monkeypatch.context() as m:
                m.setattr(L, "fuses", lambda *t: False)
                logits, _ = api.decode(params, plain_cache, want_tok, n)
            want_tok = logits.argmax(dim=-1).to(torch.int32)
            got_seq.append(got_tok.tolist())
            want_seq.append(want_tok.tolist())
    assert got_seq == want_seq
    layers = cfg.num_layers
    want_counts = dict.fromkeys(fused.KERNELS, 0) | {
        "add_rms_norm": 2 * layers, "rms_norm": 1,
        "rope_cache_write": layers, "gated_silu": layers}
    assert graphs.captures == 1
    assert per_replay[-1] == want_counts
    assert sum(want_counts.values()) == 4 * layers + 1
    assert fused in ops.COUNTED


def test_fused_ops_route_the_card_to_the_kernels(card):
    """``kernels.ops`` sends CUDA tensors to the fused kernels and counts
    them; the model layers take them for plain tensors with no grad."""
    gen = _gen(card, 5)
    x = _randn(gen, (2, 1, 64), torch.bfloat16)
    w = torch.zeros(64, dtype=torch.bfloat16, device=card)
    n0 = fused.launches
    ops.add_rms_norm_op(x, x, w, 1e-6)
    ops.gated_act_op(x, x, "silu")
    assert fused.launches == n0 + 2
    assert L.fuses(x, w)
    assert not L.fuses(x.requires_grad_(True))
    cfg = dataclasses.replace(DEEPSEEK_2L, d_model=64)
    assert L.add_norm({"scale": w}, x.detach(), x.detach(), cfg)[1].shape \
        == x.shape
