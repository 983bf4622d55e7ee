"""PyTorch port, the fused pointwise passes on the CPU (``kernels/fused.py``
runs only on the card): their plain versions in ``kernels.ref`` equal the
model layers' code as it was before the passes, bit for bit (the norm, the
rotary embedding with the cache write, the gated activation); the ops send
CPU tensors to those versions and count nothing; they refuse inputs that
require grad; and the model layers take the passes only for plain tensors
on the card with no gradient to track. The kernels themselves are held to
these versions on the card by ``tests/test_torch_fused_card.py``."""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import fused, ops, ref  # noqa: E402
from repro_torch.launch.hloanalysis import StepCost  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

E4M3 = torch.float8_e4m3fn


# ---------------------------------------------------- the layer code before


def _old_rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def _old_rotate(x, tables):
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _old_to_e4m3(x):
    nan = torch.full_like(x, float("nan")).copysign(x)
    return torch.where(x.abs() > 464.0, nan, x).to(torch.float8_e4m3fn)


def _old_cache_write(cache, new, write_pos):
    b, smax = cache.shape[:2]
    snew = new.shape[1]
    start = write_pos.long().clamp(0, smax - snew)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(snew, device=cache.device)[None]
    if cache.dtype == torch.float8_e4m3fn:
        cache.view(torch.uint8)[rows, cols] = _old_to_e4m3(new).view(
            torch.uint8)
    else:
        cache[rows, cols] = new.to(cache.dtype)


def _old_activate(x, kind):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


# ----------------------------------------------------------- bit for bit


@pytest.mark.parametrize("d", [64, 1536, 2304, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [True, False])
def test_norm_equals_the_layer_code(d, dtype, residual):
    gen = torch.Generator().manual_seed(d)
    x = _randn(gen, (3, 2, d), dtype, 3.0)
    r = _randn(gen, (3, 2, d), dtype, 3.0) if residual else None
    w = _randn(gen, (d,), dtype, 0.5)
    total, out = ops.add_rms_norm_op(x, r, w, 1e-6)
    want_total = x + r if residual else x
    assert torch.equal(_bits(total), _bits(want_total))
    assert torch.equal(_bits(out), _bits(_old_rms_norm(want_total, w, 1e-6)))
    assert torch.equal(_bits(L.rms_norm(x, w, 1e-6)),
                       _bits(_old_rms_norm(x, w, 1e-6)))


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (12, 2), (8, 1)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, E4M3])
@pytest.mark.parametrize("s", [1, 5])
def test_rope_cache_write_equals_the_layer_code(d, hq, hkv, bias,
                                                cache_dtype, s):
    """Biases, rope and the cache write as ``apply_attention`` did them, a
    write past Smax clamped back (row 1), e4m3 values past 464 NaN."""
    gen = torch.Generator().manual_seed(d + hq)
    b, smax, dtype = 3, 16, torch.bfloat16
    q = _randn(gen, (b, s, hq, d), dtype)
    k = _randn(gen, (b, s, hkv, d), dtype, 200.0)
    v = _randn(gen, (b, s, hkv, d), dtype, 200.0)
    positions = torch.randint(0, 2048, (b, s), generator=gen)
    rot = L.rope_tables(positions, d, 10_000.0)
    biases = [_randn(gen, (h, d), dtype) for h in (hq, hkv, hkv)] \
        if bias else [None] * 3
    write_pos = torch.tensor([0, smax - 1, smax - s - 2], dtype=torch.int32)
    caches = [_randn(gen, (b, smax, hkv, d), dtype).to(cache_dtype)
              for _ in "kv"]
    want_caches = [c.clone() for c in caches]
    got = ops.rope_cache_write_op(q, k, v, *rot, *caches, write_pos,
                                  *biases)
    if bias:
        q, k, v = q + biases[0], k + biases[1], v + biases[2]
    want = _old_rotate(q, rot)
    _old_cache_write(want_caches[0], _old_rotate(k, rot), write_pos)
    _old_cache_write(want_caches[1], v, write_pos)
    assert torch.equal(_bits(got), _bits(want))
    for g, w in zip(caches, want_caches):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kind", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gated_act_equals_the_layer_code(kind, dtype):
    gen = torch.Generator().manual_seed(7)
    g = _randn(gen, (2, 3, 40), dtype, 4.0)
    u = _randn(gen, (2, 3, 40), dtype, 2.0)
    want = _old_activate(g, kind) * u
    assert torch.equal(_bits(ops.gated_act_op(g, u, kind)), _bits(want))


def test_the_plain_layers_keep_their_names():
    """Code outside the model layers reaches the plain versions by the
    layers' names (the e4m3 cast, the cache write, the activation)."""
    gen = torch.Generator().manual_seed(3)
    x = _randn(gen, (4, 16), torch.float32, 300.0)
    assert torch.equal(_bits(L.to_e4m3(x)), _bits(_old_to_e4m3(x)))
    assert torch.equal(L._activate(x, "gelu"), _old_activate(x, "gelu"))
    cache, want = (torch.zeros((2, 6, 1, 16), dtype=E4M3) for _ in "ab")
    new = x.view(2, 2, 1, 16)
    pos = torch.tensor([1, 5], dtype=torch.int32)
    L._cache_write(cache, new, pos)
    _old_cache_write(want, new, pos)
    assert torch.equal(_bits(cache), _bits(want))


# --------------------------------------------------------- routing, grad


@pytest.fixture
def no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a fused kernel")
    for name in ("add_rms_norm", "rope_cache_write", "gated_act"):
        monkeypatch.setattr(fused, name, refuse)


def _rope_args(gen, b=2, s=1, h=2, d=16):
    q = _randn(gen, (b, s, h, d), torch.float32)
    rot = L.rope_tables(torch.arange(s)[None].expand(b, s), d, 10_000.0)
    cache = torch.zeros((b, 8, h, d))
    return (q, q.clone(), q.clone(), *rot, cache, cache.clone(),
            torch.tensor([0, 3], dtype=torch.int32))


def test_cpu_inputs_take_the_plain_versions_and_count(no_kernel):
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, (2, 1, 32), torch.float32)
    w = torch.zeros(32)
    n0 = fused.launches
    with StepCost() as cost:
        total, out = ops.add_rms_norm_op(x, x, w, 1e-6)
        ops.gated_act_op(x, x, "gelu")
        ops.rope_cache_write_op(*_rope_args(gen))
    assert torch.equal(out, ref.add_rms_norm_ref(x, x, w, 1e-6)[1])
    assert fused.launches == n0
    assert set(cost.op_flops) == {"add_rms_norm", "gated_act",
                                  "rope_cache_write"}
    assert cost.flops == 0.0
    assert [c[0] for c in cost.kernel_calls] == [
        "add_rms_norm", "gated_act", "rope_cache_write"]


@pytest.mark.parametrize("op", ["norm", "rope", "gated"])
def test_fused_ops_refuse_inputs_that_require_grad(op):
    gen = torch.Generator().manual_seed(1)
    x = _randn(gen, (2, 1, 16), torch.float32).requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        if op == "norm":
            ops.add_rms_norm_op(x, None, torch.zeros(16), 1e-6)
        elif op == "gated":
            ops.gated_act_op(x, x.detach(), "silu")
        else:
            args = list(_rope_args(gen))
            args[1] = args[1].requires_grad_()
            ops.rope_cache_write_op(*args)
    with torch.no_grad():                  # no gradient to track: taken
        ops.gated_act_op(x, x, "silu")


def test_layers_fuse_only_plain_card_tensors_without_grad():
    assert not L.fuses(torch.zeros(2, 4))                  # the CPU
    assert not L.fuses(torch.empty(2, 4, device="meta"))

    class OnCard:            # a stand-in for a tensor on the card
        device = torch.device("cuda")
        requires_grad = False
    assert L.fuses(OnCard())
    OnCard.requires_grad = True
    assert not L.fuses(OnCard())
    with torch.no_grad():
        assert L.fuses(OnCard())


@pytest.mark.parametrize("check,args,match", [
    ("norm", lambda: (torch.zeros(2, 8, dtype=torch.float16), None,
                      torch.zeros(8, dtype=torch.float16)), "bf16 or f32"),
    ("norm", lambda: (torch.zeros(2, 8), torch.zeros(2, 4), torch.zeros(8)),
     "residual"),
    ("norm", lambda: (torch.zeros(2, 8), None, torch.zeros(4)), "scale"),
    ("gated", lambda: (torch.zeros(2, 8), torch.zeros(2, 4), "silu"),
     "differ"),
    ("gated", lambda: (torch.zeros(2, 8), torch.zeros(2, 8), "relu"),
     "activation"),
    ("gated", lambda: (torch.zeros(2, 8).t(), torch.zeros(8, 2), "silu"),
     "contiguous")])
def test_fused_checks_refuse_what_the_kernels_do_not_take(check, args,
                                                          match):
    fn = {"norm": fused.check_add_rms_norm,
          "gated": fused.check_gated_act}[check]
    with pytest.raises(ValueError, match=match):
        fn(*args())


def test_fused_wrappers_refuse_cpu_tensors():
    """The wrappers launch on CUDA or raise; they never run on the CPU."""
    x = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        fused.add_rms_norm(x, None, torch.zeros(8), 1e-6)
    with pytest.raises(ValueError, match="not CUDA"):
        fused.gated_act(x, x, "silu")
    with pytest.raises(ValueError, match="not CUDA"):
        fused.rope_cache_write(*_rope_args(torch.Generator()))
