"""PyTorch port, attention kernels: the plain versions (what the ops run
on the CPU) against the JAX package's oracles and its Pallas kernels in
interpret mode, on the same numpy inputs; and the ops' routing. The
Hopper kernels themselves are held against the plain versions on the card
by chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import chunked_prefill as tchunk  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402

# f32: sums in another order than XLA's; bf16: one rounding of the output
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, JNP[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
    return j, t


def _ints(a):
    return jnp.asarray(a, jnp.int32), torch.from_numpy(
        np.asarray(a, np.int32))


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               **TOL[dtype])


def _mk_paged(seed, b, hq, hkv, d, ps, mp, dtype, lengths=None):
    rng = np.random.default_rng(seed)
    n_pages = b * mp + 3
    q = _pair(rng.normal(size=(b, hq, d)), dtype)
    kp = _pair(rng.normal(size=(n_pages, ps, hkv, d)), dtype)
    vp = _pair(rng.normal(size=(n_pages, ps, hkv, d)), dtype)
    bt = _ints(rng.permutation(n_pages)[: b * mp].reshape(b, mp))
    if lengths is None:
        lengths = rng.integers(1, mp * ps + 1, size=(b,))
    return q, kp, vp, bt, _ints(lengths)


# a subset of tests/test_kernels.py's PAGED_SWEEP
PAGED_SWEEP = [
    # (b, hq, hkv, d, page, max_pages, dtype)
    (1, 4, 4, 64, 16, 4, "float32"),      # MHA
    (3, 8, 2, 64, 16, 8, "float32"),      # GQA
    (2, 8, 1, 128, 32, 4, "float32"),     # MQA
    (3, 12, 2, 128, 16, 4, "float32"),    # qwen2's G = 6
    (3, 8, 2, 64, 16, 8, "bfloat16"),
]


@pytest.mark.parametrize("b,hq,hkv,d,ps,mp,dtype", PAGED_SWEEP)
def test_paged_ref_matches_jax(b, hq, hkv, d, ps, mp, dtype):
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _mk_paged(
        42, b, hq, hkv, d, ps, mp, dtype)
    got = ref.paged_attention_ref(qt, kt, vt, bt, lt)
    _close(got, jref.paged_attention_ref(qj, kj, vj, bj, lj), dtype)
    _close(got, paged_attention(qj, kj, vj, bj, lj, interpret=True), dtype)


@pytest.mark.parametrize("case", ["softcap", "length1", "partial_page"])
def test_paged_ref_edges(case):
    lengths = {"softcap": None, "length1": [1, 1],
               "partial_page": [17, 33]}[case]
    softcap = 30.0 if case == "softcap" else None
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _mk_paged(
        7, 2, 8, 4, 64, 16, 4, "float32", lengths=lengths)
    got = ref.paged_attention_ref(qt, kt, vt, bt, lt, softcap=softcap)
    want = paged_attention(qj, kj, vj, bj, lj, softcap=softcap,
                           interpret=True)
    _close(got, want, "float32")


# a subset of tests/test_kernels.py's CHUNK_SWEEP, plus ragged shapes
CHUNK_SWEEP = [
    # (b, sq, hq, hkv, d, smax, window, softcap, dtype)
    (2, 64, 4, 4, 64, 256, None, None, "float32"),
    (1, 128, 8, 2, 64, 512, None, None, "float32"),
    (2, 64, 4, 2, 64, 256, 48, None, "float32"),      # sliding window
    (2, 32, 12, 2, 128, 128, None, 30.0, "float32"),  # qwen2 G = 6 + softcap
    (2, 64, 4, 4, 64, 256, None, None, "bfloat16"),
    (2, 20, 6, 2, 32, 100, None, None, "float32"),    # ragged Sq and Smax
    (3, 1, 4, 2, 32, 40, 8, None, "float32"),         # one query, window
]


@pytest.mark.parametrize("b,sq,hq,hkv,d,smax,window,softcap,dtype",
                         CHUNK_SWEEP)
def test_chunked_ref_matches_jax(b, sq, hq, hkv, d, smax, window, softcap,
                                 dtype):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.normal(size=(b, sq, hq, d)), dtype)
    kj, kt = _pair(rng.normal(size=(b, smax, hkv, d)), dtype)
    vj, vt = _pair(rng.normal(size=(b, smax, hkv, d)), dtype)
    sj, st = _ints(rng.integers(0, smax - sq + 1, size=(b,)))
    got = ref.chunked_prefill_attention_ref(qt, kt, vt, st, softcap=softcap,
                                            window=window)
    _close(got, jref.chunked_prefill_attention_ref(
        qj, kj, vj, sj, softcap=softcap, window=window), dtype)
    if sq % 32 == 0 and smax % 64 == 0:      # the Pallas kernel's tiling
        _close(got, chunked_prefill_attention(
            qj, kj, vj, sj, softcap=softcap, window=window, bq=32, bk=64,
            interpret=True), dtype)


# ------------------------------------------------------------------ routing


def _paged_inputs(dtype=torch.float32, d=64):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, d), generator=g).to(dtype)
    kp = torch.randn((4, 8, 2, d), generator=g).to(dtype)
    vp = torch.randn((4, 8, 2, d), generator=g).to(dtype)
    bt = torch.arange(4, dtype=torch.int32).view(2, 2)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    return q, kp, vp, bt, lengths


def test_ops_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(tpaged, "paged_attention", no_kernel)
    monkeypatch.setattr(tchunk, "chunked_prefill_attention", no_kernel)
    args = _paged_inputs()
    torch.testing.assert_close(ops.paged_attention_op(*args, softcap=5.0),
                               ref.paged_attention_ref(*args, softcap=5.0),
                               rtol=0, atol=0)
    q = torch.randn((2, 8, 4, 64))
    kc = torch.randn((2, 32, 2, 64))
    starts = torch.tensor([0, 24], dtype=torch.int32)
    torch.testing.assert_close(
        ops.chunked_prefill_op(q, kc, kc, starts, window=4),
        ref.chunked_prefill_attention_ref(q, kc, kc, starts, window=4),
        rtol=0, atol=0)
    assert tpaged.launches == 0 and tchunk.launches == 0


def test_ops_raise_on_unsupported_devices():
    q, kp, vp, bt, lengths = _paged_inputs()
    meta = torch.empty((2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_attention_op(meta, kp, vp, bt, lengths)
    with pytest.raises(ValueError, match="no kernel"):
        ops.chunked_prefill_op(meta[:, None], kp, vp, lengths)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.wkv6_op(q)


@pytest.mark.parametrize("kernel", ["paged", "chunked"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The wrappers launch on CUDA or raise; they never run on the CPU."""
    q, kp, vp, bt, lengths = _paged_inputs()
    with pytest.raises(ValueError, match="not CUDA"):
        if kernel == "paged":
            tpaged.paged_attention(q, kp, vp, bt, lengths)
        else:
            tchunk.chunked_prefill_attention(q[:, None], kp, vp, lengths)
