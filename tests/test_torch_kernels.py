"""PyTorch port, attention kernels: the plain versions (what the ops run
on the CPU) against the JAX package's oracles and its Pallas kernels in
interpret mode, on the same numpy inputs; plain emulations of the
tensor-core prefill kernel's and the split decode kernel's arithmetic
against the JAX oracles; the windowed decode (the port's own: the Pallas
decode kernel takes no window) against the JAX model's masked attention;
the ops' routing; and the device kernel names the wrappers export. The
Hopper kernels themselves are held against the plain versions on the card
by chip_smoke.py."""
import ast
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro.kernels.paged_attention import paged_attention  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import chunked_prefill as tchunk  # noqa: E402
from repro_torch.kernels import fused as tfused  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.kernels import wkv6 as twkv  # noqa: E402

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


def _mma_prefill_emulation(q, k_cache, v_cache, starts, softcap=None,
                           window=None, tile=64, splits=1):
    """The arithmetic of ``chunked_prefill_mma_kernel`` in plain torch: bf16
    Q, K, V; f32 scores (softcap before the mask); an online softmax in f32
    over ``tile``-key tiles in which a masked key gets weight 0; P rounded
    to bf16 for P V, accumulated in f32; a row with no valid key gives 0.
    Each block of 64 // G queries walks its tiles from the window floor to
    its causal frontier in ``splits`` runs, each with its own online
    softmax, merged in f32 (weights e^(m_p - m) / l; a run that saw no key
    weighs 0)."""
    b, sq, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    bq = min(sq, 64 // g)
    qf = q.bfloat16().float().reshape(b, sq, hkv, g, d)
    kf, vf = k_cache.bfloat16().float(), v_cache.bfloat16().float()
    out = torch.zeros((b, sq, hkv, g, d))
    for bi in range(b):
        for q0 in range(0, sq, bq):
            qpos = int(starts[bi]) + q0 + torch.arange(min(bq, sq - q0))
            hi = min(smax, int(qpos[-1]) + 1)
            lo = max(0, int(qpos[0]) - window + 1) if window else 0
            kt_lo = lo // tile * tile
            n = max(0, -(-(hi - kt_lo) // tile))
            per = -(-n // splits)
            parts = []
            for sp in range(splits):
                t0, t1 = min(n, sp * per), min(n, (sp + 1) * per)
                qb = qf[bi, q0:q0 + len(qpos)]                # (nq, Hkv, G, D)
                m = torch.full((len(qpos), hkv, g), -math.inf)
                l = torch.zeros((len(qpos), hkv, g))
                acc = torch.zeros((len(qpos), hkv, g, d))
                for k0 in range(kt_lo + t0 * tile, kt_lo + t1 * tile, tile):
                    kt, vt = kf[bi, k0:k0 + tile], vf[bi, k0:k0 + tile]
                    s = torch.einsum("qhgd,shd->qhgs", qb, kt) / math.sqrt(d)
                    if softcap is not None:
                        s = softcap * torch.tanh(s / softcap)
                    kpos = torch.arange(k0, k0 + kt.shape[0])
                    ok = kpos[None] <= qpos[:, None]
                    if window is not None:
                        ok = ok & (kpos[None] > qpos[:, None] - window)
                    s = torch.where(ok[:, None, None], s, -math.inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.where(m_new == -math.inf, 1.0,
                                        torch.exp(m - m_new))
                    p = torch.where(s == -math.inf, 0.0,
                                    torch.exp(s - m_new[..., None]))
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "qhgs,shd->qhgd", p.bfloat16().float(), vt)
                    m = m_new
                parts.append((m, l, acc))
            ms, ls, accs = (torch.stack(x) for x in zip(*parts))
            if splits == 1:
                res = accs[0] / ls[0].clamp_min(1e-30)[..., None]
            else:
                top = ms.amax(0)
                f = torch.where(ms == -math.inf, 0.0, torch.exp(ms - top))
                w = f / (ls * f).sum(0).clamp_min(1e-30)
                res = (accs * w[..., None]).sum(0)
            out[bi, q0:q0 + len(qpos)] = res
    return out.reshape(b, sq, hq, d).bfloat16()


def _chip_smoke_constant(name):
    """A literal constant of chip_smoke.py (which exits on import without a
    CUDA device), read from its source."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


# the prefill launcher's split counts, which chip_smoke.py holds the C
# function to on the card; the kernel never splits below D = 256
PREFILL_SPLITS = _chip_smoke_constant("PREFILL_SPLITS")


MMA_SWEEP = [
    # (b, sq, hq, hkv, d, smax, window, softcap): qwen2 SMOKE heads, then
    # the full-width G = 6, D = 128 and a G = 1, D = 64 case
    (2, 32, 6, 2, 16, 128, None, None),
    (2, 40, 6, 2, 16, 100, 24, 30.0),
    (1, 5, 12, 2, 128, 200, None, None),
    (2, 70, 4, 4, 64, 160, None, None),
    # gemma2's heads (G = 2, D = 256: 32-key tiles, split key runs): a
    # global layer (4 runs), a window with both starts (504, 252) past it
    # (2 runs), a window with one start (297) past it (1 run)
    (2, 64, 8, 4, 256, 512, None, 50.0),
    (2, 64, 8, 4, 256, 640, 300, 50.0),
    (2, 32, 8, 4, 256, 448, 128, 50.0),
    # zamba2's head dim (D = 80: 5 k-steps, 64-key tiles): G = 1 at a
    # ragged Sq (64 queries a block, the last block 6), a window with a
    # softcap, and G = 4 (16 queries a block)
    (2, 70, 4, 4, 80, 200, None, None),
    (2, 100, 4, 4, 80, 300, 40, 30.0),
    (2, 37, 16, 4, 80, 160, None, None),
]


@pytest.mark.parametrize("b,sq,hq,hkv,d,smax,window,softcap", MMA_SWEEP)
def test_tensor_core_prefill_numerics_match_jax(b, sq, hq, hkv, d, smax,
                                                window, softcap):
    """bf16 P in P V (as the JAX model casts p to V's dtype) stays within
    the bf16 tolerance of the f32-P oracle the card holds the kernel to; at
    D = 256 over 32-key tiles in the launcher's split runs, also within it
    of the Pallas kernel."""
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.normal(size=(b, sq, hq, d)), "bfloat16")
    kj, kt = _pair(rng.normal(size=(b, smax, hkv, d)), "bfloat16")
    vj, vt = _pair(rng.normal(size=(b, smax, hkv, d)), "bfloat16")
    sj, st = _ints(rng.integers(0, smax - sq + 1, size=(b,)))
    wide = d == 256
    got = _mma_prefill_emulation(
        qt, kt, vt, st, softcap=softcap, window=window,
        tile=32 if wide else 64,
        splits=PREFILL_SPLITS[(b, sq, hq, hkv, d, smax, window)] if wide
        else 1)
    _close(got, jref.chunked_prefill_attention_ref(
        qj, kj, vj, sj, softcap=softcap, window=window), "bfloat16")
    if wide:
        _close(got, chunked_prefill_attention(
            qj, kj, vj, sj, softcap=softcap, window=window, bq=32, bk=64,
            interpret=True), "bfloat16")


def test_prefill_split_table_covers_runs_of_1_2_and_4():
    """The D = 256 rows above are shapes whose launcher split count
    chip_smoke.py checks on the card, and between them they merge runs of
    4, 2 and 1."""
    wide = [row[:7] for row in MMA_SWEEP if row[4] == 256]
    assert all(key in PREFILL_SPLITS for key in wide)
    assert sorted(PREFILL_SPLITS[key] for key in wide) == [1, 2, 4]


def _split_decode_emulation(q, k_pages, v_pages, block_tables, lengths, *,
                            splits, softcap=None, window=None):
    """The arithmetic of ``csrc/paged_attention.cu`` in plain torch. Each
    (b, kv-head) splits the pages holding its tokens [first, len) (first =
    len - window under a window, else 0) into ``splits`` runs of whole
    pages (at least one a split; splits past the length are empty; the
    first split starts at ``first``); in a split, warp w of 4 takes key
    tiles w, w + 4,
    ... and keeps its own online softmax (m, l, acc) in f32; every (split,
    warp) partial is merged in f32, and an empty one (m = -inf) weighs 0.
    bf16 at D = 64 / 80 / 128 / 256 is the tensor-core variant (16-key
    tiles, P rounded to bf16 for P V); other inputs the CUDA-core one
    (32-key tiles, P in f32; the kernel runs 1-4 warps as shared memory
    allows, which changes only the order of the f32 merge). Length 0 gives
    0."""
    b, hq, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    g, mp = hq // hkv, block_tables.shape[1]
    mma = q.dtype == torch.bfloat16 and d in tpaged.TENSOR_CORE_HEAD_DIMS
    tile, warps = (16, 4) if mma else (32, 4)
    qf = q.float().reshape(b, hkv, g, d)
    out = torch.zeros((b, hkv, g, d))
    tok = torch.arange(mp * ps)
    for bi in range(b):
        n = max(0, min(int(lengths[bi]), mp * ps))
        rows = block_tables[bi].long().clamp_min(0)[tok // ps]
        k = k_pages[rows, tok % ps].float()                  # (P*ps, Hkv, D)
        v = v_pages[rows, tok % ps].float()
        first = max(0, n - window) if window else 0
        p0 = first // ps
        pages = -(-n // ps) - p0
        per = max(1, -(-pages // splits))                  # pages a split
        parts = []
        for s in range(splits):
            lo = max(first, (p0 + s * per) * ps)
            hi = min(n, (p0 + (s + 1) * per) * ps)
            for w in range(warps):
                m = torch.full((hkv, g), -math.inf)
                l = torch.zeros((hkv, g))
                acc = torch.zeros((hkv, g, d))
                for t0 in range(lo + w * tile, hi, warps * tile):
                    kt, vt = k[t0:min(t0 + tile, hi)], v[t0:min(t0 + tile, hi)]
                    sc = torch.einsum("hgd,thd->hgt", qf[bi], kt) / math.sqrt(d)
                    if softcap is not None:
                        sc = softcap * torch.tanh(sc / softcap)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    pv = p.bfloat16().float() if mma else p
                    acc = acc * alpha[..., None] + torch.einsum(
                        "hgt,thd->hgd", pv, vt)
                    m = m_new
                parts.append((m, l, acc))
        ms, ls, accs = (torch.stack(x) for x in zip(*parts))
        top = ms.amax(0)
        f = torch.where(ms == -math.inf, 0.0, torch.exp(ms - top))
        out[bi] = (accs * f[..., None]).sum(0) / \
            (ls * f).sum(0).clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def _kernel_splits(b, hkv, max_pages, sms=132, cap=16):
    """S as the launcher picks it: the SMs over B * Hkv, at most the
    table's pages and the cluster limit."""
    return max(1, min(sms // (b * hkv), cap, max_pages))


SPLIT_SWEEP = [
    # (b, hq, hkv, d, page, max_pages, dtype, lengths, softcap, splits);
    # splits None: as the launcher picks them
    *[(b, hq, hkv, d, ps, mp, dt, None, None, None)
      for b, hq, hkv, d, ps, mp, dt in PAGED_SWEEP],
    (2, 12, 2, 128, 16, 8, "bfloat16", [20, 33], None, 8),   # splits > pages
    (2, 12, 2, 128, 16, 4, "bfloat16", [1, 1], None, 4),     # length 1
    (2, 8, 1, 64, 16, 4, "bfloat16", [17, 50], None, 3),     # partial page
    (2, 16, 2, 64, 16, 4, "bfloat16", None, None, 4),        # G = 8
    (2, 32, 2, 128, 16, 4, "bfloat16", None, None, 4),       # G = 16
    (2, 12, 2, 128, 16, 4, "bfloat16", None, 30.0, 4),       # softcap
    (3, 12, 2, 128, 16, 4, "float32", [1, 17, 64], 30.0, 5),  # CUDA cores
    # gemma2 (G = 2, D = 256, softcap 50) on the tensor cores: the serve
    # step's 8 slots (S = 4) and one slot at 4300 (S = 16)
    (8, 8, 4, 256, 64, 16, "bfloat16", [300, 420, 96, 512, 280, 333, 64, 450],
     50.0, None),
    (1, 8, 4, 256, 64, 68, "bfloat16", [4300], 50.0, None),
    # zamba2 (G = 1, D = 80) on the tensor cores: the serve step's 8 slots
    # over 32 KV heads (256 pairs, S = 1; 8 pages of 64 hold the longest),
    # one slot split over 16 blocks, a partial page
    (8, 32, 32, 80, 64, 8, "bfloat16", [300, 420, 96, 512, 280, 333, 64, 450],
     None, None),
    (1, 4, 4, 80, 16, 32, "bfloat16", [500], None, None),
    (2, 4, 4, 80, 16, 4, "bfloat16", [17, 50], None, 3),
]


@pytest.mark.parametrize(
    "b,hq,hkv,d,ps,mp,dtype,lengths,softcap,splits", SPLIT_SWEEP)
def test_split_decode_numerics_match_jax(b, hq, hkv, d, ps, mp, dtype,
                                         lengths, softcap, splits):
    """Per-split partials merged in f32, with P in bf16 on the tensor-core
    variant, stay within the file's tolerance of the JAX oracle and of the
    Pallas kernel."""
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _mk_paged(
        3, b, hq, hkv, d, ps, mp, dtype, lengths=lengths)
    got = _split_decode_emulation(
        qt, kt, vt, bt, lt, softcap=softcap,
        splits=splits or _kernel_splits(b, hkv, mp))
    _close(got, jref.paged_attention_ref(qj, kj, vj, bj, lj,
                                         softcap=softcap), dtype)
    _close(got, paged_attention(qj, kj, vj, bj, lj, softcap=softcap,
                                interpret=True), dtype)


# windowed decode: (b, hq, hkv, d, page, max_pages, dtype, lengths,
# softcap, window, splits); lengths on both sides of the window, with
# len - window on a page boundary, inside a page and at 0
WINDOW_SWEEP = [
    (4, 12, 2, 128, 16, 8, "bfloat16", [1, 40, 56, 128], None, 40, None),
    (3, 8, 4, 256, 16, 4, "float32", [10, 33, 64], 50.0, 16, 5),  # gemma2
    (2, 8, 4, 256, 16, 4, "bfloat16", [64, 50], 50.0, 20, None),
    (2, 12, 2, 128, 16, 8, "bfloat16", [100, 128], None, 1, 8),
    (2, 4, 4, 64, 32, 4, "float32", [128, 97], None, 96, 3),
    (2, 16, 2, 64, 16, 4, "bfloat16", [60, 33], 30.0, 24, 4),
    # gemma2's timed decode shapes, bf16 on the tensor cores at the
    # launcher's S: 8 slots (the window never bites, S = 4), one slot at
    # 4300 (first key 204, S = 16)
    (8, 8, 4, 256, 64, 16, "bfloat16", [300, 420, 96, 512, 280, 333, 64, 450],
     50.0, 4096, None),
    (1, 8, 4, 256, 64, 68, "bfloat16", [4300], 50.0, 4096, None),
]


def _dense(pages, tables):
    """(B, P * ps, Hkv, D): each request's pages gathered in table order."""
    b, mp = tables.shape
    return pages[tables].reshape(b, mp * pages.shape[1], *pages.shape[2:])


@pytest.mark.parametrize(
    "b,hq,hkv,d,ps,mp,dtype,lengths,softcap,window,splits", WINDOW_SWEEP)
def test_windowed_paged_ref_matches_jax(b, hq, hkv, d, ps, mp, dtype,
                                        lengths, softcap, window, splits):
    """The plain windowed decode against the JAX model's XLA attention
    under ``MaskSpec("lengths", window)`` (its lengths: the write
    position, one less) and against the JAX prefill oracle on a one-token
    chunk at that position."""
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _mk_paged(
        5, b, hq, hkv, d, ps, mp, dtype, lengths=lengths)
    got = ref.paged_attention_ref(qt, kt, vt, bt, lt, softcap=softcap,
                                  window=window)
    kd, vd = _dense(kj, bj), _dense(vj, bj)
    xla = JL.attention_scores(qj[:, None], kd, vd,
                              JL.MaskSpec("lengths", window=window),
                              attn_softcap=softcap, lengths=lj - 1)
    _close(got, xla[:, 0], dtype)
    one = jref.chunked_prefill_attention_ref(qj[:, None], kd, vd, lj - 1,
                                             softcap=softcap, window=window)
    _close(got, one[:, 0], dtype)


@pytest.mark.parametrize(
    "b,hq,hkv,d,ps,mp,dtype,lengths,softcap,window,splits", WINDOW_SWEEP)
def test_windowed_split_decode_numerics_match_jax(b, hq, hkv, d, ps, mp,
                                                  dtype, lengths, softcap,
                                                  window, splits):
    """The kernel's split of [len - window, len) (the first split starting
    inside a page), merged in f32, against the JAX one-token oracle and the
    port's plain version."""
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _mk_paged(
        6, b, hq, hkv, d, ps, mp, dtype, lengths=lengths)
    got = _split_decode_emulation(
        qt, kt, vt, bt, lt, softcap=softcap, window=window,
        splits=splits or _kernel_splits(b, hkv, mp))
    one = jref.chunked_prefill_attention_ref(
        qj[:, None], _dense(kj, bj), _dense(vj, bj), lj - 1,
        softcap=softcap, window=window)
    _close(got, one[:, 0], dtype)
    torch.testing.assert_close(
        got.float(), ref.paged_attention_ref(
            qt, kt, vt, bt, lt, softcap=softcap, window=window).float(),
        **TOL[dtype])


def test_split_decode_length_zero_gives_zero():
    """A request of length 0 has only empty splits; the kernel returns 0
    (the oracles' uniform softmax over masked keys is not compared)."""
    (_, qt), (_, kt), (_, vt), (_, bt), (_, lt) = _mk_paged(
        4, 2, 12, 2, 128, 16, 4, "bfloat16", lengths=[0, 9])
    got = _split_decode_emulation(qt, kt, vt, bt, lt, splits=4)
    assert not got[0].any() and got[1].abs().sum() > 0


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
    torch.testing.assert_close(ops.paged_attention_op(*args, window=3),
                               ref.paged_attention_ref(*args, window=3),
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
    meta4 = torch.empty((2, 1, 4, 64), device="meta")
    u, s0 = torch.zeros((4, 64)), torch.zeros((2, 4, 64, 64))
    with pytest.raises(ValueError, match="no kernel"):
        ops.wkv6_op(meta4, meta4, meta4, meta4, u, s0, "decode")


@pytest.mark.parametrize("kernel", ["paged", "chunked"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The wrappers launch on CUDA or raise; they never run on the CPU."""
    q, kp, vp, bt, lengths = _paged_inputs()
    with pytest.raises(ValueError, match="not CUDA"):
        if kernel == "paged":
            tpaged.paged_attention(q, kp, vp, bt, lengths)
        else:
            tchunk.chunked_prefill_attention(q[:, None], kp, vp, lengths)


def test_tensor_core_head_dims_are_one_rule():
    """Both attention wrappers send bf16 at the same head dims to their
    tensor-core kernels (chip_smoke.py holds each C variant function to
    this constant), and gemma2's 256 and zamba2's 80 are among them."""
    assert tchunk.TENSOR_CORE_HEAD_DIMS == tpaged.TENSOR_CORE_HEAD_DIMS \
        == (64, 80, 128, 256)


@pytest.mark.parametrize("module", [tchunk, tpaged, twkv, tfused],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_exported_kernel_names_are_the_sources_kernels(module):
    """The names chip_smoke.py's profile matches device time by are the
    ``__global__`` functions of the wrapper's source, one per variant."""
    src = module.LIB.source.read_text()
    kernels = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        src))
    assert set(module.KERNELS.values()) == kernels
    assert getattr(module, "launches_by_variant",
                   dict.fromkeys(module.KERNELS)).keys() == module.KERNELS.keys()


@pytest.mark.parametrize("module", [tchunk, tpaged],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_e4m3_launches_count_under_their_own_variant_keys(module,
                                                          monkeypatch):
    """A launch over e4m3 K/V counts under its variant's ``_e4m3`` key, a
    key of ``launches_by_variant`` naming the variant's own device kernel
    (chip_smoke.py holds every e4m3 case and the fp8 serve paths to these
    keys); the variant itself still follows q's dtype and D alone. The
    library's variant function is stood in for (no card here)."""
    name = module.__name__.rsplit(".", 1)[-1]
    dims = module.TENSOR_CORE_HEAD_DIMS
    monkeypatch.setattr(module.LIB, "lib", lambda: type("Lib", (), {
        f"{name}_variant": staticmethod(
            lambda d, dtype: int(dtype == 1 and d in dims))})())
    bf16, f32 = 1, 0
    for d, dtype, kv, want in ((128, bf16, 0, "tensor_core"),
                               (128, bf16, 1, "tensor_core_e4m3"),
                               (256, bf16, 1, "tensor_core_e4m3"),
                               (80, bf16, 1, "tensor_core_e4m3"),
                               (80, f32, 0, "cuda_core"),
                               (96, bf16, 1, "cuda_core_e4m3"),
                               (128, f32, 1, "cuda_core_e4m3"),
                               (64, f32, 0, "cuda_core")):
        key = module.variant_key(d, dtype, kv)
        assert key == want and key in module.launches_by_variant
        assert module.KERNELS[key] == module.KERNELS[key.removesuffix("_e4m3")]
