"""Measured-MFU roofline: instantiate the analytic model from real kernels.

Port of ``repro/perf/calibrate.py``. The analytic ``CostModel`` ships with
assumed efficiency constants (``mfu_prefill``/``mfu_decode``/``bw_eff``).
``calibrate_hardware`` runs the port's own attention kernels, the Hopper
chunked-prefill kernel for the prefill side and the paged-decode kernel
for the decode side (through ``kernels.ops``), times them, and returns a
``HardwareSpec`` whose efficiency constants are *measurements*:

    mfu    = achieved_flops / (elapsed · peak_flops)
    bw_eff = achieved_bytes / (elapsed · hbm_bw)

``calibrate_interference`` runs the two kernels *mixed* vs *pure* across a
(decode-batch × chunk-size) grid and solves each cell's measured excess
for the §IV contention coefficient γ, returning a bucketed
``InterferenceTable`` for ``HardwareSpec.interference``.

``CalibratedRooflineBackend`` is the ``ExecutionBackend`` over the
resulting model.

Flops, bytes, clamps, the γ solve and the default shapes are the JAX
package's. Where it runs: ``device=None`` means the card (and raises
without one), as every entry point of the port; the CPU only when the
caller passes ``device="cpu"``. On the card the inputs are bf16 and the
hand-written kernels run; on the CPU they are f32 and the kernels' plain
versions run, and the measured fractions are tiny but still well-defined
(clamped into ``(0, 1]``). ``_time_fn`` is the JAX package's: one warm-up,
then the median of ``repeats`` wall-clock times, each between two
``torch.cuda.synchronize`` calls on the card (``block_until_ready`` in
JAX).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional

from repro_torch.perf.hardware import (HardwareSpec, InterferenceTable, V5E,
                                       WorkerSpec)
from repro_torch.perf.model import CostModel

_MFU_FLOOR = 1e-6        # CPU measurements stay valid fractions


@dataclasses.dataclass(frozen=True)
class KernelCalibration:
    """What the calibration run measured (seconds + derived fractions).

    The ``gemm_*`` fields (0.0 when the GEMM pass is disabled) time the
    full-layer dense forward — projections, MLP, unembed — so the blended
    ``mfu_prefill``/``mfu_decode`` cover the MLP-dominated regime the
    attention microkernels alone cannot see. ``device`` is the card's name,
    or ``"cpu"``."""
    mfu_prefill: float
    mfu_decode: float
    bw_eff: float
    prefill_seconds: float
    decode_seconds: float
    prefill_flops: float
    decode_flops: float
    decode_bytes: float
    device: str
    gemm_prefill_seconds: float = 0.0
    gemm_decode_seconds: float = 0.0
    gemm_prefill_flops: float = 0.0
    gemm_decode_flops: float = 0.0
    mfu_gemm_prefill: float = 0.0
    mfu_gemm_decode: float = 0.0


def _clamp_frac(x: float) -> float:
    return min(max(x, _MFU_FLOOR), 1.0)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, repeats: int, device) -> float:
    """True-median-of-``repeats`` wall time, after one warmup call (kernels
    built and loaded); ``statistics.median`` averages the two middles of an
    even count."""
    if repeats < 1:
        raise ValueError(
            f"repeats must be >= 1 to measure anything, got {repeats}")
    fn()
    _sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _setup(device):
    """(device, its name for ``KernelCalibration``, working dtype)."""
    import torch

    from repro_torch.serving.executor import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        return device, torch.cuda.get_device_name(device), torch.bfloat16
    return device, device.type, torch.float32


def _tensor(a, dtype, device):
    import numpy as np
    import torch
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


def _prefill_case(rng, dtype, seq: int, heads: int, head_dim: int, device):
    """Pure chunked-prefill workload over the real kernel: (timed fn,
    useful flops, hot bytes). One full-chunk causal attention over the
    cache; flops = causal QK^T + PV = 4 · Hq · D · Sq · Skv / 2, bytes =
    q/k/v read + output write."""
    import torch

    from repro_torch.kernels import ops

    q = _tensor(rng.normal(size=(1, seq, heads, head_dim)), dtype, device)
    kc = _tensor(rng.normal(size=(1, seq, heads, head_dim)), dtype, device)
    vc = _tensor(rng.normal(size=(1, seq, heads, head_dim)), dtype, device)
    starts = torch.zeros((1,), dtype=torch.int32, device=device)
    flops = 4.0 * heads * head_dim * seq * seq / 2.0
    nbytes = 4.0 * seq * heads * head_dim * dtype.itemsize
    return (lambda: ops.chunked_prefill_op(q, kc, vc, starts),
            flops, nbytes)


def _decode_case(rng, dtype, batch: int, heads: int, head_dim: int,
                 page_size: int, pages_per_seq: int, device):
    """Pure paged-decode workload over a block-table-indirected pool:
    (timed fn, useful flops, hot bytes). Decode streams every attended
    K/V byte once — the memory roofline side."""
    import torch

    from repro_torch.kernels import ops

    n_pages = batch * pages_per_seq + 1
    ctx = page_size * pages_per_seq
    qd = _tensor(rng.normal(size=(batch, heads, head_dim)), dtype, device)
    kp = _tensor(rng.normal(size=(n_pages, page_size, heads, head_dim)),
                 dtype, device)
    vp = _tensor(rng.normal(size=(n_pages, page_size, heads, head_dim)),
                 dtype, device)
    bt = _tensor(rng.permutation(n_pages)[: batch * pages_per_seq]
                 .reshape(batch, pages_per_seq), torch.int32, device)
    lengths = torch.full((batch,), ctx, dtype=torch.int32, device=device)
    flops = 4.0 * batch * heads * head_dim * ctx
    nbytes = 2.0 * batch * ctx * heads * head_dim * dtype.itemsize
    return (lambda: ops.paged_attention_op(qd, kp, vp, bt, lengths),
            flops, nbytes)


def _gemm_case(rng, dtype, seq: int, batch: int, device):
    """Full-layer GEMM workload over the serving executor's own batched
    entry points (``ExecutorKernels.prefill_fn`` / ``decode_fn``): a tiny
    2-layer dense model driven through the exact slot-indexed functions
    ``RealExecutor`` runs, so the measured fraction prices the serving
    path — slot gather/scatter, bucket padding and on-device sampling
    included — not a bespoke harness. Weights in ``dtype`` from a seeded
    ``torch.Generator``. Returns ``(prefill_fn, prefill_flops, decode_fn,
    decode_flops)`` with the canonical 2 · n_active flops/token accounting
    the cost model uses, so the measured fraction is an apples-to-apples
    MFU."""
    import torch

    from repro_torch.models.api import build
    from repro_torch.models.layers import ModelConfig
    from repro_torch.perf.model import build_cost_spec
    from repro_torch.serving.executor import ExecutorKernels

    cfg = ModelConfig(name="calib-gemm", family="dense", num_layers=2,
                      d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
                      d_ff=512, vocab_size=512, dtype=dtype)
    api = build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n_active = build_cost_spec(cfg).n_active
    # +1 cache row so the decode write at position ``seq`` stays in bounds
    kernels = ExecutorKernels(api, max_slots=batch, max_len=seq + 1,
                              device=device)
    cache = api.init_cache(batch, seq + 1, device)
    bucket = kernels.bucket_for(seq)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, seq))
    chunk = torch.zeros((batch, bucket), dtype=torch.int32, device=device)
    chunk[:, :seq] = _tensor(tokens, torch.int32, device)
    slots = torch.arange(batch, dtype=torch.int32, device=device)
    starts = torch.zeros((batch,), dtype=torch.int32, device=device)
    takes = torch.full((batch,), seq, dtype=torch.int32, device=device)

    def prefill_call():
        toks, _ = kernels.prefill_fn(params, cache, chunk, slots, starts,
                                     takes)
        return toks

    lengths = torch.full((batch,), seq, dtype=torch.int32, device=device)
    step = _tensor(rng.integers(0, cfg.vocab_size, size=(batch,)),
                   torch.int32, device)

    def decode_call():
        toks, _ = kernels.decode_fn(params, cache, step, lengths)
        return toks

    prefill_call()                       # decode times a filled cache
    _sync(device)
    return (prefill_call, 2.0 * n_active * batch * seq,
            decode_call, 2.0 * n_active * batch)


def calibrate_hardware(hw: HardwareSpec = V5E, *,
                       seq: int = 256, heads: int = 4, head_dim: int = 64,
                       batch: int = 4, page_size: int = 16,
                       pages_per_seq: int = 8, repeats: int = 3,
                       device=None,
                       gemm: bool = True,
                       ) -> tuple[HardwareSpec, KernelCalibration]:
    """Measure achieved MFU / bandwidth-efficiency of the real serving
    kernels and return ``hw`` with the measured constants substituted.

    With ``gemm=True`` (default) the attention microkernel timings are
    blended with a full-layer dense-forward GEMM pass, so the returned
    MFU reflects the MLP-dominated regime a serving iteration actually
    spends most of its flops in:

        mfu = (attn_flops + gemm_flops) / ((t_attn + t_gemm) · peak)

    Shapes default small enough that a CPU calibration finishes in
    seconds; on the card pass serving-sized shapes (seq=2048,
    head_dim=128, page_size=64) for representative numbers."""
    import numpy as np

    device, name, dtype = _setup(device)
    rng = np.random.default_rng(0)

    prefill_fn, p_flops, _ = _prefill_case(rng, dtype, seq, heads, head_dim,
                                           device)
    t_p = _time_fn(prefill_fn, repeats, device)
    mfu_p = _clamp_frac(p_flops / (t_p * hw.peak_flops))

    decode_fn, d_flops, d_bytes = _decode_case(
        rng, dtype, batch, heads, head_dim, page_size, pages_per_seq,
        device)
    t_d = _time_fn(decode_fn, repeats, device)
    mfu_d = _clamp_frac(d_flops / (t_d * hw.peak_flops))
    bw_eff = _clamp_frac(d_bytes / (t_d * hw.hbm_bw))

    gp_t = gd_t = gp_f = gd_f = mfu_gp = mfu_gd = 0.0
    if gemm:
        gp_fn, gp_f, gd_fn, gd_f = _gemm_case(rng, dtype, seq, batch, device)
        gp_t = _time_fn(gp_fn, repeats, device)
        gd_t = _time_fn(gd_fn, repeats, device)
        mfu_gp = _clamp_frac(gp_f / (gp_t * hw.peak_flops))
        mfu_gd = _clamp_frac(gd_f / (gd_t * hw.peak_flops))
        # blended phase MFU: one combined workload, one combined clock
        mfu_p = _clamp_frac((p_flops + gp_f) / ((t_p + gp_t) * hw.peak_flops))
        mfu_d = _clamp_frac((d_flops + gd_f) / ((t_d + gd_t) * hw.peak_flops))

    cal = KernelCalibration(
        mfu_prefill=mfu_p, mfu_decode=mfu_d, bw_eff=bw_eff,
        prefill_seconds=t_p, decode_seconds=t_d,
        prefill_flops=p_flops, decode_flops=d_flops, decode_bytes=d_bytes,
        device=name,
        gemm_prefill_seconds=gp_t, gemm_decode_seconds=gd_t,
        gemm_prefill_flops=gp_f, gemm_decode_flops=gd_f,
        mfu_gemm_prefill=mfu_gp, mfu_gemm_decode=mfu_gd)
    measured = dataclasses.replace(
        hw, name=f"{hw.name}-measured",
        mfu_prefill=mfu_p, mfu_decode=mfu_d, bw_eff=bw_eff)
    return measured, cal


@dataclasses.dataclass(frozen=True)
class InterferenceCalibration:
    """What the mixed-vs-pure grid sweep measured, per cell."""
    table: InterferenceTable
    decode_batches: tuple           # grid axis values (= table edges)
    chunk_sizes: tuple
    pure_prefill_s: tuple           # per chunk size
    pure_decode_s: tuple            # per decode batch
    mixed_s: tuple                  # row-per-batch grid of mixed times
    device: str


def calibrate_interference(hw: HardwareSpec = V5E, *,
                           decode_batches: tuple = (1, 4, 8),
                           chunk_sizes: tuple = (128, 256),
                           heads: int = 4, head_dim: int = 64,
                           page_size: int = 16, pages_per_seq: int = 8,
                           repeats: int = 3,
                           device=None,
                           gamma_max: float = 1.0,
                           ) -> tuple[InterferenceTable,
                                      InterferenceCalibration]:
    """Measure the §IV mixed-batch contention coefficient γ per
    (decode-batch, chunk-size) bucket from the port's own serving kernels.

    For every grid cell the kernels run *pure* (the chunked-prefill
    attention alone, the paged decode attention alone) and *mixed* (both
    in one composed call — how a multiplexing worker's iteration
    executes), and the cell's measured excess over the perfect-overlap
    floor ``max(t_prefill, t_decode)`` solves the cost model's penalty
    form for γ::

        t_mixed = max(t_p, t_d) + γ · β_p · β_d · min(t_p, t_d)

    with β from the kernels' flop/byte rooflines — the same *functional
    form* as ``CostModel._interference``, evaluated over the attention
    kernels' own operands. γ is clamped into [0, ``gamma_max``];
    ``gamma_max=1`` keeps the model's guarantee that a mixed iteration
    never exceeds the fully-serialised sum. The two launches go to one
    stream, so on the card they run one after the other and γ measures
    how far the pair falls short of overlapping.

    Returns the bucketed table (edges = the swept grid values as bucket
    lower bounds) plus the raw per-cell measurements."""
    import numpy as np

    if not decode_batches or not chunk_sizes:
        raise ValueError("calibrate_interference needs a non-empty grid")
    decode_batches = tuple(sorted(decode_batches))
    chunk_sizes = tuple(sorted(chunk_sizes))
    device, name, dtype = _setup(device)
    rng = np.random.default_rng(0)
    peak_c = hw.peak_flops
    mem = hw.hbm_bw * hw.bw_eff

    # one workload per axis value, shared by the pure timing and every
    # mixed cell it appears in — the mixed run times the SAME operands
    # its pure baseline did. Alone-times are per-axis (a chunk's does not
    # depend on which decode batch it will be mixed with); mixed per cell.
    pre = {c: _prefill_case(rng, dtype, c, heads, head_dim, device)
           for c in chunk_sizes}
    dec = {b: _decode_case(rng, dtype, b, heads, head_dim, page_size,
                           pages_per_seq, device)
           for b in decode_batches}
    t_p = {c: _time_fn(pre[c][0], repeats, device) for c in chunk_sizes}
    t_d = {b: _time_fn(dec[b][0], repeats, device) for b in decode_batches}
    mixed_rows, gamma_rows = [], []
    for b in decode_batches:
        mixed_row, gamma_row = [], []
        for c in chunk_sizes:
            pf, p_flops, p_bytes = pre[c]
            df, d_flops, d_bytes = dec[b]
            t_mix = _time_fn(lambda: (pf(), df()), repeats, device)
            # kernel-level flop/byte accounting -> phase boundedness
            t_cp = p_flops / (peak_c * hw.mfu_prefill)
            t_mp = p_bytes / mem
            t_cd = d_flops / (peak_c * hw.mfu_decode)
            t_md = d_bytes / mem
            beta_p = t_cp / max(t_cp, t_mp)
            beta_d = t_md / max(t_cd, t_md)
            unit = beta_p * beta_d * min(t_p[c], t_d[b])
            excess = t_mix - max(t_p[c], t_d[b])
            gamma = min(max(excess / unit, 0.0), gamma_max) \
                if unit > 1e-12 else 0.0
            mixed_row.append(t_mix)
            gamma_row.append(gamma)
        mixed_rows.append(tuple(mixed_row))
        gamma_rows.append(tuple(gamma_row))

    table = InterferenceTable(decode_edges=decode_batches,
                              chunk_edges=chunk_sizes,
                              gamma=tuple(gamma_rows))
    cal = InterferenceCalibration(
        table=table, decode_batches=decode_batches, chunk_sizes=chunk_sizes,
        pure_prefill_s=tuple(t_p[c] for c in chunk_sizes),
        pure_decode_s=tuple(t_d[b] for b in decode_batches),
        mixed_s=tuple(mixed_rows), device=name)
    return table, cal


class CalibratedRooflineBackend:
    """ExecutionBackend whose clock is a roofline instantiated from
    measured kernel efficiency instead of the assumed constants.

    Runs the calibration once at construction; ``run_iteration`` then
    prices every composed iteration with the measured model. The
    per-worker cost models the engine carries (admission, capacity) are
    untouched — only the *clock* comes from measurements: capacity is a
    spec property, speed is an empirical one."""

    def __init__(self, cfg, worker: WorkerSpec = WorkerSpec(),
                 page_size: int = 16, device=None,
                 measure_interference: bool = False,
                 interference_kw: Optional[dict] = None,
                 **calibrate_kw):
        hw, self.calibration = calibrate_hardware(
            worker.hw, device=device, **calibrate_kw)
        self.interference_calibration = None
        if measure_interference:
            # solve γ against the MEASURED spec — the same constants the
            # model will recompute β with when applying the penalty
            table, self.interference_calibration = calibrate_interference(
                hw, device=device, **(interference_kw or {}))
            hw = dataclasses.replace(hw, interference=table)
        self.cost = CostModel(cfg, dataclasses.replace(worker, hw=hw),
                              page_size=page_size)

    def run_iteration(self, worker, plan) -> float:
        return self.cost.iteration_time(
            plan.n_decode, plan.sum_ctx, plan.prefill_tokens,
            plan.prefill_ctx_offset)

    def on_finish(self, req) -> None:
        pass

    def on_migrate(self, req, src_wid: int, dst_wid: int) -> None:
        pass
