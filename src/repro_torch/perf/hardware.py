"""Hardware descriptions for the unified performance model.

``HardwareSpec`` is **per-worker**: a cluster may mix fast and slow
workers (different chip generations, degraded-MFU stragglers, thermally
throttled hosts), and every layer that prices work — dispatch, toggle
admission, decode routing, role rebalancing — must price it on the
*target* worker's hardware, not a global spec. ``WorkerSpec`` scales one
``HardwareSpec`` by the tensor-parallel degree of a model replica.

Constants follow the assignment hardware: TPU v5e, 197 TFLOP/s bf16,
819 GB/s HBM, ~50 GB/s/link ICI per chip.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class InterferenceTable:
    """Bucketed §IV interference coefficient γ(n_decode, prefill_tokens).

    The super-additive mixed-batch slowdown is not one number: DistServe
    (arXiv:2401.09670) and prefill-decode multiplexing (arXiv:2504.14489)
    both measure it varying strongly with the decode batch size and the
    co-batched chunk length. ``decode_edges`` / ``chunk_edges`` are
    ascending bucket *lower bounds* (the first bucket also absorbs
    anything below it); ``gamma[i][j]`` applies to decode bucket ``i`` ×
    chunk bucket ``j`` and lookups are piecewise-constant within a cell.

    ``HardwareSpec.interference`` accepts a plain scalar (uniform γ, the
    legacy form — ``from_scalar`` is the degenerate 1×1 table and prices
    every mixed batch identically) or a table; ``gamma_at`` resolves
    both, so every consumer of the model is shape-agnostic."""
    decode_edges: tuple
    chunk_edges: tuple
    gamma: tuple                      # one row-tuple per decode bucket

    def __post_init__(self):
        # normalise to tuples so the (frozen) table stays hashable inside
        # HardwareSpec — build_cluster deduplicates specs via set()
        object.__setattr__(self, "decode_edges", tuple(self.decode_edges))
        object.__setattr__(self, "chunk_edges", tuple(self.chunk_edges))
        object.__setattr__(self, "gamma",
                           tuple(tuple(float(g) for g in row)
                                 for row in self.gamma))
        if not self.decode_edges or not self.chunk_edges:
            raise ValueError("InterferenceTable needs >= 1 bucket per axis")
        for edges in (self.decode_edges, self.chunk_edges):
            if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
                raise ValueError(f"bucket edges must strictly ascend: {edges}")
        if len(self.gamma) != len(self.decode_edges) or any(
                len(row) != len(self.chunk_edges) for row in self.gamma):
            raise ValueError(
                f"gamma grid must be {len(self.decode_edges)}x"
                f"{len(self.chunk_edges)}, got "
                f"{[len(r) for r in self.gamma]}")
        for row in self.gamma:
            for g in row:
                # NaN fails both comparisons; negative γ would price mixed
                # iterations BELOW the additive roofline
                if not (math.isfinite(g) and g >= 0.0):
                    raise ValueError(f"gamma must be finite and >= 0, "
                                     f"got {g!r}")

    @classmethod
    def from_scalar(cls, gamma: float) -> "InterferenceTable":
        """The degenerate 1×1 table: one γ for every mixed batch —
        bit-equivalent to the legacy scalar ``HardwareSpec.interference``."""
        return cls(decode_edges=(0,), chunk_edges=(0,),
                   gamma=((float(gamma),),))

    @staticmethod
    def _cell(edges: tuple, x: float) -> int:
        return max(bisect.bisect_right(edges, x) - 1, 0)

    def lookup(self, n_decode: float, prefill_tokens: float) -> float:
        return self.gamma[self._cell(self.decode_edges, n_decode)][
            self._cell(self.chunk_edges, prefill_tokens)]

    @property
    def max_gamma(self) -> float:
        return max(max(row) for row in self.gamma)


def gamma_at(interference, n_decode: float, prefill_tokens: float) -> float:
    """Resolve a scalar-or-table ``HardwareSpec.interference`` to the γ
    governing one concrete mixed batch. A scalar (incl. the 0.0 default)
    is returned unchanged, so the legacy additive path stays bit-exact."""
    if isinstance(interference, InterferenceTable):
        return interference.lookup(n_decode, prefill_tokens)
    return float(interference)


def gamma_at_batch(interference, n_decode, prefill_tokens) -> np.ndarray:
    """Vectorized ``gamma_at``: resolve γ for many mixed batches at once.

    ``np.searchsorted(edges, x, side="right") - 1`` clipped at 0 is
    bit-identical to ``InterferenceTable._cell``'s
    ``bisect.bisect_right`` (bucket lower bounds and batch sizes are
    small integers, exactly representable in float64), so every element
    equals the scalar lookup."""
    n = np.asarray(n_decode, dtype=np.float64)
    p = np.asarray(prefill_tokens, dtype=np.float64)
    n, p = np.broadcast_arrays(n, p)
    if isinstance(interference, InterferenceTable):
        de = np.asarray(interference.decode_edges, dtype=np.float64)
        ce = np.asarray(interference.chunk_edges, dtype=np.float64)
        grid = np.asarray(interference.gamma, dtype=np.float64)
        i = np.maximum(np.searchsorted(de, n, side="right") - 1, 0)
        j = np.maximum(np.searchsorted(ce, p, side="right") - 1, 0)
        return grid[i, j]
    return np.full(n.shape, float(interference))


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 per chip
    hbm_bw: float = 819e9             # bytes/s per chip
    hbm_bytes: float = 16e9           # per chip
    ici_bw: float = 50e9              # bytes/s per link
    ici_links: int = 2                # usable links for P2P KV migration
    mfu_prefill: float = 0.55         # achievable fraction of peak, big GEMMs
    mfu_decode: float = 0.6           # decode GEMMs are memory bound anyway
    bw_eff: float = 0.8
    t_fixed: float = 0.003            # per-iteration dispatch overhead (s)
    migration_latency: float = 0.001  # per-migration fixed cost (s)
    # Host-DRAM tier link (tiered KV offload/restore): aggregate DMA
    # bandwidth between one worker's HBM and host memory, PCIe-class —
    # far below ICI, which is exactly why restore cost must be priced
    # before choosing offload over re-prefill.
    host_bw: float = 32e9             # bytes/s per worker, each direction
    host_latency: float = 0.0005      # per-offload/restore fixed cost (s)
    # §IV interference: decode tokens co-batched with prefill chunks pay a
    # contention penalty (the mixed iteration is NOT the sum of its parts —
    # it is worse). A scalar γ (0.0 = the legacy purely-additive roofline,
    # which every pre-existing benchmark reproduces bit-exactly) or an
    # ``InterferenceTable`` calibrated per (decode-batch, chunk-size)
    # bucket by ``repro_torch.perf.calibrate.calibrate_interference`` and kept
    # current online by ``repro_torch.perf.recalibrate.DriftMonitor``.
    interference: "float | InterferenceTable" = 0.0

    def slowed(self, factor: float) -> "HardwareSpec":
        """A ``factor``x-slower variant of this spec (straggler modelling):
        compute and memory throughput both divide by ``factor``."""
        return dataclasses.replace(
            self, name=f"{self.name}-x{factor:g}slow",
            peak_flops=self.peak_flops / factor,
            hbm_bw=self.hbm_bw / factor)


V5E = HardwareSpec()


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One serving worker = ``tp`` chips running one model replica."""
    tp: int = 4
    hw: HardwareSpec = V5E

    @property
    def peak_flops(self) -> float:
        return self.tp * self.hw.peak_flops

    @property
    def hbm_bw(self) -> float:
        return self.tp * self.hw.hbm_bw

    @property
    def hbm_bytes(self) -> float:
        return self.tp * self.hw.hbm_bytes
