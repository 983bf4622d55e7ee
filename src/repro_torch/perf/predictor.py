"""Execution-time predictors (paper §IV-C), per-worker aware.

The toggle "leverages offline profiling tools to estimate both the
execution time of a prefill request and the queuing time when scheduling
to the local worker". Every predict method takes an optional ``wid`` so
callers can price work on the *target* worker's hardware — heterogeneous
clusters answer differently per worker, homogeneous ones ignore it (and
stay decision-identical to the pre-``repro_torch.perf`` scheduler).

* ``AnalyticalPredictor`` — wraps one roofline ``CostModel`` (what the
  simulator itself uses, optionally with a safety margin; predictor error
  can be injected for robustness experiments). Worker-agnostic.
* ``ClusterPredictor`` — one ``IterationCostModel`` per worker: the
  heterogeneous-cluster analytic predictor. ``wid=None`` prices on the
  reference (fastest) worker.
* ``ProfiledPredictor`` — piecewise-linear interpolation over an offline
  profile table {(tokens, ctx) -> seconds}, the way a real deployment
  profiles its worker; built by ``profile_worker`` from any executor.

The online-calibration wrapper (``OnlinePredictor``) lives in
``repro_torch.perf.calibration``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.perf.model import (CostModel, IterationCostModel,
                              canonical_iteration_time)


def _col(x, n: int) -> np.ndarray:
    """Broadcast a scalar-or-sequence argument to a length-``n`` float64
    column (a read-only broadcast view for scalars — callers never write)."""
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 0:
        return np.broadcast_to(a, (n,))
    return a


def _seq(x, n: int) -> Sequence:
    """Per-element view of a scalar-or-sequence argument, preserving the
    original Python scalar types for exact scalar-fallback loops."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return x
    return [x] * n


class Predictor:
    def predict_prefill(self, tokens: int, ctx_offset: int = 0,
                        wid: Optional[int] = None) -> float:
        raise NotImplementedError

    def predict_decode_iter(self, n_decode: int, sum_ctx: float,
                            wid: Optional[int] = None) -> float:
        raise NotImplementedError

    def predict_migration(self, ctx_tokens: int,
                          wid: Optional[int] = None) -> float:
        raise NotImplementedError

    def predict_interference(self, n_decode: int, sum_ctx: float,
                             prefill_tokens: int, ctx_offset: float = 0.0,
                             wid: Optional[int] = None) -> float:
        """§IV contention penalty a prefill chunk adds *on top of* the
        additive prefill + decode estimates when co-batched with
        ``n_decode`` running decodes. Admission paths add this to their
        chunk cost; the default (and any γ=0 model) returns exactly 0.0,
        so interference-blind predictors keep legacy decision parity."""
        return 0.0

    def predict_restore(self, ctx_tokens: int, residue_tokens: int = 0,
                        wid: Optional[int] = None) -> float:
        """Tiered-KV restore cost: wire time to pull an offloaded request's
        KV back over the host link plus any re-prefill residue. The engine
        offloads instead of evicting only when this beats re-prefilling the
        whole context; the default inf means 'no tier knowledge — never
        prefer offload', keeping tier-blind predictors safe."""
        return float("inf")

    # ------------------------------------------------- batched entry points
    # Price one candidate against many workers in a single call: ``wids``
    # is a length-n sequence of worker ids (None allowed, same meaning as
    # the scalar calls); the other arguments broadcast scalar-or-length-n.
    # The base implementations are scalar loops — bit-identical by
    # construction, so any Predictor subclass is batch-callable; the
    # analytic subclasses override with one-shot numpy evaluations that
    # tests/test_vectorized.py pins against the loops element-for-element.

    def predict_prefill_batch(self, wids: Sequence[Optional[int]], tokens,
                              ctx_offset=0) -> np.ndarray:
        n = len(wids)
        toks, offs = _seq(tokens, n), _seq(ctx_offset, n)
        return np.array([self.predict_prefill(t, o, wid=w)
                         for w, t, o in zip(wids, toks, offs)],
                        dtype=np.float64)

    def predict_decode_iter_batch(self, wids: Sequence[Optional[int]],
                                  n_decode, sum_ctx) -> np.ndarray:
        n = len(wids)
        nds, scs = _seq(n_decode, n), _seq(sum_ctx, n)
        return np.array([self.predict_decode_iter(b, s, wid=w)
                         for w, b, s in zip(wids, nds, scs)],
                        dtype=np.float64)

    def predict_interference_batch(self, wids: Sequence[Optional[int]],
                                   n_decode, sum_ctx, prefill_tokens,
                                   ctx_offset=0.0) -> np.ndarray:
        n = len(wids)
        nds, scs = _seq(n_decode, n), _seq(sum_ctx, n)
        pts, offs = _seq(prefill_tokens, n), _seq(ctx_offset, n)
        return np.array([self.predict_interference(b, s, p, o, wid=w)
                         for w, b, s, p, o in zip(wids, nds, scs, pts, offs)],
                        dtype=np.float64)

    # ------------------------------------------- slack-chunk inversion
    def chunk_candidates(self, wids: Sequence[Optional[int]], lo: int,
                         hi: int, budget, n_decode, sum_ctx, ctx_offset,
                         s_mul=None) -> Optional[np.ndarray]:
        """Closed-form slack-chunking support: per-row candidate chunk
        sizes guaranteed to contain every integer on [lo, hi] where this
        predictor's chunk cost (prefill + interference) can cross the
        per-row ``budget`` — so the toggle verifies them with ONE batched
        cost evaluation instead of a bisection loop. ``s_mul`` stacks an
        extra per-row multiplier on the prefill estimate (the
        OnlinePredictor's EWMA scale). None = no closed form available
        (profiled/custom predictors); callers fall back to bisection."""
        return None


@dataclasses.dataclass
class AnalyticalPredictor(Predictor):
    cost: CostModel
    safety: float = 1.1          # conservative over-estimate (paper: the
                                 # toggle "conservatively sends requests")
    def predict_prefill(self, tokens: int, ctx_offset: int = 0,
                        wid: Optional[int] = None) -> float:
        return self.cost.prefill_time(tokens, ctx_offset) * self.safety

    def predict_decode_iter(self, n_decode: int, sum_ctx: float,
                            wid: Optional[int] = None) -> float:
        return self.cost.decode_iter_time(n_decode, sum_ctx) * self.safety

    def predict_migration(self, ctx_tokens: int,
                          wid: Optional[int] = None) -> float:
        return self.cost.migration_time(ctx_tokens) * self.safety

    def predict_interference(self, n_decode: int, sum_ctx: float,
                             prefill_tokens: int, ctx_offset: float = 0.0,
                             wid: Optional[int] = None) -> float:
        return self.cost.interference_penalty(
            n_decode, sum_ctx, prefill_tokens, ctx_offset) * self.safety

    def predict_restore(self, ctx_tokens: int, residue_tokens: int = 0,
                        wid: Optional[int] = None) -> float:
        return self.cost.restore_time(ctx_tokens, residue_tokens) \
            * self.safety

    def predict_prefill_batch(self, wids: Sequence[Optional[int]], tokens,
                              ctx_offset=0) -> np.ndarray:
        n = len(wids)
        return self.cost.prefill_time_batch(
            _col(tokens, n), _col(ctx_offset, n)) * self.safety

    def predict_decode_iter_batch(self, wids: Sequence[Optional[int]],
                                  n_decode, sum_ctx) -> np.ndarray:
        n = len(wids)
        return self.cost.decode_iter_time_batch(
            _col(n_decode, n), _col(sum_ctx, n)) * self.safety

    def predict_interference_batch(self, wids: Sequence[Optional[int]],
                                   n_decode, sum_ctx, prefill_tokens,
                                   ctx_offset=0.0) -> np.ndarray:
        n = len(wids)
        return self.cost.interference_penalty_batch(
            _col(n_decode, n), _col(sum_ctx, n), _col(prefill_tokens, n),
            _col(ctx_offset, n)) * self.safety

    def _chunk_scales(self) -> tuple[float, float]:
        """(prefill multiplier, penalty multiplier) this predictor applies
        on top of the raw CostModel estimates — what the closed-form
        chunk inversion must fold into its coefficients."""
        return self.safety, self.safety

    def chunk_candidates(self, wids: Sequence[Optional[int]], lo: int,
                         hi: int, budget, n_decode, sum_ctx, ctx_offset,
                         s_mul=None) -> Optional[np.ndarray]:
        n = len(wids)
        S, Q = self._chunk_scales()
        s = S if s_mul is None else S * _col(s_mul, n)
        return self.cost.chunk_candidates(
            lo, hi, _col(budget, n), _col(n_decode, n), _col(sum_ctx, n),
            _col(ctx_offset, n), s, Q)


class BiasedPredictor(AnalyticalPredictor):
    """Systematically ``bias``×-miscalibrated analytical predictor — a
    stale or wrong-hardware offline profile. Robustness benchmarks and the
    OnlinePredictor convergence tests inject known error through this."""

    def __init__(self, cost: CostModel, bias: float, safety: float = 1.1):
        super().__init__(cost, safety=safety)
        self.bias = bias

    def predict_prefill(self, tokens: int, ctx_offset: int = 0,
                        wid: Optional[int] = None) -> float:
        return super().predict_prefill(tokens, ctx_offset, wid) * self.bias

    def predict_decode_iter(self, n_decode: int, sum_ctx: float,
                            wid: Optional[int] = None) -> float:
        return super().predict_decode_iter(n_decode, sum_ctx, wid) * self.bias

    def predict_prefill_batch(self, wids: Sequence[Optional[int]], tokens,
                              ctx_offset=0) -> np.ndarray:
        return super().predict_prefill_batch(wids, tokens, ctx_offset) \
            * self.bias

    def predict_decode_iter_batch(self, wids: Sequence[Optional[int]],
                                  n_decode, sum_ctx) -> np.ndarray:
        return super().predict_decode_iter_batch(wids, n_decode, sum_ctx) \
            * self.bias

    def _chunk_scales(self) -> tuple[float, float]:
        # the bias hits the additive prefill estimate only — interference
        # is not overridden and keeps the base safety margin
        return self.safety * self.bias, self.safety


class ClusterPredictor(Predictor):
    """Per-worker analytic pricing over heterogeneous hardware.

    One ``IterationCostModel`` per worker id; predictions for ``wid``
    price on that worker's spec, so a 2x-slow straggler's prefill chunk
    really predicts 2x longer. ``wid=None`` (worker-agnostic call sites:
    SLO derivation, global-queue sizing) uses the reference model — by
    convention the fastest worker's, matching the optimistic light-load
    latencies SLOs are derived from."""

    def __init__(self, costs: dict[int, IterationCostModel],
                 reference: Optional[IterationCostModel] = None,
                 safety: float = 1.1):
        if not costs:
            raise ValueError("ClusterPredictor needs at least one worker")
        self.costs = dict(costs)
        self.safety = safety
        self.reference = reference if reference is not None else min(
            self.costs.values(), key=canonical_iteration_time)

    def _cost(self, wid: Optional[int]) -> IterationCostModel:
        if wid is None:
            return self.reference
        return self.costs.get(wid, self.reference)

    def predict_prefill(self, tokens: int, ctx_offset: int = 0,
                        wid: Optional[int] = None) -> float:
        return self._cost(wid).prefill_time(tokens, ctx_offset) * self.safety

    def predict_decode_iter(self, n_decode: int, sum_ctx: float,
                            wid: Optional[int] = None) -> float:
        return self._cost(wid).decode_iter_time(n_decode, sum_ctx) \
            * self.safety

    def predict_migration(self, ctx_tokens: int,
                          wid: Optional[int] = None) -> float:
        return self._cost(wid).migration_time(ctx_tokens) * self.safety

    def predict_interference(self, n_decode: int, sum_ctx: float,
                             prefill_tokens: int, ctx_offset: float = 0.0,
                             wid: Optional[int] = None) -> float:
        # IterationCostModel does not require the penalty decomposition;
        # models without one price 0 (interference-blind), like the base
        penalty = getattr(self._cost(wid), "interference_penalty", None)
        if penalty is None:
            return 0.0
        return penalty(n_decode, sum_ctx, prefill_tokens, ctx_offset) \
            * self.safety

    def predict_restore(self, ctx_tokens: int, residue_tokens: int = 0,
                        wid: Optional[int] = None) -> float:
        # IterationCostModel does not require restore_time; tier-blind
        # models keep the base's 'never prefer offload' answer
        restore = getattr(self._cost(wid), "restore_time", None)
        if restore is None:
            return float("inf")
        return restore(ctx_tokens, residue_tokens) * self.safety

    def _groups(self, wids: Sequence[Optional[int]]):
        """(cost_model, row_indices) groups — workers sharing one CostModel
        instance (the homogeneous common case: a single group) price in one
        batched evaluation each."""
        groups: dict[int, tuple[IterationCostModel, list[int]]] = {}
        for i, w in enumerate(wids):
            c = self._cost(w)
            g = groups.get(id(c))
            if g is None:
                groups[id(c)] = (c, [i])
            else:
                g[1].append(i)
        return groups.values()

    def predict_prefill_batch(self, wids: Sequence[Optional[int]], tokens,
                              ctx_offset=0) -> np.ndarray:
        n = len(wids)
        toks, offs = _col(tokens, n), _col(ctx_offset, n)
        out = np.empty(n, dtype=np.float64)
        for cost, idxs in self._groups(wids):
            if isinstance(cost, CostModel):
                ii = np.asarray(idxs)
                out[ii] = cost.prefill_time_batch(toks[ii], offs[ii]) \
                    * self.safety
            else:
                for i in idxs:
                    out[i] = cost.prefill_time(toks[i], offs[i]) * self.safety
        return out

    def predict_decode_iter_batch(self, wids: Sequence[Optional[int]],
                                  n_decode, sum_ctx) -> np.ndarray:
        n = len(wids)
        nds, scs = _col(n_decode, n), _col(sum_ctx, n)
        out = np.empty(n, dtype=np.float64)
        for cost, idxs in self._groups(wids):
            if isinstance(cost, CostModel):
                ii = np.asarray(idxs)
                out[ii] = cost.decode_iter_time_batch(nds[ii], scs[ii]) \
                    * self.safety
            else:
                for i in idxs:
                    out[i] = cost.decode_iter_time(nds[i], scs[i]) \
                        * self.safety
        return out

    def predict_interference_batch(self, wids: Sequence[Optional[int]],
                                   n_decode, sum_ctx, prefill_tokens,
                                   ctx_offset=0.0) -> np.ndarray:
        n = len(wids)
        nds, scs = _col(n_decode, n), _col(sum_ctx, n)
        pts, offs = _col(prefill_tokens, n), _col(ctx_offset, n)
        out = np.empty(n, dtype=np.float64)
        for cost, idxs in self._groups(wids):
            if isinstance(cost, CostModel):
                ii = np.asarray(idxs)
                out[ii] = cost.interference_penalty_batch(
                    nds[ii], scs[ii], pts[ii], offs[ii]) * self.safety
            else:
                penalty = getattr(cost, "interference_penalty", None)
                for i in idxs:
                    out[i] = 0.0 if penalty is None else \
                        penalty(nds[i], scs[i], pts[i], offs[i]) * self.safety
        return out

    def chunk_candidates(self, wids: Sequence[Optional[int]], lo: int,
                         hi: int, budget, n_decode, sum_ctx, ctx_offset,
                         s_mul=None) -> Optional[np.ndarray]:
        n = len(wids)
        bud, nd = _col(budget, n), _col(n_decode, n)
        sc, off = _col(sum_ctx, n), _col(ctx_offset, n)
        mul = None if s_mul is None else _col(s_mul, n)
        got = []
        for cost, idxs in self._groups(wids):
            # any worker priced by a non-roofline model sinks the whole
            # batch to bisection: mixed closed-form/bisected rows would
            # split one arrival's pricing into several evaluations
            if not isinstance(cost, CostModel):
                return None
            ii = np.asarray(idxs)
            s = self.safety if mul is None else self.safety * mul[ii]
            got.append((ii, cost.chunk_candidates(
                lo, hi, bud[ii], nd[ii], sc[ii], off[ii], s, self.safety)))
        width = max(cand.shape[1] for _, cand in got)
        out = np.full((n, width), int(lo), dtype=np.int64)
        for ii, cand in got:
            out[ii, :cand.shape[1]] = cand
        return out


class ProfiledPredictor(Predictor):
    """Interpolates a profiled (tokens -> seconds) table; ctx contributions
    enter linearly with a profiled per-ctx-token coefficient."""

    def __init__(self, prefill_points: Sequence[tuple[int, float]],
                 decode_points: Sequence[tuple[int, float, float]],
                 ctx_coeff: float, migration_coeff: float,
                 safety: float = 1.1):
        self.prefill_points = sorted(prefill_points)
        self.decode_points = sorted(decode_points)
        self.ctx_coeff = ctx_coeff
        self.migration_coeff = migration_coeff
        self.safety = safety

    @staticmethod
    def _interp(points, x):
        xs = [p[0] for p in points]
        i = bisect.bisect_left(xs, x)
        if i == 0:
            lo, hi = points[0], points[min(1, len(points) - 1)]
        elif i >= len(points):
            lo, hi = points[-2] if len(points) > 1 else points[-1], points[-1]
        else:
            lo, hi = points[i - 1], points[i]
        if hi[0] == lo[0]:
            return lo[1]
        t = (x - lo[0]) / (hi[0] - lo[0])
        return lo[1] + t * (hi[1] - lo[1])

    def predict_prefill(self, tokens: int, ctx_offset: int = 0,
                        wid: Optional[int] = None) -> float:
        base = self._interp(self.prefill_points, tokens)
        return (base + self.ctx_coeff * ctx_offset * tokens) * self.safety

    def predict_decode_iter(self, n_decode: int, sum_ctx: float,
                            wid: Optional[int] = None) -> float:
        base = self._interp([(b, t) for b, t, _ in self.decode_points], n_decode)
        return (base + self.ctx_coeff * sum_ctx) * self.safety

    def predict_migration(self, ctx_tokens: int,
                          wid: Optional[int] = None) -> float:
        return self.migration_coeff * ctx_tokens * self.safety


def profile_worker(step_fn: Callable[[int, float, int], float],
                   token_grid: Sequence[int] = (128, 512, 2048, 8192),
                   batch_grid: Sequence[int] = (1, 8, 32, 128),
                   ctx_probe: int = 8192) -> ProfiledPredictor:
    """Build a ProfiledPredictor by measuring ``step_fn(n_decode, sum_ctx,
    prefill_tokens) -> seconds`` — works against the real executor or the
    simulator alike (offline profiling per §IV-C)."""
    prefill_points = [(t, step_fn(0, 0.0, t)) for t in token_grid]
    decode_points = [(b, step_fn(b, float(b * 512), 0), 512.0)
                     for b in batch_grid]
    t0 = step_fn(1, 0.0, 0)
    t1 = step_fn(1, float(ctx_probe), 0)
    ctx_coeff = max(0.0, (t1 - t0) / ctx_probe)
    return ProfiledPredictor(prefill_points, decode_points, ctx_coeff,
                             migration_coeff=1e-9)
