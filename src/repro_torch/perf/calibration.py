"""Online calibration layer: per-(worker, phase, size-bucket) EWMA.

``OnlinePredictor`` wraps any base ``Predictor`` and closes the §IV-C
loop: the scheduler feeds every observed iteration duration back in, and
multiplicative EWMA correction factors pull a biased/stale offline
profile toward what the executor actually delivers (wall-clock on the
real backend, injected noise in robustness sims) while preserving the
base safety margin.

Correction hierarchy (most to least specific, each level falling back to
the next until it has enough evidence):

    (worker, phase, size-bucket)   per_worker=True only
    (worker, phase)                per_worker=True only
    (phase, size-bucket)           bucketed=True (default)
    phase                          always

The per-worker levels close the ROADMAP straggler item: on a
heterogeneous cluster a single global scale per phase converges to a
traffic-weighted blend of the workers' biases — systematically
under-predicting the slow worker and over-predicting the fast ones. With
``per_worker=True`` each worker's scale converges to its own bias, so a
2x-slow straggler is priced at 2x and admission/dispatch route around it
(``benchmarks/fig_hetero.py`` measures the attainment this recovers).
``per_worker=False`` (default) is bit-identical to the pre-perf-package
global correction.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.perf.predictor import Predictor, _seq


class OnlinePredictor(Predictor):
    """Online feedback wrapper: multiplicative EWMA correction.

    Let ``raw`` be the base predictor's estimate (which already includes
    its conservative ``safety`` margin). After each observed iteration the
    matching scale moves toward ``observed * margin / raw`` — so an
    unbiased base converges to scale 1.0 (the safety margin is *kept*, not
    regressed away), and a k×-biased base converges to scale 1/k, restoring
    calibrated-but-conservative predictions. Mixed decode+prefill
    iterations split the observed time proportionally to the current
    corrected per-phase estimates.

    Heterogeneity has two axes. *Size*: real profiles miss differently at
    batch 1 than at batch 128 (kernel occupancy, attention-vs-MLP
    balance), so each observation feeds a per-(phase, size-bucket) EWMA —
    buckets are powers of two over prefill tokens / decode batch size —
    used once it has ``bucket_floor`` observations (cold buckets borrow
    the global per-phase scale instead of guessing from one sample);
    ``bucketed=False`` restores pure global correction. *Hardware*: with
    ``per_worker=True`` every observation additionally feeds
    per-(worker, phase, bucket) and per-(worker, phase) EWMAs keyed on the
    worker id the scheduler reports, consulted first when predicting for a
    specific ``wid`` — the heterogeneous-cluster mode."""

    def __init__(self, base: Predictor, alpha: float = 0.2,
                 clip: tuple[float, float] = (0.125, 8.0),
                 bucketed: bool = True, bucket_floor: int = 8,
                 per_worker: bool = False, worker_floor: int = 8):
        self.base = base
        self.alpha = alpha
        self.clip = clip
        self.bucketed = bucketed
        self.bucket_floor = bucket_floor
        self.per_worker = per_worker
        self.worker_floor = worker_floor
        # preserve the base's deliberate conservatism as the convergence
        # target; a margin-free base converges to exact calibration
        self.margin = float(getattr(base, "safety", 1.0))
        self.prefill_scale = 1.0
        self.decode_scale = 1.0
        self.prefill_observations = 0
        self.decode_observations = 0
        self.bucket_scales: dict[tuple[str, int], float] = {}
        self.bucket_observations: dict[tuple[str, int], int] = {}
        # per-worker levels (per_worker=True): (wid, phase[, bucket]) keys
        self.worker_scales: dict[tuple[int, str], float] = {}
        self.worker_observations: dict[tuple[int, str], int] = {}
        self.worker_bucket_scales: dict[tuple[int, str, int], float] = {}
        self.worker_bucket_observations: dict[tuple[int, str, int], int] = {}

    # ------------------------------------------------------------- buckets
    @staticmethod
    def _bucket(size: float) -> int:
        """Power-of-two size bucket: 1, 2, 3… for sizes 1, 2-3, 4-7, …"""
        return max(int(size), 1).bit_length()

    def _bucket_scale(self, phase: str, size: float,
                      global_scale: float) -> float:
        if not self.bucketed:
            return global_scale
        key = (phase, self._bucket(size))
        if self.bucket_observations.get(key, 0) < self.bucket_floor:
            return global_scale
        return self.bucket_scales[key]

    def _observe_bucket(self, phase: str, size: float, ratio: float,
                        global_scale: float) -> None:
        if not self.bucketed:
            return
        key = (phase, self._bucket(size))
        # seed a cold bucket from the converged global scale, not 1.0:
        # crossing bucket_floor must refine the prediction, never snap it
        # back toward the uncorrected base
        self.bucket_scales[key] = self._ewma(
            self.bucket_scales.get(key, global_scale), ratio)
        self.bucket_observations[key] = \
            self.bucket_observations.get(key, 0) + 1

    # --------------------------------------------------------- worker level
    def _scale_for(self, phase: str, size: float, global_scale: float,
                   wid: Optional[int]) -> float:
        """Most-specific trusted correction: (wid, phase, bucket) ->
        (wid, phase) -> (phase, bucket) -> phase."""
        if self.per_worker and wid is not None:
            wkey = (wid, phase, self._bucket(size))
            if self.worker_bucket_observations.get(wkey, 0) \
                    >= self.bucket_floor:
                return self.worker_bucket_scales[wkey]
            pkey = (wid, phase)
            if self.worker_observations.get(pkey, 0) >= self.worker_floor:
                return self.worker_scales[pkey]
        return self._bucket_scale(phase, size, global_scale)

    def _observe_worker(self, phase: str, size: float, ratio: float,
                        global_scale: float, wid: Optional[int]) -> None:
        if not self.per_worker or wid is None:
            return
        pkey = (wid, phase)
        # cold per-worker levels seed from the converged coarser scale so
        # crossing the floor refines rather than resets
        self.worker_scales[pkey] = self._ewma(
            self.worker_scales.get(pkey, global_scale), ratio)
        self.worker_observations[pkey] = \
            self.worker_observations.get(pkey, 0) + 1
        wkey = (wid, phase, self._bucket(size))
        self.worker_bucket_scales[wkey] = self._ewma(
            self.worker_bucket_scales.get(
                wkey, self.worker_scales[pkey]), ratio)
        self.worker_bucket_observations[wkey] = \
            self.worker_bucket_observations.get(wkey, 0) + 1

    # ----------------------------------------------------------- predictions
    def predict_prefill(self, tokens: int, ctx_offset: int = 0,
                        wid: Optional[int] = None) -> float:
        return self.base.predict_prefill(tokens, ctx_offset, wid=wid) \
            * self._scale_for("prefill", tokens, self.prefill_scale, wid)

    def predict_decode_iter(self, n_decode: int, sum_ctx: float,
                            wid: Optional[int] = None) -> float:
        return self.base.predict_decode_iter(n_decode, sum_ctx, wid=wid) \
            * self._scale_for("decode", n_decode, self.decode_scale, wid)

    def predict_migration(self, ctx_tokens: int,
                          wid: Optional[int] = None) -> float:
        return self.base.predict_migration(ctx_tokens, wid=wid)

    def predict_restore(self, ctx_tokens: int, residue_tokens: int = 0,
                        wid: Optional[int] = None) -> float:
        # wire-dominated like migration: no EWMA correction layer (yet)
        return self.base.predict_restore(ctx_tokens, residue_tokens,
                                         wid=wid)

    def predict_interference(self, n_decode: int, sum_ctx: float,
                             prefill_tokens: int, ctx_offset: float = 0.0,
                             wid: Optional[int] = None) -> float:
        # the penalty rides on the base model's γ (kept current by the
        # DriftMonitor, the component that owns γ's online re-fit); the
        # per-phase EWMA scales correct the *additive* estimates only
        return self.base.predict_interference(
            n_decode, sum_ctx, prefill_tokens, ctx_offset, wid=wid)

    # ------------------------------------------------- batched entry points
    # base batch estimate × gathered per-element EWMA scales: the scale
    # lookup hierarchy is dict-bound Python either way, so gathering it
    # into a vector is exactly the scalar sequence of lookups.
    def predict_prefill_batch(self, wids: Sequence[Optional[int]], tokens,
                              ctx_offset=0) -> np.ndarray:
        base = self.base.predict_prefill_batch(wids, tokens, ctx_offset)
        toks = _seq(tokens, len(wids))
        scales = np.array(
            [self._scale_for("prefill", t, self.prefill_scale, w)
             for w, t in zip(wids, toks)], dtype=np.float64)
        return base * scales

    def predict_decode_iter_batch(self, wids: Sequence[Optional[int]],
                                  n_decode, sum_ctx) -> np.ndarray:
        base = self.base.predict_decode_iter_batch(wids, n_decode, sum_ctx)
        nds = _seq(n_decode, len(wids))
        scales = np.array(
            [self._scale_for("decode", b, self.decode_scale, w)
             for w, b in zip(wids, nds)], dtype=np.float64)
        return base * scales

    def predict_interference_batch(self, wids: Sequence[Optional[int]],
                                   n_decode, sum_ctx, prefill_tokens,
                                   ctx_offset=0.0) -> np.ndarray:
        return self.base.predict_interference_batch(
            wids, n_decode, sum_ctx, prefill_tokens, ctx_offset)

    def chunk_candidates(self, wids: Sequence[Optional[int]], lo: int,
                         hi: int, budget, n_decode, sum_ctx, ctx_offset,
                         s_mul=None) -> Optional[np.ndarray]:
        """The EWMA scale on predict_prefill is piecewise constant over
        the power-of-two size buckets, so the closed-form chunk inversion
        stays exact: delegate to the base once per bucket segment of
        [lo, hi] with that segment's per-row scale folded in via
        ``s_mul``. Segment edges are structural breakpoints and each call
        includes its own endpoints, so flips at a bucket boundary are
        covered. (Candidate generation is pure arithmetic — the single
        batched cost evaluation still happens in the caller.)"""
        parts = []
        a = int(lo)
        while a <= int(hi):
            b = min(int(hi), (1 << max(a, 1).bit_length()) - 1)
            scales = np.array(
                [self._scale_for("prefill", a, self.prefill_scale, w)
                 for w in wids], dtype=np.float64)
            mul = scales if s_mul is None \
                else scales * np.asarray(s_mul, dtype=np.float64)
            cand = self.base.chunk_candidates(
                wids, a, b, budget, n_decode, sum_ctx, ctx_offset,
                s_mul=mul)
            if cand is None:
                return None
            parts.append(cand)
            a = b + 1
        return np.concatenate(parts, axis=1)

    # ------------------------------------------------------------- feedback
    def _ewma(self, scale: float, ratio: float) -> float:
        lo, hi = self.clip
        ratio = min(max(ratio, lo), hi)
        return (1.0 - self.alpha) * scale + self.alpha * ratio

    def observe_prefill(self, tokens: int, ctx_offset: int,
                        observed: float, wid: Optional[int] = None) -> None:
        if tokens <= 0:
            return
        raw = self.base.predict_prefill(tokens, ctx_offset, wid=wid)
        if raw > 0.0 and observed > 0.0:
            ratio = observed * self.margin / raw
            self._observe_worker("prefill", tokens, ratio,
                                 self.prefill_scale, wid)
            self._observe_bucket("prefill", tokens, ratio,
                                 self.prefill_scale)
            self.prefill_scale = self._ewma(self.prefill_scale, ratio)
            self.prefill_observations += 1

    def observe_decode(self, n_decode: int, sum_ctx: float,
                       observed: float, wid: Optional[int] = None) -> None:
        if n_decode <= 0:
            return
        raw = self.base.predict_decode_iter(n_decode, sum_ctx, wid=wid)
        if raw > 0.0 and observed > 0.0:
            ratio = observed * self.margin / raw
            self._observe_worker("decode", n_decode, ratio,
                                 self.decode_scale, wid)
            self._observe_bucket("decode", n_decode, ratio,
                                 self.decode_scale)
            self.decode_scale = self._ewma(self.decode_scale, ratio)
            self.decode_observations += 1

    def observe_iteration(self, n_decode: int, sum_ctx: float,
                          prefill_tokens: int, ctx_offset: float,
                          observed: float,
                          wid: Optional[int] = None) -> None:
        """ClusterScheduler hook: one finished iteration's composition and
        its observed duration (simulated or wall-clock), tagged with the
        worker that ran it so per-worker scales converge independently."""
        has_p = prefill_tokens > 0
        has_d = n_decode > 0
        if has_p and has_d:
            # the phase scales correct the ADDITIVE estimates only: strip
            # the model's own γ penalty from the observed mixed duration
            # before apportioning, or the penalty would be absorbed into
            # the scales AND re-added by predict_interference — pricing
            # the contention twice in admission (base penalty carries the
            # base's safety margin; divide it back out to get the model's
            # raw expectation, mirroring DriftMonitor's base0 handling)
            penalty = self.base.predict_interference(
                n_decode, sum_ctx, prefill_tokens, ctx_offset,
                wid=wid) / self.margin
            observed = max(observed - penalty, 0.0)
            cp = self.predict_prefill(prefill_tokens, int(ctx_offset),
                                      wid=wid)
            cd = self.predict_decode_iter(n_decode, sum_ctx, wid=wid)
            if cp + cd <= 0.0:
                return
            share = cp / (cp + cd)
            self.observe_prefill(prefill_tokens, int(ctx_offset),
                                 observed * share, wid=wid)
            self.observe_decode(n_decode, sum_ctx, observed * (1.0 - share),
                                wid=wid)
        elif has_p:
            self.observe_prefill(prefill_tokens, int(ctx_offset), observed,
                                 wid=wid)
        elif has_d:
            self.observe_decode(n_decode, sum_ctx, observed, wid=wid)
