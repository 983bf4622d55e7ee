"""Online recalibration: re-fit γ (and nudge MFU/bandwidth) from residuals.

``calibrate_interference``/``calibrate_hardware`` measure once at startup,
but achieved efficiency drifts (thermal throttling, XLA recompiles,
noisy neighbours) and the startup γ grid was measured under synthetic
shapes. The scheduler's observation path already sees every iteration as
(plan, predicted, observed); ``DriftMonitor`` closes the loop the ROADMAP
left open — *re-calibrate periodically online instead of once at
startup*:

* **mixed iterations** — the observed excess over the worker model's
  γ=0 prediction, divided by the model's own unit penalty (γ=1 term),
  is that iteration's *implied* γ. The base is first scaled by the
  blended pure-phase drift ratio, so uniform slowdown (which the pure
  observations evidence) is never misread as contention. Per-(decode-bucket, chunk-bucket)
  EWMAs accumulate it, and every ``every`` observations the warm cells
  are folded into the worker models' ``InterferenceTable`` — whose grid
  is the *union* of the existing edges and the warm cells, so a startup
  calibration's cells outside the traffic's hull keep their measured γ.
* **pure iterations** — the observed/predicted ratio per phase nudges
  the measured efficiency constants: prefill residuals re-fit
  ``mfu_prefill``; decode residuals re-fit ``mfu_decode`` and ``bw_eff``
  together (scaling both moves the decode roofline's max by exactly the
  ratio, whichever side binds). This assumes the usual serving regime —
  prefill compute-bound, decode memory-bound: ``bw_eff`` is shared with
  the prefill memory roofline, so a decode-only slowdown also raises a
  *memory-bound* prefill's prediction, and ``mfu_prefill`` (the
  compute knob) cannot pull it back down. Splitting per-phase bandwidth
  efficiency would need a ``HardwareSpec`` schema change; out of scope
  here.

Evidence is kept **per distinct cost model**: on a heterogeneous cluster
one throttling worker must not blend its residuals into its healthy
peers' constants (workers sharing one model — the homogeneous default —
share one evidence pool, which is the same thing said twice).

Predictions from every consumer — the ``AnalyticalPredictor`` admission
maths, ``ClusterPredictor`` per-worker pricing, toggle chunk gating —
sharpen automatically because they all read the same ``CostModel``
objects this monitor updates. Against a drift-free clock (the default
cost-model backend) every residual is zero, so an armed monitor is a
bit-exact no-op: recalibration swaps in the identical model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.perf.hardware import InterferenceTable, gamma_at
from repro_torch.perf.model import CostModel

_EFF_FLOOR = 1e-6                    # efficiency fractions stay in (0, 1]


def _pow2_bucket(x: float) -> int:
    """Power-of-two bucket lower bound: 1, 2, 4, 8… (sizes below 1 -> 1)."""
    return 1 << max(int(x).bit_length() - 1, 0)


class _Evidence:
    """Residual accumulators for ONE distinct cost model."""

    def __init__(self):
        # implied-γ EWMA per (decode-bucket, chunk-bucket) cell
        self.gamma_ewma: dict[tuple[int, int], float] = {}
        self.gamma_obs: dict[tuple[int, int], int] = {}
        # pure-phase observed/predicted ratio EWMAs (reset on each apply:
        # the fold into the spec consumes the accumulated drift)
        self.ratio = {"prefill": 1.0, "decode": 1.0}
        self.ratio_obs = {"prefill": 0, "decode": 0}

    def reset_ratio(self, phase: str) -> None:
        """Restart ONE phase's ratio EWMA after its drift was folded into
        the spec; a phase still below its evidence floor keeps
        accumulating across windows (low-rate phases would otherwise
        never reach the floor before being wiped)."""
        self.ratio[phase] = 1.0
        self.ratio_obs[phase] = 0


class DriftMonitor:
    """Re-fits per-bucket γ and the measured efficiency constants from
    observed iteration residuals on a configurable cadence.

    ``costs`` maps worker id -> the ``CostModel`` whose ``WorkerSpec`` the
    monitor keeps current (homogeneous clusters share one instance; its
    evidence pool and update are shared the same way). ``every`` is the
    recalibration cadence in observed iterations."""

    def __init__(self, costs: dict[int, CostModel], every: int = 256,
                 alpha: float = 0.2, floor: int = 8,
                 gamma_max: float = 1.0, adjust_efficiency: bool = True,
                 ratio_clip: tuple[float, float] = (0.125, 8.0)):
        if every < 1:
            raise ValueError(f"recalibration cadence must be >= 1 "
                             f"iteration, got {every}")
        self.costs = dict(costs)
        self.every = int(every)
        self.alpha = alpha
        self.floor = floor
        self.gamma_max = gamma_max
        self.adjust_efficiency = adjust_efficiency
        self.ratio_clip = ratio_clip
        # evidence per DISTINCT model object (id-keyed; workers sharing a
        # CostModel share a pool, per-worker models drift independently)
        self._models: dict[int, tuple[CostModel, _Evidence]] = {}
        for cost in self.costs.values():
            self._models.setdefault(id(cost), (cost, _Evidence()))
        self._since_apply = 0
        self.recalibrations = 0

    def register(self, wid: int, cost: CostModel) -> None:
        """Start monitoring a worker added after construction (elastic
        clusters): the scheduler calls this from its add-worker path so
        late workers observe and recalibrate like founding ones."""
        self.costs[wid] = cost
        self._models.setdefault(id(cost), (cost, _Evidence()))

    # --------------------------------------------------------------- feed
    def observe(self, wid: int, plan, predicted: float,
                observed: float) -> None:
        """One finished iteration: its composition, the worker model's
        current prediction for it, and the backend's observed duration."""
        cost = self.costs.get(wid)
        if cost is None or predicted <= 0.0 or observed <= 0.0:
            return
        ev = self._models[id(cost)][1]
        n, s = plan.n_decode, plan.sum_ctx
        p, c = plan.prefill_tokens, plan.prefill_ctx_offset
        if n > 0 and p > 0:
            unit = cost._interference(1.0, n, s, p, c)
            if unit > 0.0:
                base0 = predicted - cost.interference_penalty(n, s, p, c)
                # discount uniform efficiency drift before attributing the
                # excess to contention: the pure-phase ratio EWMAs track
                # how much slower than the model the hardware runs overall
                # (they accumulate even when adjust_efficiency is off —
                # e.g. paired with an OnlinePredictor that owns the
                # correction), and a uniformly-1.5x-slow backend must not
                # read as γ
                r = self._drift_ratio(ev, cost, n, s, p, c)
                # symmetric per-sample clamp: negative residuals (noise
                # below the additive prediction) must pull the EWMA down,
                # or a drift-free noisy clock would learn a phantom γ from
                # E[max(noise, 0)] > 0; the fold into the table clamps the
                # *converged* value into [0, gamma_max] instead
                implied = min(max((observed - r * base0) / (r * unit),
                                  -self.gamma_max), self.gamma_max)
                key = (_pow2_bucket(n), _pow2_bucket(p))
                prev = ev.gamma_ewma.get(key)
                ev.gamma_ewma[key] = implied if prev is None else \
                    (1.0 - self.alpha) * prev + self.alpha * implied
                ev.gamma_obs[key] = ev.gamma_obs.get(key, 0) + 1
        elif p > 0 or n > 0:
            phase = "prefill" if p > 0 else "decode"
            lo, hi = self.ratio_clip
            ratio = min(max(observed / predicted, lo), hi)
            ev.ratio[phase] = (1.0 - self.alpha) * ev.ratio[phase] \
                + self.alpha * ratio
            ev.ratio_obs[phase] += 1
        self._since_apply += 1
        if self._since_apply >= self.every:
            self.apply()

    def _drift_ratio(self, ev: _Evidence, cost: CostModel, n: int, s: float,
                     p: int, c: float) -> float:
        """Blended pure-phase observed/predicted ratio for one mixed
        iteration, weighted by the model's own phase shares. Phases below
        the evidence floor contribute ratio 1.0; after a fold (which
        resets the EWMAs) the drift lives in the model and this correctly
        returns toward 1.0."""
        r_p = ev.ratio["prefill"] if ev.ratio_obs["prefill"] >= self.floor \
            else 1.0
        r_d = ev.ratio["decode"] if ev.ratio_obs["decode"] >= self.floor \
            else 1.0
        if r_p == 1.0 and r_d == 1.0:
            return 1.0
        t_p = cost.prefill_time(p, int(c))
        t_d = cost.decode_iter_time(n, s)
        if t_p + t_d <= 0.0:
            return 1.0
        return (r_p * t_p + r_d * t_d) / (t_p + t_d)

    # -------------------------------------------------------------- re-fit
    def _table(self, current, ev: _Evidence) -> Optional[InterferenceTable]:
        """The re-fitted γ table from cells with >= ``floor`` evidence, or
        None when nothing is warm yet. The grid is the union of the warm
        cells and the current table's edges; cells without fresh evidence
        keep the model's *current* coefficient there, so a recalibration
        refines what it has evidence for and never forgets the startup
        calibration's cells outside the traffic's hull."""
        warm = {k for k, n in ev.gamma_obs.items() if n >= self.floor}
        if not warm:
            return None
        d_edges = {k[0] for k in warm}
        c_edges = {k[1] for k in warm}
        if isinstance(current, InterferenceTable):
            d_edges |= set(current.decode_edges)
            c_edges |= set(current.chunk_edges)
        else:
            # scalar start: anchor the lowest bucket on each axis so a
            # cell below the warm hull keeps the current scalar instead of
            # clamping into a big-batch cell it has no evidence for
            d_edges.add(1)
            c_edges.add(1)
        decode_edges = tuple(sorted(d_edges))
        chunk_edges = tuple(sorted(c_edges))
        gamma = tuple(
            tuple(min(max(ev.gamma_ewma[(db, cb)], 0.0), self.gamma_max)
                  if (db, cb) in warm
                  else gamma_at(current, db, cb)
                  for cb in chunk_edges)
            for db in decode_edges)
        return InterferenceTable(decode_edges=decode_edges,
                                 chunk_edges=chunk_edges, gamma=gamma)

    def apply(self) -> None:
        """Fold each model's accumulated evidence into that model."""
        self._since_apply = 0
        self.recalibrations += 1
        for cost, ev in self._models.values():
            hw = cost.worker.hw
            changes: dict = {}
            new_table = self._table(hw.interference, ev)
            if new_table is not None:
                changes["interference"] = new_table
            if self.adjust_efficiency:
                if ev.ratio_obs["prefill"] >= self.floor:
                    changes["mfu_prefill"] = self._clamp_eff(
                        hw.mfu_prefill / ev.ratio["prefill"])
                    ev.reset_ratio("prefill")
                if ev.ratio_obs["decode"] >= self.floor:
                    r = ev.ratio["decode"]
                    changes["mfu_decode"] = self._clamp_eff(hw.mfu_decode / r)
                    changes["bw_eff"] = self._clamp_eff(hw.bw_eff / r)
                    ev.reset_ratio("decode")
            if changes:
                cost.worker = dataclasses.replace(
                    cost.worker, hw=dataclasses.replace(hw, **changes))

    @staticmethod
    def _clamp_eff(x: float) -> float:
        return min(max(x, _EFF_FLOOR), 1.0)

    # ------------------------------------------------------------- reporting
    def gamma_range(self) -> tuple[float, float]:
        """(min, max) learned γ across every model's warm cells;
        (0, 0) before any cell warms up."""
        warm = [min(max(ev.gamma_ewma[k], 0.0), self.gamma_max)
                for _, ev in self._models.values()
                for k, n in ev.gamma_obs.items() if n >= self.floor]
        if not warm:
            return 0.0, 0.0
        return min(warm), max(warm)

    @property
    def gamma_obs(self) -> dict:
        """Union view of per-cell observation counts (single-model
        monitors expose their one pool directly)."""
        out: dict[tuple[int, int], int] = {}
        for _, ev in self._models.values():
            for k, n in ev.gamma_obs.items():
                out[k] = out.get(k, 0) + n
        return out

    @property
    def gamma_ewma(self) -> dict:
        """Union view of learned per-cell γ (when multiple models learned
        the same cell, the last model's value wins — use per-model
        evidence via ``_models`` for exact multi-model introspection)."""
        out: dict[tuple[int, int], float] = {}
        for _, ev in self._models.values():
            out.update(ev.gamma_ewma)
        return out
