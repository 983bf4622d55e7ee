"""Event-driven elastic role rebalancing.

The toggle's §IV-C role review originally ran as a side effect of
``dispatch_prefill`` (every N-th dispatch), which couples role lifecycle to
arrival timing: a quiet cluster never reviews, a bursty one reviews at the
worst moments, and the signal (a dispatch-failure counter) says nothing
about what users actually experienced. The ``RoleRebalancer`` instead runs
on scheduler-clock events and decides from *windowed SLO attainment*: the
scheduler records every first-token (TTFT) and every finish (TPOT) outcome,
and at each review the rebalancer promotes/demotes PREFILL / MULTIPLEX
workers toward whichever phase is missing its SLO — falling back to the
paper's HBM-watermark rule, which stays load-bearing under memory pressure.

Multi-tenant: outcomes are windowed **per SLO class** and reviews act on
the *worst* class's attainment, so a healthy aggregate can no longer mask
a starving tight-SLO tenant behind an over-served batch tenant (the
failure mode "Taming Request Imbalance" (arXiv:2605.02329) schedules
against). Single-class traffic reduces to the old aggregate window.

At 100+-worker scale, one role move per review is too slow to chase a
breach. ``confirm_windows``/``max_move_frac`` add proportional moves with
hysteresis: after ``confirm_windows`` *consecutive* breach reviews (a lone
bad window never triggers a reconfiguration), move
``ceil(deficit_fraction x convertible workers)`` at once, capped at
``ceil(max_move_frac x alive workers)`` per review. Defaults reproduce the
legacy controller exactly (act on the first breach, one worker per
review).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

from repro_torch.core.request import Request
from repro_torch.core.toggle import Role, WorkerView


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    interval: float = 5.0         # seconds between reviews
    window: int = 64              # outcomes per class per sliding window
    min_samples: int = 12         # don't act on thinner per-class evidence
    ttft_target: float = 0.9      # windowed attainment floors
    tpot_target: float = 0.9
    cooldown: float = 10.0        # seconds between role changes
    demote_hbm_max: float = 0.5   # only turn an M into a P below this util
    hbm_watermark: float = 0.90   # paper rule: all M above -> P becomes M
    confirm_windows: int = 1      # consecutive breach reviews before acting
                                  # (hysteresis; 1 = legacy immediate)
    max_move_frac: float = 0.0    # >0: proportional moves, ceil(deficit x
                                  # convertible) capped at ceil(frac x
                                  # alive) per review; 0 = legacy single
                                  # move
    window_ttl: Optional[float] = None
                                  # seconds a class's window stays live
                                  # after its last outcome: a tenant that
                                  # stops sending traffic expires instead
                                  # of pinning worst-class reviews to a
                                  # stale window. None = never expire (the
                                  # legacy behaviour; continuously-active
                                  # classes are unaffected either way)


class RoleRebalancer:
    """Windowed-attainment role controller. The scheduler feeds it outcome
    events; ``step`` applies at most one review's worth of role changes."""

    def __init__(self, config: RebalanceConfig = RebalanceConfig()):
        self.cfg = config
        # per-SLO-class sliding windows; legacy aggregate callers land in
        # the eagerly-created "default" class deques (kept as attributes)
        self.ttft_windows: dict[str, deque] = {}
        self.tpot_windows: dict[str, deque] = {}
        self.ttft_window = self._window(self.ttft_windows, "default")
        self.tpot_window = self._window(self.tpot_windows, "default")
        self._last_change = float("-inf")
        self._ttft_streak = 0         # consecutive breach reviews
        self._tpot_streak = 0
        self._last_outcome: dict[str, float] = {}   # class -> latest event
        self.transitions: list[tuple[float, int, Role]] = []   # audit trail

    def _window(self, windows: dict[str, deque], name: str) -> deque:
        if name not in windows:
            windows[name] = deque(maxlen=self.cfg.window)
        return windows[name]

    # ------------------------------------------------------------- signals
    def record_first_token(self, req: Request) -> None:
        self._window(self.ttft_windows, req.slo.name).append(req.ttft_ok())
        if req.first_token_time is not None:
            self._touch(req.slo.name, req.first_token_time)

    def record_finish(self, req: Request) -> None:
        self._window(self.tpot_windows, req.slo.name).append(req.tpot_ok())
        if req.finish_time is not None:
            self._touch(req.slo.name, req.finish_time)

    def _touch(self, name: str, t: float) -> None:
        self._last_outcome[name] = max(self._last_outcome.get(name, t), t)

    def _expire_stale_windows(self, now: float) -> None:
        """Time-based decay: a class silent for longer than ``window_ttl``
        stops contributing evidence — its window describes traffic that no
        longer exists, and worst-class reviews must not chase it. Directly
        populated windows with no recorded outcome timestamp (legacy
        aggregate callers) never expire."""
        ttl = self.cfg.window_ttl
        if ttl is None:
            return
        for name, last in list(self._last_outcome.items()):
            if now - last > ttl:
                for windows in (self.ttft_windows, self.tpot_windows):
                    if name in windows:
                        windows[name].clear()
                del self._last_outcome[name]

    def _worst_attainment(self, windows: dict[str, deque]) -> Optional[float]:
        """Attainment of the worst class with enough evidence (None when no
        class clears ``min_samples``). With one populated class this *is*
        the aggregate window — the pre-multi-tenant behaviour."""
        atts = [sum(w) / len(w) for w in windows.values()
                if len(w) >= self.cfg.min_samples]
        return min(atts) if atts else None

    # -------------------------------------------------------------- review
    def _n_moves(self, deficit: float, convertible: int, alive: int) -> int:
        """Workers to move this review: proportional to how far the worst
        class is below target, bounded by the per-review cap."""
        if self.cfg.max_move_frac <= 0.0:
            return 1
        want = math.ceil(deficit * convertible)
        cap = math.ceil(self.cfg.max_move_frac * alive)
        return max(1, min(want, cap, convertible))

    def step(self, workers: dict[int, WorkerView], now: float) -> Optional[str]:
        """Review roles; mutate ``WorkerView.role`` on up to one review's
        move budget. Returns a human-readable action description, or
        None."""
        cfg = self.cfg
        self._expire_stale_windows(now)
        alive = [w for w in workers.values() if w.alive]
        m = [w for w in alive if w.role == Role.MULTIPLEX]
        p = [w for w in alive if w.role == Role.PREFILL]

        # paper §IV-C memory-pressure rule first: every multiplexing worker
        # above the HBM watermark starves decode admission cluster-wide.
        # Queued work is priced on the candidate's own hardware (tokens /
        # relative speed): the cheapest P to flip is the one whose backlog
        # clears soonest, not the one with the fewest raw tokens.
        if m and p and all(w.hbm_util > cfg.hbm_watermark for w in m):
            conv = min(p, key=lambda w: w.queued_prefill_tokens / w.speed)
            return self._apply([conv], Role.MULTIPLEX, now, "hbm-pressure")

        ttft_att = self._worst_attainment(self.ttft_windows)
        tpot_att = self._worst_attainment(self.tpot_windows)
        ttft_bad = ttft_att is not None and ttft_att < cfg.ttft_target
        tpot_bad = tpot_att is not None and tpot_att < cfg.tpot_target
        # hysteresis streaks advance on every review, including those that
        # land inside the cooldown — the cooldown delays acting, it must
        # not erase the evidence that a breach persisted through it
        self._ttft_streak = self._ttft_streak + 1 if ttft_bad else 0
        self._tpot_streak = self._tpot_streak + 1 if tpot_bad else 0

        if now - self._last_change < cfg.cooldown:
            return None

        if ttft_bad and not tpot_bad \
                and self._ttft_streak >= cfg.confirm_windows and len(m) > 1:
            # prefill capacity starved while decode is healthy: flip the
            # least decode-committed multiplexers (cheap direction —
            # running decodes drain in place, no migration)
            cands = [w for w in m if w.hbm_util < cfg.demote_hbm_max]
            if cands:
                deficit = (cfg.ttft_target - ttft_att) / cfg.ttft_target
                n = min(self._n_moves(deficit, len(cands), len(alive)),
                        len(m) - 1)         # never demote the last M
                cands.sort(key=lambda w: (w.decode_batch,
                                          w.decode_sum_ctx / w.speed))
                return self._apply(cands[:n], Role.PREFILL, now,
                                   "ttft-window")
        if tpot_bad and not ttft_bad \
                and self._tpot_streak >= cfg.confirm_windows and p:
            # decode capacity starved: the least-queued prefill workers
            # start multiplexing (admission-only change)
            deficit = (cfg.tpot_target - tpot_att) / cfg.tpot_target
            n = self._n_moves(deficit, len(p), len(alive))
            p.sort(key=lambda w: w.queued_prefill_tokens / w.speed)
            return self._apply(p[:n], Role.MULTIPLEX, now, "tpot-window")
        return None

    def _apply(self, ws: list[WorkerView], role: Role, now: float,
               reason: str) -> str:
        for w in ws:
            w.role = role
            self.transitions.append((now, w.wid, role))
        self._last_change = now
        self._ttft_streak = 0
        self._tpot_streak = 0
        wids = ", ".join(str(w.wid) for w in ws)
        return f"{reason}: worker {wids} -> {role.value}"
