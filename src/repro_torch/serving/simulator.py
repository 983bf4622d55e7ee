"""Discrete-event driver for the unified ClusterScheduler.

The Simulator owns exactly two things: the event heap and the clock. Every
scheduling decision — dispatch, batch composition, decode routing, role
lifecycle, predictor feedback — lives in ``repro_torch.sched.ClusterScheduler``
and is byte-for-byte the code path the real-JAX executor drives (see
``repro_torch.sched.backend.ExecutionBackend``); only the backend's notion of an
iteration duration differs. ``tests/test_sched_core.py`` pins that parity.

Events: request arrival, per-worker iteration completion, migration
completion, transfer ticks, worker failure/recovery, elastic worker
addition, role-rebalance reviews.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Optional, Sequence

from repro_torch.core.metrics import ServeMetrics
from repro_torch.core.policies import Policy
from repro_torch.core.request import Request
from repro_torch.sched.backend import (CallableBackend, ExecutionBackend,
                                 TraceReplayBackend)
from repro_torch.sched.core import ClusterScheduler
from repro_torch.sched.rebalance import RebalanceConfig, RoleRebalancer
from repro_torch.serving.engine import Worker
from repro_torch.tracing import span


# heap entries are plain tuples ``(time, seq, kind, payload)`` — the seq
# counter is unique, so comparisons never reach kind/payload and the heap
# skips dataclass dispatch entirely (this is the hottest allocation in a
# large simulation)
class Simulator:
    def __init__(self, workers: Sequence[Worker], policy: Policy,
                 duration_fn: Optional[Callable] = None,
                 transfer=None,
                 backend: Optional[ExecutionBackend] = None,
                 rebalancer: Optional[RoleRebalancer] = None,
                 drift_monitor=None,
                 record_decisions: bool = False):
        """``backend`` supplies iteration durations (and execution, for the
        real-JAX backend); default = the analytical cost model.
        ``duration_fn(worker, plan) -> seconds`` is the legacy hook and
        wraps into a ``CallableBackend`` over ``backend``.

        ``transfer``: bandwidth-contended KV migration engine. None keeps
        the legacy fixed-delay ``CostModel.migration_time`` path.

        ``drift_monitor``: optional ``repro_torch.perf.recalibrate.DriftMonitor``
        fed every observed iteration for online γ/MFU recalibration."""
        if duration_fn is not None:
            backend = CallableBackend(duration_fn, base=backend)
        self.sched = ClusterScheduler(
            workers, policy, backend=backend, transfer=transfer,
            rebalancer=rebalancer, drift_monitor=drift_monitor,
            record_decisions=record_decisions)
        self.sched.bind(self.push)
        self.now = 0.0
        self._heap: list[tuple] = []
        self._seq = itertools.count()
        self.max_sim_time = float("inf")
        self._replay: Optional[TraceReplayBackend] = None

    # ------------------------------------------------- scheduler passthrough
    @property
    def workers(self) -> dict[int, Worker]:
        return self.sched.workers

    @property
    def policy(self) -> Policy:
        return self.sched.policy

    @property
    def transfer(self):
        return self.sched.transfer

    @property
    def requests(self) -> list[Request]:
        return self.sched.requests

    @property
    def global_queue(self) -> dict[int, Request]:
        return self.sched.global_queue

    @property
    def decisions(self):
        return self.sched.decisions

    @property
    def duration_fn(self) -> Callable:
        backend = self.sched.backend
        return lambda worker, plan: backend.run_iteration(worker, plan)

    @duration_fn.setter
    def duration_fn(self, fn: Callable) -> None:
        # layer the raw clock over the current backend so lifecycle hooks
        # (slot teardown, KV materialisation) keep firing
        self.sched.backend = CallableBackend(fn, base=self.sched.backend)

    # ----------------------------------------------------------------- api
    def push(self, kind: str, time: float, payload=None) -> None:
        heapq.heappush(self._heap, (time, next(self._seq), kind, payload))

    def add_trace(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self.push("arrival", r.arrival_time, r)

    def add_replay(self, replay) -> None:
        """Stream arrivals lazily from a ``TraceReplayBackend`` (or any
        ``(arrival_time, Request)`` iterator, which is wrapped in one over
        the current backend). Exactly one pending arrival sits in the heap
        at a time; each processed arrival pulls the next — a recorded
        production trace replays in constant memory."""
        if not isinstance(replay, TraceReplayBackend) \
                and not hasattr(replay, "next_arrival"):
            replay = TraceReplayBackend(replay, inner=self.sched.backend)
        elif getattr(replay, "inner_defaulted", False):
            # a bare TraceReplayBackend(feed) adopts the simulator's
            # configured clock instead of discarding it for the default
            replay.inner = self.sched.backend
            replay.inner_defaulted = False
        self._replay = replay
        self.sched.backend = replay
        nxt = replay.next_arrival()
        if nxt is not None:
            self.push("replay_next", nxt[0], nxt[1])

    def inject_failure(self, time: float, wid: int,
                       recover_after: Optional[float] = None) -> None:
        self.push("fail", time, (wid, recover_after))

    def add_worker_at(self, time: float, worker: Worker) -> None:
        self.push("add_worker", time, worker)

    # ---------------------------------------------------------------- loop
    def run(self, until: Optional[float] = None) -> ServeMetrics:
        """Drain the heap. Events sharing a timestamp are popped as one
        batch and handed to ``ClusterScheduler.handle_batch`` (same-kind
        runs share one handler dispatch). The total processing order is
        identical to one-at-a-time pops: the batch is drained in seq
        order, and any event a handler pushes at the *same* timestamp gets
        a strictly higher seq than everything drained — the outer loop
        re-drains it as the next batch, exactly where the one-at-a-time
        loop would have popped it."""
        if until is not None:
            self.max_sim_time = until
        heap = self._heap
        pop = heapq.heappop
        handle_batch = self.sched.handle_batch
        max_t = self.max_sim_time
        batch: list[tuple] = []
        with span("repro_torch.sched.run", until=max_t):
            while heap:
                t = heap[0][0]
                if t > max_t:
                    break
                self.now = t
                batch.clear()
                while heap and heap[0][0] == t:
                    batch.append(pop(heap))
                i, m = 0, len(batch)
                while i < m:
                    if batch[i][2] == "replay_next":
                        # driver-level streaming arrival: hand it to the
                        # scheduler, then pull the next from the replay
                        # iterator (a same-t successor re-drains next round)
                        self.sched.handle("arrival", t, batch[i][3])
                        nxt = self._replay.next_arrival()
                        if nxt is not None:
                            self.push("replay_next", nxt[0], nxt[1])
                        i += 1
                        continue
                    j = i + 1
                    while j < m and batch[j][2] != "replay_next":
                        j += 1
                    handle_batch(t, batch[i:j])
                    i = j
        return self.metrics()

    def metrics(self) -> ServeMetrics:
        return self.sched.metrics()


def build_cluster(cfg, policy_name: str, n_workers: int = 4,
                  worker_spec=None, predictor=None,
                  use_transfer_engine: bool = True,
                  ici_bw: Optional[float] = None,
                  ici_links: Optional[int] = None,
                  page_size: int = 16,
                  online_predictor: bool = False,
                  recalibrate_every: Optional[int] = None,
                  per_worker_calibration: str | bool = "auto",
                  worker_specs: Optional[Sequence] = None,
                  role_rebalance: str | bool = "auto",
                  rebalance_config: Optional[RebalanceConfig] = None,
                  record_decisions: bool = False,
                  backend: Optional[ExecutionBackend] = None,
                  host_kv_gb: float = 0.0,
                  prefix_cache: bool = False,
                  prefix_cache_frac: float = 0.2,
                  vectorized: bool = True,
                  **policy_kw):
    """Convenience: workers + cost models + policy + scheduler, wired.

    ``worker_specs``: one ``WorkerSpec`` per worker for heterogeneous
    clusters (mixed chip generations, degraded stragglers) — each worker
    gets its own ``CostModel``, the default predictor becomes a per-worker
    ``ClusterPredictor``, and every ``WorkerView.speed`` carries the
    worker's relative throughput so load comparisons price work on the
    target's hardware. Omitted (the homogeneous default) every speed is
    exactly 1.0 and all decisions are bit-identical to the global-spec
    scheduler.

    ``ici_bw``/``ici_links`` override the per-worker migration link model
    (bytes/s per link, link count); ``use_transfer_engine=False`` reverts
    to the seed's fixed uncontended ``migration_time`` delay.

    ``online_predictor=True`` wraps the predictor in an ``OnlinePredictor``
    so observed iteration durations EWMA-correct its estimates;
    ``per_worker_calibration``: "auto" (per-worker EWMA exactly when the
    cluster is heterogeneous), True/False to force.
    ``recalibrate_every=N`` arms a ``DriftMonitor`` that re-fits the
    per-bucket interference γ and nudges the measured MFU/bandwidth
    constants on the worker cost models every N observed iterations
    (None = legacy calibrate-once; a drift-free clock makes it a
    bit-exact no-op). Combined with an observing predictor
    (``online_predictor=True``) the monitor re-fits γ only — efficiency
    drift stays the predictor's job, so the two loops never correct the
    same error twice.
    ``role_rebalance``: "auto" (windowed-attainment rebalancing for
    policies that own a toggle, i.e. tropical), True (same, but a
    ValueError on policies without role lifecycle), or False (keep the
    legacy dispatch-count ``review_roles`` side effect).

    ``host_kv_gb``: per-worker host-DRAM KV tier (GB). 0 (default) keeps
    the seed's evict + full re-prefill watermark behaviour bit-exact;
    > 0 lets watermark victims offload over the host DMA link when the
    predictor prices restore below re-prefill.
    ``prefix_cache=True`` arms a per-worker cross-request prefix cache
    (LRU over at most ``prefix_cache_frac`` of HBM pages): requests
    sharing a workload-tagged system prompt skip the cached span of
    prefill.
    ``vectorized`` (default True) switches the scheduler hot path to the
    batched implementations: dispatch prices a candidate against every
    worker in one numpy evaluation (``Predictor.predict_*_batch``), the
    cost model memoizes per-signature iteration times, and workers run
    their fast bookkeeping paths. Decisions are bit-identical either way
    (tests/test_vectorized.py pins it); ``vectorized=False`` keeps the
    per-worker scalar loops — the reference the scale benchmark's
    sim-throughput speedup is measured against."""
    from repro_torch.core.policies import make_policy
    from repro_torch.perf import (AnalyticalPredictor, ClusterPredictor, CostModel,
                            OnlinePredictor, WorkerSpec, relative_speeds)
    from repro_torch.serving.kvcache import PrefixIndex
    from repro_torch.serving.transfer import TransferEngine

    worker_spec = worker_spec or WorkerSpec()
    specs = list(worker_specs) if worker_specs is not None \
        else [worker_spec] * n_workers
    if len(specs) != n_workers:
        raise ValueError(f"worker_specs has {len(specs)} entries for "
                         f"{n_workers} workers")
    if ici_bw is not None or ici_links is not None:
        specs = [dataclasses.replace(s, hw=dataclasses.replace(
            s.hw,
            ici_bw=ici_bw if ici_bw is not None else s.hw.ici_bw,
            ici_links=(ici_links if ici_links is not None
                       else s.hw.ici_links))) for s in specs]
    heterogeneous = len(set(specs)) > 1
    cost = CostModel(cfg, specs[0], page_size=page_size)
    if heterogeneous:
        costs = {i: CostModel(cfg, s, page_size=page_size)
                 for i, s in enumerate(specs)}
    else:
        costs = {i: cost for i in range(n_workers)}
    workers = [
        Worker(i, costs[i],
               host_pages=costs[i].host_capacity_pages(host_kv_gb * 1e9),
               prefix_cache=PrefixIndex(max_pages=int(
                   prefix_cache_frac * costs[i].kv_capacity_pages()))
               if prefix_cache else None)
        for i in range(n_workers)]
    for wid, speed in relative_speeds(costs).items():
        workers[wid].view.speed = speed
    if predictor is None:
        predictor = ClusterPredictor(costs) if heterogeneous \
            else AnalyticalPredictor(cost)
    if online_predictor and not hasattr(predictor, "observe_iteration"):
        per_worker = heterogeneous if per_worker_calibration == "auto" \
            else bool(per_worker_calibration)
        predictor = OnlinePredictor(predictor, per_worker=per_worker)
    if host_kv_gb > 0:
        # offload only when the predictor prices restore (wire + residue)
        # below a full re-prefill of the same context — the ISSUE's tier
        # decision rule, evaluated per victim at preemption time
        def _gate(req, _p=predictor, _w=None):
            return _p.predict_restore(req.context_len, wid=_w) \
                < _p.predict_prefill(req.context_len, wid=_w)
        for w in workers:
            w.offload_gate = \
                lambda req, _p=predictor, _w=w.wid: _gate(req, _p, _w)
    policy = make_policy(policy_name, [w.view for w in workers], predictor,
                         **policy_kw)
    if vectorized:
        policy.vectorized = True
        if getattr(policy, "toggle", None) is not None:
            policy.toggle.vectorized = True
        for w in workers:
            w.fast = True
        for c in costs.values():
            c.cached = True      # idempotent on the shared homogeneous model
    transfer = TransferEngine() if use_transfer_engine else None
    policy.attach_transfer(transfer, cost.kv_transfer_bytes,
                           cost.state_tokens)
    for w in workers:
        w.queue_discipline = policy.queue_discipline

    rebalancer = None
    has_toggle = getattr(policy, "toggle", None) is not None
    if role_rebalance is True and not has_toggle:
        raise ValueError(
            f"role_rebalance=True requires a policy with role lifecycle "
            f"(a MultiplexingToggle); {policy.name!r} has none")
    if has_toggle and (role_rebalance is True or role_rebalance == "auto"):
        rebalancer = RoleRebalancer(rebalance_config or RebalanceConfig(
            hbm_watermark=policy.toggle.cfg.hbm_watermark))
        # role lifecycle is now event-driven at the scheduler: turn off the
        # toggle's dispatch-count review side effect
        policy.toggle.cfg = dataclasses.replace(
            policy.toggle.cfg, role_transitions=False)

    drift_monitor = None
    if recalibrate_every is not None:
        from repro_torch.perf.recalibrate import DriftMonitor
        # an observing predictor (OnlinePredictor) already EWMA-corrects
        # efficiency drift at the prediction layer; folding the same drift
        # into the model too would double-correct until the predictor's
        # scales decay back — so the monitor then re-fits γ only (the one
        # axis the predictor cannot learn)
        drift_monitor = DriftMonitor(
            costs, every=recalibrate_every,
            adjust_efficiency=not hasattr(predictor, "observe_iteration"))

    sim = Simulator(workers, policy, transfer=transfer, backend=backend,
                    rebalancer=rebalancer, drift_monitor=drift_monitor,
                    record_decisions=record_decisions)
    return sim, cost
