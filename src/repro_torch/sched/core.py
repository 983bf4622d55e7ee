"""ClusterScheduler — the one scheduling code path behind every executor.

Owns dispatch, the global overflow queue, per-worker iteration planning,
decode routing/KV migration, failure/recovery/elastic-add lifecycle, the
§IV-C predictor feedback loop and event-driven role rebalancing. It is
clock-free: a *driver* (the discrete-event ``Simulator``, or any real-time
loop) owns time, feeds events in via ``handle(kind, now, payload)`` and
lends the scheduler a ``defer(kind, time, payload)`` callback for the
events the scheduler itself originates (iteration completions, migration
arrivals, transfer ticks, rebalance reviews). Compute lives behind the
``ExecutionBackend`` protocol.

Event kinds (payloads):
  arrival         Request
  iter_done       (wid, IterationPlan, duration)
  migration_done  (dst_wid, Request, started_at, src_wid)
  transfer_tick   transfer-engine version stamp
  offload_done    (wid, Request)        KV landed in the host-DRAM tier
  restore_done    (wid, Request)        KV pulled back into HBM
  fail            (wid, recover_after | None)
  recover         wid
  add_worker      Worker
  rebalance       None
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.core.metrics import ServeMetrics, compute_metrics
from repro_torch.core.policies import Policy
from repro_torch.core.request import Phase, Request
from repro_torch.sched.backend import CostModelBackend, ExecutionBackend, \
    SlotExhausted
from repro_torch.sched.rebalance import RoleRebalancer
from repro_torch.serving.engine import IterationPlan, Worker, _slack_key
from repro_torch.serving.transfer import LinkSpec, host_node


class ClusterScheduler:
    def __init__(self, workers: Sequence[Worker], policy: Policy,
                 backend: Optional[ExecutionBackend] = None,
                 transfer=None,
                 rebalancer: Optional[RoleRebalancer] = None,
                 drift_monitor=None,
                 record_decisions: bool = False):
        self.workers: dict[int, Worker] = {w.wid: w for w in workers}
        self.policy = policy
        self.backend = backend or CostModelBackend()
        # optional online recalibration (repro_torch.perf.recalibrate): observed
        # iteration residuals re-fit per-bucket γ + efficiency constants
        self.drift_monitor = drift_monitor
        self.transfer = transfer
        if transfer is not None:
            for w in workers:
                transfer.add_worker(
                    w.wid, LinkSpec.from_hardware(w.cost.worker.hw))
                if w.pages.host_total_pages > 0:
                    transfer.add_host(
                        w.wid, LinkSpec.from_host_hardware(w.cost.worker.hw))
        self.rebalancer = rebalancer
        # overflow queue as an insertion-ordered dict {rid: req}: O(1)
        # membership/removal where the old list paid O(n) scans per event,
        # while iteration keeps exact arrival order (drain parity)
        self.global_queue: dict[int, Request] = {}
        # live class-name counts for the queued set, maintained
        # incrementally so the multi-tenant drain check below is O(1)
        # instead of a full rescan per drain
        self._gq_classes: dict[str, int] = {}
        self.requests: list[Request] = []
        self._handlers: dict[str, Callable] = {}
        self._busy: dict[int, bool] = {w.wid: False for w in workers}
        # decision log: dispatch targets, batch compositions, decode routes.
        # The backend-parity test replays one trace through two backends and
        # asserts these are identical — the guarantee that simulator and
        # real executor share one scheduling brain.
        self.decisions: Optional[list[tuple]] = [] if record_decisions else None
        self._defer: Optional[Callable[[str, float, object], None]] = None
        self._rebalance_armed = False

    # ------------------------------------------------------------- driver api
    def bind(self, defer: Callable[[str, float, object], None]) -> None:
        """Give the scheduler its driver's event sink."""
        self._defer = defer

    def handle(self, kind: str, now: float, payload=None) -> None:
        h = self._handlers.get(kind)
        if h is None:
            h = self._handlers[kind] = getattr(self, f"_on_{kind}")
        h(now, payload)

    def handle_batch(self, now: float, events) -> None:
        """Process a same-timestamp run of ``(time, seq, kind, payload)``
        heap tuples in order. Semantically identical to calling ``handle``
        per event — coalescing exists so per-timestamp overhead (handler
        lookup per same-kind run, the driver's pop/dispatch round-trips)
        is paid once per batch; view-column syncs stay lazy/dirty-row so
        they already collapse across the batch."""
        handlers = self._handlers
        i, m = 0, len(events)
        while i < m:
            kind = events[i][2]
            h = handlers.get(kind)
            if h is None:
                h = handlers[kind] = getattr(self, f"_on_{kind}")
            h(now, events[i][3])
            j = i + 1
            while j < m and events[j][2] == kind:
                h(now, events[j][3])
                j += 1
            i = j

    def metrics(self) -> ServeMetrics:
        qt, bt = {}, {}
        counters = {"prefix_lookups": 0, "prefix_hits": 0,
                    "kv_offloads": 0, "kv_restores": 0,
                    "pages_offloaded": 0, "pages_restored": 0,
                    "pages_reprefilled": 0}
        for w in self.workers.values():
            qt.update(w.queue_times)
            bt.update(w.blocked_time)
            counters["kv_offloads"] += w.offload_count
            counters["kv_restores"] += w.restore_count
            counters["pages_offloaded"] += w.pages_offloaded
            counters["pages_restored"] += w.pages_restored
            counters["pages_reprefilled"] += w.pages_reprefilled
            if w.prefix_cache is not None:
                counters["prefix_lookups"] += w.prefix_cache.lookups
                counters["prefix_hits"] += w.prefix_cache.hits
        return compute_metrics(self.requests, qt, bt, counters=counters)

    # --------------------------------------------------------------- events
    def _on_arrival(self, now: float, req: Request) -> None:
        self.requests.append(req)
        self._try_dispatch(req, now)
        self._arm_rebalance(now)

    def _try_dispatch(self, req: Request, now: float) -> None:
        wid = self.policy.dispatch_prefill(req, now)
        ok = wid is not None and wid in self.workers \
            and self.workers[wid].view.alive
        if self.decisions is not None:
            self.decisions.append(("dispatch", req.rid, wid if ok else None))
        if not ok:
            if req.rid not in self.global_queue:
                self.global_queue[req.rid] = req
                name = req.slo.name
                self._gq_classes[name] = self._gq_classes.get(name, 0) + 1
            return
        if self.global_queue.pop(req.rid, None) is not None:
            name = req.slo.name
            left = self._gq_classes[name] - 1
            if left:
                self._gq_classes[name] = left
            else:
                del self._gq_classes[name]
        self.workers[wid].admit_prefill(req, now)
        self._kick(wid, now)

    def _drain_global_queue(self, now: float) -> None:
        queue = list(self.global_queue.values())
        if len(self._gq_classes) > 1:
            # multi-tenant overflow: offer dispatch slots tightest-relative-
            # TTFT-slack first across classes (absolute seconds don't
            # compare across SLO tiers), hopeless requests last; a single-
            # class queue keeps its arrival order, preserving pre-SLO-class
            # decision parity
            queue.sort(key=_slack_key(now))
        for req in queue:
            self._try_dispatch(req, now)

    def _kick(self, wid: int, now: float) -> None:
        """Start an iteration on a now-idle worker if it has work."""
        w = self.workers[wid]
        if self._busy[wid] or not w.view.alive:
            return
        head = w.peek_prefill(now)
        rule = self.policy.batch_rule(w.view, now, head)
        plan = w.compose_iteration(rule, now)
        if plan.empty:
            return
        if self.decisions is not None:
            self.decisions.append((
                "iter", wid,
                tuple(r.rid for r in plan.decode_reqs),
                tuple((r.rid, t) for r, t in plan.prefill_parts)))
        try:
            dur = self.backend.run_iteration(w, plan)
        except SlotExhausted as exc:
            # the backend refused the plan's NEW prefill (per-worker slot
            # capacity, a real-hardware constraint the view's HBM watermark
            # does not model) before running any compute: requeue that
            # request globally and re-kick the worker with the rest
            self._refuse_prefill(w, plan, exc.rid, now)
            return
        self._busy[wid] = True
        self._defer("iter_done", now + dur, (wid, plan, dur))

    def _refuse_prefill(self, w: Worker, plan: IterationPlan, rid: int,
                        now: float) -> None:
        """Back out one refused first-chunk prefill: undo its admission on
        the worker, return it to the global overflow queue (NOT
        ``_try_dispatch`` — the policy would place it straight back on the
        same slot-full worker), and let the worker run its remaining
        work."""
        req = next(r for r, _ in plan.prefill_parts if r.rid == rid)
        if self.decisions is not None:
            self.decisions.append(("refuse", w.wid, rid))
        w.withdraw_prefill(req)           # queue + pages + prefix ref + kv
        req.reset_for_reprefill(now)
        if req.rid not in self.global_queue:
            self.global_queue[req.rid] = req
            name = req.slo.name
            self._gq_classes[name] = self._gq_classes.get(name, 0) + 1
        self._kick(w.wid, now)

    def _on_iter_done(self, now: float, payload) -> None:
        wid, plan, dur = payload
        w = self.workers[wid]
        self._busy[wid] = False
        if not w.view.alive:
            return
        self._observe(wid, plan, dur)
        finished_prefills = w.complete_iteration(plan, now, dur)
        self._record_outcomes(plan, finished_prefills)
        for req in finished_prefills:
            self._route_decode(w, req, now)
        # watermark evictions re-enter global dispatch (re-prefill cost)
        for req in w.drain_preempted():
            self.backend.on_finish(req)      # execution state restarts too
            self._try_dispatch(req, now)
        # watermark offloads spill to the host tier over the DMA link;
        # freed HBM may in turn let a parked request come back
        for req in w.drain_offload_started():
            self._start_offload(w, req, now)
        self._maybe_restore(w, now)
        self._drain_global_queue(now)
        self._kick(wid, now)
        self._arm_rebalance(now)

    def _route_decode(self, src: Worker, req: Request, now: float) -> None:
        target = self.policy.dispatch_decode(req, now)
        if self.decisions is not None:
            self.decisions.append(("route", req.rid, src.wid, target))
        if target is None or target == src.wid:
            src.admit_decode(req, now)
            self._kick(src.wid, now)
            return
        # KV migration: src frees; target admits when the bytes have crossed
        # the (possibly contended) ICI links
        req.migrations += 1
        req.phase = Phase.MIGRATING
        src.release(req)
        if self.transfer is None:
            delay = src.cost.migration_time(req.context_len)
            self._defer("migration_done", now + delay,
                        (target, req, now, src.wid))
            return
        nbytes = src.cost.kv_transfer_bytes(req.context_len)
        self.transfer.start(src.wid, target, nbytes, now,
                            payload=(target, req, now, src.wid))
        self._schedule_transfer_tick(now)

    # ------------------------------------------------- tiered KV (host DRAM)
    def _start_offload(self, w: Worker, req: Request, now: float) -> None:
        """Push a watermark victim's KV pages over the host DMA link. The
        pages were already moved to the host tier in the accountant (HBM is
        freed immediately — that is the point of the spill); the flow models
        the wire time before the copy is *restorable*."""
        if self.decisions is not None:
            self.decisions.append(("offload", req.rid, w.wid))
        if self.transfer is None:
            delay = w.cost.restore_time(req.context_len)
            self._defer("offload_done", now + delay, (w.wid, req))
            return
        nbytes = w.cost.kv_transfer_bytes(req.context_len)
        self.transfer.start(w.wid, host_node(w.wid), nbytes, now,
                            payload=("offload", w.wid, req))
        self._schedule_transfer_tick(now)

    def _on_offload_done(self, now: float, payload) -> None:
        wid, req = payload
        w = self.workers.get(wid)
        if w is None or not w.view.alive:
            return          # fail() already restarted the request
        if w.offloading.get(req.rid) is not req:
            return          # stale (worker failed and recovered meanwhile)
        w.offload_landed(req)
        self._maybe_restore(w, now)

    def _maybe_restore(self, w: Worker, now: float) -> None:
        """Pull parked requests back into HBM while they fit below the
        watermark (FIFO over the parked set — oldest spill returns first)."""
        if not w.view.alive:
            return
        while True:
            req = w.next_restorable()
            if req is None or not w.begin_restore(req, now):
                return
            if self.decisions is not None:
                self.decisions.append(("restore", req.rid, w.wid))
            if self.transfer is None:
                delay = w.cost.restore_time(req.context_len)
                self._defer("restore_done", now + delay, (w.wid, req))
                continue
            nbytes = w.cost.kv_transfer_bytes(req.context_len)
            self.transfer.start(host_node(w.wid), w.wid, nbytes, now,
                                payload=("restore", w.wid, req))
            self._schedule_transfer_tick(now)

    def _on_restore_done(self, now: float, payload) -> None:
        wid, req = payload
        w = self.workers.get(wid)
        if w is None or not w.view.alive:
            return          # fail() already restarted the request
        if w.finish_restore(req, now):
            self._kick(wid, now)

    # -------------------------------------------------- contended transfers
    def _schedule_transfer_tick(self, now: float) -> None:
        t = self.transfer.next_completion()
        if t is not None:
            self._defer("transfer_tick", max(t, now), self.transfer.version)

    @staticmethod
    def _flow_event(flow) -> tuple[str, object]:
        """Map a completed flow to its event. Host-tier flows carry
        string-tagged payloads ("offload"|"restore", wid, req); migration
        flows keep the legacy 4-tuple (target, req, started, src_wid)."""
        p = flow.payload
        if isinstance(p, tuple) and p and p[0] in ("offload", "restore"):
            return f"{p[0]}_done", p[1:]
        return "migration_done", p

    def _on_transfer_tick(self, now: float, version) -> None:
        if version != self.transfer.version:
            return                           # rates changed since scheduling
        for flow in self.transfer.pop_completed(now):
            latency = self.transfer.delivery_latency(flow.src)
            kind, payload = self._flow_event(flow)
            self._defer(kind, now + latency, payload)
        self._schedule_transfer_tick(now)

    def _on_migration_done(self, now: float, payload) -> None:
        wid, req, started, src_wid = payload
        wait = now - started
        req.migration_wait += wait
        if req.generated_tokens > 0:
            # the user is mid-stream: time on the wire is inter-token
            # latency — it burns TPOT budget exactly like a stalled
            # iteration (the D->P/P->D asymmetry cost the paper's toggle
            # avoids by keeping decodes in place)
            req.decode_time += wait
            req.tpot_slack -= wait
        w = self.workers.get(wid)
        if w is None or not w.view.alive or \
                not w.admit_migrated(req, now):
            self.backend.on_finish(req)
            req.restarts += 1
            req.reset_for_reprefill(now)
            self._try_dispatch(req, now)
            return
        try:
            self.backend.on_migrate(req, src_wid, wid)
        except SlotExhausted:
            # destination has HBM room but no free KV slot: undo the admit
            # and fall back to the failed-placement restart path
            w.release(req)
            self.backend.on_finish(req)
            req.restarts += 1
            req.reset_for_reprefill(now)
            self._try_dispatch(req, now)
            return
        self._kick(wid, now)
        self._arm_rebalance(now)

    # ------------------------------------------------------ fault tolerance
    def _on_fail(self, now: float, payload) -> None:
        wid, recover_after = payload
        w = self.workers.get(wid)
        if w is None:
            return
        lost = w.fail(now)
        self.policy.on_worker_failure(wid)
        if self.transfer is not None:
            # KV in flight to OR from the dead worker is lost: restart.
            # Host-tier flows (tagged payloads) touch the worker's own host
            # node; their requests were already restarted by w.fail().
            dropped = self.transfer.drop_flows_touching(wid, now)
            dropped += self.transfer.drop_flows_touching(host_node(wid), now)
            for flow in dropped:
                if self._flow_event(flow)[0] != "migration_done":
                    continue
                _, req, started, _src = flow.payload
                req.migration_wait += now - started
                req.restarts += 1
                req.reset_for_reprefill(now)
                lost.append(req)
            self._schedule_transfer_tick(now)
        for r in lost:
            if r.phase != Phase.FINISHED:
                self.backend.on_finish(r)
                self._try_dispatch(r, now)
        if recover_after is not None:
            self._defer("recover", now + recover_after, wid)

    def _on_recover(self, now: float, wid: int) -> None:
        w = self.workers.get(wid)
        if w is None:
            return
        w.view.alive = True
        self._drain_global_queue(now)
        self._kick(wid, now)
        self._arm_rebalance(now)

    def _on_add_worker(self, now: float, w: Worker) -> None:
        self.workers[w.wid] = w
        self._busy[w.wid] = False
        if self.drift_monitor is not None:
            self.drift_monitor.register(w.wid, w.cost)
        if self.transfer is not None:
            self.transfer.add_worker(
                w.wid, LinkSpec.from_hardware(w.cost.worker.hw))
            if w.pages.host_total_pages > 0:
                self.transfer.add_host(
                    w.wid, LinkSpec.from_host_hardware(w.cost.worker.hw))
        self.policy.workers[w.wid] = w.view
        if getattr(self.policy, "toggle", None) is not None:
            self.policy.toggle.workers[w.wid] = w.view
        self._drain_global_queue(now)
        self._arm_rebalance(now)

    # --------------------------------------------------- feedback + roles
    def _observe(self, wid: int, plan: IterationPlan, dur: float) -> None:
        """Close the §IV-C loop: feed the observed iteration duration back
        to the predictor (OnlinePredictor EWMA-corrects; others ignore),
        tagged with the worker that ran it so per-worker calibration
        (heterogeneous clusters) converges independently per worker."""
        observe = getattr(self.policy.predictor, "observe_iteration", None)
        if observe is not None:
            observe(plan.n_decode, plan.sum_ctx, plan.prefill_tokens,
                    plan.prefill_ctx_offset, dur, wid=wid)
        if self.drift_monitor is not None:
            w = self.workers.get(wid)
            if w is not None:
                # residual vs the worker model's *current* prediction: the
                # DriftMonitor re-fits γ / efficiency from what's left
                self.drift_monitor.observe(wid, plan, w.plan_duration(plan),
                                           dur)

    def _record_outcomes(self, plan: IterationPlan,
                         finished_prefills: list[Request]) -> None:
        finished = [r for r in plan.decode_reqs if r.phase == Phase.FINISHED]
        finished += [r for r, _ in plan.prefill_parts
                     if r.phase == Phase.FINISHED]
        for r in finished:
            self.backend.on_finish(r)
        if self.rebalancer is None:
            return
        for r in finished_prefills:
            self.rebalancer.record_first_token(r)
        for r, _ in plan.prefill_parts:
            if r.phase == Phase.FINISHED and r not in finished_prefills:
                self.rebalancer.record_first_token(r)   # 0-decode requests
        for r in finished:
            self.rebalancer.record_finish(r)

    def _arm_rebalance(self, now: float) -> None:
        if self.rebalancer is None or self._rebalance_armed:
            return
        self._rebalance_armed = True
        self._defer("rebalance", now + self.rebalancer.cfg.interval, None)

    def _on_rebalance(self, now: float, _payload) -> None:
        self._rebalance_armed = False
        action = self.rebalancer.step(
            {wid: w.view for wid, w in self.workers.items()}, now)
        if action is not None:
            # roles changed: queued work may have new admissible homes
            self._drain_global_queue(now)
            for wid in list(self.workers):
                self._kick(wid, now)
        if self._progress_pending():
            self._arm_rebalance(now)

    def _progress_pending(self) -> bool:
        """True when some non-rebalance event is still coming (an iteration
        or a transfer in flight). Queued-but-stuck work alone must NOT keep
        the review timer alive: with nothing else in flight no review can
        make progress, and perpetual self-re-arming would keep the driver's
        heap non-empty forever (an unbounded ``run()`` would never return).
        Any later arrival/completion/recovery re-arms the timer."""
        if any(self._busy.values()):
            return True
        return (self.transfer is not None
                and self.transfer.next_completion() is not None)
