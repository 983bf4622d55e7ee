"""Per-worker continuous-batching engine.

A Worker owns: a local prefill queue, the running decode batch, KV/state
accounting, and iteration composition (driven by the policy's BatchRule).
It is executor-agnostic: ``compose_iteration`` returns the work description;
the ClusterScheduler's ``ExecutionBackend`` (cost model or real JAX —
``repro_torch.sched.backend``) supplies the duration; ``complete_iteration``
applies state transitions + SLO bookkeeping.

Fast mode (``build_cluster(vectorized=True)``) makes the per-iteration
bookkeeping array-native and incremental:

* ``RequestColumns`` — a structure-of-arrays mirror of the decode batch
  (the ``ViewColumns`` discipline one layer down) so completion effects
  (decode recording, KV footprint growth, blocked-time charging, finish
  detection, page-growth filtering) run as numpy ops over the batch, with
  scalar fallbacks only for the rows the masks flag;
* incremental ``_refresh_view`` — queue tokens, per-class TPOT floors and
  the prefix-span map are maintained as running aggregates at the mutation
  sites instead of O(batch) rescans per event.

The scalar path remains the reference: ``view_reference()`` recomputes
every derived view field from scratch, and the fast path must match it —
and the full decision stream / ``ServeMetrics`` — bit for bit
(``tests/test_engine_fast.py``, ``tests/test_vectorized.py``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import math

import numpy as np

from repro_torch.core.policies import BatchRule, Policy
from repro_torch.core.request import Phase, Request
from repro_torch.core.toggle import Role, WorkerView
from repro_torch.perf import CostModel
from repro_torch.serving.kvcache import PageAccountant, PrefixIndex

# Decode batches below this run the scalar completion/refresh bodies even
# in fast mode: numpy's fixed per-op cost (~µs) only amortises once the
# loop it replaces has enough rows. The scalar body is the parity
# reference, so the shortcut cannot change results, only wall clock.
_VEC_MIN_BATCH = 8


def _slack_key(now: float):
    """Sort key for the class-aware 'slack' discipline: tightest relative
    TTFT slack first among requests that can still make their deadline;
    already-hopeless requests (deadline passed — TTFT is unattainable
    whatever happens next) go last, exactly like the 'edf' discipline's
    hopeless demotion — spending capacity on them ahead of salvageable
    work buys no attainment. Shared by worker queues and the scheduler's
    global overflow queue so both orders agree."""
    def key(r: Request):
        rel = r.rel_ttft_slack(now)
        return (rel <= 0.0, rel, r.arrival_time, r.rid)
    return key


@dataclasses.dataclass
class IterationPlan:
    decode_reqs: list          # requests getting one token this iteration
    prefill_parts: list        # (request, tokens) chunks executed
    n_decode: int
    sum_ctx: float
    prefill_tokens: int
    prefill_ctx_offset: float
    exclusive_prefill: bool    # decode stalled behind prefill (interference)
    # decode-batch membership version at compose time (fast mode): lets
    # ``complete_iteration`` prove the SoA rows still ARE the planned batch
    # and take the vector path; any admit/release/offload in between bumps
    # the worker counter and the completion falls back to the scalar body
    batch_version: int = -1

    @property
    def empty(self) -> bool:
        return self.n_decode == 0 and self.prefill_tokens == 0


class RequestColumns:
    """Structure-of-arrays mirror of one worker's decode batch: the
    per-request scalars the completion hot path touches, as numpy columns
    in ``decode_running``'s insertion order — which is exactly the plan
    order ``compose_iteration`` captured, so masked results map back to
    requests by row index.

    The ``Request`` objects stay authoritative: the fast completion path
    writes its array results straight back every iteration, so the mirror
    never holds state the scalar fallbacks (preempt / offload / metrics)
    can't see. Any membership change just sets ``dirty`` (batch-granular
    analogue of ``ViewColumns``' per-row dirty set — decode batches are
    small enough that a whole-batch rebuild beats row surgery); the next
    reader rebuilds from the dict."""

    __slots__ = ("reqs", "rids", "ctx", "gen", "rem_out", "decode_time",
                 "tpot_slack", "tpot_slo", "cached_prefix", "pages_held",
                 "n", "dirty")

    def __init__(self) -> None:
        self.reqs: list[Request] = []
        self.rids: list[int] = []
        self.ctx = np.empty(0, dtype=np.int64)
        self.gen = np.empty(0, dtype=np.int64)
        self.rem_out = np.empty(0, dtype=np.int64)
        self.decode_time = np.empty(0, dtype=np.float64)
        self.tpot_slack = np.empty(0, dtype=np.float64)
        self.tpot_slo = np.empty(0, dtype=np.float64)
        self.cached_prefix = np.empty(0, dtype=np.int64)
        self.pages_held = np.empty(0, dtype=np.int64)
        self.n = 0
        self.dirty = True

    def rebuild(self, decode_running: dict[int, Request],
                pages: PageAccountant) -> None:
        reqs = list(decode_running.values())
        n = len(reqs)
        self.reqs = reqs
        self.rids = [r.rid for r in reqs]
        self.ctx = np.fromiter((r.context_len for r in reqs), np.int64, n)
        self.gen = np.fromiter((r.generated_tokens for r in reqs),
                               np.int64, n)
        self.rem_out = np.fromiter((r.remaining_output for r in reqs),
                                   np.int64, n)
        self.decode_time = np.fromiter((r.decode_time for r in reqs),
                                       np.float64, n)
        self.tpot_slack = np.fromiter((r.tpot_slack for r in reqs),
                                      np.float64, n)
        self.tpot_slo = np.fromiter((r.slo.tpot for r in reqs),
                                    np.float64, n)
        self.cached_prefix = np.fromiter((r.cached_prefix for r in reqs),
                                         np.int64, n)
        self.pages_held = np.fromiter((pages.held_pages(rid)
                                       for rid in self.rids), np.int64, n)
        self.n = n
        self.dirty = False


class Worker:
    def __init__(self, wid: int, cost: CostModel, role: Role = Role.MULTIPLEX,
                 queue_discipline: str = "fcfs",
                 kv_preempt_watermark: float = 0.98,
                 host_pages: int = 0,
                 prefix_cache: Optional[PrefixIndex] = None,
                 offload_gate: Optional[Callable[[Request], bool]] = None):
        self.wid = wid
        self.cost = cost
        self.queue_discipline = queue_discipline   # fcfs | edf
        # page-granular HBM accounting: admission and growth gate on real
        # allocatable pages; crossing the watermark evicts decodes (which
        # pay a re-prefill on readmission) — unless a host-DRAM tier
        # (``host_pages`` > 0) can absorb the spill and the ``offload_gate``
        # (predictor-priced: restore beats re-prefill) approves
        self.pages = PageAccountant(cost.kv_capacity_pages(), cost.page_size,
                                    host_pages=host_pages)
        self.kv_preempt_watermark = kv_preempt_watermark
        # fast mode (build_cluster(vectorized=True)): incremental view
        # refresh + array-shaped completion effects over RequestColumns.
        # State transitions are identical — tests/test_vectorized.py and
        # tests/test_engine_fast.py pin decision/metrics/view parity.
        self.fast = False
        self.prefix_cache = prefix_cache
        self.offload_gate = offload_gate
        self.view = WorkerView(
            wid=wid, role=role,
            kv_capacity_tokens=float(max(cost.kv_capacity_tokens(), 1)),
            total_pages=self.pages.total_pages,
            free_pages=self.pages.total_pages,
            page_size=self.pages.page_size,
            host_total_pages=self.pages.host_total_pages,
            host_free_pages=self.pages.host_total_pages,
        )
        self.prefill_queue: deque[Request] = deque()
        # insertion-ordered, keyed by rid: O(1) membership/removal where
        # the old list paid O(batch) scans per event; iteration order is
        # insertion order, i.e. exactly the old list order (plan parity)
        self.decode_running: dict[int, Request] = {}
        self.preempted: list[Request] = []       # drained by the simulator
        # tiered-KV lifecycle (scheduler drains/advances these):
        # offload_started -> engine starts the worker->host flow;
        # offloading (wire) -> offloaded (parked) -> restoring (wire back)
        self.offload_started: list[Request] = []
        self.offloading: dict[int, Request] = {}
        self.offloaded: dict[int, Request] = {}
        self.restoring: dict[int, Request] = {}
        self.busy = False
        # incremental-view aggregates, maintained at the mutation sites in
        # both modes (the slow path ignores them; keeping them mode-blind
        # makes toggling ``fast`` mid-life safe in tests):
        # exact queued-prefill token count (ints — no float drift)
        self._q_tokens = 0
        # per-class {tpot: live count} so the class floor map rebuilds
        # from keys already in the batch instead of an O(batch) walk
        self._floor_counts: dict[str, dict[float, int]] = {}
        self._floors_cache: Optional[dict[str, float]] = {}
        # bumped on every decode-batch membership change; plans carry the
        # compose-time value so completion can prove row alignment
        self._batch_version = 0
        self._cols = RequestColumns()
        # prefix-cache content version last mirrored into the view
        self._prefix_seen = -1
        # metrics
        self.blocked_time: dict[int, float] = {}
        self.queue_times: dict[int, float] = {}
        # wall seconds this worker's decode batches spent blocked behind
        # co-batched prefill work, charged ONCE per mixed iteration (the
        # per-request ``blocked_time`` dict intentionally charges the same
        # interval to every blocked request — see complete_iteration)
        self.interference_time = 0.0
        self.preemption_count = 0
        self.offload_count = 0
        self.restore_count = 0
        self.pages_offloaded = 0
        self.pages_restored = 0
        self.pages_reprefilled = 0

    # ---------------------------------------------------- batch bookkeeping
    def _decode_add(self, req: Request) -> None:
        self.decode_running[req.rid] = req
        self._batch_version += 1
        self._cols.dirty = True
        counts = self._floor_counts.get(req.slo.name)
        if counts is None:
            counts = self._floor_counts[req.slo.name] = {}
        tpot = req.slo.tpot
        counts[tpot] = counts.get(tpot, 0) + 1
        self._floors_cache = None

    def _decode_discard(self, req: Request) -> bool:
        if self.decode_running.pop(req.rid, None) is None:
            return False
        self._batch_version += 1
        self._cols.dirty = True
        # tolerant of direct decode_running inserts (test harnesses):
        # missing entries just skip the floor aggregate — fast-mode runs
        # always pair _decode_add/_decode_discard, and the view parity
        # tests would surface any imbalance as a floor-map divergence
        counts = self._floor_counts.get(req.slo.name)
        tpot = req.slo.tpot
        if counts is not None and tpot in counts:
            left = counts[tpot] - 1
            if left:
                counts[tpot] = left
            else:
                del counts[tpot]
                if not counts:
                    del self._floor_counts[req.slo.name]
        self._floors_cache = None
        return True

    # ------------------------------------------------------------- admission
    def admit_prefill(self, req: Request, now: float) -> None:
        req.worker = self.wid
        self.prefill_queue.append(req)
        self._q_tokens += req.remaining_prefill
        self._refresh_view()

    def admit_decode(self, req: Request, now: float) -> None:
        req.worker = self.wid
        req.phase = Phase.DECODING
        self._decode_add(req)
        self._refresh_view()

    def withdraw_prefill(self, req: Request, now: float = 0.0) -> None:
        """Back out a queued/just-started prefill whose execution the
        backend refused (e.g. ``SlotExhausted``): drop it from the queue,
        return its reserved pages / borrowed prefix ref / KV accounting.
        The caller re-queues the request elsewhere."""
        if req in self.prefill_queue:
            self.prefill_queue.remove(req)
            self._q_tokens -= req.remaining_prefill
        self.release(req, refresh=False)
        self._refresh_view()

    def admit_migrated(self, req: Request, now: float) -> bool:
        """Admit a request whose KV just arrived over the links. False when
        the page pool cannot hold the migrated context (caller restarts the
        request elsewhere — the re-prefill cost of a failed placement)."""
        if not self.pages.reserve(req.rid, self._page_need(req.context_len,
                                                           req.cached_prefix)):
            return False
        self.view.kv_used_tokens += self._own_state(req, req.context_len)
        self.admit_decode(req, now)
        return True

    # ------------------------------------------------------------- planning
    def compose_iteration(self, rule: BatchRule, now: float) -> IterationPlan:
        decode_reqs: list[Request] = []
        prefill_parts: list[tuple[Request, int]] = []
        budget = rule.prefill_budget

        run_prefill_exclusively = (
            rule.prefill_exclusive and self._has_admissible_prefill())
        if run_prefill_exclusively:
            # full-prompt (or budget-bounded) prefill-only iteration
            taken = set()
            while budget > 0 and self._has_admissible_prefill():
                req = self._next_admissible_prefill(now)
                if req is None or req.rid in taken:
                    break
                take = min(req.remaining_prefill, budget)
                if take < req.remaining_prefill and prefill_parts:
                    break       # don't split a second prompt mid-iteration
                if not self._start_prefill(req, now):
                    break       # page pool can't hold the prompt yet
                prefill_parts.append((req, take))
                taken.add(req.rid)
                budget -= take
        else:
            if rule.run_decode:
                decode_reqs = list(self.decode_running.values())
            if budget > 0 and self._has_admissible_prefill():
                req = self._peek_admissible_prefill(now)
                if req is not None and self._start_prefill(req, now):
                    take = min(req.remaining_prefill, budget)
                    prefill_parts.append((req, take))

        if self.fast and rule.run_decode and not run_prefill_exclusively:
            # decode_reqs is exactly decode_running, whose context sum the
            # view maintains (refreshed after every mutation) — same value,
            # no O(batch) rescan
            sum_ctx = self.view.decode_sum_ctx
        else:
            sum_ctx = float(sum(r.context_len for r in decode_reqs))
        p_tokens = sum(t for _, t in prefill_parts)
        ctx_off = float(prefill_parts[0][0].prefilled_tokens) if prefill_parts else 0.0
        return IterationPlan(
            decode_reqs=decode_reqs, prefill_parts=prefill_parts,
            n_decode=len(decode_reqs), sum_ctx=sum_ctx,
            prefill_tokens=p_tokens, prefill_ctx_offset=ctx_off,
            exclusive_prefill=run_prefill_exclusively and bool(prefill_parts),
            batch_version=self._batch_version if self.fast else -1,
        )

    def plan_duration(self, plan: IterationPlan) -> float:
        return self.cost.iteration_time(
            plan.n_decode, plan.sum_ctx, plan.prefill_tokens,
            plan.prefill_ctx_offset)

    # ------------------------------------------------------------ completion
    def complete_iteration(self, plan: IterationPlan, now: float,
                           duration: float) -> list[Request]:
        """Apply effects at iteration end. Returns requests whose prefill
        finished this iteration (for decode dispatch)."""
        finished_prefills: list[Request] = []
        # decode side. ``interference`` is the wall time this iteration ran
        # beyond a pure decode pass (piggybacked prefill compute + the §IV
        # contention penalty when γ is active). It is one per-ITERATION
        # quantity: the worker-level ``interference_time`` accumulates it
        # exactly once, while the per-request ``blocked_time`` dict charges
        # the same interval to EVERY blocked decode — deliberately, because
        # each request's stream really did stall that long (wall blocking
        # is concurrent, so per-request entries must never be summed across
        # a batch as if they were machine time).
        pure_decode = self.cost.decode_iter_time(plan.n_decode, plan.sum_ctx) \
            if plan.n_decode else 0.0
        interference = max(0.0, duration - pure_decode)
        if plan.n_decode and plan.prefill_tokens > 0:
            self.interference_time += interference
        if self.fast and plan.n_decode >= _VEC_MIN_BATCH \
                and plan.batch_version == self._batch_version:
            # membership unchanged since compose: the SoA rows are exactly
            # plan.decode_reqs, in order — take the vector path. Below
            # the batch threshold the numpy fixed cost exceeds the loop
            # it replaces, so small batches run the scalar body (which IS
            # the reference — parity is free).
            self._decode_effects_fast(plan, now, duration, interference)
        else:
            if self.fast and plan.n_decode:
                # scalar fallback advanced the batch outside the SoA; a
                # refresh between compose and now may have rebuilt (and
                # clean-flagged) the mirror at the new version, so the
                # version bump alone does not guarantee a re-pull
                self._cols.dirty = True
            self._decode_effects(plan, now, duration, interference)
        while self.pages.utilization > self.kv_preempt_watermark:
            if self._evict_prefix_lru():
                continue
            if len(self.decode_running) <= 1 or not self._preempt_one(now):
                break
        # decode requests stalled behind an exclusive prefill count as blocked
        if plan.exclusive_prefill and self.decode_running:
            bt = self.blocked_time
            for r in self.decode_running.values():
                r.decode_time += duration
                r.tpot_slack -= duration       # the stall burns slack
                bt[r.rid] = bt.get(r.rid, 0.0) + duration
            # scalar mutation of batch members outside the SoA path: the
            # mirror must re-pull before the next vector step reads it
            self._cols.dirty = True
        # prefill side
        fast = self.fast
        for req, tokens in plan.prefill_parts:
            in_queue = req in self.prefill_queue
            before = req.remaining_prefill
            req.prefilled_tokens += tokens
            if in_queue:
                # exact aggregate delta (remaining_prefill clamps at 0, so
                # the delta is re-derived, not assumed equal to ``tokens``)
                self._q_tokens -= before - req.remaining_prefill
            if req.remaining_prefill == 0:
                req.record_first_token(now)
                # the prefill's forward pass emitted token #1: charge its
                # footprint (context grew past the prompt the admission
                # reservation covered), so release(st(final ctx)) balances
                # to zero over the request's life
                self.view.kv_used_tokens += \
                    self.cost.state_tokens(req.context_len) \
                    - self.cost.state_tokens(req.prompt_len)
                if (self.prefix_cache is not None
                        and req.prefix_key is not None
                        and req.cached_prefix == 0):
                    # first bearer of this shared prompt on this worker:
                    # retain a copy of the prefix span for later arrivals
                    self._cache_prefix(req)
                if req.remaining_output == 0:
                    req.phase = Phase.FINISHED
                    req.finish_time = now
                    self.release(req, refresh=not fast)
                else:
                    finished_prefills.append(req)
                if in_queue:
                    self.prefill_queue.remove(req)
        self._refresh_view()
        return finished_prefills

    def _decode_effects(self, plan: IterationPlan, now: float,
                        duration: float, interference: float) -> None:
        """Scalar reference for the decode-side completion effects: token
        recording, KV footprint growth, blocked-time charging, finish
        detection, then page growth for the tokens just written."""
        running = self.decode_running
        bt = self.blocked_time
        mixed = plan.prefill_tokens > 0
        for r in plan.decode_reqs:
            if r.phase != Phase.DECODING or r.rid not in running:
                continue        # evicted mid-compose (page preemption)
            r.record_decode_iteration(duration)
            # grow the token counter by the request's true footprint
            # delta so release() — which frees state_tokens(ctx) — always
            # balances: 1.0 for dense KV, 0.5 past a sliding window's
            # cap, 0 for constant-state (rwkv/mamba, whose fixed state
            # was pinned in full at admission). A flat += 1 leaked the
            # difference on every finished request.
            self.view.kv_used_tokens += \
                self.cost.state_tokens(r.context_len) \
                - self.cost.state_tokens(r.context_len - 1)
            if mixed:
                bt[r.rid] = bt.get(r.rid, 0.0) + interference
            if r.remaining_output == 0:
                r.phase = Phase.FINISHED
                r.finish_time = now
                self.release(r, refresh=not self.fast)
        # page growth for the tokens just written; evict newest decodes
        # when the pool can't supply it, then enforce the watermark
        for r in plan.decode_reqs:
            if r.phase != Phase.DECODING or r.rid not in running:
                continue
            need = self._page_need(r.context_len, r.cached_prefix)
            while not self.pages.reserve(r.rid, need):
                if self._evict_prefix_lru():
                    continue       # unreferenced cached prefixes go first
                if not self._preempt_one(now, keep=r):
                    self._preempt(r, now)      # nobody else to evict
                    break

    def _decode_effects_fast(self, plan: IterationPlan, now: float,
                             duration: float, interference: float) -> None:
        """Array-native decode-side completion: the same effects as
        ``_decode_effects``, as elementwise ops over ``RequestColumns``.
        Bit-for-bit identical because every column op mirrors the scalar
        recurrence's IEEE-754 association order, and the one cross-row
        accumulation (the KV footprint delta) sums exactly-representable
        dyadic values, where grouping cannot change the result. Rows the
        masks flag (finished, page growth) fall back to the exact scalar
        bodies in row (= plan) order.

        One knowing divergence: rows that need no new pages skip the
        no-op ``PageAccountant.reserve`` the scalar loop still issues, so
        the accountant's advisory per-rid token watermark (feeding only
        the ``fragmentation`` diagnostic) can read lower here. Decisions
        never consume it."""
        cols = self._cols
        if cols.dirty:
            cols.rebuild(self.decode_running, self.pages)
        reqs = cols.reqs
        # one decode token per request — the scalar recurrences of
        # Request.record_decode_iteration, elementwise
        cols.ctx += 1
        cols.gen += 1
        cols.rem_out -= 1
        cols.decode_time += duration
        cols.tpot_slack += cols.tpot_slo - duration
        delta = self.cost.state_token_delta_sum(cols.ctx)
        if delta:
            self.view.kv_used_tokens += delta
        if plan.prefill_tokens > 0:
            bt = self.blocked_time
            for rid in cols.rids:
                bt[rid] = bt.get(rid, 0.0) + interference
        # immediate writeback: Requests stay authoritative for every
        # scalar consumer (preempt/offload victims, metrics, routing)
        for r, d, t, g in zip(reqs, cols.decode_time.tolist(),
                              cols.tpot_slack.tolist(), cols.gen.tolist()):
            r.decode_time = d
            r.tpot_slack = t
            r.generated_tokens = g
        done = None
        if cols.rem_out.min() == 0:
            done = np.nonzero(cols.rem_out == 0)[0]
            for i in done.tolist():
                r = reqs[i]
                r.phase = Phase.FINISHED
                r.finish_time = now
                self.release(r, refresh=False)
        # page growth: vector-filter the rows whose own reservation no
        # longer covers their grown footprint, scalar-handle only those
        spec = self.cost.spec
        if spec.kv_bytes_per_token <= 0:
            return          # constant-state: footprint pinned at admission
        cap = spec.ctx_cap
        ps = self.pages.page_size
        if cap is None:
            need_tok = np.maximum(cols.ctx - cols.cached_prefix, 0)
        else:
            st_ctx = cols.ctx * 0.5 + np.minimum(cols.ctx, cap) * 0.5
            st_cached = cols.cached_prefix * 0.5 \
                + np.minimum(cols.cached_prefix, cap) * 0.5
            need_tok = np.ceil(
                np.maximum(st_ctx - st_cached, 0.0)).astype(np.int64)
        grow = -(-need_tok // ps) > cols.pages_held
        if done is not None:
            grow[done] = False
        if not grow.any():
            return
        running = self.decode_running
        for i in np.nonzero(grow)[0].tolist():
            r = reqs[i]
            if r.phase != Phase.DECODING or r.rid not in running:
                continue        # evicted by an earlier victim this pass
            need = self._page_need(r.context_len, r.cached_prefix)
            while not self.pages.reserve(r.rid, need):
                if self._evict_prefix_lru():
                    continue
                if not self._preempt_one(now, keep=r):
                    self._preempt(r, now)
                    break
            else:
                cols.pages_held[i] = self.pages.held_pages(r.rid)

    def release(self, req: Request, refresh: bool = True) -> None:
        """Free KV held by a finished/migrated request (both tiers), and
        return any borrowed prefix-cache reference. ``refresh=False`` lets
        ``complete_iteration`` coalesce many releases into its single
        trailing view rebuild (the rebuild is a full recompute, so the
        final state is identical)."""
        self.view.kv_used_tokens = max(
            0.0, self.view.kv_used_tokens - self._own_state(req, req.context_len))
        self.pages.release(req.rid)
        if req.cached_prefix > 0 and self.prefix_cache is not None:
            self.prefix_cache.unref(req.prefix_key)
            req.cached_prefix = 0
        self._decode_discard(req)
        if refresh:
            self._refresh_view()

    # ------------------------------------------------------------ preemption
    def _preempt(self, req: Request, now: float) -> None:
        """Evict a decode's KV pages; the request re-prefills its whole
        context (the §IV-B eviction cost) wherever dispatch next places it."""
        req.preemptions += 1
        self.preemption_count += 1
        self.pages_reprefilled += self.pages.held_pages(req.rid)
        # preemption only happens inside complete_iteration, whose trailing
        # _refresh_view covers fast mode's skipped intermediate rebuild
        self.release(req, refresh=not self.fast)
        req.reset_for_reprefill(now)
        self.preempted.append(req)

    def _preempt_one(self, now: float, keep: Optional[Request] = None) -> bool:
        """Displace the most recently admitted decode (least sunk prefill
        work, vLLM-style LIFO recomputation). Prefers *offloading* its
        pages to the host-DRAM tier (restore later, no re-prefill) when the
        tier has room and the offload gate prices restore below re-prefill;
        falls back to eviction. Returns False when there is no eligible
        victim."""
        for victim in reversed(self.decode_running.values()):
            if victim is not keep:
                if self._try_offload(victim, now):
                    return True
                self._preempt(victim, now)
                return True
        return False

    def drain_preempted(self) -> list[Request]:
        out, self.preempted = self.preempted, []
        return out

    # ------------------------------------------------------------- tiered KV
    def _try_offload(self, victim: Request, now: float) -> bool:
        """Move ``victim``'s KV accounting to the host tier instead of
        discarding it. The scheduler drains ``offload_started`` and puts
        the bytes on the host link."""
        if (self.offload_gate is None or self.pages.host_total_pages <= 0
                or not self.pages.can_offload(victim.rid)
                or not self.offload_gate(victim)):
            return False
        moved = self.pages.offload(victim.rid)
        if moved <= 0:
            return False
        victim.offloads += 1
        self.offload_count += 1
        self.pages_offloaded += moved
        victim.phase = Phase.OFFLOADED
        if victim.stall_start is None:
            victim.stall_start = now    # stream stalls until restore lands
        self.view.kv_used_tokens = max(
            0.0,
            self.view.kv_used_tokens - self._own_state(victim,
                                                       victim.context_len))
        # a borrowed prefix ref stays held across the park: the cached span
        # must still be resident when the restore lands
        self._decode_discard(victim)
        self.offloading[victim.rid] = victim
        self.offload_started.append(victim)
        return True

    def drain_offload_started(self) -> list[Request]:
        out, self.offload_started = self.offload_started, []
        return out

    def offload_landed(self, req: Request) -> None:
        """The worker->host flow completed; the request is restore-eligible."""
        if self.offloading.pop(req.rid, None) is not None:
            self.offloaded[req.rid] = req

    def next_restorable(self) -> Optional[Request]:
        """Oldest parked request whose pages fit back in HBM without
        pushing utilization past the preempt watermark (restoring must not
        immediately re-trigger the preemption it was meant to avoid)."""
        for rid, req in self.offloaded.items():
            pages = self.pages.host_held_pages(rid)
            would = (self.pages.used_pages + pages) \
                / max(self.pages.total_pages, 1)
            if pages <= self.pages.free_pages \
                    and would <= self.kv_preempt_watermark:
                return req
        return None

    def begin_restore(self, req: Request, now: float) -> bool:
        """Reserve the HBM destination and mark the restore in flight."""
        if req.rid not in self.offloaded or not self.pages.can_restore(req.rid):
            return False
        self.pages.restore(req.rid)
        del self.offloaded[req.rid]
        self.restoring[req.rid] = req
        self._refresh_view()
        return True

    def finish_restore(self, req: Request, now: float) -> bool:
        """Restore flow landed: rejoin the decode batch. The whole parked
        interval (offload wire + host dwell + restore wire) is inter-token
        latency the user saw — charged like migration wait."""
        if self.restoring.pop(req.rid, None) is None:
            return False               # stale completion (failure raced it)
        self.restore_count += 1
        self.pages_restored += self.pages.held_pages(req.rid)
        self.view.kv_used_tokens += self._own_state(req, req.context_len)
        req.restores += 1
        if req.stall_start is not None:
            gap = now - req.stall_start
            req.decode_time += gap
            req.tpot_slack -= gap
            req.stall_start = None
        self.admit_decode(req, now)
        return True

    # ------------------------------------------------------------- internals
    def _page_need(self, ctx_tokens: int, cached: int = 0) -> int:
        """Token-footprint the request's OWN reservation must cover: its
        full context minus any span borrowed from the prefix cache (whose
        pages are pinned under the cache entry's pseudo rid)."""
        st = self.cost.state_tokens(ctx_tokens)
        if cached > 0:
            st -= self.cost.state_tokens(cached)
        return int(math.ceil(max(st, 0.0)))

    def _own_state(self, req: Request, ctx_tokens: int) -> float:
        """``state_tokens`` charged to ``req`` itself (excludes the
        borrowed prefix span — the cache entry carries those tokens)."""
        st = self.cost.state_tokens(ctx_tokens)
        if req.cached_prefix > 0:
            st -= self.cost.state_tokens(req.cached_prefix)
        return max(st, 0.0)

    def _prefix_span(self, req: Request) -> int:
        """Tokens of ``req``'s prompt a prefill start here would borrow
        from the cache (0 without a hit). Capped at prompt_len - 1 so at
        least one prefill token always runs — the forward pass that emits
        the first token. Pure peek: no counters, no LRU touch."""
        if req.cached_prefix > 0:
            return req.cached_prefix
        if self.prefix_cache is None or req.prefix_key is None:
            return 0
        span = self.prefix_cache.peek(req.prefix_key)
        return max(0, min(span, req.prefix_len, req.prompt_len - 1))

    def _kv_room_for(self, req: Request) -> bool:
        span = self._prefix_span(req)
        if not self.pages.can_fit(self._page_need(req.prompt_len, span),
                                  rid=req.rid):
            return False
        st = self.cost.state_tokens(req.prompt_len)
        if span > 0:
            st -= self.cost.state_tokens(span)
        return self.view.kv_used_tokens + max(st, 0.0) \
            <= self.view.kv_capacity_tokens

    def _has_admissible_prefill(self) -> bool:
        return any(self._kv_room_for(r) or r.prefill_start is not None
                   for r in self.prefill_queue)

    def _prefill_order(self, now: float) -> list[Request]:
        """Queue order. 'fcfs' (the discipline of vLLM/Sarathi/DistServe and
        the paper's Tropical). 'slack' is the multi-tenant class-aware
        order: tightest-relative-TTFT-slack first — absolute seconds are
        not comparable across SLO classes, the consumed budget *fraction*
        is. A homogeneous queue (every request in one class) keeps the
        exact FCFS admission order, so single-class runs are
        decision-identical to the paper's discipline (an interactive-class
        arrival only ever overtakes *other-class* work). 'edf' is the
        beyond-paper SLO-aware order: earliest-deadline-first among
        requests that can still make TTFT; already-hopeless requests are
        served last (spending capacity on them in deadline order buys no
        attainment)."""
        if self.queue_discipline == "fcfs":
            return list(self.prefill_queue)

        if self.queue_discipline == "slack":
            if len({r.slo.name for r in self.prefill_queue}) <= 1:
                return list(self.prefill_queue)
            return sorted(self.prefill_queue, key=_slack_key(now))

        def key(r: Request):
            deadline = r.arrival_time + r.slo.ttft
            t_exec = self.cost.prefill_time(r.remaining_prefill,
                                            r.prefilled_tokens)
            hopeless = now + t_exec > deadline
            return (hopeless, deadline, r.rid)

        return sorted(self.prefill_queue, key=key)

    def peek_prefill(self, now: float) -> Optional[Request]:
        """Head-of-queue under the active discipline — what the policy's
        ``batch_rule`` sizes its chunk budget against. 'fcfs'/'edf' keep
        the legacy raw queue head; 'slack' surfaces the class-aware order's
        head (identical for a single-class queue). O(n) min, not a full
        sort — this runs on every _kick."""
        if not self.prefill_queue:
            return None
        if self.queue_discipline == "slack" and \
                len({r.slo.name for r in self.prefill_queue}) > 1:
            return min(self.prefill_queue, key=_slack_key(now))
        return self.prefill_queue[0]

    def _next_admissible_prefill(self, now: float) -> Optional[Request]:
        for r in self._prefill_order(now):
            if r.remaining_prefill > 0 and (
                    r.prefill_start is not None or self._kv_room_for(r)):
                return r
        return None

    def _peek_admissible_prefill(self, now: float) -> Optional[Request]:
        return self._next_admissible_prefill(now)

    def _start_prefill(self, req: Request, now: float) -> bool:
        """Reserve prompt KV and mark the prefill started. False (state
        untouched) when the page pool can't hold the prompt — unreachable
        behind the ``_kv_room_for`` admission gate, kept as the contract
        for callers. A prefix-cache hit borrows the cached span: only the
        uncached suffix reserves pages and runs prefill compute."""
        if req.prefill_start is None:
            span = self._prefix_span(req)
            if not self.pages.reserve(req.rid,
                                      self._page_need(req.prompt_len, span)):
                return False
            if self.prefix_cache is not None and req.prefix_key is not None:
                entry = self.prefix_cache.lookup(req.prefix_key)  # counted
                if entry is not None and span > 0:
                    entry.refs += 1
                    req.cached_prefix = span
                    # the borrowed span never runs prefill compute: the
                    # queued-token aggregate sheds it here (req is still
                    # in the queue — starts only come from queue walks)
                    before = req.remaining_prefill
                    req.prefilled_tokens = span
                    self._q_tokens -= before - req.remaining_prefill
                    req.prefix_hits += 1
            req.prefill_start = now
            req.phase = Phase.PREFILLING
            self.queue_times[req.rid] = now - req.arrival_time
            self.view.kv_used_tokens += self._own_state(req, req.prompt_len)
        return True

    def _cache_prefix(self, req: Request) -> None:
        """Retain a copy of ``req``'s just-prefilled shared-prompt span for
        later arrivals. Skipped when the key is already cached, the span
        exceeds the cache's page budget, or HBM lacks free pages (the
        cache must never squeeze live decodes to populate itself)."""
        if self.cost.spec.kv_bytes_per_token <= 0:
            return          # constant-state families have no prefix KV
        if self.prefix_cache.peek(req.prefix_key) > 0:
            return          # another bearer landed first
        tokens = min(req.prefix_len, req.prompt_len)
        if tokens <= 0:
            return
        need = self._page_need(tokens)
        pages = self.pages.pages_for(need)
        if pages <= 0 or pages > self.prefix_cache.max_pages:
            return
        while self.prefix_cache.used_pages + pages > self.prefix_cache.max_pages:
            if not self._evict_prefix_lru():
                return
        if self.pages.free_pages < pages:
            return
        entry = self.prefix_cache.insert(req.prefix_key, tokens, pages)
        self.pages.reserve(entry.rid, need)
        self.view.kv_used_tokens += self.cost.state_tokens(tokens)

    def _evict_prefix_lru(self) -> bool:
        """Drop the LRU *unreferenced* cache entry and free its pages.
        False when the cache is off, empty, or every entry has a live
        borrower (those pages must not dangle under a mid-decode)."""
        if self.prefix_cache is None:
            return False
        entry = self.prefix_cache.evict_lru()
        if entry is None:
            return False
        self.pages.release(entry.rid)
        self.view.kv_used_tokens = max(
            0.0, self.view.kv_used_tokens
            - self.cost.state_tokens(entry.tokens))
        return True

    # ------------------------------------------------------------------ view
    def view_reference(self) -> dict:
        """Every derived view field, recomputed from scratch — the scalar
        reference the fast incremental refresh must match bit for bit
        after every event (``tests/test_engine_fast.py`` walks event
        histories asserting exactly that)."""
        decode = list(self.decode_running.values())
        fields: dict = {
            "queued_prefill_tokens": sum(r.remaining_prefill
                                         for r in self.prefill_queue),
            "queued_requests": len(self.prefill_queue),
            "decode_batch": len(decode),
            "decode_sum_ctx": float(sum(r.context_len for r in decode)),
        }
        base_iter = self.cost.decode_iter_time(
            fields["decode_batch"], fields["decode_sum_ctx"]) \
            if decode else 0.0
        fields["min_tpot_slack"] = min(
            (r.effective_slack(base_iter) for r in decode),
            default=float("inf"))
        floors: dict[str, float] = {}
        for r in decode:
            name = r.slo.name
            floors[name] = min(floors.get(name, float("inf")), r.slo.tpot)
        fields["decode_tpot_floor"] = floors
        fields["total_pages"] = self.pages.total_pages
        fields["free_pages"] = self.pages.free_pages
        fields["page_size"] = self.pages.page_size
        fields["host_total_pages"] = self.pages.host_total_pages
        fields["host_free_pages"] = self.pages.host_free_pages
        if self.prefix_cache is not None:
            fields["cached_prefixes"] = self.prefix_cache.spans()
            fields["prefix_hit_ewma"] = self.prefix_cache.hit_ewma
        return fields

    def _refresh_view(self) -> None:
        if self.fast:
            self._refresh_view_fast()
            return
        self.view.assign(**self.view_reference())

    def _refresh_view_fast(self) -> None:
        """Incremental refresh: running aggregates + SoA reductions in
        place of ``view_reference``'s O(batch + queue) rescans. Values are
        bit-identical: the queue/floor aggregates are exact integer /
        min-structure maintenance, ``decode_sum_ctx`` is an exact int64
        sum, and the slack reduction mirrors ``Request.effective_slack``'s
        float ops elementwise before one order-free ``min``."""
        running = self.decode_running
        n = len(running)
        if not n:
            sum_ctx = 0.0
            min_slack = float("inf")
        elif n < _VEC_MIN_BATCH:
            # small batch: the reference's own scalar recurrences, hand
            # inlined (``Request.effective_slack``'s exact float ops, the
            # same int context sum), straight off the live requests — no
            # SoA rebuild, no numpy fixed cost. cols stays dirty; it
            # re-pulls when the batch grows past the threshold.
            ictx = 0
            for r in running.values():
                ictx += r.prompt_len + r.generated_tokens
            sum_ctx = float(ictx)
            base_iter = self.cost.decode_iter_time(n, sum_ctx)
            min_slack = float("inf")
            for r in running.values():
                rem = r.output_len - r.prior_tokens - r.generated_tokens
                if rem > 4:
                    rem = 4
                elif rem < 0:
                    rem = 0
                s = r.tpot_slack + max(0.0, r.slo.tpot - base_iter) * rem
                if s < min_slack:
                    min_slack = s
        else:
            cols = self._cols
            if cols.dirty:
                cols.rebuild(running, self.pages)
            sum_ctx = float(np.sum(cols.ctx))
            # memoized in fast mode — repeat signatures are dict hits
            base_iter = self.cost.decode_iter_time(n, sum_ctx)
            credit = np.maximum(0.0, cols.tpot_slo - base_iter) \
                * np.minimum(cols.rem_out, 4)
            min_slack = float(np.min(cols.tpot_slack + credit))
        floors = self._floors_cache
        if floors is None:
            floors = self._floors_cache = {
                name: min(counts)
                for name, counts in self._floor_counts.items()}
        pages = self.pages
        view = self.view
        set_ = object.__setattr__
        set_(view, "queued_prefill_tokens", self._q_tokens)
        set_(view, "queued_requests", len(self.prefill_queue))
        set_(view, "decode_batch", n)
        set_(view, "decode_sum_ctx", sum_ctx)
        set_(view, "min_tpot_slack", min_slack)
        set_(view, "decode_tpot_floor", floors)
        set_(view, "total_pages", pages.total_pages)
        set_(view, "free_pages", pages.free_pages)
        set_(view, "page_size", pages.page_size)
        set_(view, "host_total_pages", pages.host_total_pages)
        set_(view, "host_free_pages", pages.host_free_pages)
        pc = self.prefix_cache
        if pc is not None:
            if pc.version != self._prefix_seen:
                self._prefix_seen = pc.version
                set_(view, "cached_prefixes", pc.spans())
            set_(view, "prefix_hit_ewma", pc.hit_ewma)
        cols_mirror = view._cols
        if cols_mirror is not None:
            cols_mirror.dirty.add(view._row)

    # -------------------------------------------------------------- failure
    def fail(self, now: Optional[float] = None) -> list[Request]:
        """Worker dies: every held request must restart elsewhere — the
        host tier dies with its worker (it hangs off the same host), so
        parked/in-flight offloads are lost too, accounted exactly once
        (``offload_started`` entries are already in ``offloading``)."""
        self.view.alive = False
        lost = list(self.prefill_queue) + list(self.decode_running.values()) \
            + list(self.offloading.values()) + list(self.offloaded.values()) \
            + list(self.restoring.values())
        self.prefill_queue.clear()
        self.decode_running.clear()
        self.offload_started.clear()
        self.offloading.clear()
        self.offloaded.clear()
        self.restoring.clear()
        self._q_tokens = 0
        self._floor_counts.clear()
        self._floors_cache = {}
        self._batch_version += 1
        self._cols.dirty = True
        if self.prefix_cache is not None:
            self.prefix_cache.clear()   # entries died with the HBM
        self.view.kv_used_tokens = 0.0
        self.view.cached_prefixes = {}
        self.pages.reset()
        for r in lost:
            r.restarts += 1
            r.reset_for_reprefill(now)
        self._refresh_view()
        return lost
