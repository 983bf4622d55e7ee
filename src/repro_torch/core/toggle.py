"""The Multiplexing Toggle (paper §IV) — Tropical's cluster scheduler.

Responsibilities (Fig. 6):
  * assignment: classify workers as PREFILL or MULTIPLEX;
  * dispatching: route requests
      Path ① -> prefill workers (queue-dominated regime),
      Path ② -> multiplexing workers directly (interference within budget);
  * track per-worker status: HBM watermark, local queue, decode batch,
    accumulated TPOT slack (§IV-B);
  * role transitions: P->M when every multiplexing worker is above the HBM
    watermark; M->P when prefill queuing persistently violates TTFT slack.
    Transitions only change *admission* — running decodes drain in place,
    so there is no migration/recompute overhead (the paper's asymmetry
    argument: D->P switching is the expensive direction and is avoided).
    Under the unified ClusterScheduler the event-driven, windowed
    ``repro_torch.sched.rebalance.RoleRebalancer`` owns this lifecycle and the
    dispatch-count ``review_roles`` here is disabled
    (``ToggleConfig.role_transitions=False``).

The toggle is executor-agnostic: it sees ``WorkerView`` state snapshots and
returns dispatch decisions; the engine (serving/engine.py) owns execution.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.predictor import Predictor
from repro_torch.core.request import Phase, Request


class Role(enum.Enum):
    PREFILL = "prefill"
    MULTIPLEX = "multiplex"


@dataclasses.dataclass
class WorkerView:
    """Scheduler-visible state of one worker (kept current by the engine).

    When a ``ViewColumns`` mirror is attached (vectorized dispatch), every
    field assignment marks this view's row dirty so the column arrays
    re-pull it before the next batched decision — writers (engine refresh,
    role transitions, failure paths) never need to know about the mirror.
    """
    wid: int
    role: Role
    # prefill side
    queued_prefill_tokens: int = 0          # tokens waiting in local queue
    queued_requests: int = 0
    # decode side
    decode_batch: int = 0                   # running decode requests
    decode_sum_ctx: float = 0.0
    min_tpot_slack: float = float("inf")    # min over running decodes
    decode_tpot_floor: dict = dataclasses.field(default_factory=dict)
                                            # class name -> tightest TPOT
                                            # SLO among running decodes of
                                            # that class: multi-tenant
                                            # admission must protect the
                                            # tightest *resident* class,
                                            # not just the arriving
                                            # request's
    # memory — token-level (legacy) and page-level (paged KV accounting)
    kv_used_tokens: float = 0.0
    kv_capacity_tokens: float = 1.0
    total_pages: int = 0                    # 0 = worker has no page pool
    free_pages: int = 0
    page_size: int = 16
    # host-DRAM tier (tiered KV): 0 pages = tier disabled, every tier-aware
    # branch below degenerates to the legacy evict-only decision
    host_total_pages: int = 0
    host_free_pages: int = 0
    # prefix cache: {prefix_key: cached tokens} resident on this worker +
    # the cache's EWMA hit-rate estimate (dispatch-score signal)
    cached_prefixes: dict = dataclasses.field(default_factory=dict)
    prefix_hit_ewma: float = 0.0
    alive: bool = True
    # hardware — relative throughput of this worker's HardwareSpec
    # (fastest worker in the cluster = 1.0; see repro_torch.perf.relative_speeds).
    # Load comparisons divide by it so "least loaded" means "finishes
    # soonest": a 2x-slow straggler with half the queue is NOT less loaded.
    # Homogeneous clusters have speed 1.0 everywhere, keeping every
    # ordering (and thus every decision) bit-identical to the pre-perf
    # scheduler.
    speed: float = 1.0

    # ViewColumns back-reference; CLASS attributes (not dataclass fields)
    # so unattached views — and the dataclass __init__'s own assignments,
    # which run before attach — resolve them without per-instance state.
    _cols = None
    _row = -1

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        c = self._cols
        if c is not None:
            c.dirty.add(self._row)

    def assign(self, **fields) -> None:
        """Bulk field update with ONE dirty-mark: the engine's per-event
        view refresh writes ~12 fields back to back, and marking the row
        once instead of per assignment keeps the mirror contract while
        dropping the redundant set-adds from the hottest write path."""
        setattr_ = object.__setattr__
        for name, value in fields.items():
            setattr_(self, name, value)
        c = self._cols
        if c is not None:
            c.dirty.add(self._row)

    @property
    def hbm_util(self) -> float:
        if self.total_pages > 0:
            return 1.0 - self.free_pages / self.total_pages
        return self.kv_used_tokens / max(self.kv_capacity_tokens, 1.0)

    def pages_for(self, tokens: float) -> int:
        from repro_torch.serving.kvcache import pages_for
        return pages_for(int(tokens), self.page_size)

    def page_headroom_for(self, tokens: float, watermark: float = 1.0) -> bool:
        """Would admitting ``tokens`` keep page usage under ``watermark``?
        True when the worker reports no page pool (token check governs)."""
        if self.total_pages <= 0:
            return True
        used_after = (self.total_pages - self.free_pages
                      + self.pages_for(tokens))
        return used_after <= watermark * self.total_pages

    @property
    def unfinished_tokens(self) -> float:
        """InFaaS-style load metric: fewest unfinished token count."""
        return self.queued_prefill_tokens + self.decode_sum_ctx


class ViewColumns:
    """Dirty-flagged structure-of-arrays mirror of the worker views.

    Batched dispatch reads whole per-worker columns (pages, KV usage,
    batch sizes, slack, load) as numpy arrays instead of re-gathering
    them from Python objects on every decision. ``WorkerView.__setattr__``
    marks a row dirty on ANY field write, and ``sync`` re-pulls exactly
    the dirty rows — one event touches one worker, so the per-dispatch
    sync cost is O(touched workers), not O(cluster). The dict-valued
    fields (``decode_tpot_floor``, ``cached_prefixes``) stay on the view
    objects; the few code paths that need them walk only the rows that
    survived the array gates."""

    def __init__(self, views: Sequence[WorkerView]):
        self.views = list(views)
        n = len(self.views)
        self.dirty: set = set()
        self.wid = np.empty(n, dtype=np.int64)
        self.total_pages = np.empty(n, dtype=np.int64)
        self.free_pages = np.empty(n, dtype=np.int64)
        self.page_size = np.empty(n, dtype=np.int64)
        self.decode_batch = np.empty(n, dtype=np.int64)
        self.queued_prefill_tokens = np.empty(n, dtype=np.int64)
        self.kv_used_tokens = np.empty(n, dtype=np.float64)
        self.kv_capacity_tokens = np.empty(n, dtype=np.float64)
        self.decode_sum_ctx = np.empty(n, dtype=np.float64)
        self.min_tpot_slack = np.empty(n, dtype=np.float64)
        self.speed = np.empty(n, dtype=np.float64)
        self.alive = np.empty(n, dtype=bool)
        self.is_prefill = np.empty(n, dtype=bool)
        for i, v in enumerate(self.views):
            self._pull(i, v)
            object.__setattr__(v, "_row", i)
            object.__setattr__(v, "_cols", self)

    def _pull(self, i: int, v: WorkerView) -> None:
        self.wid[i] = v.wid
        self.total_pages[i] = v.total_pages
        self.free_pages[i] = v.free_pages
        self.page_size[i] = v.page_size
        self.decode_batch[i] = v.decode_batch
        self.queued_prefill_tokens[i] = v.queued_prefill_tokens
        self.kv_used_tokens[i] = v.kv_used_tokens
        self.kv_capacity_tokens[i] = v.kv_capacity_tokens
        self.decode_sum_ctx[i] = v.decode_sum_ctx
        self.min_tpot_slack[i] = v.min_tpot_slack
        self.speed[i] = v.speed
        self.alive[i] = v.alive
        self.is_prefill[i] = v.role is Role.PREFILL

    def sync(self) -> None:
        if self.dirty:
            views = self.views
            for i in self.dirty:
                self._pull(i, views[i])
            self.dirty.clear()


@dataclasses.dataclass(frozen=True)
class ToggleConfig:
    hbm_watermark: float = 0.90         # stop Path-② above this
    hbm_admission: float = 0.85         # don't admit prefill into M above
    slack_safety: float = 1.2           # chunk must fit slack*1/safety
    decode_iter_guard: float = 0.8      # don't multiplex when decode iter
                                        # time > guard * TPOT_SLO (§IV-C)
    chunk_tokens: int = 2048            # chunked prefill on M workers
    migrate_stall_budget: float = 4.0   # TPOT budgets a migration stall may
                                        # burn (beyond banked slack) before
                                        # decode-in-place wins
    slack_chunking: bool = False        # beyond-paper: size chunk by slack
    min_chunk: int = 256
    queue_violation_window: int = 16    # dispatches between role reviews
    role_transitions: bool = True       # dispatch-count review_roles. The
                                        # ClusterScheduler turns this off
                                        # when its event-driven windowed
                                        # RoleRebalancer owns role lifecycle
                                        # (repro_torch.sched.rebalance)


class MultiplexingToggle:
    def __init__(self, workers: Sequence[WorkerView], predictor: Predictor,
                 config: ToggleConfig = ToggleConfig(),
                 transfer=None, kv_bytes_fn=None):
        self.workers = {w.wid: w for w in workers}
        self.predictor = predictor
        self.cfg = config
        # optional contended-transfer awareness (serving/transfer.py):
        # dispatch_decode penalises destinations whose migration would sit
        # behind deep link queues. kv_bytes_fn(ctx_tokens) -> bytes to move.
        self.transfer = transfer
        self.kv_bytes_fn = kv_bytes_fn
        # ctx tokens -> HBM-token footprint (sliding-window archs hold less
        # than their raw context); engines reserve pages in these units, so
        # the admission gates must too. None = identity (dense).
        self.state_tokens_fn = None
        self._ttft_pressure = 0           # recent Path-① slack violations
        self._dispatches = 0
        # batched dispatch: price a candidate against every worker in one
        # numpy evaluation (Predictor.predict_*_batch) instead of a
        # per-worker Python loop. Decisions are bit-identical either way
        # (tests/test_vectorized.py pins it); build_cluster(vectorized=...)
        # sets this, default off so the toggle alone stays scalar-shaped.
        self.vectorized = False
        self._columns: Optional[ViewColumns] = None   # lazy SoA mirror

    # ------------------------------------------------------------- helpers
    def _alive(self, role: Optional[Role] = None):
        return [w for w in self.workers.values()
                if w.alive and (role is None or w.role == role)]

    def chunk_for(self, w: WorkerView, tpot_slo: float) -> int:
        """Prefill chunk size admissible on multiplexing worker ``w``.

        beyond-paper: size the chunk to the current slack budget (the
        paper uses a fixed 2048 chunk). The cost of a candidate chunk
        includes the §IV contention penalty (0.0 under γ=0): sizing by
        the additive estimate alone would pick chunks the penalty then
        pushes over budget — rejected outright by the admission gates
        instead of shrunk to fit. Analytic predictors invert the budget
        in closed form (``Predictor.chunk_candidates`` + one batched
        verification); others bisect (``_chunk_for_bisect``)."""
        if not self.cfg.slack_chunking:
            return self.cfg.chunk_tokens
        cfg = self.cfg
        lo, hi = cfg.min_chunk, cfg.chunk_tokens
        budget = w.min_tpot_slack / cfg.slack_safety
        ictx = int(w.decode_sum_ctx)
        cand = self.predictor.chunk_candidates(
            [w.wid], lo, hi, np.array([budget]),
            np.array([float(w.decode_batch)]),
            np.array([w.decode_sum_ctx]), np.array([float(ictx)]))
        if cand is None:
            return self._chunk_for_bisect(w, tpot_slo)
        row = np.unique(cand[0])            # sorted; row[0] == lo
        wids = [w.wid] * row.size
        offs = np.full(row.size, ictx, dtype=np.int64)
        t = self.predictor.predict_prefill_batch(wids, row, offs)
        if w.decode_batch > 0:
            t = t + self.predictor.predict_interference_batch(
                wids, w.decode_batch, w.decode_sum_ctx, row, offs)
        feas = t <= budget
        if not feas[0]:     # the minimum chunk already busts the budget
            return lo
        return int(row[feas].max())

    def _chunk_for_bisect(self, w: WorkerView, tpot_slo: float) -> int:
        """Reference bisection for ``chunk_for``: the fallback for
        predictors with no closed form, and the test-time cross-check the
        closed-form path is pinned against (tests/test_vectorized.py)."""
        def chunk_cost(tokens: int) -> float:
            t = self.predictor.predict_prefill(tokens, int(w.decode_sum_ctx),
                                               wid=w.wid)
            if w.decode_batch > 0:
                t += self.predictor.predict_interference(
                    w.decode_batch, w.decode_sum_ctx, tokens,
                    int(w.decode_sum_ctx), wid=w.wid)
            return t

        lo, hi = self.cfg.min_chunk, self.cfg.chunk_tokens
        budget = w.min_tpot_slack / self.cfg.slack_safety
        if chunk_cost(lo) > budget:
            return lo
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if chunk_cost(mid) <= budget:
                lo = mid
            else:
                hi = mid - 1
        return lo

    # ----------------------------------------------------------- helpers
    def _cached_span(self, w: WorkerView, req: Request) -> int:
        """Tokens of ``req``'s prompt already resident in ``w``'s prefix
        cache — prefill there runs (and is priced on) only the uncached
        suffix. Capped at prompt_len - 1: one token always prefills (the
        first-token forward pass)."""
        if req.prefix_key is None or not w.cached_prefixes:
            return 0
        span = w.cached_prefixes.get(req.prefix_key, 0)
        return max(0, min(span, req.prefix_len, req.prompt_len - 1))

    def _tier_relief(self, w: WorkerView, req: Request,
                     need_tokens: float) -> bool:
        """HBM memory checks failed — admit anyway iff the host-DRAM tier
        can absorb a displaced resident decode AND pulling it back is
        predicted to cost less than the slack the batch has banked
        (``Predictor.predict_restore``: wire time + re-prefill residue).
        Without a tier (or an empty batch) this is False and the legacy
        evict-only admission decision stands."""
        if w.host_total_pages <= 0 or w.decode_batch <= 0:
            return False
        need_pages = w.pages_for(self._kv_need_tokens(need_tokens))
        if need_pages > w.host_free_pages:
            return False
        typical_ctx = int(w.decode_sum_ctx / w.decode_batch)
        stall = self.predictor.predict_restore(typical_ctx, wid=w.wid)
        return stall * self.cfg.slack_safety <= max(w.min_tpot_slack, 0.0)

    # ----------------------------------------------------------- Path ②
    def _multiplex_ok(self, w: WorkerView, req: Request) -> bool:
        """§IV-B / §IV-C admission: slack, decode-iter guard, HBM (with
        host-tier relief when offload+restore beats rejection)."""
        cfg = self.cfg
        if w.role != Role.MULTIPLEX or not w.alive:
            return False
        footprint = (req.prompt_len - self._cached_span(w, req)
                     + req.remaining_output)
        # page-granular headroom: block rounding + fragmentation can exhaust
        # allocatable pages well before the token counter says so
        mem_ok = (w.hbm_util <= cfg.hbm_admission
                  and w.kv_used_tokens + footprint
                  <= cfg.hbm_watermark * w.kv_capacity_tokens
                  and w.page_headroom_for(self._kv_need_tokens(footprint),
                                          cfg.hbm_watermark))
        if not mem_ok and not self._tier_relief(w, req, footprint):
            return False
        chunk = min(self.chunk_for(w, req.slo.tpot), req.remaining_prefill
                    or req.prompt_len)
        t_chunk = self.predictor.predict_prefill(chunk, int(w.decode_sum_ctx),
                                                 wid=w.wid)
        if w.decode_batch > 0:
            # §IV contention: the chunk's true cost to the batch includes
            # the super-additive mixed-batch penalty (exactly 0.0 under the
            # legacy γ=0 model, preserving decision parity)
            t_chunk += self.predictor.predict_interference(
                w.decode_batch, w.decode_sum_ctx, chunk,
                int(w.decode_sum_ctx), wid=w.wid)
            # per-iteration slack must absorb the inserted chunk
            if t_chunk * self.cfg.slack_safety > max(w.min_tpot_slack, 0.0):
                return False
            # decode batch already near the TPOT SLO -> no multiplexing.
            # Class-aware: the binding budget is the arriving request's own
            # TPOT SLO or the tightest resident of a *different* class
            # (its iterations absorb the inserted chunk too). Keyed on
            # class identity, so single-class traffic — whatever its
            # per-request SLO spread — stays the paper's per-request
            # check exactly.
            other = min((t for n, t in w.decode_tpot_floor.items()
                         if n != req.slo.name), default=float("inf"))
            t_iter = self.predictor.predict_decode_iter(
                w.decode_batch, w.decode_sum_ctx, wid=w.wid)
            if t_iter > cfg.decode_iter_guard * min(req.slo.tpot, other):
                return False
        return True

    # ----------------------------------------------------------- Path ①
    def _prefill_queue_time(self, w: WorkerView) -> float:
        return self.predictor.predict_prefill(max(w.queued_prefill_tokens, 0),
                                              wid=w.wid)

    def _prefill_ok(self, w: WorkerView, req: Request, now: float) -> bool:
        suffix = req.prompt_len - self._cached_span(w, req)
        t_exec = self.predictor.predict_prefill(suffix, wid=w.wid)
        t_queue = self._prefill_queue_time(w)
        return t_queue + t_exec <= req.ttft_deadline_slack(now)

    # ---------------------------------------------------------- dispatch
    def _predict_ttft_on_prefill(self, w: WorkerView, req: Request) -> float:
        # prefill is priced on the UNCACHED suffix: workers already holding
        # the request's prefix predict a shorter TTFT and win dispatch
        suffix = req.prompt_len - self._cached_span(w, req)
        return self._prefill_queue_time(w) \
            + self.predictor.predict_prefill(suffix, wid=w.wid)

    def _predict_ttft_on_multiplex(self, w: WorkerView, req: Request) -> float:
        """Chunked-prefill completion on an M worker: each chunk is admitted
        once the batch has re-banked ~chunk_time of slack, i.e. the prefill
        advances at chunk/(t_chunk + catchup) tokens/s."""
        chunk = self.cfg.chunk_tokens
        t_chunk = self.predictor.predict_prefill(chunk, int(w.decode_sum_ctx),
                                                 wid=w.wid)
        if w.decode_batch > 0:
            # interference slows the chunk's effective advance rate too
            t_chunk += self.predictor.predict_interference(
                w.decode_batch, w.decode_sum_ctx, chunk,
                int(w.decode_sum_ctx), wid=w.wid)
        base = self.predictor.predict_decode_iter(
            max(w.decode_batch, 1), w.decode_sum_ctx, wid=w.wid)
        margin = max(req.slo.tpot - base, 1e-3)
        catchup = t_chunk / margin * base        # iterations to re-bank
        rate = chunk / (t_chunk + catchup)
        queue = w.queued_prefill_tokens / max(rate, 1.0)
        suffix = req.prompt_len - self._cached_span(w, req)
        return queue + suffix / max(rate, 1.0)

    # ------------------------------------------------- vectorized dispatch
    # The batched twins of chunk_for / _multiplex_ok / the TTFT predictors:
    # per-worker state comes from the dirty-synced ``ViewColumns`` mirror
    # (no Python re-gathering), and the candidate is priced against ALL
    # workers in one Predictor.*_batch evaluation. Every arithmetic
    # expression mirrors its scalar twin operation-for-operation (same
    # association order, same masked terms), so selections are
    # bit-identical — tests/test_vectorized.py pins decision parity.

    def _cols_sync(self) -> ViewColumns:
        c = self._columns
        if c is None:
            c = self._columns = ViewColumns(list(self.workers.values()))
        elif c.dirty:
            c.sync()
        return c

    def _chunk_for_vec(self, c: ViewColumns, gidx: np.ndarray,
                       tpot_slo: float) -> np.ndarray:
        """``chunk_for`` for many workers. Analytic predictors invert the
        slack budget in closed form: ``Predictor.chunk_candidates`` emits
        every chunk size where feasibility can flip (quadratic roots of
        the piecewise roofline+penalty cost, plus structural breakpoints)
        and ONE batched cost evaluation over rows × candidates verifies
        them — where the lockstep bisection issued ~12. Predictors with
        no closed form fall back to ``_chunk_for_vec_bisect``."""
        cfg = self.cfg
        n = gidx.size
        if not cfg.slack_chunking:
            return np.full(n, cfg.chunk_tokens, dtype=np.int64)
        sumctx = c.decode_sum_ctx[gidx]
        ictx = sumctx.astype(np.int64)
        batch = c.decode_batch[gidx]
        lo, hi = cfg.min_chunk, cfg.chunk_tokens
        budget = c.min_tpot_slack[gidx] / cfg.slack_safety
        cand = self.predictor.chunk_candidates(
            c.wid[gidx].tolist(), lo, hi, budget, batch.astype(np.float64),
            sumctx, ictx.astype(np.float64))
        if cand is None:
            return self._chunk_for_vec_bisect(c, gidx, tpot_slo)
        k = cand.shape[1]
        toks = cand.ravel()
        wrep = np.repeat(c.wid[gidx], k).tolist()
        offs = np.repeat(ictx, k)
        t = self.predictor.predict_prefill_batch(wrep, toks, offs)
        has_b = batch > 0
        if bool(has_b.any()):
            t_int = self.predictor.predict_interference_batch(
                wrep, np.repeat(batch, k), np.repeat(sumctx, k), toks, offs)
            t = t + np.where(np.repeat(has_b, k), t_int, 0.0)
        feas = (t <= np.repeat(budget, k)).reshape(n, k)
        best = np.where(feas, cand, lo).max(axis=1)
        # a row whose minimum chunk busts the budget returns min_chunk
        # outright (bisection semantics); lo is always a candidate
        lo_ok = np.where(cand == lo, feas, False).any(axis=1)
        return np.where(lo_ok, best, lo).astype(np.int64)

    def _chunk_for_vec_bisect(self, c: ViewColumns, gidx: np.ndarray,
                              tpot_slo: float) -> np.ndarray:
        """Reference lockstep masked binary search for ``_chunk_for_vec``
        (fallback + test-time cross-check). Rows converge at different
        interval lengths, so finished rows (lo == hi) freeze under an
        active mask while the rest keep bisecting; frozen rows re-price
        at ``lo`` (pure, discarded)."""
        cfg = self.cfg
        n = gidx.size
        if not cfg.slack_chunking:
            return np.full(n, cfg.chunk_tokens, dtype=np.int64)
        wids = c.wid[gidx].tolist()
        sumctx = c.decode_sum_ctx[gidx]
        ictx = sumctx.astype(np.int64)
        batch = c.decode_batch[gidx]
        has_b = batch > 0
        any_b = bool(has_b.any())

        def chunk_cost(tokens: np.ndarray) -> np.ndarray:
            t = self.predictor.predict_prefill_batch(wids, tokens, ictx)
            if any_b:
                t_int = self.predictor.predict_interference_batch(
                    wids, batch, sumctx, tokens, ictx)
                t = t + np.where(has_b, t_int, 0.0)
            return t

        lo = np.full(n, cfg.min_chunk, dtype=np.int64)
        hi = np.full(n, cfg.chunk_tokens, dtype=np.int64)
        budget = c.min_tpot_slack[gidx] / cfg.slack_safety
        # rows whose minimum chunk already busts the budget return min_chunk
        hi = np.where(chunk_cost(lo) > budget, lo, hi)
        active = lo < hi
        while np.any(active):
            mid = (lo + hi + 1) // 2
            fits = chunk_cost(np.where(active, mid, lo)) <= budget
            lo = np.where(active & fits, mid, lo)
            hi = np.where(active & ~fits, mid - 1, hi)
            active = lo < hi
        return lo

    def _other_floor_vec(self, c: ViewColumns, gidx: np.ndarray,  # lint: parity-ref(_multiplex_ok)
                         name: str) -> np.ndarray:
        """Tightest resident TPOT SLO of a *different* class, per row.
        The floor dicts stay Python-side; single-class rows (empty dict or
        only the arriving class — the overwhelmingly common shape) resolve
        without building a generator."""
        inf = float("inf")
        out = np.empty(gidx.size, dtype=np.float64)
        views = c.views
        for j, i in enumerate(gidx.tolist()):
            fl = views[i].decode_tpot_floor
            if not fl or (name in fl and len(fl) == 1):
                out[j] = inf
            elif name not in fl:
                out[j] = min(fl.values())
            else:
                out[j] = min(t for nm, t in fl.items() if nm != name)
        return out

    def _multiplex_ok_vec(self, c: ViewColumns, midx: np.ndarray,
                          req: Request) -> np.ndarray:
        """``_multiplex_ok`` over all M workers at once — returns the
        admissible rows of ``midx``. The memory gates run as column
        arithmetic (the footprint is one scalar when the request carries
        no prefix key — the common case); the predictor-priced chunk and
        iteration gates run as one batched evaluation over the rows that
        survive. Only the rare tier-relief fallback (mem-failing rows that
        actually have a host tier and a resident batch) drops to the
        scalar helper with its restore prediction."""
        cfg = self.cfg
        total = c.total_pages[midx]
        free = c.free_pages[midx]
        used = c.kv_used_tokens[midx]
        cap = c.kv_capacity_tokens[midx]
        ps = c.page_size[midx]
        if req.prefix_key is None:
            # no prefix -> every cached span is 0 -> uniform footprint
            fparr = req.prompt_len + req.remaining_output
            kvi = max(int(self._kv_need_tokens(fparr)), 0)
        else:
            fparr = np.array(
                [req.prompt_len - self._cached_span(c.views[i], req)
                 + req.remaining_output for i in midx.tolist()],
                dtype=np.int64)
            if self.state_tokens_fn is None:
                kvi = np.maximum(fparr, 0)
            else:
                kvi = np.maximum(np.fromiter(
                    (int(self.state_tokens_fn(int(f)))
                     for f in fparr.tolist()), np.int64, midx.size), 0)
        # pages_for, vectorised: ceil-div by the (clamped) page size
        pages = -(-kvi // np.maximum(ps, 1))
        util = np.where(total > 0, 1.0 - free / np.maximum(total, 1),
                        used / np.maximum(cap, 1.0))
        ok = ((util <= cfg.hbm_admission)
              & (used + fparr <= cfg.hbm_watermark * cap)
              & ((total <= 0)
                 | (total - free + pages <= cfg.hbm_watermark * total)))
        if not ok.all():
            for j in np.nonzero(~ok)[0].tolist():
                w = c.views[midx[j]]
                # replicate _tier_relief's own cheap pre-checks so tierless
                # rows never pay the predictor call
                if w.host_total_pages > 0 and w.decode_batch > 0:
                    f = fparr if req.prefix_key is None else int(fparr[j])
                    ok[j] = self._tier_relief(w, req, f)
        gidx = midx[ok] if not ok.all() else midx
        if gidx.size == 0:
            return gidx
        batch = c.decode_batch[gidx]
        has_b = batch > 0
        if not has_b.any():
            return gidx        # no decode batches: the chunk gates all pass
        # only rows with a resident decode batch can fail the chunk gates,
        # so the predictor-priced tail runs on that subset alone — the
        # evaluations are elementwise, so each surviving row's values are
        # bit-identical to a full-width evaluation
        bidx = np.nonzero(has_b)[0]
        sub = gidx[bidx]
        wids = c.wid[sub].tolist()
        batch_b = batch[bidx]
        sumctx = c.decode_sum_ctx[sub]
        ictx = sumctx.astype(np.int64)
        rp = req.remaining_prefill or req.prompt_len
        if cfg.slack_chunking:
            chunks = np.minimum(
                self._chunk_for_vec(c, sub, req.slo.tpot), rp)
        else:
            chunks = min(cfg.chunk_tokens, rp)   # uniform: scalar broadcast
        t_chunk = self.predictor.predict_prefill_batch(wids, chunks, ictx)
        t_int = self.predictor.predict_interference_batch(
            wids, batch_b, sumctx, chunks, ictx)
        t_chunk = t_chunk + t_int
        slack_arr = np.maximum(c.min_tpot_slack[sub], 0.0)
        other = self._other_floor_vec(c, sub, req.slo.name)
        t_iter = self.predictor.predict_decode_iter_batch(
            wids, batch_b, sumctx)
        fail = ((t_chunk * cfg.slack_safety > slack_arr)
                | (t_iter > cfg.decode_iter_guard
                   * np.minimum(req.slo.tpot, other)))
        if not fail.any():
            return gidx
        keep = np.ones(gidx.size, dtype=bool)
        keep[bidx[fail]] = False
        return gidx[keep]

    def _ttft_prefill_vec(self, c: ViewColumns, pidx: np.ndarray,  # lint: parity-ref(_predict_ttft_on_prefill)
                          req: Request) -> np.ndarray:
        # queue + exec priced in ONE stacked batch call (rows 0..n-1 the
        # queue drains, rows n..2n-1 the uncached suffixes), then the
        # halves are summed — elementwise, so bit-identical to two calls
        n = pidx.size
        wids = c.wid[pidx].tolist()
        qtok = np.maximum(c.queued_prefill_tokens[pidx], 0)
        if req.prefix_key is None:
            stok = np.full(n, req.prompt_len, dtype=np.int64)
        else:
            stok = np.array(
                [req.prompt_len - self._cached_span(c.views[i], req)
                 for i in pidx.tolist()], dtype=np.int64)
        t = self.predictor.predict_prefill_batch(
            wids + wids, np.concatenate([qtok, stok]))
        return t[:n] + t[n:]

    def _ttft_multiplex_vec(self, c: ViewColumns, gidx: np.ndarray,  # lint: parity-ref(_predict_ttft_on_multiplex)
                            req: Request) -> np.ndarray:
        cfg = self.cfg
        wids = c.wid[gidx].tolist()
        sumctx = c.decode_sum_ctx[gidx]
        ictx = sumctx.astype(np.int64)
        batch = c.decode_batch[gidx]
        chunk = cfg.chunk_tokens
        t_chunk = self.predictor.predict_prefill_batch(wids, chunk, ictx)
        has_b = batch > 0
        if has_b.any():
            # price interference only where a decode batch exists; the
            # other rows add an exact 0.0 either way
            bidx = np.nonzero(has_b)[0]
            t_int = np.zeros(gidx.size)
            t_int[bidx] = self.predictor.predict_interference_batch(
                c.wid[gidx[bidx]].tolist(), batch[bidx], sumctx[bidx],
                chunk, ictx[bidx])
            t_chunk = t_chunk + t_int
        base = self.predictor.predict_decode_iter_batch(
            wids, np.maximum(batch, 1), sumctx)
        margin = np.maximum(req.slo.tpot - base, 1e-3)
        catchup = t_chunk / margin * base
        rate = chunk / (t_chunk + catchup)
        queued = c.queued_prefill_tokens[gidx]
        if req.prefix_key is None:
            suffix = float(req.prompt_len)     # uniform: scalar broadcast
        else:
            suffix = np.array(
                [req.prompt_len - self._cached_span(c.views[i], req)
                 for i in gidx.tolist()], dtype=np.float64)
        floor = np.maximum(rate, 1.0)
        return queued / floor + suffix / floor

    def _dispatch_prefill_vec(self, req: Request,
                              now: float) -> Optional[int]:
        slack = req.ttft_deadline_slack(now)
        c = self._cols_sync()
        live = c.alive
        pidx = np.nonzero(live & c.is_prefill)[0]
        midx = np.nonzero(live & ~c.is_prefill)[0]
        parts: list[np.ndarray] = []
        wids: list[int] = []
        if pidx.size:
            parts.append(self._ttft_prefill_vec(c, pidx, req))
            wids.extend(c.wid[pidx].tolist())
        if midx.size:
            gidx = self._multiplex_ok_vec(c, midx, req)
            if gidx.size:
                parts.append(self._ttft_multiplex_vec(c, gidx, req))
                wids.extend(c.wid[gidx].tolist())
        if not wids:
            m_any = [c.views[i] for i in midx.tolist()] or self._alive()
            if not m_any:
                return None
            self._ttft_pressure += 1
            return min(m_any, key=lambda w: w.unfinished_tokens / w.speed).wid
        t = parts[0] if len(parts) == 1 else np.concatenate(parts)
        in_slo = np.nonzero(t <= slack)[0]
        if in_slo.size:
            return wids[int(in_slo[int(np.argmin(t[in_slo]))])]
        self._ttft_pressure += 1
        return wids[int(np.argmin(t))]

    def _dispatch_decode_vec(self, req: Request,
                             now: float) -> Optional[int]:
        cfg = self.cfg
        c = self._cols_sync()
        midx = np.nonzero(c.alive & ~c.is_prefill)[0]
        cidx = midx
        if midx.size:
            need = req.context_len + req.remaining_output
            kvi = max(int(self._kv_need_tokens(need)), 0)
            total = c.total_pages[midx]
            free = c.free_pages[midx]
            # pages_for, vectorised: ceil-div by the (clamped) page size
            pages = -(-kvi // np.maximum(c.page_size[midx], 1))
            fits = ((c.kv_used_tokens[midx] + need
                     <= cfg.hbm_watermark * c.kv_capacity_tokens[midx])
                    & ((total <= 0)
                       | (total - free + pages
                          <= cfg.hbm_watermark * total)))
            if not fits.all():
                cidx = midx[fits]
        if cidx.size == 0:
            src = self.workers.get(req.worker) \
                if req.worker is not None else None
            if src is not None and src.alive:
                return None
            cidx = midx            # src dead: least-bad
        if cidx.size == 0:
            return None
        tpot = max(req.slo.tpot, 1e-6)
        cw = c.wid[cidx]
        if self.transfer is None or self.kv_bytes_fn is None \
                or req.worker is None:
            remote = None
        else:
            remote = cw != req.worker
        if remote is None or not remote.any():
            # matches the scalar short-circuit exactly: src == dst (or no
            # transfer awareness) never touches the engine, so its drain
            # arithmetic stays untouched too
            stalls = np.zeros(cidx.size)
        else:
            nbytes = self.kv_bytes_fn(req.context_len)
            stalls = np.zeros(cidx.size)
            stalls[remote] = self.transfer \
                .predict_transfer_times(req.worker, cw[remote], nbytes,
                                        now=now)
        q = stalls / tpot
        # int(q) truncates; q >= 0 so trunc == floor == int()
        bucket = np.where(np.isinf(stalls), q, np.trunc(q))
        load = (c.queued_prefill_tokens[cidx] + c.decode_sum_ctx[cidx]) \
            / c.speed[cidx]
        # lexsort: last key is primary -> (bucket, load, wid) tuple order;
        # wid is unique, so ties resolve identically to the scalar min
        best = int(np.lexsort((cw, load, bucket))[0])
        if req.worker is not None and float(stalls[best]) > \
                req.tpot_slack + cfg.migrate_stall_budget * tpot:
            return None
        return int(cw[best])

    def dispatch_prefill(self, req: Request, now: float) -> Optional[int]:
        """Choose the worker minimising predicted TTFT among SLO-admissible
        paths (Path ① prefill workers / Path ② multiplexing workers); the
        per-path admission checks of §IV-B/C gate candidacy."""
        self._dispatches += 1
        if self.cfg.role_transitions and \
                self._dispatches % self.cfg.queue_violation_window == 0:
            self.review_roles(now)
        if self.vectorized:
            return self._dispatch_prefill_vec(req, now)

        slack = req.ttft_deadline_slack(now)
        cands: list[tuple[float, int, bool]] = []   # (t_pred, wid, in_slo)
        for w in self._alive(Role.PREFILL):
            t = self._predict_ttft_on_prefill(w, req)
            cands.append((t, w.wid, t <= slack))
        for w in self._alive(Role.MULTIPLEX):
            if self._multiplex_ok(w, req):
                t = self._predict_ttft_on_multiplex(w, req)
                cands.append((t, w.wid, t <= slack))
        if not cands:
            m_any = self._alive(Role.MULTIPLEX) or self._alive()
            if not m_any:
                return None
            self._ttft_pressure += 1
            return min(m_any, key=lambda w: w.unfinished_tokens / w.speed).wid
        ok = [c for c in cands if c[2]]
        if not ok:
            self._ttft_pressure += 1
        pick = min(ok or cands, key=lambda c: c[0])
        return pick[1]

    def _kv_need_tokens(self, ctx_tokens: float) -> float:
        """Raw context tokens -> HBM-token footprint, matching the units
        the engine's PageAccountant reserves in."""
        if self.state_tokens_fn is None:
            return ctx_tokens
        return self.state_tokens_fn(int(ctx_tokens))

    def _transfer_stall(self, src_wid: Optional[int], dst: WorkerView,
                        req: Request, now: float) -> float:
        """Predicted seconds the migrated KV sits on the wire behind the
        source's egress queue and ``dst``'s ingress queue."""
        if self.transfer is None or self.kv_bytes_fn is None \
                or src_wid is None or src_wid == dst.wid:
            return 0.0
        nbytes = self.kv_bytes_fn(req.context_len)
        return self.transfer.predict_transfer_time(src_wid, dst.wid, nbytes,
                                                   now=now)

    def dispatch_decode(self, req: Request, now: float) -> Optional[int]:
        """After Path-① prefill completes: pick a multiplexing worker for the
        decode phase (KV migrates). InFaaS least-unfinished-tokens, tempered
        by predicted transfer time: a destination whose links are backed up
        stalls the first decode tokens however idle its batch is, so stall
        (quantised to TPOT budgets — the granularity at which it burns
        slack) ranks ahead of queue depth."""
        if self.vectorized:
            return self._dispatch_decode_vec(req, now)
        need = req.context_len + req.remaining_output
        cands = [w for w in self._alive(Role.MULTIPLEX)
                 if w.kv_used_tokens + need
                 <= self.cfg.hbm_watermark * w.kv_capacity_tokens
                 and w.page_headroom_for(self._kv_need_tokens(need),
                                         self.cfg.hbm_watermark)]
        if not cands:
            # every M worker is page/watermark-full: migrating would pay the
            # wire transfer only for admit_migrated to reject it (restart +
            # full re-prefill). Decode in place while the source lives — it
            # still holds the request's pages at dispatch time.
            src = self.workers.get(req.worker) \
                if req.worker is not None else None
            if src is not None and src.alive:
                return None
            cands = self._alive(Role.MULTIPLEX)   # src dead: least-bad
        if not cands:
            return None
        tpot = max(req.slo.tpot, 1e-6)
        best_key, best_w, best_stall = None, None, 0.0
        for w in cands:
            stall = self._transfer_stall(req.worker, w, req, now)
            bucket = stall / tpot if math.isinf(stall) else int(stall / tpot)
            # load normalised by the destination's speed: tokens on a slow
            # worker take proportionally longer to clear the runway
            key = (bucket, w.unfinished_tokens / w.speed, w.wid)
            if best_key is None or key < best_key:
                best_key, best_w, best_stall = key, w, stall
        # §IV asymmetry: when even the best link queue would burn more TPOT
        # budget than the request has banked (plus a bounded forward
        # credit), keep decoding in place — the source worker multiplexes
        # the decode rather than drowning it on the wire
        if req.worker is not None and best_stall > \
                req.tpot_slack + self.cfg.migrate_stall_budget * tpot:
            return None
        return best_w.wid

    # ------------------------------------------------------ role management
    def review_roles(self, now: float) -> None:
        """§IV-C: all M workers above watermark -> P becomes M; persistent
        prefill TTFT pressure -> one M (least decode load) becomes P."""
        cfg = self.cfg
        m = self._alive(Role.MULTIPLEX)
        p = self._alive(Role.PREFILL)
        if m and all(w.hbm_util > cfg.hbm_watermark for w in m) and p:
            conv = min(p, key=lambda w: w.queued_prefill_tokens)
            conv.role = Role.MULTIPLEX
            self._ttft_pressure = 0
            return
        if self._ttft_pressure >= cfg.queue_violation_window and len(m) > 1:
            conv = min(m, key=lambda w: w.decode_batch)
            if conv.hbm_util < 0.5:
                conv.role = Role.PREFILL
        self._ttft_pressure = 0

    # --------------------------------------------------------------- faults
    def on_worker_failure(self, wid: int) -> None:
        if wid in self.workers:
            self.workers[wid].alive = False

    def on_worker_recovered(self, wid: int, role: Role) -> None:
        w = self.workers.get(wid)
        if w is not None:
            w.alive = True
            w.role = role
