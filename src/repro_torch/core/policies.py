"""Scheduling policies: Tropical + the paper's three baselines.

A policy owns (a) worker role assignment, (b) global dispatch, and (c) the
per-iteration batch-composition rule its workers follow. The unified
``repro_torch.sched.ClusterScheduler`` consults the policy at every dispatch and
iteration boundary; execution backends (sim cost model or real JAX) are
orthogonal — see ``repro_torch.sched.backend.ExecutionBackend``.

  vllm       — non-disaggregated, prefill-prioritised full-prompt iterations
               (decode stalls behind prefill: the interference regime).
  sarathi    — non-disaggregated + chunked prefill (hybrid batches,
               chunk=2048 as profiled in the paper §V-A).
  distserve  — disaggregated: static P/D worker split, full-prompt prefill
               on P, pure decode batches on D, KV migration P->D.
  tropical   — SLO-aware multiplexing via the MultiplexingToggle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.predictor import Predictor
from repro_torch.core.request import Request
from repro_torch.core.toggle import MultiplexingToggle, Role, ToggleConfig, WorkerView


@dataclasses.dataclass(frozen=True)
class BatchRule:
    """What a worker may put in one iteration."""
    run_decode: bool
    prefill_budget: int            # max new prefill tokens this iteration
    prefill_exclusive: bool        # if True and prefill work exists, decode
                                   # is stalled (vLLM-style interference)


class Policy:
    name = "base"
    queue_discipline = "fcfs"     # what the real systems do; see engine
    toggle = None                 # policies owning a MultiplexingToggle set
                                  # this; the ClusterScheduler keys role
                                  # rebalancing and worker registration on it
    vectorized = False            # build_cluster(vectorized=True) flips this
                                  # (and the toggle's) to the batched paths

    def __init__(self, workers: Sequence[WorkerView], predictor: Predictor):
        self.workers = {w.wid: w for w in workers}
        self.predictor = predictor
        self.transfer = None          # set via attach_transfer

    def attach_transfer(self, transfer, kv_bytes_fn,
                        state_tokens_fn=None) -> None:
        """Give the policy visibility into the contended KV transfer engine
        (queue depths on worker links) and the cost model's HBM-footprint
        conversion. Baselines ignore it — DistServe's blind migration is
        exactly the cost the paper charges it."""
        self.transfer = transfer

    # --- dispatch ----------------------------------------------------------
    def dispatch_prefill(self, req: Request, now: float) -> Optional[int]:
        raise NotImplementedError

    def dispatch_decode(self, req: Request, now: float) -> Optional[int]:
        """Where decode continues after prefill. None = same worker."""
        return None

    # --- iteration composition ---------------------------------------------
    def batch_rule(self, w: WorkerView, now: float,
                   head: Optional[Request]) -> BatchRule:
        raise NotImplementedError

    def on_worker_failure(self, wid: int) -> None:
        self.workers[wid].alive = False

    def _alive(self, role: Optional[Role] = None):
        return [w for w in self.workers.values()
                if w.alive and (role is None or w.role == role)]

    def _least_loaded(self, ws):
        # InFaaS least-unfinished-tokens, normalised by the worker's
        # relative hardware speed: on a heterogeneous cluster the same
        # token backlog clears later on a straggler. Homogeneous speeds
        # are exactly 1.0, so orderings (and decisions) are unchanged.
        if not ws:
            return None
        if self.vectorized:
            # same keys, same first-wins tie-break: np.argmin returns the
            # first minimum exactly as min() keeps the first smallest
            loads = np.fromiter((w.unfinished_tokens / w.speed for w in ws),
                                dtype=np.float64, count=len(ws))
            return ws[int(np.argmin(loads))].wid
        return min(ws, key=lambda w: w.unfinished_tokens / w.speed).wid


# ---------------------------------------------------------------------------


class VLLMPolicy(Policy):
    """Colocated; InFaaS least-unfinished-token dispatch; prefill-priority."""
    name = "vllm"
    prefill_token_budget = 16384

    def dispatch_prefill(self, req, now):
        return self._least_loaded(self._alive())

    def batch_rule(self, w, now, head):
        return BatchRule(run_decode=True,
                         prefill_budget=self.prefill_token_budget,
                         prefill_exclusive=True)


class SarathiPolicy(Policy):
    """Colocated + chunked prefill: hybrid decode+chunk iterations."""
    name = "sarathi"

    def __init__(self, workers, predictor, chunk: int = 2048):
        super().__init__(workers, predictor)
        self.chunk = chunk

    def dispatch_prefill(self, req, now):
        return self._least_loaded(self._alive())

    def batch_rule(self, w, now, head):
        return BatchRule(run_decode=True, prefill_budget=self.chunk,
                         prefill_exclusive=False)


class DistServePolicy(Policy):
    """Static P/D split; decode always migrates to a D worker."""
    name = "distserve"
    prefill_token_budget = 16384

    def __init__(self, workers, predictor, n_prefill: Optional[int] = None):
        super().__init__(workers, predictor)
        ws = list(self.workers.values())
        n_p = n_prefill if n_prefill is not None else len(ws) // 2
        for i, w in enumerate(ws):
            w.role = Role.PREFILL if i < n_p else Role.MULTIPLEX

    def dispatch_prefill(self, req, now):
        wid = self._least_loaded(self._alive(Role.PREFILL))
        if wid is None:                     # note: wid 0 is a valid worker
            wid = self._least_loaded(self._alive())
        return wid

    def dispatch_decode(self, req, now):
        return self._least_loaded(self._alive(Role.MULTIPLEX))

    def batch_rule(self, w, now, head):
        if w.role == Role.PREFILL:
            return BatchRule(run_decode=False,
                             prefill_budget=self.prefill_token_budget,
                             prefill_exclusive=True)
        return BatchRule(run_decode=True, prefill_budget=0,
                         prefill_exclusive=False)


class TropicalPolicy(Policy):
    """SLO-aware multiplexing (the paper's contribution). The 'slack'
    queue discipline adds multi-tenant class-awareness: heterogeneous
    prefill queues serve tightest-relative-TTFT-slack first, while a
    single-class queue keeps the paper's exact FCFS order (decision
    parity with the pre-SLO-class scheduler)."""
    name = "tropical"
    queue_discipline = "slack"
    prefill_token_budget = 16384

    def __init__(self, workers, predictor, n_prefill: Optional[int] = None,
                 toggle_config: ToggleConfig = ToggleConfig()):
        super().__init__(workers, predictor)
        ws = list(self.workers.values())
        n_p = n_prefill if n_prefill is not None else len(ws) // 2
        for i, w in enumerate(ws):
            w.role = Role.PREFILL if i < n_p else Role.MULTIPLEX
        self.toggle = MultiplexingToggle(ws, predictor, toggle_config)
        # per-class typical TTFT SLO (EWMA over dispatched requests): live
        # multi-tenant traffic makes long loose-class prefills run chunked
        # so a tight-class arrival mid-iteration waits one chunk, not one
        # long-context prompt. Keyed by class NAME — per-request SLO
        # variation inside one class never triggers it, so single-class
        # runs keep the paper's full-prompt budget bit-exactly. An EWMA,
        # not a lifetime min: one short-prompt outlier with a derived
        # per-request SLO must not permanently ratchet the class's
        # tightness. Entries expire after class_ttl dispatches without
        # traffic: a departed tenant stops taxing the survivors.
        self._class_ttft: dict[str, float] = {}
        self._class_last_seen: dict[str, int] = {}
        self._dispatch_no = 0
        self.class_ttl = 1024
        self.class_ttft_alpha = 0.1

    def attach_transfer(self, transfer, kv_bytes_fn,
                        state_tokens_fn=None) -> None:
        super().attach_transfer(transfer, kv_bytes_fn, state_tokens_fn)
        self.toggle.transfer = transfer
        self.toggle.kv_bytes_fn = kv_bytes_fn
        self.toggle.state_tokens_fn = state_tokens_fn

    def dispatch_prefill(self, req, now):
        self._dispatch_no += 1
        name = req.slo.name
        prev = self._class_ttft.get(name)
        a = self.class_ttft_alpha
        self._class_ttft[name] = req.slo.ttft if prev is None \
            else (1.0 - a) * prev + a * req.slo.ttft
        self._class_last_seen[name] = self._dispatch_no
        for stale in [n for n, last in self._class_last_seen.items()
                      if self._dispatch_no - last > self.class_ttl]:
            del self._class_last_seen[stale]
            del self._class_ttft[stale]
        return self.toggle.dispatch_prefill(req, now)

    def _tightest_other_class_ttft(self, name: str) -> float:
        """Tightest typical TTFT among live classes OTHER than ``name``."""
        return min((t for n, t in self._class_ttft.items()
                    if n != name), default=float("inf"))

    def dispatch_decode(self, req, now):
        # decode stays in place on a multiplexing worker (Path ②); only
        # Path-① prefills migrate
        w = self.workers[req.worker]
        if w.role == Role.MULTIPLEX and w.alive:
            return None
        return self.toggle.dispatch_decode(req, now)

    def batch_rule(self, w, now, head):
        if w.role == Role.PREFILL:
            budget = self.prefill_token_budget
            # multi-tenant head-of-line guard: a looser-CLASS head must not
            # hold the worker for a whole long-context prompt when a
            # tighter class is queued behind it — or could arrive
            # mid-iteration (recently dispatched classes proxy for live
            # tenants). Chunking bounds the tight tenant's wait to one
            # chunk. Compared at class level (typical vs typical), so
            # intra-class SLO spread never flips it; single-class traffic
            # (no OTHER class live) keeps the paper's full-prompt budget.
            if head is not None:
                own = self._class_ttft.get(head.slo.name, head.slo.ttft)
                if own > self._tightest_other_class_ttft(head.slo.name) \
                        * (1.0 + 1e-9):
                    budget = self.toggle.cfg.chunk_tokens
            return BatchRule(run_decode=True, prefill_budget=budget,
                             prefill_exclusive=True)
        # multiplexing worker: piggyback a chunk only when slack allows
        if head is None:
            return BatchRule(run_decode=True, prefill_budget=0,
                             prefill_exclusive=False)
        if w.decode_batch == 0:
            return BatchRule(run_decode=True,
                             prefill_budget=self.prefill_token_budget,
                             prefill_exclusive=False)
        chunk = self.toggle.chunk_for(w, head.slo.tpot)
        take = min(chunk, head.remaining_prefill)
        # the chunk's true cost to the batch includes the §IV mixed-batch
        # contention penalty (exactly 0.0 under the legacy γ=0 model) —
        # the per-iteration insertion gate must price what dispatch
        # admission prices, or slack-blowing chunks slip in here
        t_chunk = self.predictor.predict_prefill(
            take, int(w.decode_sum_ctx), wid=w.wid) \
            + self.predictor.predict_interference(
                w.decode_batch, w.decode_sum_ctx, take,
                int(w.decode_sum_ctx), wid=w.wid)
        budget = max(w.min_tpot_slack, 0.0) / self.toggle.cfg.slack_safety
        if t_chunk <= budget:
            return BatchRule(run_decode=True, prefill_budget=chunk,
                             prefill_exclusive=False)
        return BatchRule(run_decode=True, prefill_budget=0,
                         prefill_exclusive=False)


class TropicalPPPolicy(TropicalPolicy):
    """Beyond-paper extensions on top of the faithful Tropical:
    * EDF + hopeless-last prefill queue order (SLO-aware queueing);
    * slack-sized prefill chunks instead of the fixed 2048 (§IV-B note:
      the paper uses a fixed chunk; sizing it to the currently banked
      slack extracts more multiplexing throughput at equal TPOT safety).
    Reported separately in EXPERIMENTS.md §Repro vs §Beyond."""
    name = "tropical++"
    queue_discipline = "edf"

    def __init__(self, workers, predictor, n_prefill: Optional[int] = None,
                 toggle_config: Optional[ToggleConfig] = None):
        super().__init__(
            workers, predictor, n_prefill,
            toggle_config or ToggleConfig(slack_chunking=True))


POLICIES = {
    "vllm": VLLMPolicy,
    "sarathi": SarathiPolicy,
    "distserve": DistServePolicy,
    "tropical": TropicalPolicy,
    "tropical++": TropicalPPPolicy,
}


def make_policy(name: str, workers, predictor, **kw) -> Policy:
    return POLICIES[name](workers, predictor, **kw)
