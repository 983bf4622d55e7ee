"""ExecutionBackend — the narrow seam between scheduling and execution.

The ``ClusterScheduler`` never runs compute and never reads a wall clock;
it asks its backend to execute one composed iteration and report how long
it took (simulated or measured), and notifies it of the few lifecycle
events an execution substrate must mirror (request teardown, KV
migration). Everything else — dispatch, queueing, routing, role changes —
is backend-agnostic scheduler code.

Implementations:

* ``CostModelBackend`` — the analytical roofline clock (discrete-event
  simulation; default).
* ``CallableBackend`` — adapts a bare ``duration_fn(worker, plan)`` (the
  legacy ``Simulator.duration_fn`` hook, noise-injection experiments).
* ``TraceReplayBackend`` — streams a recorded/synthesised trace
  (``Scenario.replay`` / ``replay_csv`` iterators) into the driver lazily
  while an inner backend supplies durations: arrivals need never be
  materialised up front, which is how a recorded production trace with
  millions of requests replays in O(1) pending-arrival memory.
* ``RealJaxBackend`` (serving/executor.py) — actually runs the JAX model
  and measures wall-clock, or runs it under the cost-model clock for
  decision-parity tests against the simulator.
* ``CalibratedRooflineBackend`` (repro_torch.perf.calibrate) — the analytic
  clock re-instantiated from measured Pallas-kernel MFU/bandwidth.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Protocol, \
    runtime_checkable

from repro_torch.core.request import Request
from repro_torch.serving.engine import IterationPlan, Worker


class SlotExhausted(RuntimeError):
    """A backend ran out of per-worker KV slots for a new request.

    Raised by ``RealExecutor._slot`` (and any backend with bounded
    per-worker request state) BEFORE any compute runs, so the scheduler
    can treat it as a dispatch refusal — requeue the request globally and
    retry once a slot frees — rather than a crash. Carries the worker,
    the refused request, and the capacity so the refusal is loggable."""

    def __init__(self, wid: int, rid: int, max_slots: int):
        super().__init__(
            f"worker {wid}: no free KV slot for request {rid} "
            f"(max_slots={max_slots})")
        self.wid = wid
        self.rid = rid
        self.max_slots = max_slots


@runtime_checkable
class ExecutionBackend(Protocol):
    def run_iteration(self, worker: Worker, plan: IterationPlan) -> float:
        """Execute (or simulate) one iteration; return its duration in
        seconds of the driving clock."""
        ...

    def on_finish(self, req: Request) -> None:
        """Request left the cluster (finished, or restarting from scratch
        after KV loss): release any per-request execution state."""
        ...

    def on_migrate(self, req: Request, src_wid: int, dst_wid: int) -> None:
        """The request's KV just crossed the links: materialise it on the
        destination so decode can continue there."""
        ...


class CostModelBackend:
    """Pure simulation: durations from the worker's analytical cost model."""

    def run_iteration(self, worker: Worker, plan: IterationPlan) -> float:
        return worker.plan_duration(plan)

    def on_finish(self, req: Request) -> None:
        pass

    def on_migrate(self, req: Request, src_wid: int, dst_wid: int) -> None:
        pass


class CallableBackend:
    """Wrap a bare ``duration_fn(worker, plan) -> seconds``."""

    def __init__(self, duration_fn: Callable[[Worker, IterationPlan], float],
                 base: ExecutionBackend | None = None):
        self.duration_fn = duration_fn
        # lifecycle hooks forward to the backend being wrapped (if any), so
        # ``sim.duration_fn = noisy_fn`` layered over a real backend keeps
        # slot teardown/migration working
        self.base = base

    def run_iteration(self, worker: Worker, plan: IterationPlan) -> float:
        return self.duration_fn(worker, plan)

    def on_finish(self, req: Request) -> None:
        if self.base is not None:
            self.base.on_finish(req)

    def on_migrate(self, req: Request, src_wid: int, dst_wid: int) -> None:
        if self.base is not None:
            self.base.on_migrate(req, src_wid, dst_wid)


class TraceReplayBackend:
    """Replay a trace through the scheduler without materialising it.

    Wraps the ``(arrival_time, Request)`` iterator contract of
    ``repro_torch.workload.Scenario.replay`` / ``replay_csv`` (or any recorded
    stream in that shape) and an inner ``ExecutionBackend`` that supplies
    iteration durations (default: the analytical cost-model clock). The
    driver (``Simulator.add_replay``) pulls arrivals one at a time via
    ``next_arrival`` and keeps exactly one pending arrival event in its
    heap — a million-request production dump replays in constant memory,
    and the scheduling decisions are identical to pre-materialising the
    same stream with ``add_trace`` for time-sorted feeds with distinct
    timestamps (an arrival landing on exactly the same float second as
    another pending event tie-breaks by heap insertion order, which
    necessarily differs between the two feeds; continuous-time arrival
    processes never tie). Unsorted feeds raise ``ValueError``.
    """

    def __init__(self, replay: Iterable[tuple[float, Request]],
                 inner: Optional[ExecutionBackend] = None):
        self._iter: Iterator[tuple[float, Request]] = iter(replay)
        # remember whether the clock was defaulted: Simulator.add_replay
        # substitutes its configured backend for a defaulted inner, so a
        # pre-constructed TraceReplayBackend(feed) and a raw iterator get
        # the same physics (a custom duration_fn is never silently lost)
        self.inner_defaulted = inner is None
        self.inner: ExecutionBackend = inner or CostModelBackend()
        self.replayed = 0
        self._last_t = float("-inf")

    # ------------------------------------------------------- arrival stream
    def next_arrival(self) -> Optional[tuple[float, Request]]:
        """The next ``(arrival_time, Request)`` pair, or None when the
        trace is exhausted. Streaming keeps only ONE pending arrival, so
        the feed must be sorted by arrival time — an out-of-order item
        would move the driver's clock backwards and silently corrupt
        every now-derived metric. Raises ValueError instead (sort the
        trace, or use the materialising ``add_trace`` path, which heaps
        everything up front and tolerates any order)."""
        item = next(self._iter, None)
        if item is not None:
            if item[0] < self._last_t:
                raise ValueError(
                    f"trace-replay feed is not sorted by arrival time: "
                    f"got t={item[0]:.6f} after t={self._last_t:.6f} "
                    f"(rid={item[1].rid}); sort the trace or replay it "
                    f"via add_trace")
            self._last_t = item[0]
            self.replayed += 1
        return item

    # --------------------------------------------------- ExecutionBackend
    def run_iteration(self, worker: Worker, plan: IterationPlan) -> float:
        return self.inner.run_iteration(worker, plan)

    def on_finish(self, req: Request) -> None:
        self.inner.on_finish(req)

    def on_migrate(self, req: Request, src_wid: int, dst_wid: int) -> None:
        self.inner.on_migrate(req, src_wid, dst_wid)
