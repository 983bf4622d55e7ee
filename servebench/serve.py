"""One window of the port's serving stack, driven as ``repro_torch/launch/
serve.py::run`` builds it in ``--mode real``: ``build_cluster`` with the
cell's policy and workers, each priced as an H100 with the card's memory,
and ``ClusterRealExecutors`` behind ``RealTorchBackend(clock="wall")`` as
the scheduler's backend. The benchmark builds these itself, to hold the
window's wall time and to give the executors the cell's slots and weights.

The window: arrivals, timed on the scheduler's clock, stream in
(``Simulator.add_replay``) while less than ``offer_share`` of the window's
wall seconds have passed; then the window drains. It closes at
``seconds`` of wall time or when every offered request has finished,
whichever is first. ``Simulator.run`` is stepped in slices of
``SLICE_S`` scheduler seconds, the wall clock read between them. Every
iteration ends in a device-to-host copy, so the card is idle between
slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Optional

import numpy as np

from servebench import stats, traffic

SLICE_S = 0.05


def prefill_keys(buckets, max_prompt: int, slots: int, budget: int) -> list:
    """Every ("prefill", bucket, rows) step the executor can be asked for:
    a bucket's parts each take more tokens than the bucket below holds (the
    first bucket's from 1), at most ``budget`` tokens in one iteration
    (the policy's prefill budget) and one part a slot; rows are the parts
    rounded up to a power of two."""
    keys, prev = [], 0
    for b in buckets:
        if prev + 1 > max_prompt:
            break
        most = slots if prev == 0 else min(slots, budget // (prev + 1))
        rows = 1
        while True:
            keys.append(("prefill", b, rows))
            if rows >= most:
                break
            rows *= 2
        prev = b
    return keys


class Port:
    """The system under test: the cluster of executors over the benchmark's
    weights, every step it will run captured before the window."""

    def __init__(self, cell, weights: dict, device):
        from repro_torch.serving.executor import ClusterRealExecutors
        self.cell = cell
        self.cfg = cell.config.port_config()
        self.execs = ClusterRealExecutors(
            self.cfg, cell.workers, max_slots=cell.slots,
            max_len=cell.max_len, warmup=False, device=device,
            params=weights)
        self.kernels = self.execs.kernels

    def keys(self) -> list:
        from repro_torch.core.policies import POLICIES
        budget = POLICIES[self.cell.policy].prefill_token_budget
        return prefill_keys(self.kernels.buckets, self.cell.mix.prompt["max"],
                            self.cell.slots, budget) + [("decode",)]

    def warm(self) -> int:
        """Run (on the card: capture) every key once on every worker's
        cache with placeholder inputs, then zero the caches. Returns the
        number of steps run."""
        import torch
        keys = self.keys()
        params, k = self.execs.params, self.kernels
        for e in self.execs.execs.values():
            for key in keys:
                n = sum(int(np.prod(s)) for s in k.input_shapes(key))
                flat = torch.zeros((n,), dtype=torch.int32, device=k.device)
                if key[0] == "prefill":
                    flat[-key[2]:] = 1                     # takes
                k.step(params, e.cache, key, flat)
            for a in e.cache.values():
                a.zero_()
        if k.device.type == "cuda":
            torch.cuda.synchronize(k.device)
        return len(keys) * len(self.execs.execs)

    def reset(self) -> None:
        """Forget every request and zero the caches, keeping the captured
        steps (for a further window in the same process)."""
        self.execs._owner.clear()
        for e in self.execs.execs.values():
            e.free_slots = list(range(e.max_slots))
            e.slot_of.clear()
            e.lengths[:] = 0
            e.prompts.clear()
            e.generated.clear()
            for a in e.cache.values():
                a.zero_()

    def tokens(self, rid: int) -> list:
        """The tokens the port served to ``rid``: the longest of its
        executors' lists (a migrated request's source keeps a prefix)."""
        best: list = []
        for e in self.execs.execs.values():
            got = e.generated.get(rid, [])
            if len(got) > len(best):
                best = list(got)
        return best

    def free(self) -> None:
        import torch
        self.execs = self.kernels = None
        gc.collect()
        torch.cuda.empty_cache()


class Recorder:
    """The scheduler's backend: the port's ``RealTorchBackend``, timed at
    this seam. With ``record``, each iteration's kernel calls and model
    FLOPs are worked out from its plan and the executor's slots by the
    configuration's architecture (its ``count``)."""

    def __init__(self, inner, execs, config, region: Callable,
                 record: bool = False):
        self.inner, self.execs = inner, execs
        self.shape, self.count = config.shape(), config.arch.count
        self.region, self.record = region, record
        self.iter_wall = 0.0
        self.count_wall = 0.0         # the benchmark's own counting
        self.iterations = 0
        self.with_prefill = 0         # iterations with a prefill part
        self.with_decode = 0          # iterations with decoding rows
        self.ridden: set = set()      # rids with a chunk on a decode batch
        # (kind, flops, bytes): a kernel call of one layer, or an
        # iteration's model FLOPs ("step")
        self.calls: list = []

    def run_iteration(self, worker, plan) -> float:
        parts = [(r, int(r.prefilled_tokens), take)
                 for r, take in plan.prefill_parts]
        if parts and plan.decode_reqs:
            self.ridden.update(r.rid for r, _, _ in parts)
        t0 = time.perf_counter()
        with self.region("servebench.run_iteration"):
            out = self.inner.run_iteration(worker, plan)
        self.iter_wall += time.perf_counter() - t0
        self.iterations += 1
        self.with_prefill += bool(parts)
        self.with_decode += bool(plan.decode_reqs)
        if self.record:
            t1 = time.perf_counter()
            self._count(worker.wid, plan, parts)
            self.count_wall += time.perf_counter() - t1
        return out

    def _count(self, wid: int, plan, parts) -> None:
        """The work the iteration's requests need: each prefill part with
        the bucket the executor groups it in (one kernel call a bucket),
        and the decoding rows' lengths (the executor's slot lengths after
        the step, the new key included)."""
        e = self.execs.execs[wid]
        parts = [(e.kernels.bucket_for(take), start, take,
                  start + take >= r.prompt_len) for r, start, take in parts]
        lengths = [int(e.lengths[e.slot_of[r.rid]])
                   for r in plan.decode_reqs]
        cols = int(e.max_len // np.gcd(e.max_len, 64))
        self.calls += self.count(self.shape, parts, lengths, cols)

    def on_finish(self, req) -> None:
        self.inner.on_finish(req)

    def on_migrate(self, req, src_wid: int, dst_wid: int) -> None:
        self.inner.on_migrate(req, src_wid, dst_wid)


class Feed:
    """The arrival stream the simulator pulls one request at a time, until
    ``open`` is cleared."""

    def __init__(self, arrivals: list, make: Callable):
        self.arrivals, self.make = arrivals, make
        self.i = 0
        self.open = True

    def __iter__(self):
        return self

    def __next__(self):
        if not self.open or self.i >= len(self.arrivals):
            raise StopIteration
        a = self.arrivals[self.i]
        self.i += 1
        return a.time, self.make(a)


@dataclasses.dataclass
class Window:
    served: list
    requests: list               # the port's Request of each offered one
    close: float                 # scheduler time when it closed
    wall_s: float
    recorder: Recorder
    backend: object              # the port's RealTorchBackend
    workers: dict
    captures: int                # steps captured inside the window
    drained: bool


def offered_horizon(seconds: float) -> float:
    """Scheduler seconds of arrivals to generate: more than a window can
    offer. The scheduler's clock runs ahead of the wall only through idle
    gaps; 8 wall-seconds' worth bounds it."""
    return 8.0 * seconds


def run_window(port: Port, cell, arrivals: list, seconds: float,
               tracer=None, record: bool = False,
               watch: Optional[Callable] = None) -> Window:
    """One window; ``watch(wall, sim)``, if given, is called between
    slices."""
    import torch
    from repro_torch.core.request import Request, SLOClass
    from repro_torch.perf import H100, WorkerSpec
    from repro_torch.serving.simulator import build_cluster

    region = tracer.region if tracer is not None else \
        (lambda name: contextlib.nullcontext())
    device = port.kernels.device
    hw = dataclasses.replace(H100, hbm_bytes=float(
        torch.cuda.get_device_properties(device).total_memory)) \
        if device.type == "cuda" else H100
    sim, _ = build_cluster(port.cfg, cell.policy, n_workers=cell.workers,
                           worker_spec=WorkerSpec(tp=1, hw=hw))
    backend = port.execs.as_backend(clock="wall")
    rec = Recorder(backend, port.execs, cell.config, region, record=record)
    sim.sched.backend = rec

    def make(a: traffic.Arrival):
        return Request(rid=a.rid, arrival_time=a.time, prompt_len=a.prompt,
                       output_len=a.output,
                       slo=SLOClass(ttft=cell.ttft_limit(a.prompt),
                                    tpot=cell.tpot_limit))

    feed = Feed(arrivals, make)
    sim.add_replay(feed)
    captures0 = port.kernels.captures if port.kernels else 0
    offer_until = cell.offer_share * seconds
    drained = False
    target = 0.0
    t0 = time.perf_counter()
    while True:
        wall = time.perf_counter() - t0
        if wall >= seconds:
            break
        if tracer is not None:
            tracer.tick(wall, rec)
        if watch is not None:
            watch(wall, sim)
        if feed.open and wall >= offer_until:
            feed.open = False
        if not feed.open:
            reqs = sim.sched.requests
            if len(reqs) == feed.i and all(r.finish_time is not None
                                           for r in reqs):
                drained = True
                break
        target = max(target, sim.now) + SLICE_S
        with region("servebench.scheduler"):
            sim.run(until=target)
    wall_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.finish(wall_s, rec)
    by_rid = {a.rid: a for a in arrivals[:feed.i]}
    served = [stats.Served(
        arrival=r.arrival_time, prompt=by_rid[r.rid].prompt,
        first_token=r.first_token_time, finish=r.finish_time,
        decode_time=r.decode_time, tokens=r.streamed_tokens,
        ttft_limit=r.slo.ttft, tpot_limit=r.slo.tpot)
        for r in sim.sched.requests]
    return Window(served=served, requests=list(sim.sched.requests),
                  close=target, wall_s=wall_s,
                  recorder=rec, backend=backend,
                  workers=dict(sim.workers),
                  captures=(port.kernels.captures if port.kernels else 0)
                  - captures0, drained=drained)
