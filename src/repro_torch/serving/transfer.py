"""Bandwidth-contended KV transfer engine.

Replaces the fixed ``CostModel.migration_time`` delay with a per-worker ICI
link model: each worker exposes ``ici_links x ici_bw`` bytes/s of egress and
ingress capacity, and every in-flight migration is a *flow* holding a
max-min-fair share of the links it crosses. A burst of P->D handoffs out of
one prefill worker therefore queues on that worker's egress links instead
of teleporting — the disaggregation penalty DistServe-style splits pay and
that Tropical's Path-② multiplexing avoids (paper §IV's asymmetry
argument rests on this cost being real).

The engine is clock-agnostic: the simulator advances it to event times and
asks for the next flow completion; real deployments would swap it for a
NIXL/UCX-style transfer layer with the same interface.

Tiered-KV offload/restore traffic rides the same engine: each worker with
a host-DRAM tier registers a *host node* (``host_node(wid)``, a negative
id that can never collide with a worker id) whose ``LinkSpec`` models the
worker's DMA path to host memory. Offloads are worker→host flows, restores
host→worker — so KV spills contend with migrations for the worker's real
link capacity instead of teleporting.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np


def host_node(wid: int) -> int:
    """Pseudo node id for worker ``wid``'s host-DRAM endpoint. Worker ids
    are non-negative, so the mapping is collision-free and invertible."""
    return -(int(wid) + 1)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Aggregate P2P capacity of one worker (bytes/s per direction)."""
    egress_bw: float
    ingress_bw: float
    latency: float = 0.001      # per-migration fixed cost (handshake/launch)

    @classmethod
    def from_hardware(cls, hw) -> "LinkSpec":
        bw = hw.ici_bw * hw.ici_links
        return cls(egress_bw=bw, ingress_bw=bw, latency=hw.migration_latency)

    @classmethod
    def from_host_hardware(cls, hw) -> "LinkSpec":
        """Host-DRAM DMA endpoint (PCIe/DMA, not ICI): symmetric, slower,
        with its own setup latency."""
        return cls(egress_bw=hw.host_bw, ingress_bw=hw.host_bw,
                   latency=hw.host_latency)


@dataclasses.dataclass
class Flow:
    fid: int
    src: int
    dst: int
    nbytes: float
    remaining: float
    payload: object
    start_time: float
    rate: float = 0.0           # current granted bytes/s

    @property
    def finished(self) -> bool:
        # absolute floor plus a relative guard: float residue from
        # rate*dt draining must not strand a flow (or spin the event loop
        # on zero-length completions)
        return self.remaining <= max(1e-6, 1e-9 * self.nbytes) or \
            (self.rate > 0 and self.remaining / self.rate < 1e-9)


class TransferEngine:
    """Max-min fair sharing of per-worker egress/ingress link capacity."""

    def __init__(self, links: Optional[dict[int, LinkSpec]] = None,
                 default_spec: Optional[LinkSpec] = None):
        self.links: dict[int, LinkSpec] = dict(links or {})
        self.default_spec = default_spec or LinkSpec(50e9 * 2, 50e9 * 2)
        self._flows: dict[int, Flow] = {}
        self._fid = itertools.count()
        self._clock = 0.0
        # bumped on every rate change; schedulers use it to drop stale events
        self.version = 0
        # lifetime stats (benchmarks / regression guards)
        self.completed_flows = 0
        self.bytes_moved = 0.0
        self.total_transfer_seconds = 0.0
        # wid-indexed (ingress_bw, latency) cache for the vectorized
        # predictor; the topology only grows, so len(links) is a token
        self._ibw_cache: Optional[np.ndarray] = None
        self._ibw_token = -1

    # ------------------------------------------------------------- topology
    def add_worker(self, wid: int, spec: Optional[LinkSpec] = None) -> None:
        self.links.setdefault(wid, spec or self.default_spec)

    def add_host(self, wid: int, spec: LinkSpec) -> int:
        """Register worker ``wid``'s host-DRAM endpoint; returns its node
        id. Offload flows are ``start(wid, host_node(wid), ...)``."""
        node = host_node(wid)
        self.links[node] = spec
        return node

    def _spec(self, wid: int) -> LinkSpec:
        return self.links.get(wid, self.default_spec)

    # -------------------------------------------------------------- queries
    @property
    def active_flows(self) -> int:
        return len(self._flows)

    def egress_queued_bytes(self, wid: int) -> float:
        return sum(f.remaining for f in self._flows.values() if f.src == wid)

    def ingress_queued_bytes(self, wid: int) -> float:
        return sum(f.remaining for f in self._flows.values() if f.dst == wid)

    def predict_transfer_time(self, src: int, dst: int, nbytes: float,
                              now: Optional[float] = None) -> float:
        """Predicted completion time of a new src->dst flow given current
        queue depths. Links drain their whole backlog at full capacity
        under fair sharing, so the new flow lands behind
        ``queued/capacity`` seconds on its most-contended link. Pass
        ``now`` so already-drained bytes don't count as backlog."""
        if now is not None:
            self.advance(now)
        s, d = self._spec(src), self._spec(dst)
        if s.egress_bw <= 0 or d.ingress_bw <= 0:
            return float("inf")          # dead link: the KV never arrives
        t_out = ((self.egress_queued_bytes(src) + nbytes) / s.egress_bw
                 if math.isfinite(s.egress_bw) else 0.0)
        t_in = ((self.ingress_queued_bytes(dst) + nbytes) / d.ingress_bw
                if math.isfinite(d.ingress_bw) else 0.0)
        return s.latency + max(t_out, t_in)

    def predict_transfer_time_batch(self, src: int, dsts, nbytes: float,
                                    now: Optional[float] = None) -> list:
        """``predict_transfer_time`` against many candidate destinations in
        one pass: the clock advances once, the source egress backlog is
        summed once, and a single sweep over in-flight flows accumulates
        each candidate's ingress backlog (per-destination accumulation in
        flow-table order — the same addition sequence as the scalar
        filtered sums, so every element is bit-identical)."""
        if now is not None:
            self.advance(now)
        s = self._spec(src)
        if s.egress_bw <= 0:
            return [float("inf")] * len(dsts)
        egress = self.egress_queued_bytes(src)
        t_out = ((egress + nbytes) / s.egress_bw
                 if math.isfinite(s.egress_bw) else 0.0)
        want = set(dsts)
        ingress = dict.fromkeys(want, 0.0)
        for f in self._flows.values():
            if f.dst in ingress:
                ingress[f.dst] += f.remaining
        out = []
        for dst in dsts:
            d = self._spec(dst)
            if d.ingress_bw <= 0:
                out.append(float("inf"))
                continue
            t_in = ((ingress[dst] + nbytes) / d.ingress_bw
                    if math.isfinite(d.ingress_bw) else 0.0)
            out.append(s.latency + max(t_out, t_in))
        return out

    def _ingress_bw_array(self, n: int) -> np.ndarray:
        """Ingress bandwidth indexed by worker id for ids ``0..n-1``."""
        c = self._ibw_cache
        if c is None or c.size < n or self._ibw_token != len(self.links):
            m = max(n, c.size if c is not None else 0)
            c = np.empty(m, dtype=np.float64)
            for w in range(m):
                c[w] = self._spec(w).ingress_bw
            self._ibw_cache = c
            self._ibw_token = len(self.links)
        return c

    def predict_transfer_times(self, src: int, dsts: np.ndarray,
                               nbytes: float,
                               now: Optional[float] = None) -> np.ndarray:
        """Array-native ``predict_transfer_time_batch``: ``dsts`` is an
        int array of non-negative worker ids; returns a float64 array.
        Each element is bit-identical to the scalar prediction — the
        per-destination backlogs accumulate in flow-table order and the
        divisions/max use the same operand values."""
        if now is not None:
            self.advance(now)
        n = dsts.size
        s = self._spec(src)
        if s.egress_bw <= 0:
            return np.full(n, float("inf"))
        t_out = ((self.egress_queued_bytes(src) + nbytes) / s.egress_bw
                 if math.isfinite(s.egress_bw) else 0.0)
        ing = np.zeros(n, dtype=np.float64)
        if self._flows:
            acc: dict[int, float] = {}
            for f in self._flows.values():
                acc[f.dst] = acc.get(f.dst, 0.0) + f.remaining
            for dst, v in acc.items():
                ing[dsts == dst] = v
        ibw = self._ingress_bw_array(int(dsts.max()) + 1 if n else 0)[dsts]
        dead = ibw <= 0
        safe = np.where(dead, 1.0, ibw)
        t_in = np.where(np.isfinite(ibw), (ing + nbytes) / safe, 0.0)
        out = s.latency + np.maximum(t_out, t_in)
        if dead.any():
            out[dead] = float("inf")
        return out

    # ------------------------------------------------------------ mechanics
    def advance(self, now: float) -> None:
        """Drain in-flight flows up to ``now`` at their granted rates."""
        dt = now - self._clock
        if dt > 0:
            for f in self._flows.values():
                if math.isinf(f.rate):
                    f.remaining = 0.0
                else:
                    f.remaining = max(0.0, f.remaining - f.rate * dt)
        self._clock = max(self._clock, now)

    def start(self, src: int, dst: int, nbytes: float, now: float,
              payload: object = None) -> Flow:
        self.advance(now)
        f = Flow(fid=next(self._fid), src=src, dst=dst,
                 nbytes=float(nbytes), remaining=max(float(nbytes), 0.0),
                 payload=payload, start_time=now)
        self._flows[f.fid] = f
        self._reallocate()
        return f

    def pop_completed(self, now: float) -> list[Flow]:
        """Flows fully drained by ``now`` (engine re-shares their links)."""
        self.advance(now)
        done = [f for f in self._flows.values() if f.finished]
        for f in done:
            del self._flows[f.fid]
            self.completed_flows += 1
            self.bytes_moved += f.nbytes
            self.total_transfer_seconds += now - f.start_time
        if done:
            self._reallocate()
        return done

    def next_completion(self) -> Optional[float]:
        """Absolute time of the earliest flow completion, or None."""
        best = None
        for f in self._flows.values():
            if math.isinf(f.rate):
                t = self._clock
            elif f.rate > 0:
                t = self._clock + f.remaining / f.rate
            else:               # zero capacity: stalls forever
                continue
            if best is None or t < best:
                best = t
        return best

    def drop_flows_touching(self, wid: int, now: float) -> list[Flow]:
        """Worker died mid-transfer: in-bound KV never lands, and the
        untransferred remainder of out-bound KV was lost with its HBM —
        both directions abandon. Advances to ``now`` first so survivors'
        new rates don't apply retroactively."""
        self.advance(now)
        dead = [f for f in self._flows.values()
                if f.src == wid or f.dst == wid]
        for f in dead:
            del self._flows[f.fid]
        if dead:
            self._reallocate()
        return dead

    # --------------------------------------------------- max-min fair rates
    def _reallocate(self) -> None:
        """Progressive-filling (waterfilling) max-min fair allocation over
        the bipartite egress/ingress resource graph. Two concurrent flows
        out of one worker each get half its egress; a flow bottlenecked on
        its destination releases source bandwidth to its siblings."""
        self.version += 1
        flows = list(self._flows.values())
        if not flows:
            return
        cap: dict[tuple[str, int], float] = {}
        members: dict[tuple[str, int], set[int]] = {}
        for f in flows:
            out_r, in_r = ("out", f.src), ("in", f.dst)
            cap.setdefault(out_r, self._spec(f.src).egress_bw)
            cap.setdefault(in_r, self._spec(f.dst).ingress_bw)
            members.setdefault(out_r, set()).add(f.fid)
            members.setdefault(in_r, set()).add(f.fid)
        unassigned = {f.fid for f in flows}
        by_id = {f.fid: f for f in flows}
        while unassigned:
            bottleneck = None
            for r, fids in members.items():
                live = fids & unassigned
                if not live:
                    continue
                share = cap[r] / len(live)
                if bottleneck is None or share < bottleneck[0]:
                    bottleneck = (share, r, live)
            if bottleneck is None:      # pragma: no cover - defensive
                break
            share, _, live = bottleneck
            for fid in live:
                f = by_id[fid]
                f.rate = share
                unassigned.discard(fid)
                if math.isfinite(share):
                    cap[("out", f.src)] -= share
                    cap[("in", f.dst)] -= share

    # ------------------------------------------------------------ delivery
    def delivery_latency(self, src: int) -> float:
        return self._spec(src).latency
