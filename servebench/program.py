"""The port's own spans (``repro_torch.tracing``) in a traced sub-window,
joined with the card's operations on the profile's one clock.

From the profile's events (``records`` turns kineto's into plain tuples):

* ``spans``: for each span name, the count, the total seconds and the self
  seconds (the duration less the part its child spans cover);
* ``idle``: the idle seconds of each gap between device operations of
  ``SHORT_GAP_NS`` or more, split by overlap over the gap's whole length
  among the innermost spans the host was in, the rest under ``OUTSIDE``;
  shorter gaps are summed under ``SHORT``;
* ``replay``: for the ``executor.replay.decode`` and ``.prefill`` spans,
  their count, and the count and device seconds of the operations launched
  inside them: an operation is tied to the runtime call that launched it
  (``cudaGraphLaunch``, ``cudaLaunchKernel``, ...) by the correlation id
  the two share, and the call to the innermost span it was made in;
* ``lags_ns``: for each operation that ends an idle gap, its start less
  the start of the runtime call that launched it;
* ``drift_ms_per_s``: how fast the two clocks part, the least-squares
  slope of the host-to-device copies' launch lags against time. The
  executor's one upload an iteration is a pageable copy, which starts
  within microseconds of its call, so its lag should stay flat.

The host's spans and the card's operations are on one clock
(``clock_ok``) only if no lag is negative and the drift moves them apart
by less than a short gap over a traced sub-window.

The device operations are those ``servebench.trace`` counts (its
``busy_s``), so the gaps are its gaps. The benchmark's harness does not
call this yet: ``servebench/attribute.py`` runs a traced window and
reduces it here.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from servebench.trace import SHORT_GAP_NS, TRACE_S

PREFIX = "repro_torch."
OUTSIDE = "outside the program"
SHORT = f"gaps under {SHORT_GAP_NS // 1000} us"
REPLAY = {"decode": PREFIX + "executor.replay.decode",
          "prefill": PREFIX + "executor.replay.prefill"}
BACKEND = PREFIX + "sched.backend"
TO_HOST = PREFIX + "executor.to_host"
ITERATION = PREFIX + "executor.iteration"


@dataclasses.dataclass
class Program:
    spans: dict       # name -> [count, total seconds, self seconds]
    idle: dict        # innermost span | OUTSIDE | SHORT -> idle seconds
    replay: dict      # "decode" | "prefill" -> [spans, ops, device seconds]
    lags_ns: list     # launch lag of each op that ends a gap
    drift_ms_per_s: float | None

    @property
    def clock_ok(self) -> bool:
        drift = self.drift_ms_per_s or 0.0
        return all(lag >= 0 for lag in self.lags_ns) and \
            abs(drift) * TRACE_S <= SHORT_GAP_NS * 1e-6


def category(name: str) -> str:
    """Where the host was, by the innermost span: the scheduler's own work
    (``sched``), the executor's host work (``executor``), the executor
    waiting for the card's copy (``wait``), or no work of the program
    (``outside``: no span, or the backend call's own wrapping, which in
    the benchmark is its recorder); ``short`` for the short gaps."""
    if name == SHORT:
        return "short"
    if name == TO_HOST:
        return "wait"
    if name == OUTSIDE or name == BACKEND:
        return "outside"
    if name.startswith(PREFIX + "sched."):
        return "sched"
    if name.startswith(PREFIX + "executor."):
        return "executor"
    raise ValueError(f"not a span of the program: {name!r}")


def idle_share(program: Program, cat: str):
    """The share of the idle seconds in ``category`` ``cat``, or None when
    no span was recorded (a program without spans) or nothing was idle."""
    total = sum(program.idle.values())
    if not program.spans or total <= 0:
        return None
    return sum(s for name, s in program.idle.items()
               if category(name) == cat) / total


def per_iteration_ms(program: Program, names) -> float | None:
    """Self milliseconds of the spans ``names`` picks (a predicate on the
    name), over the sub-window's ``executor.iteration`` spans."""
    n = program.spans.get(ITERATION, [0])[0]
    if not n:
        return None
    return sum(row[2] for name, row in program.spans.items()
               if names(name)) / n * 1e3


def records(events) -> list:
    """kineto's events as ``(kind, name, start_ns, end_ns, correlation)``
    with ``kind`` one of "device" (an operation on the card, as
    ``servebench.trace`` counts them), "span" (the program's) and
    "runtime" (a CUDA runtime or driver call on the host)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in events:
        name, s = e.name(), e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith("servebench.") \
                    and not e.is_user_annotation():
                out.append(("device", name, s, t, e.correlation_id()))
        elif name.startswith(PREFIX):
            out.append(("span", name, s, t, 0))
        elif name.startswith("cu"):
            out.append(("runtime", name, s, t, e.correlation_id()))
    return out


def _nest(spans: list):
    """Self seconds of each span, and the host's timeline as sorted
    ``(start, end, innermost span name)`` pieces."""
    selfs = defaultdict(float)
    pieces: list = []
    stack: list = []                 # [name, end]
    cursor = 0

    def close():
        nonlocal cursor
        name, end = stack.pop()
        if end > cursor:
            pieces.append((cursor, end, name))
        cursor = max(cursor, end)

    for name, s, t in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            close()
        if stack:
            if s > cursor:
                pieces.append((cursor, s, stack[-1][0]))
            selfs[stack[-1][0]] -= (min(t, stack[-1][1]) - s) * 1e-9
        selfs[name] += (t - s) * 1e-9
        stack.append([name, t])
        cursor = s
    while stack:
        close()
    return selfs, pieces


def reduce(recs: list) -> Program:
    spans = [(n, s, t) for k, n, s, t, _ in recs if k == "span"]
    launch = {c: s for k, _, s, _, c in recs if k == "runtime"}
    dev = sorted((s, t, c) for k, _, s, t, c in recs if k == "device")
    totals: dict = {}
    for name, s, t in spans:
        row = totals.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (t - s) * 1e-9
    selfs, pieces = _nest(spans)
    for name, row in totals.items():
        row[2] = selfs[name]
    starts = [p[0] for p in pieces]

    def inside(ns: int):
        i = bisect.bisect_right(starts, ns) - 1
        return pieces[i][2] if i >= 0 and pieces[i][1] > ns else None

    anchors = [(launch[c], s - launch[c]) for k, name, s, _, c in recs
               if k == "device" and name.startswith("Memcpy HtoD")
               and c in launch]
    replay = {kind: [totals.get(name, [0])[0], 0, 0.0]
              for kind, name in REPLAY.items()}
    kinds = {name: kind for kind, name in REPLAY.items()}
    for s, t, c in dev:
        kind = kinds.get(inside(launch[c])) if c in launch else None
        if kind is not None:
            replay[kind][1] += 1
            replay[kind][2] += (t - s) * 1e-9

    # gaps between the merged device intervals, each with the op after it
    merged: list = []
    for s, t, c in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t, c])
    idle: dict = defaultdict(float)
    lags: list = []
    j = 0
    for (_, a, _), (b, _, c) in zip(merged, merged[1:]):
        if b - a < SHORT_GAP_NS:
            idle[SHORT] += (b - a) * 1e-9
            continue
        if c in launch:
            lags.append(b - launch[c])
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                idle[pieces[k][2]] += (hi - lo) * 1e-9
                covered += hi - lo
            k += 1
        idle[OUTSIDE] += (b - a - covered) * 1e-9
    return Program(spans=totals, idle=dict(idle), replay=replay,
                   lags_ns=lags, drift_ms_per_s=_slope(anchors))


def _slope(points: list):
    """Least-squares slope of y over x (both in ns), in ms per s."""
    if len(points) < 2:
        return None
    mx = sum(x for x, _ in points) / len(points)
    my = sum(y for _, y in points) / len(points)
    var = sum((x - mx) ** 2 for x, _ in points)
    cov = sum((x - mx) * (y - my) for x, y in points)
    return cov / var * 1e3 if var > 0 else None
