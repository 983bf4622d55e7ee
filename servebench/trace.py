"""The traced run's device trace: ``torch.profiler`` over a steady
sub-window of a few seconds in the middle of the window (a whole window's
kernel events would be millions), and the host regions the benchmark's own
files put around the seams it owns:

* ``servebench.scheduler``: a slice of ``Simulator.run`` (the scheduler's
  event handling, with the iterations it starts inside it);
* ``servebench.run_iteration``: one iteration at the backend seam;
* ``servebench.upload`` / ``servebench.replay`` / ``servebench.to_host``:
  the executor's one host-to-device upload, each CUDA graph replay, and
  the one device-to-host copy of an iteration, wrapped from outside for the
  traced run only.

From the events: the device's busy time (the union of its operations'
intervals), the kernels by name, and the idle gaps between device
operations, each labelled by the innermost region the host was in at the
gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict

START_SHARE = 0.35          # the sub-window opens at this share of the window
TRACE_S = 2.0               # and lasts this long, and until it holds an
                            # iteration with a prefill part and one with
                            # decoding rows, or until the window ends
SHORT_GAP_NS = 10_000       # idle gaps shorter than this are summed apart


@dataclasses.dataclass
class Profile:
    window_s: float                       # length of the traced sub-window
    busy_s: float                         # union of device intervals
    kernels: dict                         # name -> device seconds
    idle: dict                            # host region -> idle seconds
    calls: list                           # the recorder's calls inside it


class Tracer:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._make = lambda: profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
        self.prof = None
        self.t_on = self.t_off = None
        self.start_at = None
        self.result = None
        self._marks = (0, 0)
        self._seen = (0, 0)                # the recorder's iteration counts
        self._saved = []

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start's cost stays out of the window."""
        torch = self._torch
        with self._make():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def region(self, name: str):
        from torch.profiler import record_function
        return record_function(name) if self.prof is not None \
            else contextlib.nullcontext()

    def patch(self) -> None:
        """Wrap the executor's upload, graph replay and device-to-host copy
        in regions for this process."""
        from repro_torch.serving import executor as ex
        for owner, name, label in ((ex, "_upload", "servebench.upload"),
                                   (ex, "_to_host", "servebench.to_host"),
                                   (ex._StepGraph, "replay",
                                    "servebench.replay")):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with self.region(_label):
                    return _fn(*a, **kw)
            setattr(owner, name, wrapped)

    def unpatch(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()

    def tick(self, wall: float, rec) -> None:
        """Between slices (the card idle): open or close the sub-window."""
        if self.start_at is None:
            return
        if self.prof is None and self.result is None and wall >= self.start_at:
            self.prof = self._make()
            self.prof.start()
            self.t_on = wall
            self._marks = (len(rec.calls), 0)
            self._seen = (rec.with_prefill, rec.with_decode)
        elif self.prof is not None and wall >= self.t_on + TRACE_S \
                and rec.with_prefill > self._seen[0] \
                and rec.with_decode > self._seen[1]:
            self._stop(wall, rec)

    def finish(self, wall: float, rec) -> None:
        if self.prof is not None:
            self._stop(wall, rec)

    def _stop(self, wall: float, rec) -> None:
        self._torch.cuda.synchronize()
        self.prof.stop()
        self.t_off = wall
        self._marks = (self._marks[0], len(rec.calls))
        prof, self.prof = self.prof, None
        self.result = self._reduce(prof, rec)

    def _reduce(self, prof, rec) -> Profile:
        torch = self._torch
        events = prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            if e.name().startswith("servebench."):
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    continue            # a region's span mirrored on the card
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             e.name()))
            elif e.device_type() == torch.autograd.DeviceType.CUDA \
                    and not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e))
        kernels: dict = defaultdict(float)
        for s, t, e in dev:
            kernels[e.name()] += (t - s) * 1e-9
        dev.sort(key=lambda x: x[0])
        merged = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged) * 1e-9
        host.sort(key=lambda x: x[0])
        starts = [s for s, _, _ in host]
        idle: dict = defaultdict(float)
        for (_, a), (b, _) in zip(merged, merged[1:]):
            if b - a < SHORT_GAP_NS:
                idle[f"gaps under {SHORT_GAP_NS // 1000} us"] += (b - a) * 1e-9
                continue
            mid = (a + b) / 2
            label = "outside any region"
            # regions nest: the latest-starting one that holds the middle
            # is the innermost
            top = bisect.bisect_right(starts, mid) - 1
            for i in range(top, max(-1, top - 64), -1):
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
            idle[label] += (b - a) * 1e-9
        window = (self.t_off - self.t_on)
        lo, hi = self._marks
        return Profile(window_s=window, busy_s=busy, kernels=dict(kernels),
                       idle=dict(idle),
                       calls=rec.calls[lo:hi])
