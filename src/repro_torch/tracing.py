"""Spans of the serving stack, for ``torch.profiler``.

``span(name, **ids)`` marks a stretch of host work. While no profile
records, it costs one call to the profiler's enabled flag and returns a
shared no-op: no range is opened and no id is formatted. While one records
(``torch.profiler.profile``, or any profiler that sets the flag), it opens
a range named ``name`` on the profile's host timeline, the clock its
device events are stamped on, so the spans lie beside the kernels they
launched. The ids ride on the range as keyword values: a profile that
records shapes (``record_shapes=True``) keeps them, as the event's
``kwinputs()`` and its ``args`` in a Chrome trace. An id given as a
zero-argument callable is called only while a profile records; a tuple or
list is written as its items joined by commas, any other value but an int
or a string as its ``str`` (the Chrome trace writes a float as ``40.``,
which is no JSON); None is left out.

Names start with ``repro_torch.``: ``sched.*`` the scheduler's
(``sched/core.py``, ``serving/simulator.py``), ``executor.*`` the
executor's (``serving/executor.py``). No span is kept anywhere but in the
profile: the profiler is the exporter
(``repro_torch.launch.serve --torch-trace PATH`` writes one as a Chrome
trace).
"""
from __future__ import annotations

import contextlib

import torch

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str, **ids):
    if not _recording():
        return _OFF
    # record_function drops its args string from the profile; the fast
    # record function keeps keyword values as the event's inputs
    from torch._C._profiler import _RecordFunctionFast
    values = {}
    for key, v in ids.items():
        if callable(v):
            v = v()
        if v is None:
            continue
        if isinstance(v, (tuple, list)):
            v = ",".join(map(str, v))
        elif not isinstance(v, (int, str)):
            v = str(v)
        values[key] = v
    return _RecordFunctionFast(name, (), values)
