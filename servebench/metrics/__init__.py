"""Per-layer metrics, one reader a file: ``<metric name>.py`` with
``read(run) -> float | None``, found by the metric's name. ``run`` has
the ``window`` (``servebench.serve.Window``), the traced sub-window's
``profile`` (``servebench.trace.Profile``, whose ``calls`` are the
architecture's ``count``s), the ``cell`` and its configuration's
``shape``. ``roofline`` reads the calls of one kind. A reader that finds
nothing to read returns None, and the metric is left out of the run's
line."""
from __future__ import annotations

import importlib.util
from pathlib import Path

from servebench import cost

HERE = Path(__file__).resolve().parent


def reader(name: str):
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"servebench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def roofline(run, kind: str, word: str):
    """% of the roofline of the ``kind`` calls in the traced sub-window,
    against the device time of the kernels whose name holds ``word``."""
    p = run.profile
    if p is None:
        return None
    bound = sum(cost.bound_s(f, b) for k, f, b in p.calls if k == kind)
    spent = sum(t for name, t in p.kernels.items() if word in name)
    if bound <= 0 or spent <= 0:
        return None
    return bound / spent * 100.0
