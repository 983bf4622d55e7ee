"""DEPRECATED import shim — the cost model moved to ``repro_torch.perf``.

Every name below is re-exported unchanged (same classes, same objects —
``isinstance`` checks and pickle-free configs keep working), so existing
import paths stay valid. New code should import from ``repro_torch.perf``:

    from repro_torch.perf import CostModel, HardwareSpec, WorkerSpec, V5E

The move gave the model a home of its own: per-worker ``HardwareSpec``
(heterogeneous clusters), the §IV mixed-batch interference term, the
per-worker online calibration layer and the measured-MFU calibrated
roofline all live in ``src/repro/perf/``.
"""
from repro_torch.perf.hardware import V5E, HardwareSpec, WorkerSpec
from repro_torch.perf.model import (CostModel, IterationCostModel, ModelCostSpec,
                              build_cost_spec, relative_speeds)

__all__ = [
    "CostModel", "HardwareSpec", "IterationCostModel", "ModelCostSpec",
    "V5E", "WorkerSpec", "build_cost_spec", "relative_speeds",
]
