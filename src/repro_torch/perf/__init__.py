"""repro_torch.perf — the unified interference-aware performance model.

One subsystem owns every step-time estimate in the stack:

* ``hardware``    — per-worker ``HardwareSpec``/``WorkerSpec`` (clusters
                    may mix fast and slow workers);
* ``model``       — the ``IterationCostModel`` interface and the roofline
                    ``CostModel`` with the §IV mixed-batch interference
                    term (``HardwareSpec.interference``, default off);
* ``predictor``   — §IV-C analytic/profiled predictors, per-worker aware
                    (``ClusterPredictor`` prices on the target worker);
* ``calibration`` — ``OnlinePredictor``: per-(worker, phase, size-bucket)
                    EWMA correction from observed durations;
* ``calibrate``   — measured-MFU roofline: run the real Pallas kernels
                    once, instantiate the model from measurements
                    (``CalibratedRooflineBackend``); v2 adds
                    ``calibrate_interference`` — the mixed-vs-pure kernel
                    grid sweep that fits a bucketed ``InterferenceTable``;
* ``recalibrate`` — ``DriftMonitor``: periodic online re-fit of per-bucket
                    γ and the measured efficiency constants from observed
                    iteration residuals (thermal drift, stale profiles).

``serving/costmodel.py`` and ``core/predictor.py`` remain as import shims
so every pre-existing call site keeps working unchanged.
"""
from repro_torch.perf.calibration import OnlinePredictor
from repro_torch.perf.hardware import (V5E, HardwareSpec, InterferenceTable,
                                 WorkerSpec, gamma_at, gamma_at_batch)
from repro_torch.perf.model import (STATE_TOKEN_EQUIV, CostModel,
                              IterationCostModel, ModelCostSpec,
                              build_cost_spec, canonical_iteration_time,
                              relative_speeds)
from repro_torch.perf.predictor import (AnalyticalPredictor, BiasedPredictor,
                                  ClusterPredictor, Predictor,
                                  ProfiledPredictor, profile_worker)
from repro_torch.perf.recalibrate import DriftMonitor

__all__ = [
    "AnalyticalPredictor", "BiasedPredictor",
    "ClusterPredictor", "CostModel", "DriftMonitor", "HardwareSpec",
    "InterferenceTable", "IterationCostModel",
    "ModelCostSpec", "OnlinePredictor", "Predictor",
    "ProfiledPredictor", "STATE_TOKEN_EQUIV", "V5E", "WorkerSpec",
    "build_cost_spec",
    "canonical_iteration_time", "gamma_at", "gamma_at_batch",
    "profile_worker", "relative_speeds",
]
