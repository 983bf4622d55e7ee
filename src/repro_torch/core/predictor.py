"""DEPRECATED import shim — the §IV-C predictors moved to ``repro_torch.perf``.

Every name is re-exported unchanged so existing import paths keep
working. New code should import from ``repro_torch.perf``:

    from repro_torch.perf import AnalyticalPredictor, OnlinePredictor, ...

The predictors live with the cost model they wrap now: per-worker pricing
(``ClusterPredictor``), the per-(worker, phase, size-bucket) online
calibration hierarchy (``OnlinePredictor``) and the measured-MFU
calibrated roofline are one subsystem in ``src/repro/perf/``.

SIGNATURE CHANGE: every ``predict_*`` method now takes an optional
``wid=None`` keyword (per-worker pricing on heterogeneous clusters) and
the toggle/policies pass it unconditionally; likewise the scheduler
passes ``wid=`` to ``observe_iteration`` (and ``OnlinePredictor``
forwards it to ``observe_prefill``/``observe_decode``). A ``Predictor``
subclass overriding any ``predict_*`` or ``observe_*`` method with the
old signature must add the ``wid=None`` parameter (ignore it to keep
worker-agnostic behaviour).
"""
from repro_torch.perf.calibration import OnlinePredictor
from repro_torch.perf.predictor import (AnalyticalPredictor, BiasedPredictor,
                                  ClusterPredictor, Predictor,
                                  ProfiledPredictor, profile_worker)

__all__ = [
    "AnalyticalPredictor", "BiasedPredictor", "ClusterPredictor",
    "OnlinePredictor", "Predictor", "ProfiledPredictor", "profile_worker",
]
