"""Legacy import path — the workload subsystem lives in ``repro_torch.workload``.

Everything that used to be defined here (the mooncake-like profile,
Gamma-modulated arrivals, ``generate_trace``, the Mooncake-schema CSV
round-trip) moved into the ``repro_torch.workload`` package, which adds named
scenarios (bursty / diurnal / longctx / agentic / mixture), SLO classes
and replay iterators on top. This shim keeps every pre-package import
working; ``generate_trace`` remains RNG-stream identical, so seeded
benchmark numbers reproduce exactly.
"""
from repro_torch.workload import (AGENTIC, LONGCTX, MOONCAKE,  # noqa: F401
                            SCENARIOS, STEADY, Scenario, ScenarioComponent,
                            TraceProfile, generate_trace, get_scenario,
                            load_csv, replay_csv, sample_arrivals,
                            sample_lengths, save_csv)

__all__ = [
    "AGENTIC", "LONGCTX", "MOONCAKE", "SCENARIOS", "STEADY", "Scenario",
    "ScenarioComponent", "TraceProfile", "generate_trace", "get_scenario",
    "load_csv", "replay_csv", "sample_arrivals", "sample_lengths",
    "save_csv",
]
