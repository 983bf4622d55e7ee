"""Unified workload subsystem: length profiles x arrival processes x SLO
classes, composed into named ``Scenario`` objects, with Mooncake-schema
CSV round-tripping and a TraceReplayBackend-ready ``replay`` iterator.

Grew out of ``serving/trace.py`` (which remains as an import shim); the
legacy single-class ``generate_trace`` keeps its exact RNG stream.
"""
from repro_torch.workload.arrivals import (ArrivalProcess, Diurnal, GammaPoisson,
                                     OnOffBursts, sample_arrivals)
from repro_torch.workload.csvio import load_csv, save_csv
from repro_torch.workload.profiles import (AGENTIC, LONGCTX, MOONCAKE, STEADY,
                                     TraceProfile, sample_lengths)
from repro_torch.workload.scenario import (SCENARIOS, Scenario, ScenarioComponent,
                                     generate_trace, get_scenario,
                                     replay_csv)

__all__ = [
    "AGENTIC",
    "ArrivalProcess",
    "Diurnal",
    "GammaPoisson",
    "LONGCTX",
    "MOONCAKE",
    "OnOffBursts",
    "SCENARIOS",
    "STEADY",
    "Scenario",
    "ScenarioComponent",
    "TraceProfile",
    "generate_trace",
    "get_scenario",
    "load_csv",
    "replay_csv",
    "sample_arrivals",
    "sample_lengths",
    "save_csv",
]
