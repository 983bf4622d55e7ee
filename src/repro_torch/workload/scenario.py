"""Scenarios: named, composable workload definitions.

A ``Scenario`` is a list of components, each owning a length profile, an
arrival process, a traffic share and an SLO class. ``generate`` yields the
merged Request stream (fixed-seed deterministic, per-component independent
RNG streams); ``replay`` yields ``(arrival_time, Request)`` pairs in
arrival order — the iterator contract a ``TraceReplayBackend`` consumes —
and every scenario round-trips through the Mooncake CSV schema
(``repro_torch.workload.csvio``), so a real Mooncake/ShareGPT dump drops in by
loading it instead of generating.

The registry::

    mooncake   the paper's §V-A synthetic trace (long-tail prefills)
    steady     damped tail + near-Poisson arrivals (calibration runs)
    bursty     mooncake lengths, on/off Gamma bursts (flash crowds)
    diurnal    mooncake lengths, sinusoidal rate (day/night cycle)
    longctx    tail-heavy prefills (RAG/document QA, HOL-blocking regime)
    agentic    short-prompt/long-output inversion (decode-bound agents)
    mixture    two tenants: interactive (tight SLO, 2x weight) + batch
               (loose SLO) with distinct profiles and arrival processes

``generate_trace`` is the legacy single-profile entry point, RNG-stream
identical to the pre-package ``serving/trace.py`` — the compatibility shim
every existing benchmark and test reproduces its numbers through.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.core.metrics import derive_slos
from repro_torch.core.request import Request, SLOClass
from repro_torch.workload.arrivals import (ArrivalProcess, Diurnal, GammaPoisson,
                                     OnOffBursts, sample_arrivals)
from repro_torch.workload.profiles import (AGENTIC, LONGCTX, MOONCAKE, STEADY,
                                     TraceProfile, sample_lengths)


@dataclasses.dataclass(frozen=True)
class ScenarioComponent:
    """One traffic stream: who arrives when, with what shape, under which
    SLO class. ``slo=None`` derives per-request SLOs from the cost model
    (paper §V-A: scale x the light-load latency of the request's own
    phases), tagged with this component's class name and weight."""
    name: str
    profile: TraceProfile
    arrivals: ArrivalProcess
    rate_frac: float = 1.0          # share of the scenario-level rate
    slo: Optional[SLOClass] = None
    slo_scale: tuple[float, float] = (5.0, 5.0)
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    components: tuple[ScenarioComponent, ...]

    def __post_init__(self):
        names = [c.name for c in self.components]
        if len(set(names)) != len(names):
            raise ValueError(
                f"scenario {self.name!r}: duplicate component names "
                f"{names} — substreams are keyed by name")

    def generate(self, rate: float, duration: float, cost_model,
                 seed: int = 0) -> list[Request]:
        """Merged Request stream over [0, duration); ``rate`` is the total
        average arrival rate, split across components by ``rate_frac``.
        Each component draws from a substream keyed by its NAME (not its
        position), so adding/removing/reordering components never perturbs
        the survivors' traffic. Profiles with ``shared_prefixes`` > 0 tag
        eligible requests (prompt > ``prefix_tokens``) with a shared-prompt
        identity from a *separate* RNG substream — arrival/length streams
        are bit-identical with tagging on or off, and the tags themselves
        are inert unless a worker-side prefix cache is armed."""
        rows: list[tuple[float, int, int, SLOClass, Optional[int], int]] = []
        for comp in self.components:
            rng = np.random.default_rng(
                [seed, zlib.crc32(comp.name.encode())])
            times = comp.arrivals.sample(rng, rate * comp.rate_frac,
                                         duration)
            inputs, outputs = sample_lengths(rng, len(times), comp.profile)
            prof = comp.profile
            pkeys: list[Optional[int]] = [None] * len(times)
            if prof.shared_prefixes > 0 and prof.prefix_tokens > 0:
                prng = np.random.default_rng(
                    [seed, zlib.crc32(comp.name.encode()),
                     zlib.crc32(b"prefix")])
                draws = prng.integers(prof.shared_prefixes, size=len(times))
                # identities are globally unique per (component, slot):
                # two components can never alias each other's prompts
                pkeys = [
                    zlib.crc32(f"{comp.name}:{int(k)}".encode())
                    if int(pl) > prof.prefix_tokens else None
                    for k, pl in zip(draws, inputs)]
            for t, pl, ol, pkey in zip(times, inputs, outputs, pkeys):
                if comp.slo is not None:
                    slo = comp.slo
                else:
                    slo = dataclasses.replace(
                        derive_slos(cost_model, int(pl), *comp.slo_scale),
                        name=comp.name, weight=comp.weight)
                rows.append((float(t), int(pl), int(ol), slo, pkey,
                             prof.prefix_tokens if pkey is not None else 0))
        rows.sort(key=lambda x: x[0])
        return [Request(rid=i, arrival_time=t, prompt_len=pl, output_len=ol,
                        slo=slo, prefix_key=pkey, prefix_len=plen)
                for i, (t, pl, ol, slo, pkey, plen) in enumerate(rows)]

    def replay(self, rate: float, duration: float, cost_model,
               seed: int = 0) -> Iterator[tuple[float, Request]]:
        """TraceReplayBackend-ready iterator: ``(arrival_time, Request)``
        in arrival order. A backend replaying a recorded CSV gets the same
        contract from ``replay_csv``."""
        for r in self.generate(rate, duration, cost_model, seed):
            yield r.arrival_time, r

    @property
    def classes(self) -> dict[str, SLOClass]:
        """Fixed SLO classes declared by components (derived-SLO
        components are per-request and absent)."""
        return {c.slo.name: c.slo for c in self.components
                if c.slo is not None}


def replay_csv(path: str, cost_model, slo_scale=(5.0, 5.0),
               classes=None) -> Iterator[tuple[float, Request]]:
    """Replay a recorded Mooncake-schema CSV with the same iterator
    contract as ``Scenario.replay`` — how a real trace drops in."""
    from repro_torch.workload.csvio import load_csv
    for r in load_csv(path, cost_model, slo_scale=slo_scale,
                      classes=classes):
        yield r.arrival_time, r


# ------------------------------------------------------------------ registry

def _single(name: str, profile: TraceProfile,
            arrivals: ArrivalProcess) -> Scenario:
    return Scenario(name, (ScenarioComponent(
        name="default", profile=profile, arrivals=arrivals),))


def _mixture() -> Scenario:
    """Two tenants at a 60/40 traffic split: an interactive class (short
    prompts, tight 3x-light-load SLOs, double weight) sharing the cluster
    with a batch class (long-context prompts, loose 12x SLOs, bursty
    arrivals)."""
    return Scenario("mixture", (
        ScenarioComponent(
            name="interactive", profile=AGENTIC,
            arrivals=GammaPoisson(window=5.0, shape=4.0),
            rate_frac=0.6, slo_scale=(3.0, 3.0), weight=2.0),
        ScenarioComponent(
            name="batch", profile=LONGCTX,
            arrivals=OnOffBursts(on_mean=8.0, off_mean=12.0),
            rate_frac=0.4, slo_scale=(12.0, 12.0), weight=1.0),
    ))


SCENARIOS: dict[str, Callable[[], Scenario]] = {
    "mooncake": lambda: _single("mooncake", MOONCAKE, GammaPoisson()),
    "steady": lambda: _single("steady", STEADY,
                              GammaPoisson(shape=STEADY.burst_shape)),
    "bursty": lambda: _single("bursty", MOONCAKE, OnOffBursts()),
    "diurnal": lambda: _single("diurnal", MOONCAKE, Diurnal()),
    "longctx": lambda: _single("longctx", LONGCTX, GammaPoisson()),
    "agentic": lambda: _single("agentic", AGENTIC, GammaPoisson()),
    "mixture": _mixture,
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: "
            f"{sorted(SCENARIOS)}") from None


# ------------------------------------------------------------- legacy shim

def generate_trace(rate: float, duration: float, cost_model,
                   seed: int = 0, profile: TraceProfile = MOONCAKE,
                   slo_scale: tuple[float, float] = (5.0, 5.0),
                   fixed_slo: Optional[SLOClass] = None) -> list[Request]:
    """Paper §V-A SLO setting: TTFT SLO = 5x the light-load prefill latency
    of the request's own prompt; TPOT SLO = 5x the light-load decode
    latency (per-request, as in DistServe). RNG-stream identical to the
    pre-``repro_torch.workload`` implementation: single-class benchmark numbers
    reproduce exactly."""
    rng = np.random.default_rng(seed)
    times = sample_arrivals(rng, rate, duration, profile)
    inputs, outputs = sample_lengths(rng, len(times), profile)
    reqs = []
    for i, (t, pl, ol) in enumerate(zip(times, inputs, outputs)):
        if fixed_slo is not None:
            slo = fixed_slo
        else:
            slo = derive_slos(cost_model, int(pl), slo_scale[0], slo_scale[1])
        reqs.append(Request(rid=i, arrival_time=float(t), prompt_len=int(pl),
                            output_len=int(ol), slo=slo))
    return reqs
