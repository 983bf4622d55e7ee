"""Arrival processes.

Every process is a frozen spec with ``sample(rng, rate, duration) ->
sorted arrival times in [0, duration)`` where ``rate`` is the *average*
request rate — processes shape the fluctuation around it, never the mean,
so scenarios stay comparable at equal offered load.

* ``GammaPoisson`` — doubly-stochastic Poisson: per-window Gamma rate
  modulation (the short-term burstiness of Mooncake Fig. 3a; shape→inf
  degenerates to plain Poisson);
* ``OnOffBursts``  — on/off source with Gamma-distributed burst and gap
  durations; all traffic arrives inside bursts at ``rate / duty``;
* ``Diurnal``      — sinusoidal rate λ(t) = rate·(1 + amp·sin 2πt/period),
  sampled exactly by thinning.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.workload.profiles import TraceProfile


class ArrivalProcess:
    def sample(self, rng: np.random.Generator, rate: float,
               duration: float) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GammaPoisson(ArrivalProcess):
    window: float = 10.0        # seconds per modulation window
    shape: float = 2.0          # Gamma shape; ->inf = plain Poisson

    def sample(self, rng, rate, duration):
        times: list[float] = []
        t = 0.0
        while t < duration:
            window_rate = rate * rng.gamma(self.shape, 1.0 / self.shape)
            end = min(t + self.window, duration)
            n = rng.poisson(window_rate * (end - t))
            times.extend(rng.uniform(t, end, n))
            t = end
        return np.sort(np.asarray(times))


@dataclasses.dataclass(frozen=True)
class OnOffBursts(ArrivalProcess):
    on_mean: float = 5.0        # mean burst length, seconds
    off_mean: float = 15.0      # mean silence between bursts
    shape: float = 2.0          # Gamma shape of both period lengths

    def sample(self, rng, rate, duration):
        # all load arrives during ON periods; scale the in-burst rate by
        # the duty cycle so the long-run average stays ``rate``
        duty = self.on_mean / (self.on_mean + self.off_mean)
        rate_on = rate / max(duty, 1e-9)
        times: list[float] = []
        t = 0.0
        while t < duration:
            on = rng.gamma(self.shape, self.on_mean / self.shape)
            end = min(t + on, duration)
            n = rng.poisson(rate_on * (end - t))
            times.extend(rng.uniform(t, end, n))
            t = end + rng.gamma(self.shape, self.off_mean / self.shape)
        return np.sort(np.asarray(times))


@dataclasses.dataclass(frozen=True)
class Diurnal(ArrivalProcess):
    period: float = 120.0       # one "day" (compressed to sim scale)
    amplitude: float = 0.6      # peak-to-mean rate swing, in [0, 1)
    phase: float = 0.0          # radians; 0 starts at mean load rising

    def sample(self, rng, rate, duration):
        lam_max = rate * (1.0 + self.amplitude)
        n = rng.poisson(lam_max * duration)
        cand = np.sort(rng.uniform(0.0, duration, n))
        lam = rate * (1.0 + self.amplitude * np.sin(
            2.0 * np.pi * cand / self.period + self.phase))
        keep = rng.random(len(cand)) < lam / lam_max   # exact thinning
        return cand[keep]


def sample_arrivals(rng: np.random.Generator, rate: float, duration: float,
                    prof: TraceProfile) -> np.ndarray:
    """Legacy entry point: Gamma-modulated Poisson arrivals driven by the
    profile's ``burst_window``/``burst_shape`` fields (byte-identical RNG
    consumption to the pre-workload-package ``serving/trace.py``)."""
    return GammaPoisson(window=prof.burst_window,
                        shape=prof.burst_shape).sample(rng, rate, duration)
