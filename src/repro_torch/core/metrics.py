"""SLO attainment + latency metrics (paper Eq. 1-3, Figs. 8-11)."""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.request import Phase, Request


def percentile(xs: Sequence[float], p: float) -> float:
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


@dataclasses.dataclass
class ClassMetrics:
    """Attainment + latency tails for one SLO class (multi-tenant view)."""
    name: str
    weight: float
    n_total: int
    n_finished: int
    slo_attainment: float
    ttft_attainment: float
    tpot_attainment: float
    ttft_avg: float
    ttft_p90: float
    tpot_avg: float
    tpot_p90: float

    def row(self) -> dict:
        return {k: getattr(self, k) for k in (
            "weight", "n_total", "n_finished", "slo_attainment",
            "ttft_attainment", "tpot_attainment", "ttft_avg", "ttft_p90",
            "tpot_avg", "tpot_p90")}


@dataclasses.dataclass
class ServeMetrics:
    n_total: int
    n_finished: int
    slo_attainment: float          # Eq. 3
    ttft_attainment: float
    tpot_attainment: float
    ttft_avg: float
    ttft_p90: float
    tpot_avg: float
    tpot_p90: float
    queue_avg: float
    queue_p90: float
    ttfts: list
    tpots: list
    queues: list
    blocked_time_avg: float        # decode blocked by prefill (interference)
    migrations: int
    restarts: int
    preemptions: int               # KV watermark/pool evictions
    migration_wait_avg: float      # seconds a migrated request sat on links
    # multi-tenant view: one ClassMetrics per SLO class seen in the run and
    # the class-weight-normalised attainment Σ w_c·A_c / Σ w_c (equals
    # slo_attainment when every request shares one class)
    per_class: dict = dataclasses.field(default_factory=dict)
    weighted_attainment: float = float("nan")
    # tiered KV + prefix reuse (all zero when neither feature is on)
    kv_offloads: int = 0           # decode KV spills to the host-DRAM tier
    kv_restores: int = 0           # spills pulled back into HBM
    pages_offloaded: int = 0
    pages_restored: int = 0
    pages_reprefilled: int = 0     # pages lost to evict + full re-prefill
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_rate: float = 0.0   # hits / lookups (0 when no lookups)

    def row(self) -> dict:
        return {k: getattr(self, k) for k in (
            "n_total", "n_finished", "slo_attainment", "ttft_attainment",
            "tpot_attainment", "ttft_avg", "ttft_p90", "tpot_avg",
            "tpot_p90", "queue_avg", "queue_p90", "blocked_time_avg",
            "migrations", "restarts", "preemptions", "migration_wait_avg",
            "weighted_attainment", "kv_offloads", "kv_restores",
            "pages_offloaded", "pages_restored", "pages_reprefilled",
            "prefix_lookups", "prefix_hits", "prefix_hit_rate")}

    def per_class_rows(self) -> dict:
        """{class_name: flat metric dict} — the JSON-facing projection."""
        return {name: cm.row() for name, cm in sorted(self.per_class.items())}


def _class_metrics(name: str, weight: float,
                   reqs: Sequence[Request]) -> ClassMetrics:
    fin = [r for r in reqs if r.phase == Phase.FINISHED]
    ttfts = [r.ttft() for r in fin]
    tpots = [r.tpot() for r in fin]
    n = max(len(reqs), 1)
    return ClassMetrics(
        name=name, weight=weight,
        n_total=len(reqs), n_finished=len(fin),
        slo_attainment=sum(1 for r in fin if r.slo_ok()) / n,
        ttft_attainment=sum(1 for r in fin if r.ttft_ok()) / n,
        tpot_attainment=sum(1 for r in fin if r.tpot_ok()) / n,
        ttft_avg=float(np.mean(ttfts)) if ttfts else float("nan"),
        ttft_p90=percentile(ttfts, 90),
        tpot_avg=float(np.mean(tpots)) if tpots else float("nan"),
        tpot_p90=percentile(tpots, 90),
    )


def compute_metrics(requests: Iterable[Request],
                    queue_times: Optional[dict] = None,
                    blocked_times: Optional[dict] = None,
                    counters: Optional[dict] = None) -> ServeMetrics:
    reqs = list(requests)
    fin = [r for r in reqs if r.phase == Phase.FINISHED]
    by_class: dict[str, list[Request]] = {}
    weights: dict[str, float] = {}
    for r in reqs:
        by_class.setdefault(r.slo.name, []).append(r)
        weights[r.slo.name] = getattr(r.slo, "weight", 1.0)
    per_class = {name: _class_metrics(name, weights[name], rs)
                 for name, rs in by_class.items()}
    w_sum = sum(cm.weight for cm in per_class.values())
    weighted = sum(cm.weight * cm.slo_attainment
                   for cm in per_class.values()) / w_sum \
        if w_sum > 0 else float("nan")
    ttfts = [r.ttft() for r in fin]
    tpots = [r.tpot() for r in fin]
    ok_ttft = [r for r in fin if r.ttft_ok()]
    ok_tpot = [r for r in fin if r.tpot_ok()]
    ok_both = [r for r in fin if r.slo_ok()]
    n = max(len(reqs), 1)
    queues = list((queue_times or {}).values())
    blocked = list((blocked_times or {}).values())
    waits = [r.migration_wait for r in reqs if r.migrations > 0]
    return ServeMetrics(
        n_total=len(reqs),
        n_finished=len(fin),
        slo_attainment=len(ok_both) / n,
        ttft_attainment=len(ok_ttft) / n,
        tpot_attainment=len(ok_tpot) / n,
        ttft_avg=float(np.mean(ttfts)) if ttfts else float("nan"),
        ttft_p90=percentile(ttfts, 90),
        tpot_avg=float(np.mean(tpots)) if tpots else float("nan"),
        tpot_p90=percentile(tpots, 90),
        queue_avg=float(np.mean(queues)) if queues else float("nan"),
        queue_p90=percentile(queues, 90),
        ttfts=ttfts,
        tpots=tpots,
        queues=queues,
        blocked_time_avg=float(np.mean(blocked)) if blocked else 0.0,
        migrations=sum(r.migrations for r in reqs),
        restarts=sum(r.restarts for r in reqs),
        preemptions=sum(r.preemptions for r in reqs),
        migration_wait_avg=float(np.mean(waits)) if waits else 0.0,
        per_class=per_class,
        weighted_attainment=weighted,
        **_tier_counters(counters or {}),
    )


def _tier_counters(counters: dict) -> dict:
    """Aggregate worker-level tiered-KV/prefix counters (scheduler-supplied;
    the prefix hit *rate* is derived here so callers pass raw counts only)."""
    keys = ("kv_offloads", "kv_restores", "pages_offloaded",
            "pages_restored", "pages_reprefilled", "prefix_lookups",
            "prefix_hits")
    out = {k: int(counters.get(k, 0)) for k in keys}
    lookups = out["prefix_lookups"]
    out["prefix_hit_rate"] = out["prefix_hits"] / lookups if lookups else 0.0
    return out


def cdf(xs: Sequence[float], n_points: int = 50):
    """(value, fraction<=value) pairs for Fig.11-style CDFs."""
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return []
    out = []
    for i in range(n_points + 1):
        q = i / n_points
        idx = min(int(q * (len(xs) - 1)), len(xs) - 1)
        out.append((xs[idx], q))
    return out


def derive_slos(cost_model, prompt_len: int, ttft_scale: float = 5.0,
                tpot_scale: float = 5.0):
    """Paper §V-A: SLO = scale x the light-workload latency of the phase."""
    from repro_torch.core.request import SLOSpec
    t_prefill = cost_model.prefill_time(prompt_len)
    t_decode = cost_model.decode_iter_time(1, float(prompt_len))
    return SLOSpec(ttft=ttft_scale * t_prefill, tpot=tpot_scale * t_decode)
