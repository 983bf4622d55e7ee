"""Serving launcher of the PyTorch port: ``--mode real``.

Drives the ``ClusterScheduler`` (the port's copy of the JAX package's)
against real PyTorch model execution through ``RealTorchBackend``, with the
JAX launcher's flags and its JSON (schema v3, ``backend: "real-torch"``).
Added flags:

* ``--device`` (default ``cuda``): where the model runs; ``cpu`` runs the
  kernels' plain versions;
* ``--size {smoke,full}``: the reduced config the JAX real mode always
  runs, or the full-width one;
* ``--max-len``, ``--max-prompt``, ``--max-output``: the cache length and
  the caps on each request's prompt and output (the JAX real mode's fixed
  128 / 48 / 16).

The copied scheduler still prices iterations with the TPU-v5e cost model
(``perf/hardware.py::V5E``); under ``clock="wall"`` iteration durations
are the card's. Sim mode, ``--trace-csv`` and ``--backend trace-replay``
wait for a later slice (ROADMAP.md).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --arch qwen2-1.5b --size full --rate 2 --duration 6 --workers 2 --json
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

METRICS_SCHEMA_VERSION = 3     # v3: tiered-KV + prefix-reuse counters


def parse_slo_classes(spec: str) -> list[dict]:
    """Parse ``name:key=val,...;name:key=val,...`` into class descriptors.

    Keys: ``ttft``/``tpot`` (seconds), ``scale`` (K x the light-load phase
    latency, resolved against the cost model later), ``weight`` (default
    1), ``frac`` (rate share, default equal split). Raises ValueError with
    the offending fragment on malformed input."""
    classes = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        name, _, body = part.partition(":")
        name = name.strip()
        if not name or not body.strip():
            raise ValueError(f"malformed class spec {part!r} "
                             "(want name:key=val,...)")
        cls = {"name": name, "weight": 1.0, "frac": None,
               "ttft": None, "tpot": None, "scale": None}
        for kv in filter(None, (s.strip() for s in body.split(","))):
            key, eq, val = kv.partition("=")
            key = key.strip()
            if not eq or key not in ("ttft", "tpot", "scale", "weight",
                                     "frac"):
                raise ValueError(f"unknown key in class {name!r}: {kv!r}")
            try:
                cls[key] = float(val)
            except ValueError:
                raise ValueError(
                    f"class {name!r}: {key} must be a number, "
                    f"got {val!r}") from None
        has_any_abs = cls["ttft"] is not None or cls["tpot"] is not None
        has_abs = cls["ttft"] is not None and cls["tpot"] is not None
        if cls["scale"] is not None and has_any_abs:
            raise ValueError(
                f"class {name!r}: give ttft=+tpot= (seconds) OR scale=, "
                "not both")
        if not has_abs and cls["scale"] is None:
            raise ValueError(
                f"class {name!r} needs ttft=+tpot= (seconds) or scale=")
        for key in ("ttft", "tpot", "scale", "weight"):
            if cls[key] is not None and cls[key] <= 0:
                raise ValueError(f"class {name!r}: {key} must be > 0")
        if cls["frac"] is not None and not 0.0 < cls["frac"] <= 1.0:
            raise ValueError(f"class {name!r}: frac must be in (0, 1]")
        classes.append(cls)
    if not classes:
        raise ValueError("empty --slo-classes spec")
    names = [c["name"] for c in classes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate class names in spec: {names}")
    assigned = sum(c["frac"] for c in classes if c["frac"] is not None)
    if assigned > 1.0 + 1e-9:
        raise ValueError(
            f"class rate fracs sum to {assigned:g} > 1 (they split --rate)")
    unassigned = [c for c in classes if c["frac"] is None]
    if unassigned:
        left = 1.0 - assigned
        if left <= 1e-9:
            raise ValueError(
                "explicit fracs consume the whole rate but "
                + ", ".join(c["name"] for c in unassigned)
                + " carries no frac= — it would get zero traffic")
        for c in unassigned:
            c["frac"] = left / len(unassigned)
    return classes


def _classes_scenario(classes: list[dict], cost) -> "object":
    """Build a mixture Scenario from parsed --slo-classes descriptors:
    every class shares the mooncake-like profile and arrival process, but
    carries its own SLO tier and rate share."""
    from repro_torch.core.request import SLOClass
    from repro_torch.workload import (GammaPoisson, MOONCAKE, Scenario,
                                      ScenarioComponent)
    comps = []
    for c in classes:
        if c["ttft"] is not None and c["tpot"] is not None:
            ttft, tpot = c["ttft"], c["tpot"]
        else:
            k = c["scale"]
            ttft = k * cost.prefill_time(int(MOONCAKE.body_median * 4))
            tpot = k * cost.decode_iter_time(
                1, float(MOONCAKE.body_median * 4))
        slo = SLOClass(ttft=ttft, tpot=tpot, name=c["name"],
                       weight=c["weight"])
        comps.append(ScenarioComponent(
            name=c["name"], profile=MOONCAKE, arrivals=GammaPoisson(),
            rate_frac=c["frac"], slo=slo, weight=c["weight"]))
    return Scenario("slo-classes", tuple(comps))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm-20b")
    ap.add_argument("--policy", default="tropical",
                    choices=["vllm", "sarathi", "distserve", "tropical",
                             "tropical++"])
    ap.add_argument("--mode", default="real", choices=["real"],
                    help="only real mode is ported (sim mode: ROADMAP.md)")
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tp", type=int, default=8,
                    help="accepted for flag parity; real mode prices "
                         "tp=1 workers, as the JAX real mode does")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace synthesis + weight init seed")
    ap.add_argument("--scenario", default="mooncake",
                    help="named workload scenario (repro_torch.workload."
                         "SCENARIOS; 'mooncake' keeps the legacy §V-A trace)")
    ap.add_argument("--slo-classes", default=None, metavar="SPEC",
                    help="multi-tenant SLO tiers: 'name:ttft=S,tpot=S,"
                         "weight=W,frac=F;...' (or scale=K per §V-A)")
    ap.add_argument("--fail-worker", type=int, default=None,
                    help="inject a worker failure at duration/2")
    ap.add_argument("--ici-bw", type=float, default=None, metavar="GBPS",
                    help="per-link KV migration bandwidth in GB/s")
    ap.add_argument("--ici-links", type=int, default=None,
                    help="usable P2P links per worker (default 2)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV block granularity in tokens")
    ap.add_argument("--no-transfer-engine", action="store_true",
                    help="legacy fixed-delay migrations (no link contention)")
    ap.add_argument("--host-kv-gb", type=float, default=0.0, metavar="GB",
                    help="per-worker host-DRAM KV tier (default 0 = off)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="per-worker cross-request prefix cache")
    ap.add_argument("--online-predictor", action="store_true",
                    help="EWMA-correct the §IV-C predictor from observed "
                         "(wall-clock) iteration durations")
    ap.add_argument("--recalibrate-every", type=int, default=None,
                    metavar="N",
                    help="online drift recalibration every N iterations")
    ap.add_argument("--no-rebalance", action="store_true",
                    help="keep the legacy dispatch-count role review "
                         "instead of windowed-attainment rebalancing")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--reference", action="store_true",
                    help="run the scalar reference scheduler/engine "
                         "instead of the vectorized fast paths")
    ap.add_argument("--profile", action="store_true",
                    help="run under cProfile; print the top-25 "
                         "cumulative-time entries to stderr")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"],
                    help="reduced config (as JAX real mode) or full width")
    ap.add_argument("--max-len", type=int, default=128,
                    help="KV cache length per slot")
    ap.add_argument("--max-prompt", type=int, default=48,
                    help="cap on each request's prompt length")
    ap.add_argument("--max-output", type=int, default=16,
                    help="cap on each request's output length")
    return ap


def run(argv: Optional[Sequence[str]] = None):
    """Parse, build and run; returns ``(row, backend)`` where ``row`` is
    the metrics object ``main`` prints and ``backend`` the
    ``RealTorchBackend`` that ran it (its executors and counters)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.ici_bw is not None and args.ici_bw <= 0:
        ap.error("--ici-bw must be > 0 (migrated KV can never arrive "
                 "over a zero-bandwidth link)")
    if args.ici_links is not None and args.ici_links <= 0:
        ap.error("--ici-links must be > 0 (zero links stall every "
                 "migration forever)")
    if args.page_size <= 0:
        ap.error("--page-size must be a positive token count")
    if args.recalibrate_every is not None and args.recalibrate_every < 1:
        ap.error("--recalibrate-every must be >= 1 iteration "
                 "(omit the flag to disable online recalibration)")
    if args.host_kv_gb < 0:
        ap.error("--host-kv-gb must be >= 0 (0 disables the host tier)")
    if min(args.max_prompt, args.max_output) < 1 or \
            args.max_prompt + args.max_output > args.max_len:
        ap.error("need 1 <= --max-prompt, --max-output and --max-prompt + "
                 "--max-output <= --max-len")

    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.perf import WorkerSpec
    from repro_torch.serving.executor import ClusterRealExecutors
    from repro_torch.serving.simulator import build_cluster
    from repro_torch.workload import SCENARIOS, generate_trace, get_scenario

    if args.scenario not in SCENARIOS:
        ap.error(f"--scenario must be one of {sorted(SCENARIOS)}")
    classes = None
    if args.slo_classes is not None:
        try:
            classes = parse_slo_classes(args.slo_classes)
        except ValueError as e:
            ap.error(f"--slo-classes: {e}")
        if args.scenario != "mooncake":
            ap.error("--slo-classes defines its own workload and cannot "
                     "be combined with --scenario (drop one of the flags)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")

    cfg = get_config(args.arch) if args.size == "full" \
        else get_smoke(args.arch)
    sim, cost = build_cluster(
        cfg, args.policy, n_workers=args.workers, worker_spec=WorkerSpec(tp=1),
        use_transfer_engine=not args.no_transfer_engine,
        ici_bw=args.ici_bw * 1e9 if args.ici_bw is not None else None,
        ici_links=args.ici_links, page_size=args.page_size,
        online_predictor=args.online_predictor,
        recalibrate_every=args.recalibrate_every,
        role_rebalance=False if args.no_rebalance else "auto",
        host_kv_gb=args.host_kv_gb, prefix_cache=args.prefix_cache,
        vectorized=not args.reference)
    if classes is not None:
        scenario = _classes_scenario(classes, cost)
        feed = scenario.generate(args.rate, args.duration, cost,
                                 seed=args.seed)
    elif args.scenario != "mooncake":
        feed = get_scenario(args.scenario).generate(
            args.rate, args.duration, cost, seed=args.seed)
    else:
        feed = generate_trace(args.rate, args.duration, cost, seed=args.seed)

    for r in feed:   # cap to the cache
        r.prompt_len = min(r.prompt_len, args.max_prompt)
        r.output_len = min(r.output_len, args.max_output)
    execs = ClusterRealExecutors(cfg, args.workers, max_slots=8,
                                 max_len=args.max_len, device=args.device,
                                 seed=args.seed)
    backend = execs.as_backend(clock="wall")
    sim.sched.backend = backend
    sim.add_trace(feed)
    if args.fail_worker is not None:
        sim.inject_failure(args.duration / 2, args.fail_worker,
                           recover_after=args.duration / 4)
    if args.profile:
        import cProfile
        import pstats
        import sys as _sys
        pr = cProfile.Profile()
        pr.enable()
        try:
            m = sim.run(until=args.duration * 10)
        finally:
            pr.disable()
            stats = pstats.Stats(pr, stream=_sys.stderr)
            stats.sort_stats("cumulative")
            print("# --profile: top 25 by cumulative time",
                  file=_sys.stderr)
            stats.print_stats(25)
    else:
        m = sim.run(until=args.duration * 10)

    row = m.row()
    row.update(policy=args.policy, arch=cfg.name, mode=args.mode,
               backend="real-torch", rate=args.rate, workers=args.workers,
               seed=args.seed,
               scenario="slo-classes" if classes is not None
               else args.scenario,
               schema_version=METRICS_SCHEMA_VERSION,
               per_class=m.per_class_rows())
    if sim.transfer is not None:
        row.update(kv_bytes_migrated=sim.transfer.bytes_moved,
                   transfer_seconds=sim.transfer.total_transfer_seconds)
    pred = sim.policy.predictor
    if hasattr(pred, "prefill_scale"):
        row.update(predictor_prefill_scale=round(pred.prefill_scale, 4),
                   predictor_decode_scale=round(pred.decode_scale, 4))
    if sim.sched.rebalancer is not None:
        row.update(role_transitions=len(sim.sched.rebalancer.transitions))
    if sim.sched.drift_monitor is not None:
        lo, hi = sim.sched.drift_monitor.gamma_range()
        row.update(recalibrate_every=sim.sched.drift_monitor.every,
                   recalibrations=sim.sched.drift_monitor.recalibrations,
                   drift_gamma_min=round(lo, 4), drift_gamma_max=round(hi, 4))
    return row, backend


def main(argv: Optional[Sequence[str]] = None) -> dict:
    row, _ = run(argv)
    if build_parser().parse_args(argv).json:
        print(json.dumps(row, indent=1, sort_keys=True, default=float))
    else:
        for k, v in row.items():
            if k == "per_class":
                continue
            print(f"{k:>22}: {v}")
        for name, cm in row["per_class"].items():
            cols = " ".join(f"{ck}={cv:.4g}" if isinstance(cv, float)
                            else f"{ck}={cv}" for ck, cv in cm.items())
            print(f"{'class ' + name:>22}: {cols}")
    return row


if __name__ == "__main__":
    main()
