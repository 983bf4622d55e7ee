"""Serving launcher of the PyTorch port.

Two modes, as in the JAX launcher (``repro/launch/serve.py``):

* ``--mode real`` (the default here): drives the ``ClusterScheduler`` (the
  port's copy of the JAX package's) against real PyTorch model execution
  through ``RealTorchBackend``, on the card unless ``--device cpu`` asks
  for the CPU. JSON ``backend`` is ``"real-torch"``. It serves every
  family but encdec (whisper), which the executors refuse at construction
  as the JAX real mode fails on it (``serving.executor.refuse_encdec``).
* ``--mode sim``: the cluster-scale discrete-event run the paper's figures
  use, the JAX launcher's default mode: the full-size config of any of the
  11 architectures priced by the copied cost model (``--tp``-way workers,
  ``perf/hardware.py::V5E``, as in JAX), with ``--backend cost-model``
  (the trace materialised up front) or ``--backend trace-replay``
  (arrivals streamed lazily, identical decisions). It touches no device
  and imports no model code, so ``--device`` does not matter there, and
  its JSON row equals the JAX launcher's key for key.

The port keeps ``real`` as its default, so that the entry point runs on
the card unless asked otherwise; the JAX launcher defaults to ``sim``.

Both modes take the JAX launcher's flags, ``--trace-csv`` (a recorded
Mooncake-schema CSV replayed instead of a synthesised trace) and
``--slo-classes`` included, and print its JSON (schema v3). Real mode
adds:

* ``--device`` (default ``cuda``): where the model runs; ``cpu`` runs the
  kernels' plain versions;
* ``--size {smoke,full}``: the reduced config the JAX real mode always
  runs, or the full-width one;
* ``--max-len``, ``--max-prompt``, ``--max-output``: the cache length and
  the caps on each request's prompt and output (the JAX real mode's fixed
  128 / 48 / 16), applied to CSV traces too.

``--torch-trace PATH`` (either mode) runs the serving loop under
``torch.profiler`` and writes its Chrome trace to PATH: the port's spans
(``repro_torch.tracing``: the scheduler's run, events and decisions, the
executor's iterations with their worker and request ids, each iteration's
host preparation, upload, graph replays, device-to-host copy and
write-back) beside the kernels they launched, on one clock. It is the way
to read the spans; chrome://tracing or Perfetto opens the file. The
printed row is the same with or without it.

On a CUDA device each worker is priced as one ``perf.cards.H100`` (the
card's data-sheet peaks, the assumed efficiency fractions) whose
``hbm_bytes`` is the card's own memory, so admission, slack-bounded
chunks, trace SLOs and KV/state capacity follow the card. The launcher
does not calibrate at start-up, as the JAX one does not:
``perf.calibrate.calibrate_hardware(H100)`` measures the fractions. On the
CPU the workers are plain V5Es (``perf/hardware.py``), as in the JAX real
mode, so scheduling decisions there equal the JAX package's. Under
``clock="wall"`` iteration durations are the device's.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \
      --arch arctic-480b --json
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --arch rwkv6-7b --size full --rate 1.5 --duration 5 --workers 2 --json
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --arch zamba2-2.7b --device cpu --rate 2 --duration 4 --workers 2 --json
"""
from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--mode", default="real", choices=["sim", "real"],
                    help="real (default here; the JAX launcher defaults to "
                         "sim): PyTorch execution on --device; sim: the "
                         "discrete-event cluster run, no device")
    ap.add_argument("--backend", default="cost-model",
                    choices=["cost-model", "trace-replay"],
                    help="sim-mode execution backend: 'cost-model' "
                         "materialises the trace up front; 'trace-replay' "
                         "streams arrivals lazily (identical decisions)")
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tp", type=int, default=8,
                    help="tensor-parallel width of a sim-mode worker; real "
                         "mode prices tp=1 workers, as the JAX real mode "
                         "does")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace synthesis + weight init seed")
    ap.add_argument("--scenario", default="mooncake",
                    help="named workload scenario (repro_torch.workload."
                         "SCENARIOS; 'mooncake' keeps the legacy §V-A trace)")
    ap.add_argument("--slo-classes", default=None, metavar="SPEC",
                    help="multi-tenant SLO tiers: 'name:ttft=S,tpot=S,"
                         "weight=W,frac=F;...' (or scale=K per §V-A); "
                         "defines its own mixture workload (mutually "
                         "exclusive with a non-default --scenario) or "
                         "maps a --trace-csv slo_class column")
    ap.add_argument("--trace-csv", default=None, metavar="PATH",
                    help="replay a recorded Mooncake-schema CSV instead of "
                         "synthesising (--rate/--duration/--scenario are "
                         "ignored for arrivals)")
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
    ap.add_argument("--torch-trace", default=None, metavar="PATH",
                    help="run the serving loop under torch.profiler and "
                         "write its Chrome trace (the port's spans beside "
                         "the kernels) to PATH")
    ap.add_argument("--device", default="cuda",
                    help="real mode: torch device of the model (default "
                         "cuda); on a CUDA device each worker is priced as "
                         "an H100 with the card's memory, on the CPU as a "
                         "TPU v5e")
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"],
                    help="real mode: reduced config (as JAX real mode) or "
                         "full width")
    ap.add_argument("--max-len", type=int, default=128,
                    help="real mode: KV cache length per slot")
    ap.add_argument("--max-prompt", type=int, default=48,
                    help="real mode: cap on each request's prompt length")
    ap.add_argument("--max-output", type=int, default=16,
                    help="real mode: cap on each request's output length")
    return ap


def _run_sim(sim, args):
    """``sim.run`` over the horizon; with ``--torch-trace``, under
    ``torch.profiler`` (the card's activity too in real mode on a CUDA
    device), its Chrome trace written to the path given. Shapes are
    recorded, so the spans keep their ids."""
    until = args.duration * 10
    if args.torch_trace is None:
        return sim.run(until=until)
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if args.mode == "real" and torch.device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        m = sim.run(until=until)
    prof.export_chrome_trace(args.torch_trace)
    return m


def run(argv: Optional[Sequence[str]] = None):
    """Parse, build and run; returns ``(row, backend)`` where ``row`` is
    the metrics object ``main`` prints and ``backend`` the
    ``RealTorchBackend`` that ran it (its executors and counters), None in
    sim mode."""
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

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.perf import H100, V5E, WorkerSpec
    from repro_torch.serving.simulator import build_cluster
    from repro_torch.workload import SCENARIOS, generate_trace, \
        get_scenario, load_csv, replay_csv

    if args.backend == "trace-replay" and args.mode == "real":
        ap.error("--backend trace-replay streams the simulated clock; "
                 "--mode real owns its own backend (drop one of the flags)")
    if args.scenario not in SCENARIOS:
        ap.error(f"--scenario must be one of {sorted(SCENARIOS)}")
    classes = None
    if args.slo_classes is not None:
        try:
            classes = parse_slo_classes(args.slo_classes)
        except ValueError as e:
            ap.error(f"--slo-classes: {e}")
        if args.scenario != "mooncake" and not args.trace_csv:
            ap.error("--slo-classes defines its own workload and cannot "
                     "be combined with --scenario (use --trace-csv to "
                     "replay recorded traffic under these tiers, or drop "
                     "one of the flags)")

    if args.mode == "real":
        import torch
        if args.device.startswith("cuda") and not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: no CUDA device here "
                               "(pass --device cpu to run on the CPU)")
        cfg = get_config(args.arch) if args.size == "full" \
            else get_smoke(args.arch)
        device = torch.device(args.device)
        hw = V5E if device.type != "cuda" else dataclasses.replace(
            H100, hbm_bytes=float(torch.cuda.get_device_properties(
                device).total_memory))
        spec = WorkerSpec(tp=1, hw=hw)
    else:
        cfg = get_config(args.arch)
        spec = WorkerSpec(tp=args.tp)
    sim, cost = build_cluster(
        cfg, args.policy, n_workers=args.workers, worker_spec=spec,
        use_transfer_engine=not args.no_transfer_engine,
        ici_bw=args.ici_bw * 1e9 if args.ici_bw is not None else None,
        ici_links=args.ici_links, page_size=args.page_size,
        online_predictor=args.online_predictor,
        recalibrate_every=args.recalibrate_every,
        role_rebalance=False if args.no_rebalance else "auto",
        host_kv_gb=args.host_kv_gb, prefix_cache=args.prefix_cache,
        vectorized=not args.reference)
    # one workload-source selection for both feeds, as in the JAX launcher:
    # each leaf names the (materialised, streaming) pair
    streaming = args.backend == "trace-replay"
    if classes is not None:
        scenario = _classes_scenario(classes, cost)
        if args.trace_csv:
            feed = replay_csv(args.trace_csv, cost,
                              classes=scenario.classes) if streaming \
                else load_csv(args.trace_csv, cost, classes=scenario.classes)
        else:
            feed = (scenario.replay if streaming else scenario.generate)(
                args.rate, args.duration, cost, seed=args.seed)
    elif args.trace_csv:
        feed = replay_csv(args.trace_csv, cost) if streaming \
            else load_csv(args.trace_csv, cost)
    elif args.scenario != "mooncake":
        scenario = get_scenario(args.scenario)
        feed = (scenario.replay if streaming else scenario.generate)(
            args.rate, args.duration, cost, seed=args.seed)
    else:
        trace = generate_trace(args.rate, args.duration, cost,
                               seed=args.seed)
        feed = ((r.arrival_time, r) for r in trace) if streaming else trace

    backend = None
    if streaming:
        sim.add_replay(feed)
    else:
        if args.mode == "real":
            from repro_torch.serving.executor import ClusterRealExecutors
            for r in feed:   # cap to the cache
                r.prompt_len = min(r.prompt_len, args.max_prompt)
                r.output_len = min(r.output_len, args.max_output)
            execs = ClusterRealExecutors(cfg, args.workers, max_slots=8,
                                         max_len=args.max_len,
                                         device=args.device, seed=args.seed)
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
            m = _run_sim(sim, args)
        finally:
            pr.disable()
            stats = pstats.Stats(pr, stream=_sys.stderr)
            stats.sort_stats("cumulative")
            print("# --profile: top 25 by cumulative time",
                  file=_sys.stderr)
            stats.print_stats(25)
    else:
        m = _run_sim(sim, args)

    # label the workload that actually ran, as the JAX launcher does
    if args.trace_csv:
        scenario_label = "trace-csv"
    elif classes is not None:
        scenario_label = "slo-classes"
    else:
        scenario_label = args.scenario
    row = m.row()
    row.update(policy=args.policy, arch=cfg.name, mode=args.mode,
               backend=args.backend if args.mode == "sim" else "real-torch",
               rate=args.rate, workers=args.workers, seed=args.seed,
               scenario=scenario_label,
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
