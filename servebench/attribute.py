"""Where the card's idle time goes, by the port's own spans: one traced
window of a cell, run as ``run.py --trace 1`` runs it, with its profile's
events kept and reduced by ``servebench.program`` after the window.

    python3 servebench/attribute.py --workload <cell> --seed <n> \\
        --seconds <s> [--out PATH]

It prints one JSON object (and writes it to PATH): the run's per-layer
metrics as ``run.py`` reports them, beside those that read the program's
spans (``READS_PROGRAM``, whose readers find the reduction as the
profile's ``program``); the idle seconds under the benchmark's own host
regions (the profile's ``idle``) and split by the program's spans, by
innermost span and by ``servebench.program.category``; each span's count,
total and self seconds; the decode and prefill replays' device time; and
the clock check: the launch lag of each operation that ends an idle gap
(its smallest, median and largest, and how many are negative) and the
drift between the host's and the card's clocks; and ``stop_s``, the wall
seconds the tracer's stop (the profiler's stop and the harness's
reduction) took inside the window, which ``sched.host_ms_per_iter``
counts as host time. It needs a CUDA card, as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
READS_PROGRAM = ("sched.self_ms_per_iter", "executor.host_ms_per_iter",
                 "executor.decode_step_device_ms",
                 "device.idle_in_sched_share",
                 "device.idle_in_executor_share",
                 "device.idle_in_wait_share",
                 "device.idle_outside_program_share")


def attribute(prof, program) -> dict:
    """The report of one traced sub-window: ``prof`` the run's
    ``servebench.trace.Profile``, ``program`` its
    ``servebench.program.Program``."""
    from servebench import program as pg
    by_cat: dict = {}
    for name, s in program.idle.items():
        by_cat[pg.category(name)] = by_cat.get(pg.category(name), 0.0) + s
    lags = sorted(program.lags_ns)
    return {
        "window_s": prof.window_s, "busy_s": prof.busy_s,
        "gaps_s": sum(program.idle.values()),
        "idle_by_region": dict(sorted(prof.idle.items(),
                                      key=lambda kv: -kv[1])),
        "idle_by_category": by_cat,
        "idle_by_span": dict(sorted(program.idle.items(),
                                    key=lambda kv: -kv[1])),
        "spans": {n: {"count": c, "total_s": t, "self_s": s}
                  for n, (c, t, s) in sorted(program.spans.items(),
                                             key=lambda kv: -kv[1][2])},
        "replay": {k: {"spans": n, "ops": o, "device_s": s}
                   for k, (n, o, s) in program.replay.items()},
        "clock": {"gaps_checked": len(lags),
                  "negative": sum(lag < 0 for lag in lags),
                  "min_lag_us": lags[0] * 1e-3 if lags else None,
                  "median_lag_us": statistics.median(lags) * 1e-3
                  if lags else None,
                  "max_lag_us": lags[-1] * 1e-3 if lags else None,
                  "drift_ms_per_s": program.drift_ms_per_s,
                  "ok": program.clock_ok},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from servebench import program, run, trace
    from servebench.cells import Cell
    from servebench.metrics import reader

    kept, stops = [], []

    class Keeping(trace.Tracer):
        """The harness's tracer, keeping the profile for after the
        window (reducing it here adds nothing inside the window) and
        timing its stop."""

        def _reduce(self, prof, rec):
            kept.append(prof)
            return super()._reduce(prof, rec)

        def _stop(self, wall, rec):
            t0 = time.perf_counter()
            super()._stop(wall, rec)
            stops.append(time.perf_counter() - t0)

    trace.Tracer = Keeping
    cell = Cell.load(args.workload)
    parts: dict = {}
    out = run.run_cell(cell, args.seed, args.seconds, True, "cuda", parts)
    prof = out["profile"]
    prof.program = program.reduce(program.records(
        kept[0].profiler.kineto_results.events()))
    layer = dict(out["layer"])
    for name in READS_PROGRAM:
        layer[name] = reader(name)(types.SimpleNamespace(profile=prof))
    result = {"workload": cell.name, "seed": args.seed,
              "correct": run.checks_pass(out["checks"]),
              "metrics": layer, "setup_s": out["setup_s"],
              "stop_s": stops[0],
              **attribute(prof, prof.program)}
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
