"""One run of one cell of the port's serving benchmark on the card.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (timed from the process's start; its parts are printed on standard
error): imports, the kernels' build or load (``build/repro_torch_kernels``
in the checkout; only a checkout's first run compiles), the weights drawn
on the card from the seed, the executors' caches, every step the cell's
traffic can ask for captured as a CUDA graph, and the arrivals. Then one
window (``servebench/serve.py``), then the check of what it served
(``servebench/check.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, as
``BENCHMARK.json`` names them), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error.

It needs a CUDA card and the port (``src/repro_torch``) beside it, and
fails without them. It refuses to print a result if ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded when the window has
closed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on the ``time.time()`` clock."""
    try:
        tick = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / tick
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
ROOT = Path(__file__).resolve().parent.parent
FOREIGN = ("jax", "jaxlib", "flax", "repro")
# positions a MoE cell's check may leave out for routing near a tie: past
# this, the check would judge too few of the served tokens
LEFT_OUT_SHARE = 0.5


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, the whole top-level name compared (``repro_torch`` is the port)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FOREIGN))


def say(*parts) -> None:
    print("servebench:", *parts, file=sys.stderr, flush=True)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics ``BENCHMARK.json`` asks of this cell in this kind of
    run: (name, unit)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if cell in m.get("workloads", [cell])]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             parts: dict) -> dict:
    """Set up, serve one window and check it: the run's numbers. ``parts``
    receives the set-up's parts in seconds."""
    import gc
    import types
    import torch
    from repro_torch.kernels import build, chunked_prefill, paged_attention
    from servebench import check, serve, stats, traffic, weights
    from servebench.metrics import reader
    from servebench.trace import START_SHARE, Tracer

    t = time.time()
    parts["imports_s"] = t - STARTED
    device = torch.device(device)
    if device.type == "cuda":
        libs = [chunked_prefill.LIB, paged_attention.LIB]
        parts["compiled"] = not all(lib.path.exists() for lib in libs)
        build.build_all(libs)
        t, parts["kernels_s"] = time.time(), time.time() - t
    params = weights.make(cell.config.layout(), seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t, parts["weights_s"] = time.time(), time.time() - t
    port = serve.Port(cell, params, device)
    t, parts["caches_s"] = time.time(), time.time() - t
    parts["steps_warmed"] = port.warm()
    t, parts["captures_s"] = time.time(), time.time() - t
    arrivals = traffic.generate(cell.mix, seed, cell.rate,
                                serve.offered_horizon(seconds))
    tracer = None
    if trace:
        tracer = Tracer()
        tracer.warm()
        tracer.patch()
        tracer.start_at = START_SHARE * seconds
    t, parts["traffic_s"] = time.time(), time.time() - t
    setup_s = time.time() - STARTED

    try:
        win = serve.run_window(port, cell, arrivals, seconds, tracer=tracer,
                               record=trace)
    finally:
        if tracer is not None:
            tracer.unpatch()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    summary = stats.summarize(win.served, win.close, win.wall_s)
    profile = tracer.result if tracer is not None else None
    layer = {}
    if trace:
        run = types.SimpleNamespace(window=win, shape=cell.config.shape(),
                                    cell=cell, profile=profile)
        for name, _ in cell_metrics(load_bench(), cell.name, True):
            value = reader(name)(run)
            if value is not None:
                layer[name] = value

    items = check.sample(win, port, cell, seed)
    missing = sum(abs(it.output - len(it.served)) for it in items)
    win.backend = win.recorder.inner = win.recorder.execs = None
    port.free()
    gc.collect()
    good = [it for it in items if len(it.served) == it.output]
    found = check.gaps(params, cell.config, good, device,
                       route_margin=cell.correct.get("route_margin", 0.0)) \
        if good else {"widest_gap": -1.0, "tokens_compared": 0,
                      "left_out": 0}
    left_out = found["left_out"] / max(1, found["tokens_compared"])
    return dict(summary=summary, setup_s=setup_s, peak=peak, layer=layer,
                profile=profile,
                checks={"widest_gap": (found["widest_gap"],
                                       cell.correct["widest_gap"]),
                        "tokens_missing": (missing, 0),
                        "requests_compared": (len(good), 1),
                        "left_out_share": (left_out, LEFT_OUT_SHARE)},
                tokens_compared=found["tokens_compared"],
                captures_in_window=win.captures, drained=win.drained)


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def checks_pass(checks: dict) -> bool:
    """widest_gap, tokens_missing and left_out_share at most their limits;
    at least the limit's number of requests compared; and some position
    compared (a widest gap of -1 compared none)."""
    gap, gap_limit = checks["widest_gap"]
    missing, _ = checks["tokens_missing"]
    compared, least = checks["requests_compared"]
    share, most = checks["left_out_share"]
    return 0 <= gap <= gap_limit and missing == 0 and compared >= least \
        and share <= most


def breakdown(profile) -> dict:
    ops = sorted(profile.kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(profile.idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from servebench.cells import Cell

    bench = load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        say(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        say(f"needs {need} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cell = Cell.load(args.workload)
    parts: dict = {}
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   parts)
    say("setup", " ".join(f"{k}={v:.3f}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in parts.items()),
        f"setup_s={out['setup_s']:.3f}")
    bad = foreign_modules()
    if bad:
        say("loaded modules the benchmark must not load:", ", ".join(bad))
        return 3
    s = out["summary"]
    metrics = {}
    for name, unit in cell_metrics(bench, cell.name, bool(args.trace)):
        if args.trace:
            if name in out["layer"]:
                metrics[name] = {"value": out["layer"][name], "unit": unit}
        else:
            value = out["setup_s"] if name == "setup_s" else s[name]
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(out["peak"]),
           "power_limit": power_limit()}
    result = {"correct": checks_pass(out["checks"]),
              "attempted": s["attempted"], "failed": s["failed"],
              "metrics": metrics, "device": dev}
    if args.trace and out["profile"] is not None:
        p = out["profile"]
        dev.update(busy_s=p.busy_s, window_s=p.window_s)
        result["breakdown"] = breakdown(p)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    say("window", f"attempted={s['attempted']} failed={s['failed']}",
        f"output_tokens={s['output_tokens']}",
        f"tokens_compared={out['tokens_compared']}",
        f"captures_in_window={out['captures_in_window']}",
        f"drained={out['drained']}")
    for k, (v, lim) in out["checks"].items():
        say("check", f"{k}={v} limit={lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
