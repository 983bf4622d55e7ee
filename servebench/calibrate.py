"""Fix a cell's numbers on the card, once, when the cell is defined: its SLO
limits, its knee and rate, and the readings its correctness limit is set
from. Not part of a benchmark run.

    python3 servebench/calibrate.py --workload <cell> [--light-rate R]
        [--sweep R0 --step 1.25] [--seconds S] [--control-seeds a,b,c]
        [--control-seconds S]

In one process, over one set of captured steps (weights redrawn in place
for each seed, the executors' requests forgotten between windows):

1. light load (``--light-rate``): the paper's section V-A rule, 5x the
   light-load latency. TTFT limit = 5 (a + b * prompt) from a least-squares
   line through the light-load TTFTs; TPOT limit = 5 x their median TPOT.
2. the sweep from ``--sweep`` up by ``--step``: the knee is the highest
   offered rate (requests a scheduler second) at which at least 90% of the
   offered requests meet both limits and the backlog (requests offered and
   waiting for their first token) is no larger when the offer closes than
   half-way through it, plus 3; the cell's rate is 0.8 x the knee. With
   ``--sweep-seeds``, each rate runs one window a seed and is judged by the
   median attainment and the median backlog growth (and the spread of
   each metric over the seeds is shown).
3. the control (``--control-seeds``): at the cell's rate (or 0.8 x the
   knee just found), each seed's window and both widest gaps, the port's
   and the e4m3 reference's (``servebench/check.py``).

Each window prints a JSON line; the last line sums them up.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _plain(o):
    """numpy scalars as Python numbers, for json."""
    return o.item()


def _cell_with(cell, **changes):
    from servebench.cells import Cell
    return Cell({**cell.raw, **changes}, cell.config, cell.mix)


def _window(port, cell, seed, seconds):
    """One window at ``cell``'s rate and limits, after forgetting the last
    one's requests, with the backlog counted half-way through the offer
    and when it closes."""
    from servebench import serve, stats, traffic
    port.reset()
    arrivals = traffic.generate(cell.mix, seed, cell.rate,
                                serve.offered_horizon(seconds))
    offer = cell.offer_share * seconds
    marks: dict = {}

    def watch(wall, sim):
        for key, at in (("half", offer / 2), ("close", offer)):
            if key not in marks and wall >= at:
                marks[key] = sum(r.first_token_time is None
                                 for r in sim.sched.requests)

    win = serve.run_window(port, cell, arrivals, seconds, watch=watch)
    return win, stats.summarize(win.served, win.close, win.wall_s), marks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--light-rate", type=float, default=None)
    ap.add_argument("--light-seconds", type=float, default=60.0)
    ap.add_argument("--sweep", type=float, default=None)
    ap.add_argument("--step", type=float, default=1.25)
    ap.add_argument("--max-steps", type=int, default=8)
    ap.add_argument("--sweep-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    from repro_torch.kernels import build, chunked_prefill, paged_attention
    from servebench import check, serve, weights
    from servebench.cells import Cell

    dev = torch.device(args.device)
    report = {"workload": args.workload,
              "card": torch.cuda.get_device_name(0) if dev.type == "cuda"
              else "cpu"}
    lines = []

    def emit(kind, **kw):
        row = {"kind": kind, **kw}
        lines.append(row)
        print(json.dumps(row, default=_plain), flush=True)

    cell = Cell.load(args.workload)
    t0 = time.time()
    if dev.type == "cuda":
        build.build_all([chunked_prefill.LIB, paged_attention.LIB])
    tree = cell.config.layout()
    params = weights.make(tree, args.seed, dev)
    port = serve.Port(cell, params, dev)
    port.warm()
    emit("setup", seconds=time.time() - t0)

    if args.light_rate:
        light = _cell_with(cell, rate=args.light_rate,
                           slo={"ttft_a_s": 1e9, "ttft_b_s_per_token": 0.0,
                                "tpot_s": 1e9})
        win, summary, _ = _window(port, light, args.seed,
                                  args.light_seconds)
        done = [s for s in win.served if not s.failed]
        p = np.array([s.prompt for s in done], float)
        ttft = np.array([s.ttft(win.close) for s in done])
        tpot = [s.tpot(win.close) for s in done if s.tokens > 1]
        b, a = np.polyfit(p, ttft, 1)
        a, b = max(a, 0.0), max(b, 0.0)
        slo = {"ttft_a_s": 5 * a, "ttft_b_s_per_token": 5 * b,
               "tpot_s": 5 * statistics.median(tpot)}
        emit("light", rate=args.light_rate, n=len(done),
             fit_a=a, fit_b=b, tpot_median=statistics.median(tpot),
             ttft_median=float(np.median(ttft)), slo=slo, summary=summary)
        cell = _cell_with(cell, slo=slo)
        report["slo"] = slo

    if args.sweep:
        rate, knee = args.sweep, None
        seeds = [int(x) for x in args.sweep_seeds.split(",") if x] \
            or [args.seed]
        for _ in range(args.max_steps):
            at = _cell_with(cell, rate=rate)
            rows = []
            for seed in seeds:
                win, summary, marks = _window(port, at, seed, args.seconds)
                growth = marks.get("close", 0) - marks.get("half", 0)
                rows.append((summary, growth))
                emit("sweep_window", rate=rate, seed=seed, backlog=marks,
                     summary=summary, drained=win.drained)
            att = statistics.median(r["slo_attainment"] for r, _ in rows)
            growing = statistics.median(g for _, g in rows) > 3
            ok = att >= 0.9 and not growing
            spread = {}
            if len(rows) > 2:
                for key in ("ttft_p90_s", "tpot_p90_s", "slo_attainment",
                            "tokens_per_card_s"):
                    v = [r[key] for r, _ in rows]
                    q = statistics.quantiles(v, n=4)
                    spread[key] = (q[2] - q[0]) / statistics.median(v)
            emit("sweep", rate=rate, ok=ok, median_attainment=att,
                 spread=spread)
            if not ok:
                break
            knee = rate
            rate = round(rate * args.step, 4)
        report["knee"] = knee
        if knee:
            cell = _cell_with(cell, rate=round(0.8 * knee, 4), knee=knee)
        report["rate"] = cell.rate

    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        weights.redraw(params, tree, seed)
        win, summary, _ = _window(port, cell, seed,
                                  args.control_seconds or args.seconds)
        items = check.sample(win, port, cell, seed)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.time()
        got = check.gaps(params, cell.config, items, dev,
                         route_margin=cell.correct.get("route_margin", 0.0),
                         control=True)
        emit("control", seed=seed, rate=cell.rate, summary=summary,
             ref_seconds=time.time() - t, **got)
    report["lines"] = lines
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1, default=_plain))
    print(json.dumps({k: v for k, v in report.items() if k != "lines"},
                     default=_plain))
    return 0


if __name__ == "__main__":
    sys.exit(main())
