"""End-to-end serving driver (the paper's experiment in miniature).

Serves a Mooncake-like trace on a 4-worker InternLM-20B cluster under all
four schedulers and prints the SLO-attainment comparison — then re-runs
Tropical with a worker failure injected mid-run to show fault tolerance.

    PYTHONPATH=src python examples/serve_cluster.py [--rate 4] [--duration 240]
"""
import argparse
import copy
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.serving.costmodel import CostModel, WorkerSpec
from repro_torch.serving.simulator import build_cluster
from repro_torch.serving.trace import generate_trace
from repro_torch.core.request import SLOSpec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--duration", type=float, default=240.0)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = get_config("internlm-20b")
    spec = WorkerSpec(tp=8)
    cost = CostModel(cfg, spec)
    slo = SLOSpec(ttft=5.0 * cost.prefill_time(8192),
                  tpot=5.0 * cost.decode_iter_time(1, 8192.0))
    trace = generate_trace(args.rate, args.duration, cost, seed=args.seed,
                           fixed_slo=slo)
    until = args.duration * 10
    print(f"model={cfg.name} workers=4xTP8-v5e rate={args.rate}/s "
          f"requests={len(trace)} SLO(ttft={slo.ttft:.2f}s "
          f"tpot={slo.tpot*1000:.0f}ms)")
    print(f"{'policy':<11} {'SLO-A':>6} {'TTFT-A':>7} {'TPOT-A':>7} "
          f"{'q90(s)':>7} {'tpot90':>7} {'migr':>5}")
    for pol in ("vllm", "sarathi", "distserve", "tropical", "tropical++"):
        sim, _ = build_cluster(cfg, pol, n_workers=4, worker_spec=spec)
        sim.add_trace(copy.deepcopy(trace))
        m = sim.run(until=until)
        print(f"{pol:<11} {m.slo_attainment:>6.3f} {m.ttft_attainment:>7.3f} "
              f"{m.tpot_attainment:>7.3f} {m.queue_p90:>7.2f} "
              f"{m.tpot_p90:>7.3f} {m.migrations:>5}")

    print(f"\n--- fault tolerance: worker 3 dies at t="
          f"{args.duration / 4:.0f}s, recovers {args.duration / 4:.0f}s later")
    sim, _ = build_cluster(cfg, "tropical", n_workers=4, worker_spec=spec)
    sim.add_trace(copy.deepcopy(trace))
    sim.inject_failure(args.duration / 4, wid=3,
                       recover_after=args.duration / 4)
    m = sim.run(until=until)
    print(f"tropical+failure: SLO-A={m.slo_attainment:.3f} "
          f"finished={m.n_finished}/{m.n_total} restarts={m.restarts}")


if __name__ == "__main__":
    main()
