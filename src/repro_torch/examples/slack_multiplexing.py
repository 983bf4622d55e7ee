"""Fig. 7 in miniature: watch the TPOT-slack mechanism admit a prefill onto
a multiplexing worker without breaking the decode SLO.

    PYTHONPATH=src python examples/slack_multiplexing.py
"""
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.predictor import AnalyticalPredictor
from repro_torch.core.request import Request, SLOSpec
from repro_torch.core.toggle import Role
from repro_torch.serving.costmodel import CostModel, WorkerSpec
from repro_torch.serving.engine import Worker
from repro_torch.core.policies import TropicalPolicy
from repro_torch.serving.simulator import Simulator


def main(argv: Optional[Sequence[str]] = None) -> None:
    cfg = get_config("internlm-20b")
    cost = CostModel(cfg, WorkerSpec(tp=8))
    slo = SLOSpec(ttft=5.0, tpot=0.05)

    workers = [Worker(0, cost, role=Role.PREFILL),
               Worker(1, cost, role=Role.MULTIPLEX)]
    policy = TropicalPolicy([w.view for w in workers],
                            AnalyticalPredictor(cost), n_prefill=1)
    sim = Simulator(workers, policy)

    # R0: a decode-phase request on the multiplexing worker
    r0 = Request(rid=0, arrival_time=0.0, prompt_len=4096, output_len=120,
                 slo=slo)
    # R1 arrives while the prefill worker is busy with a monster prompt
    monster = Request(rid=1, arrival_time=0.05, prompt_len=32768,
                      output_len=8, slo=slo)
    short = Request(rid=2, arrival_time=0.30, prompt_len=2048, output_len=8,
                    slo=slo)
    sim.add_trace([r0, monster, short])
    m = sim.run(until=120.0)

    print(f"R0 (decode on multiplexing worker): tpot={r0.tpot()*1000:.1f}ms "
          f"(SLO {slo.tpot*1000:.0f}ms) ok={r0.tpot_ok()}")
    print(f"R2 (short prefill, arrived behind a 32k prompt): "
          f"ttft={short.ttft():.2f}s (SLO {slo.ttft:.0f}s) "
          f"served_on_worker={short.worker} ok={short.ttft_ok()}")
    print(f"R1 (32k prompt on prefill worker): ttft={monster.ttft():.2f}s")
    print(f"attainment={m.slo_attainment:.2f} — the short prefill was "
          f"absorbed by R0's banked TPOT slack on the multiplexing worker")


if __name__ == "__main__":
    main()
