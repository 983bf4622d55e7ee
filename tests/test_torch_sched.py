"""PyTorch port, scheduling: the port's build_cluster with a
RealTorchBackend under the cost-model clock makes exactly the decisions of
the JAX package's pure simulator (mirroring tests/test_sched_core.py's
backend parity), and the port's serve CLI finishes every request with the
JAX real mode's JSON keys."""
import copy
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving.costmodel import WorkerSpec as JWorkerSpec  # noqa: E402
from repro.serving.simulator import build_cluster as jbuild  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.perf import WorkerSpec  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402
from repro_torch.serving.simulator import build_cluster  # noqa: E402

ARCH = "deepseek-7b"


def _trace(req_cls, slo_cls, two_class, n=6, prompt=24, out=5):
    if not two_class:
        slo = slo_cls(ttft=30.0, tpot=5.0)
        return [req_cls(rid=i, arrival_time=0.05 * i, prompt_len=prompt,
                        output_len=out, slo=slo) for i in range(n)]
    tight = slo_cls(ttft=3.0, tpot=1.0, name="interactive", weight=2.0)
    loose = slo_cls(ttft=60.0, tpot=10.0, name="batch")
    return [req_cls(rid=i, arrival_time=0.05 * i, prompt_len=prompt,
                    output_len=out, slo=loose if i % 2 else tight)
            for i in range(8)]


@pytest.mark.parametrize("policy,two_class", [("tropical", False),
                                              ("distserve", False),
                                              ("tropical", True)])
def test_real_torch_backend_decisions_equal_jax_simulator(policy, two_class):
    sim_a, _ = jbuild(jax_smoke(ARCH), policy, n_workers=2,
                      worker_spec=JWorkerSpec(tp=1), record_decisions=True)
    sim_a.add_trace(_trace(JRequest, JSLOSpec, two_class))
    m_a = sim_a.run(until=3000.0)

    execs = ClusterRealExecutors(get_smoke(ARCH), 2, max_slots=8, max_len=64,
                                 device="cpu")
    backend = execs.as_backend(clock="model")
    sim_b, _ = build_cluster(get_smoke(ARCH), policy, n_workers=2,
                             worker_spec=WorkerSpec(tp=1),
                             record_decisions=True, backend=backend)
    trace = _trace(Request, SLOSpec, two_class)
    sim_b.add_trace(copy.deepcopy(trace))
    m_b = sim_b.run(until=3000.0)

    assert m_a.n_finished == m_b.n_finished == len(trace)
    assert sim_a.decisions, "decision log must be non-trivial"
    assert sim_a.decisions == sim_b.decisions
    assert {"dispatch", "iter", "route"} <= {d[0] for d in sim_a.decisions}
    assert m_a.row() == m_b.row()
    assert backend.iterations > 0
    for r in trace:      # the port really generated the tokens
        gen = [e.generated[r.rid] for e in execs.execs.values()
               if r.rid in e.generated]
        assert gen and max(len(g) for g in gen) >= r.output_len


def test_serve_real_mode_finishes_with_the_jax_json_keys(capsys):
    argv = ["--mode", "real", "--arch", "qwen2-1.5b", "--rate", "2",
            "--duration", "4", "--workers", "2", "--seed", "1", "--json"]
    row = serve.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out == json.loads(json.dumps(row, default=float))
    assert row["n_total"] > 0 and row["n_finished"] == row["n_total"]
    assert row["backend"] == "real-torch" and row["schema_version"] == 3
    jrow = jserve.main(argv)
    capsys.readouterr()
    assert set(row) == set(jrow)
    assert set(row["per_class"]["default"]) == \
        set(jrow["per_class"]["default"])


def test_serve_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-1.5b", "--duration", "1"])
