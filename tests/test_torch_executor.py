"""PyTorch port, real executor: the fixed mixed workload of
tests/test_real_exec_fast.py::_drive gives the JAX executor's token streams
in both regimes (same converted weights, f32 SMOKE config), slots are
reserved before any compute, and the fast path makes exactly one
device->host transfer per iteration."""
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.sched.backend import SlotExhausted  # noqa: E402
from repro_torch.serving import executor as texec  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402

ARCH = "qwen2-1.5b"


def _req(mod, rid, prompt_len, output_len=8):
    req_cls, slo_cls = mod
    return req_cls(rid=rid, arrival_time=0.0, prompt_len=prompt_len,
                   output_len=output_len, slo=slo_cls(ttft=30.0, tpot=5.0))


def _plan(plan_cls, prefill=(), decode=()):
    pp = [(r, int(t)) for r, t in prefill]
    dr = list(decode)
    return plan_cls(
        decode_reqs=dr, prefill_parts=pp, n_decode=len(dr),
        sum_ctx=float(sum(r.prompt_len for r in dr)),
        prefill_tokens=int(sum(t for _, t in pp)),
        prefill_ctx_offset=0.0, exclusive_prefill=not dr)


def _drive(execs, mod, plan_cls):
    """tests/test_real_exec_fast.py::_drive on a given cluster: multi-chunk
    prefill (a left-padded chunk, a same-bucket 2-row batch), mixed
    iterations, a mid-decode migration and decode on both workers."""
    e0, e1 = execs.execs[0], execs.execs[1]
    a, b, c, d = (_req(mod, 0, 24), _req(mod, 1, 40), _req(mod, 2, 16),
                  _req(mod, 3, 33))

    def step(ex, **kw):
        plan = _plan(plan_cls, **kw)
        ex.run_plan(plan)
        for r, t in plan.prefill_parts:       # the engine's bookkeeping
            r.prefilled_tokens += t

    step(e0, prefill=[(a, 16)])
    step(e0, prefill=[(a, 8), (b, 24)])              # same bucket, 2 rows
    step(e0, prefill=[(b, 16)], decode=[a])          # left-pad + mixed iter
    step(e1, prefill=[(d, 33)])                      # bucket == max_len
    step(e0, decode=[a, b])
    execs.migrate(b, 0, 1)                           # mid-decode migration
    step(e0, prefill=[(c, 16)], decode=[a])
    step(e1, decode=[b, d])
    step(e1, decode=[d, b])
    step(e0, decode=[c, a])
    return {0: list(e0.generated[0]), 1: list(e1.generated[1]),
            2: list(e0.generated[2]), 3: list(e1.generated[3])}


def _port_cluster(batched, n=2, max_slots=4, max_len=64):
    jp = japi.build(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), get_smoke(ARCH),
                             "cpu")
    return ClusterRealExecutors(get_smoke(ARCH), n, max_slots=max_slots,
                                max_len=max_len, batched=batched,
                                warmup=False, device="cpu", params=params)


@pytest.mark.parametrize("batched", [True, False])
def test_drive_token_streams_equal_jax(batched):
    jax_execs = JaxCluster(jax_smoke(ARCH), 2, max_slots=4, max_len=64,
                           batched=batched, warmup=False)
    want = _drive(jax_execs, (JRequest, JSLOSpec), JPlan)
    port = _port_cluster(batched)
    got = _drive(port, (Request, SLOSpec), IterationPlan)
    assert port.execs[0].fast == batched
    assert got == want
    for rid, toks in got.items():
        assert len(toks) >= 2, f"rid {rid} produced too few tokens"


def test_fast_path_makes_one_host_transfer_per_iteration(monkeypatch):
    calls = []
    real = texec._to_host
    monkeypatch.setattr(texec, "_to_host",
                        lambda t: (calls.append(1), real(t))[1])
    port = _port_cluster(True)
    runs = []
    for ex in port.execs.values():
        orig = ex.run_plan
        ex.run_plan = lambda plan, _o=orig: (runs.append(plan), _o(plan))
    _drive(port, (Request, SLOSpec), IterationPlan)
    assert len(runs) == 9
    assert len(calls) == len(runs), "one device->host transfer per iteration"
    port.execs[0].run_plan(_plan(IterationPlan))       # empty plan: none
    assert len(calls) == 9


def test_slot_exhausted_before_any_compute():
    port = _port_cluster(True, n=1, max_slots=2)
    e = port.execs[0]
    cache_before = copy.deepcopy(e.cache)
    reqs = [_req((Request, SLOSpec), i, 16) for i in range(3)]
    with pytest.raises(SlotExhausted) as ei:
        e.run_plan(_plan(IterationPlan, prefill=[(r, 16) for r in reqs]))
    assert (ei.value.wid, ei.value.max_slots) == (0, 2)
    assert all(not e.generated.get(r.rid) for r in reqs)
    for k in e.cache:
        assert torch.equal(e.cache[k], cache_before[k]), "cache touched"


def test_migrate_to_full_worker_raises_and_owner_release():
    port = _port_cluster(True, n=3, max_slots=1)
    e0, e1, e2 = (port.execs[i] for i in range(3))
    a = _req((Request, SLOSpec), 0, 16)
    e0.run_plan(_plan(IterationPlan, prefill=[(a, 16)]))
    a.prefilled_tokens = 16
    e1._slot(99)                            # destination is full
    with pytest.raises(SlotExhausted):
        port.migrate(a, 0, 1)
    assert a.rid in e0.slot_of and port._owner[a.rid] == 0
    free2 = list(e2.free_slots)
    port.on_finish(a)
    assert a.rid not in e0.slot_of and e0.free_slots == [0]
    assert e2.free_slots == free2 and 99 in e1.slot_of
