"""PyTorch port, its spans (``repro_torch.tracing``), on the CPU: a tiny
dense cluster served by the Tropical scheduler through ``RealTorchBackend``
under ``torch.profiler`` shows every span of the scheduler and the
executor, nested as the code nests them, one ``executor.iteration`` per
iteration run, carrying the plan's worker and request ids; with no
profile recording no range is opened at all; the profile changes no
decision; and the backend's prefill counters match a hand count."""
import copy

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.perf import WorkerSpec  # noqa: E402
from repro_torch.serving import executor as texec  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402
from repro_torch.serving.simulator import build_cluster  # noqa: E402

CFG = get_smoke("qwen2-1.5b")
P = "repro_torch."
# each span and the span it opens inside (None: at the top)
NESTING = {
    "sched.run": None,
    "sched.event": "sched.run",
    "sched.decide": "sched.event",
    "sched.backend": "sched.event",
    "executor.iteration": "sched.backend",
    "executor.prepare": "executor.iteration",
    "executor.upload": "executor.iteration",
    "executor.replay.prefill": "executor.iteration",
    "executor.replay.decode": "executor.iteration",
    "executor.to_host": "executor.iteration",
    "executor.scatter": "executor.iteration",
}


def _trace():
    slo = SLOSpec(ttft=30.0, tpot=5.0)
    return [Request(rid=i, arrival_time=0.002 * i, prompt_len=24 + 4 * i,
                    output_len=8, slo=slo) for i in range(8)]


def _serve(profiled: bool):
    """The trace served on two workers under the cost model's clock:
    (decision log, backend, the profile's ``repro_torch.`` events)."""
    execs = ClusterRealExecutors(CFG, 2, max_slots=8, max_len=64,
                                 warmup=False, device="cpu")
    backend = execs.as_backend(clock="model")
    sim, _ = build_cluster(CFG, "tropical", n_workers=2,
                           worker_spec=WorkerSpec(tp=1),
                           record_decisions=True, backend=backend)
    sim.add_trace(copy.deepcopy(_trace()))
    if not profiled:
        m = sim.run(until=3000.0)
        events = []
    else:
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            m = sim.run(until=3000.0)
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(P)]
    assert m.n_finished == len(_trace())
    return sim.decisions, backend, events


def _parents(events) -> list:
    """(short name, the innermost span that holds it, its event)."""
    out, stack = [], []
    for e in sorted(events, key=lambda e: (e.start_ns(), -e.duration_ns())):
        end = e.start_ns() + e.duration_ns()
        while stack and stack[-1][1] < end:
            stack.pop()
        out.append((e.name()[len(P):], stack[-1][0] if stack else None, e))
        stack.append((e.name()[len(P):], end))
    return out


@pytest.fixture(scope="module")
def served():
    return {profiled: _serve(profiled) for profiled in (False, True)}


@pytest.mark.parametrize("name", list(NESTING))
def test_span_appears_inside_its_parent(served, name):
    _, _, events = served[True]
    found = [parent for short, parent, _ in _parents(events)
             if short == name]
    assert found, f"no {name} span"
    assert set(found) == {NESTING[name]}


def test_one_iteration_span_per_iteration_with_the_plans_ids(served):
    decisions, backend, events = served[True]
    spans = sorted((e for e in events
                    if e.name() == P + "executor.iteration"),
                   key=lambda e: e.start_ns())
    assert len(spans) == backend.iterations > 0
    iters = [d for d in decisions if d[0] == "iter"]
    got = [e.kwinputs() for e in spans]
    assert [g["it"] for g in got] == list(range(backend.iterations))
    for g, (_, wid, decode, prefill) in zip(got, iters):
        assert g["wid"] == wid
        assert g["decode"] == ",".join(map(str, decode))
        assert g["prefill"] == ",".join(f"{r}:{t}" for r, t in prefill)
    arrivals = [e.kwinputs() for e in events
                if e.name() == P + "sched.event"
                and e.kwinputs()["kind"] == "arrival"]
    assert sorted(a["rid"] for a in arrivals) == \
        [r.rid for r in _trace()]


def test_the_profile_changes_no_decision(served):
    (plain, b0, _), (traced, b1, _) = served[False], served[True]
    assert plain == traced and plain
    assert (b0.iterations, b0.prefill_tokens, b0.ridden_prefill_tokens) == \
        (b1.iterations, b1.prefill_tokens, b1.ridden_prefill_tokens)


@pytest.mark.parametrize("profiled", [False, True])
def test_no_range_is_opened_while_no_profile_records(monkeypatch, profiled):
    """Every way to open a range raises; unprofiled, the cluster serves the
    trace all the same, and profiled, the first span meets the raise."""
    def refuse(*a, **kw):
        raise AssertionError("a range was opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    if not profiled:
        decisions, backend, _ = _serve(False)
        assert backend.iterations > 0 and decisions
    else:
        with pytest.raises(AssertionError, match="a range was opened"):
            _serve(True)


def _plan(prefill=(), decode=()):
    pp = [(r, int(t)) for r, t in prefill]
    dr = list(decode)
    return IterationPlan(
        decode_reqs=dr, prefill_parts=pp, n_decode=len(dr),
        sum_ctx=float(sum(r.prompt_len for r in dr)),
        prefill_tokens=int(sum(t for _, t in pp)),
        prefill_ctx_offset=0.0, exclusive_prefill=not dr)


def _req(rid, prompt_len):
    return Request(rid=rid, arrival_time=0.0, prompt_len=prompt_len,
                   output_len=8, slo=SLOSpec(ttft=30.0, tpot=5.0))


def test_prefill_counters_match_a_hand_count():
    execs = ClusterRealExecutors(CFG, 1, max_slots=4, max_len=64,
                                 warmup=False, device="cpu")
    backend = execs.as_backend()
    worker = type("W", (), {"wid": 0})()
    a, b, c = _req(0, 24), _req(1, 40), _req(2, 16)
    plans = [_plan(prefill=[(a, 24)]),                        # 24, alone
             _plan(prefill=[(b, 16), (c, 16)], decode=[a]),   # 32, ridden
             _plan(decode=[a, c]),                            # none
             _plan(prefill=[(b, 24)]),                        # 24, alone
             _plan(decode=[a, b, c])]
    for plan in plans:
        backend.run_iteration(worker, plan)
        for r, t in plan.prefill_parts:
            r.prefilled_tokens += t
    assert (backend.prefill_tokens, backend.ridden_prefill_tokens) == (80, 32)
    assert (backend.iterations, backend.mixed_iterations) == (5, 1)


def _stand_in_capture(fn, pool):
    """``capture_cuda_graph`` for the CPU: the step run at capture and at
    each replay."""
    out = fn()
    return (lambda: out.copy_(fn())), out


def test_capture_and_migration_spans(monkeypatch):
    """On a graphed executor (a stand-in capture on the CPU) a step's first
    use captures inside its replay span, and a migration carries the
    request and both workers."""
    monkeypatch.setattr(texec, "capture_cuda_graph", _stand_in_capture)
    execs = ClusterRealExecutors(CFG, 2, max_slots=4, max_len=64,
                                 warmup=False, device="cpu")
    execs.kernels.graphed, execs.kernels._pool = True, None
    backend = execs.as_backend()
    w0, w1 = (type("W", (), {"wid": i})() for i in (0, 1))
    a, b = _req(0, 24), _req(1, 16)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for w, plan in ((w0, _plan(prefill=[(a, 24), (b, 16)])),
                        (w0, _plan(decode=[a, b]))):
            backend.run_iteration(w, plan)
            for r, t in plan.prefill_parts:
                r.prefilled_tokens += t
        execs.migrate(b, 0, 1)
        backend.run_iteration(w1, _plan(decode=[b]))
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(P)]
    found = _parents(events)
    captures = [(parent, e.kwinputs()["key"]) for short, parent, e in found
                if short == "executor.capture"]
    assert captures == [("executor.replay.prefill", "prefill,32,2"),
                        ("executor.replay.decode", "decode"),
                        ("executor.replay.decode", "decode")]
    moves = [(parent, e.kwinputs()) for short, parent, e in found
             if short == "executor.migrate"]
    assert moves == [(None, {"rid": 1, "src": 0, "dst": 1})]
    assert execs.kernels.captures == 3
    up = [e.kwinputs()["bytes"] for short, _, e in found
          if short == "executor.upload"]
    assert up == [4 * (2 * 32 + 3 * 2), 4 * 2 * 4, 4 * 2 * 4]
