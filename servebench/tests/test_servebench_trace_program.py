"""``servebench.program`` on synthetic profile events: an idle gap split by
overlap across two nested spans, the rest outside the program; operations
tied to the replay span that launched them through the runtime call's
correlation id; a negative launch lag failing the clock check; the drift
between the clocks read from the uploads' lags; and the harness's own
reduction (``servebench.trace``) unmoved by the program's spans among its
events."""
import types

import pytest

torch = pytest.importorskip("torch")

from servebench import program as pg  # noqa: E402
from servebench.trace import Tracer  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
US = 1000


class Ev:
    """The part of a kineto event the reductions read; times in us."""

    def __init__(self, name, start, end, cuda=False, corr=0, ua=False):
        self._n, self._s, self._d = name, start * US, (end - start) * US
        self._cuda, self._c, self._ua = cuda, corr, ua

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return CUDA if self._cuda else CPU

    def is_user_annotation(self):
        return self._ua

    def correlation_id(self):
        return self._c


def op(start, end, corr=0, name="gemm"):
    return Ev(name, start, end, cuda=True, corr=corr)


def span(name, start, end):
    return Ev("repro_torch." + name, start, end)


def test_gap_split_by_overlap_across_nested_spans():
    events = [op(0, 10), op(100, 110), op(115, 120),
              span("executor.iteration", 5, 60),
              span("executor.to_host", 30, 50),
              Ev("servebench.to_host", 29, 51)]     # a harness region
    p = pg.reduce(pg.records(events))
    got = {k: round(v / 1e-6, 6) for k, v in p.idle.items()}
    assert got == {"repro_torch.executor.iteration": 30.0,
                   "repro_torch.executor.to_host": 20.0,
                   pg.OUTSIDE: 40.0, pg.SHORT: 5.0}
    shares = {c: pg.idle_share(p, c)
              for c in ("sched", "executor", "wait", "outside", "short")}
    assert shares["executor"] == pytest.approx(30 / 95)
    assert shares["wait"] == pytest.approx(20 / 95)
    assert shares["outside"] == pytest.approx(40 / 95)
    assert shares["sched"] == 0.0
    assert sum(shares.values()) == pytest.approx(1.0)
    count, total, self_s = p.spans["repro_torch.executor.iteration"]
    assert count == 1 and total == pytest.approx(55e-6) \
        and self_s == pytest.approx(35e-6)


def test_ops_tied_to_their_replay_span_by_correlation_id():
    events = [span("executor.iteration", 190, 300),
              span("executor.replay.decode", 200, 210),
              Ev("cudaGraphLaunch", 202, 205, corr=7),
              span("executor.replay.prefill", 180, 185),
              Ev("cudaLaunchKernel", 212, 214, corr=8),
              op(220, 230, corr=7), op(230, 240, corr=7),
              op(240, 250, corr=8),
              Ev("aten::copy_", 212, 214, corr=7)]     # a host op's own id
    p = pg.reduce(pg.records(events))
    assert p.replay["decode"][:2] == [1, 2]
    assert p.replay["decode"][2] == pytest.approx(20e-6)
    assert p.replay["prefill"] == [1, 0, 0.0]
    run = types.SimpleNamespace(profile=types.SimpleNamespace(program=p))
    from servebench.metrics import reader
    assert reader("executor.decode_step_device_ms")(run) == \
        pytest.approx(0.02)


@pytest.mark.parametrize("launch_at, ok", [(95, True), (105, False)])
def test_launch_lag_checks_the_clock(launch_at, ok):
    events = [op(0, 10, corr=1), op(100, 110, corr=2),
              Ev("cudaLaunchKernel", 0, 1, corr=1),
              Ev("cudaLaunchKernel", launch_at, launch_at + 2, corr=2)]
    p = pg.reduce(pg.records(events))
    assert p.lags_ns == [(100 - launch_at) * US]
    assert p.clock_ok is ok


@pytest.mark.parametrize("step, drift, ok", [(-1, -1.0, False),
                                              (1, 1.0, False),
                                              (0, 0.0, True)])
def test_drift_from_the_uploads_lags(step, drift, ok):
    """Uploads whose lag moves by ``step`` us each ms: the clocks part by
    ``drift`` ms a second, which fails the clock check even where no lag
    turns negative."""
    events = []
    for i in range(4):
        call, lag = 1000 * i, 5 + step * i
        events += [Ev("cudaMemcpyAsync", call, call + 2, corr=i + 1),
                   op(call + lag, call + lag + 1, corr=i + 1,
                      name="Memcpy HtoD (Pageable -> Device)")]
    p = pg.reduce(pg.records(events))
    assert p.drift_ms_per_s == pytest.approx(drift)
    assert p.clock_ok is ok


def _harness(events):
    tracer = Tracer()
    tracer.t_on, tracer.t_off = 0.0, 1e-3
    results = types.SimpleNamespace(events=lambda: events)
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))
    return tracer._reduce(prof, types.SimpleNamespace(calls=[]))


def test_harness_reduction_unmoved_by_program_spans():
    base = [op(0, 10, name="a"), op(5, 20, name="b"), op(100, 110),
            op(113, 130, name="a"), op(400, 420),
            Ev("servebench.scheduler", 0, 500),
            Ev("servebench.to_host", 20, 99),
            Ev("servebench.to_host", 20, 99, cuda=True),
            Ev("annotation", 20, 99, cuda=True, ua=True)]
    spans = [span("sched.run", 1, 499), span("sched.event", 15, 200),
             span("executor.iteration", 16, 180),
             span("executor.to_host", 21, 98),
             span("sched.event", 300, 450)]
    plain, traced = _harness(base), _harness(base + spans)
    assert (plain.busy_s, plain.kernels, plain.idle) == \
        (traced.busy_s, traced.kernels, traced.idle)
    p = pg.reduce(pg.records(base + spans))
    assert sum(p.idle.values()) == pytest.approx(sum(traced.idle.values()))
