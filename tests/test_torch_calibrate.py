"""PyTorch port, calibration: ``perf/calibrate.py`` against the JAX
package's on the same timings (both packages' ``_time_fn`` patched to one
deterministic sequence): equal ``KernelCalibration`` numbers, equal
measured ``HardwareSpec``s and ``InterferenceTable``s, equal iteration
prices from ``CalibratedRooflineBackend``. An unpatched CPU run gives valid
fractions and γ. The H100 spec is the data sheet's, and the serve launcher
prices a CUDA worker with it."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.perf import V5E as JV5E  # noqa: E402
from repro.perf import WorkerSpec as JWorkerSpec  # noqa: E402
from repro.perf import calibrate as jcal  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.perf import (H100, V5E, HardwareSpec,  # noqa: E402
                              WorkerSpec)
from repro_torch.perf import calibrate as tcal  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402

# tiny shapes: the JAX side runs its Pallas kernels in interpret mode
SHAPES = dict(seq=64, heads=2, head_dim=16, batch=2, page_size=8,
              pages_per_seq=2, repeats=2)
GRID = dict(decode_batches=(2, 1), chunk_sizes=(32, 64), heads=2,
            head_dim=16, page_size=8, pages_per_seq=2, repeats=2)
REL = 1e-12


# the interference sweep's calls: pure prefill per chunk (32, 64), pure
# decode per batch (1, 2), then mixed per (batch, chunk) cell; chosen so
# that γ = (mixed - max) / (β_p · β_d · min) lands inside (0, 1), at 0 and
# at the clamp (β_p is about 0.02-0.05 at these bytes-bound sizes)
SWEEP_TIMES = (2e-4, 3e-4, 1e-4, 1.5e-4, 2.012e-4, 2.9e-4, 2.5e-4, 3.05e-4)


def _same_times(monkeypatch, times=None):
    """Both packages' ``_time_fn`` return the same sequence of times, call
    by call (``times`` in turn, else a seeded draw); each call still runs
    its workload once."""
    for module in (jcal, tcal):
        rng = np.random.default_rng(7)
        seq = iter(times or ())

        def fake(fn, repeats, *_, _rng=rng, _seq=seq):
            assert repeats == 2
            fn()
            return next(_seq, None) or float(_rng.uniform(1e-5, 1e-3))

        monkeypatch.setattr(module, "_time_fn", fake)


def _asdict(obj):
    d = dataclasses.asdict(obj)
    d.pop("name", None)
    return d


def _assert_equal_numbers(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=REL, abs=0.0), k
        else:
            assert g == w, k


@pytest.mark.parametrize("gemm", [True, False])
def test_calibrate_hardware_equals_jax_on_the_same_timings(monkeypatch,
                                                           gemm):
    _same_times(monkeypatch)
    jhw, jc = jcal.calibrate_hardware(JV5E, gemm=gemm, **SHAPES)
    thw, tc = tcal.calibrate_hardware(V5E, gemm=gemm, device="cpu", **SHAPES)
    _assert_equal_numbers(dataclasses.asdict(tc), dataclasses.asdict(jc))
    assert tc.prefill_flops == jc.prefill_flops
    assert tc.decode_bytes == jc.decode_bytes
    assert tc.gemm_prefill_flops == jc.gemm_prefill_flops
    assert (tc.gemm_prefill_flops > 0) == gemm
    assert tc.device == "cpu"
    assert thw.name == jhw.name == "tpu-v5e-measured"
    _assert_equal_numbers(_asdict(thw), _asdict(jhw))


def test_calibrate_interference_equals_jax_on_the_same_timings(monkeypatch):
    _same_times(monkeypatch, SWEEP_TIMES)
    jt, jc = jcal.calibrate_interference(JV5E, **GRID)
    tt, tc = tcal.calibrate_interference(V5E, device="cpu", **GRID)
    assert tt.decode_edges == jt.decode_edges == (1, 2)
    assert tt.chunk_edges == jt.chunk_edges == (32, 64)
    for trow, jrow in zip(tt.gamma, jt.gamma):
        assert trow == pytest.approx(jrow, rel=REL, abs=0.0)
    flat = [g for row in tt.gamma for g in row]
    assert min(flat) == 0.0 and max(flat) == 1.0
    assert any(0.0 < g < 1.0 for g in flat)
    for field in ("pure_prefill_s", "pure_decode_s", "mixed_s"):
        assert getattr(tc, field) == getattr(jc, field)


def test_calibration_on_the_cpu_gives_valid_fractions_and_gamma():
    hw, cal = tcal.calibrate_hardware(V5E, device="cpu", **SHAPES)
    for frac in (hw.mfu_prefill, hw.mfu_decode, hw.bw_eff,
                 cal.mfu_gemm_prefill, cal.mfu_gemm_decode):
        assert 0.0 < frac <= 1.0
    assert cal.prefill_seconds > 0.0 and cal.gemm_decode_seconds > 0.0
    table, icl = tcal.calibrate_interference(hw, device="cpu",
                                             gamma_max=0.5, **GRID)
    assert all(0.0 <= g <= 0.5 for row in table.gamma for g in row)
    assert all(t > 0.0 for t in icl.pure_prefill_s + icl.pure_decode_s)
    assert icl.device == "cpu"


def test_calibration_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.calibrate_hardware(V5E, **SHAPES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.calibrate_interference(V5E, **GRID)


def _plans(plan_cls):
    # (n_decode, sum_ctx, prefill_tokens, prefill_ctx_offset)
    shapes = [(0, 0.0, 512, 0.0), (8, 2400.0, 0, 0.0), (8, 2400.0, 256, 0.0),
              (1, 30.0, 64, 128.0), (4, 700.0, 32, 4000.0)]
    return [plan_cls(decode_reqs=[], prefill_parts=[], n_decode=n,
                     sum_ctx=c, prefill_tokens=p, prefill_ctx_offset=o,
                     exclusive_prefill=n == 0) for n, c, p, o in shapes]


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-2b", "rwkv6-7b"])
def test_calibrated_backend_prices_iterations_as_jax(monkeypatch, arch):
    _same_times(monkeypatch)
    kw = dict(measure_interference=True,
              interference_kw=dict(GRID), **SHAPES)
    jb = jcal.CalibratedRooflineBackend(jax_smoke(arch), JWorkerSpec(tp=1),
                                        **kw)
    tb = tcal.CalibratedRooflineBackend(get_smoke(arch), WorkerSpec(tp=1),
                                        device="cpu", **kw)
    for trow, jrow in zip(tb.interference_calibration.table.gamma,
                          jb.interference_calibration.table.gamma):
        assert trow == pytest.approx(jrow, rel=REL, abs=0.0)
    for tp, jp in zip(_plans(IterationPlan), _plans(JPlan)):
        want = jb.run_iteration(None, jp)
        assert want > 0
        assert tb.run_iteration(None, tp) == pytest.approx(want, rel=REL,
                                                           abs=0.0)


def test_h100_is_the_data_sheet_with_assumed_fractions():
    assumed = HardwareSpec()
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)
    assert (H100.ici_bw, H100.ici_links, H100.host_bw) == (25e9, 18, 64e9)
    for field in ("mfu_prefill", "mfu_decode", "bw_eff", "t_fixed",
                  "interference", "migration_latency", "host_latency"):
        assert getattr(H100, field) == getattr(assumed, field), field


def test_serve_prices_cuda_workers_as_an_h100_with_the_cards_memory(
        monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.serving import simulator

    class Stop(Exception):
        pass

    seen = {}

    def build_cluster(cfg, policy, worker_spec=None, **kw):
        seen["hw"] = worker_spec.hw
        raise Stop

    monkeypatch.setattr(simulator, "build_cluster", build_cluster)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 81e9}))
    with pytest.raises(Stop):
        serve.run(["--arch", "gemma2-2b", "--duration", "1"])
    assert seen["hw"] == dataclasses.replace(H100, hbm_bytes=81e9)
    with pytest.raises(Stop):
        serve.run(["--arch", "gemma2-2b", "--duration", "1",
                   "--device", "cpu"])
    assert seen["hw"] == V5E
