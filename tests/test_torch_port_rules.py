"""PyTorch port, its rules: nothing under src/repro_torch/ (nor
chip_smoke.py) imports jax or the JAX package; each carried-over module
equals its src/repro original with ``repro.`` replaced by
``repro_torch.``, apart from two reviewed deltas; entry points need a card
unless the caller asks for the CPU."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

CARRIED = [
    "core/__init__.py", "core/request.py", "core/metrics.py",
    "core/toggle.py", "core/policies.py", "core/predictor.py",
    "perf/hardware.py", "perf/model.py", "perf/predictor.py",
    "perf/calibration.py", "perf/recalibrate.py",
    "sched/__init__.py", "sched/backend.py", "sched/core.py",
    "sched/rebalance.py",
    "serving/engine.py", "serving/transfer.py", "serving/simulator.py",
    "workload/__init__.py", "workload/profiles.py", "workload/arrivals.py",
    "workload/scenario.py", "workload/csvio.py",
]
# the two reviewed deltas
CALIBRATE_NAMES = {"CalibratedRooflineBackend", "InterferenceCalibration",
                   "KernelCalibration", "calibrate_hardware",
                   "calibrate_interference"}


def _carried(rel: str) -> str:
    return (REF / rel).read_text().replace("repro.", "repro_torch.")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_over_module_equals_its_original(rel):
    assert (PORT / rel).read_text() == _carried(rel), \
        f"{rel} drifted from src/repro/{rel}"


def test_perf_init_drops_only_calibrate():
    want = ast.parse(_carried("perf/__init__.py"))
    want.body = [n for n in want.body if not (
        isinstance(n, ast.ImportFrom)
        and n.module == "repro_torch.perf.calibrate")]
    for n in want.body:
        if isinstance(n, ast.Assign) and n.targets[0].id == "__all__":
            n.value.elts = [e for e in n.value.elts
                            if e.value not in CALIBRATE_NAMES]
    got = ast.parse((PORT / "perf/__init__.py").read_text())
    assert ast.dump(got) == ast.dump(want)


def test_kvcache_drops_only_paged_store_and_jax():
    src = _carried("serving/kvcache.py")
    src = src.replace("import jax\nimport jax.numpy as jnp\n", "")
    src = src[:src.index("\n\n@dataclasses.dataclass\nclass PagedKVStore")]
    assert (PORT / "serving/kvcache.py").read_text() == src + "\n"


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.serving.executor import ClusterRealExecutors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterRealExecutors(get_smoke("qwen2-1.5b"), 1)
    execs = ClusterRealExecutors(get_smoke("qwen2-1.5b"), 1, max_len=64,
                                 warmup=False, device="cpu")
    assert execs.execs[0].cache["k"].device.type == "cpu"


def test_kernel_input_checks_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels import build
    half = torch.zeros(4, 8, dtype=torch.float16)
    f32 = torch.zeros(4, 8)
    i64 = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="bf16 or f32"):
        build.check_cuda_inputs("k", (half,), ())
    with pytest.raises(ValueError, match="int32"):
        build.check_cuda_inputs("k", (f32,), (i64,))
    with pytest.raises(ValueError, match="contiguous"):
        build.check_cuda_inputs("k", (f32.t(),), ())
    for d in (12, 264):
        with pytest.raises(ValueError, match="head_dim"):
            build.check_head_dim("k", d)
