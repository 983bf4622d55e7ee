"""PyTorch port, its rules: nothing under src/repro_torch/ (nor
chip_smoke.py) imports jax, the JAX package, or msgpack and ml_dtypes
(the card's machine has neither; the checkpoints write bf16 as raw
words); each carried-over module
equals its src/repro original with ``repro.`` replaced by
``repro_torch.``, apart from reviewed deltas (``perf/__init__.py`` adds
the card's spec, ``serving/kvcache.py`` drops the paged store, the
scheduler's modules add the port's spans, ``serving/engine.py`` drops
``Worker.busy_time``); entry points need a card unless the caller asks for
the CPU."""
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
    "serving/costmodel.py", "serving/trace.py",
    "workload/__init__.py", "workload/profiles.py", "workload/arrivals.py",
    "workload/scenario.py", "workload/csvio.py",
]


# the port's spans (``repro_torch.tracing``): these modules equal their
# originals once each ``with span(...)`` gives way to its body and the
# import of ``span`` goes
TRACED = ["sched/core.py", "serving/simulator.py"]
# ``Worker.busy_time``, which nothing in the port reads, is dropped
DROPPED = {"serving/engine.py": ["        self.busy_time = 0.0\n",
                                 "        self.busy_time += duration\n"]}


def _carried(rel: str) -> str:
    return (REF / rel).read_text().replace("repro.", "repro_torch.")


class _Unspan(ast.NodeTransformer):
    """Each ``with span(...)`` block as its body, the import of ``span``
    gone."""

    def visit_ImportFrom(self, node):
        return None if node.module == "repro_torch.tracing" else node

    def visit_With(self, node):
        self.generic_visit(node)
        call = node.items[0].context_expr
        if len(node.items) == 1 and isinstance(call, ast.Call) and \
                getattr(call.func, "id", None) == "span":
            return node.body
        return node


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
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "msgpack",
                                   "ml_dtypes"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_over_module_equals_its_original(rel):
    got, want = (PORT / rel).read_text(), _carried(rel)
    if rel in TRACED:
        assert "with span(" in got
        got = ast.dump(_Unspan().visit(ast.parse(got)))
        want = ast.dump(ast.parse(want))
    for line in DROPPED.get(rel, []):
        assert want.count(line) == 1 and line not in got
        want = want.replace(line, "")
    assert got == want, f"{rel} drifted from src/repro/{rel}"


# the examples with no JAX compute, carried over the same way from
# examples/ (the top-level folder, beside src/)
CARRIED_EXAMPLES = ["serve_cluster.py", "slack_multiplexing.py"]


@pytest.mark.parametrize("name", CARRIED_EXAMPLES)
def test_carried_over_example_equals_its_original(name):
    want = (ROOT / "examples" / name).read_text().replace("repro.",
                                                          "repro_torch.")
    assert (PORT / "examples" / name).read_text() == want, \
        f"examples/{name} drifted from its original"


def test_perf_init_drops_only_calibrate():
    """The first reviewed delta: ``perf/__init__.py`` is the JAX package's
    (calibrate included, since the port has its own ``perf/calibrate.py``)
    plus the import and the name of the card's spec, ``H100``."""
    got = ast.parse((PORT / "perf/__init__.py").read_text())
    added = [n for n in got.body if isinstance(n, ast.ImportFrom)
             and n.module == "repro_torch.perf.cards"]
    assert [[a.name for a in n.names] for n in added] == [["H100"]]
    got.body = [n for n in got.body if n not in added]
    for n in got.body:
        if isinstance(n, ast.Assign) and n.targets[0].id == "__all__":
            names = [e.value for e in n.value.elts]
            assert names.count("H100") == 1
            n.value.elts = [e for e in n.value.elts if e.value != "H100"]
    want = ast.parse(_carried("perf/__init__.py"))
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
    from repro_torch.examples import train_tiny
    from repro_torch.launch import train
    for main in (train.main, train_tiny.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--device", "cuda"] if main is train_tiny.main else [])
    loss = train.main(["--device", "cpu", "--arch", "qwen2-1.5b",
                       "--steps", "2", "--batch", "2", "--seq", "16"])
    assert loss == loss           # trained on the CPU: a finite loss


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
    # the fused pointwise passes' own checks, on top of those
    from repro_torch.kernels import fused
    bf = torch.bfloat16
    q, kv = torch.zeros(2, 1, 4, 16, dtype=bf), torch.zeros(2, 1, 2, 16,
                                                            dtype=bf)
    tables = torch.zeros(2, 1, 1, 8)
    cache = torch.zeros(2, 8, 2, 16, dtype=bf)
    pos = torch.zeros(2, dtype=torch.int32)
    ok = (q, kv, kv, tables, tables, cache, cache, pos)
    assert fused.check_rope_cache_write(*ok) == build.DTYPE_CODES[bf]
    bad = {"int32": {7: pos.long()},
           "do not match k": {5: torch.zeros(2, 8, 4, 16, dtype=bf)},
           "rope tables must be f32": {3: tables.to(bf)},
           "K/V dtypes": {6: cache.float()},
           "mixed dtypes": {1: kv.float()}}
    for match, change in bad.items():
        args = [change.get(i, a) for i, a in enumerate(ok)]
        with pytest.raises(ValueError, match=match):
            fused.check_rope_cache_write(*args)
    with pytest.raises(ValueError, match="all three biases or none"):
        fused.check_rope_cache_write(*ok, torch.zeros(4, 16, dtype=bf))
    with pytest.raises(ValueError, match="bf16 or f32"):
        fused.check_add_rms_norm(half, None, torch.zeros(8,
                                                         dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        fused.check_gated_act(f32.t(), f32.t(), "silu")


# every module of the JAX package has a counterpart in the port, but those
# ROADMAP gives none by design: compat.py (JAX version shims) and analysis/
# (repro-lint, an AST checker of src/repro)
NO_COUNTERPART = ("compat.py", "analysis/")
JAX_MODULES = sorted(
    str(p.relative_to(ROOT / "src" / "repro"))
    for p in (ROOT / "src" / "repro").rglob("*.py")
    if not str(p.relative_to(ROOT / "src" / "repro")).startswith(
        NO_COUNTERPART))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_module_has_a_counterpart(rel):
    assert (PORT / rel).exists(), f"src/repro/{rel} has no counterpart"


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun",
                                    "repro_torch.launch.hillclimb",
                                    "repro_torch.launch.hloanalysis",
                                    "repro_torch.models.tp"])
def test_dry_run_modules_load_neither_jax_nor_repro(module):
    """Imported in a fresh interpreter, the module pulls in no module of
    JAX or of the JAX package."""
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]


@pytest.mark.parametrize("path", sorted((PORT / "kernels").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernels_import_nothing_of_launch(path):
    """The kernel layer does not depend on the launchers and their
    analysis: the cost analysis subscribes to ``kernels.cost``, not the
    other way round."""
    above = {"repro_torch.launch"}
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module] + [f"{node.module}.{a.name}"
                                     for a in node.names]
        bad = [n for n in names if any(n == m or n.startswith(m + ".")
                                       for m in above)]
        assert not bad, f"kernels/{path.name} imports {bad}"
