"""The check a run makes before it prints: no ``jax``, ``jaxlib``,
``flax`` or JAX package ``repro`` loaded, top-level names compared whole."""
import pytest

from servebench.run import foreign_modules


@pytest.mark.parametrize("mods, bad", [
    (["repro_torch", "repro_torch.serving.executor", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.metrics"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["reproducible", "jaxtyping"], []),
])
def test_top_level_names_compared_whole(mods, bad):
    assert foreign_modules(mods) == bad


def test_harness_modules_load_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import servebench.run, servebench.serve, servebench.check,"
            "servebench.calibrate, servebench.trace, servebench.cells;"
            "from servebench import archs;"
            "[(archs.harness(n), archs.reference(n)) for n in archs.names()];"
            "import repro_torch.serving.executor, repro_torch.serving.simulator;"
            "from servebench.run import foreign_modules;"
            "assert foreign_modules() == [], foreign_modules()")
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True)
