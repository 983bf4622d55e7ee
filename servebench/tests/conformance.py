"""What every architecture's two files (``servebench/archs``) owe the
harness, as checks a test calls with a configuration at a tiny size on
the CPU (the only place a test imports the port beside a reference; the
reference itself imports nothing of it)."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from servebench import weights

FOREIGN = {"repro_torch", "repro", "jax", "jaxlib", "flax"}
ROOT = Path(__file__).resolve().parents[2]


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return (tuple(t.shape), t.dtype)


def tree_is_the_ports(config) -> None:
    """The layout is the tree the port's own init makes."""
    from repro_torch.models import api as model_api
    from repro_torch.models.layers import MetaGenerator
    ours = weights.make(config.layout(), 3, "cpu")
    theirs = model_api.build(config.port_config()).init(MetaGenerator())
    assert _tree(ours) == _tree(theirs)


def reference_is_the_ports(config, prompt_len: int = 23,
                           steps: int = 5) -> None:
    """The reference's logits over the prompt and the served tokens are
    the port's prefill and then its cached decode steps."""
    from repro_torch.models import api as model_api
    params = weights.make(config.layout(), 5, "cpu")
    api = model_api.build(config.port_config())
    prepared = api.prepare(params)
    vocab = config.arch.vocab(config.raw)
    prompt = np.random.default_rng(1).integers(0, vocab, prompt_len)
    cache = api.init_cache(1, 64, "cpu")
    toks = torch.as_tensor(prompt[None], dtype=torch.int32)
    logits, cache = api.prefill(prepared, cache, toks,
                                torch.tensor([prompt_len], dtype=torch.int32))
    port = [logits[0]]
    served = [int(logits[0].argmax())]
    for step in range(steps):
        logits, cache = api.decode(
            prepared, cache, torch.tensor([served[-1]], dtype=torch.int32),
            torch.tensor([prompt_len + step], dtype=torch.int32))
        port.append(logits[0])
        served.append(int(logits[0].argmax()))
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    ref = config.reference
    (got,) = ref.logits(params, ref.arch(config.raw), [seq],
                        [prompt_len - 1])
    assert torch.allclose(got, torch.stack(port), atol=1e-4, rtol=1e-4)


def _imported(path: Path) -> set:
    """Modules a file imports by name (a relative import as the reference
    package's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("servebench.reference" if node.level
                      else node.module or "")
    return names


def reference_imports_nothing_of_the_port(reference_dir: Path,
                                          name: str) -> None:
    """Neither the reference's file nor what loading it loads is the port,
    the JAX package, JAX, or another part of the harness."""
    for mod in _imported(reference_dir / f"{name}.py"):
        top = mod.split(".")[0]
        assert top not in FOREIGN, mod
        assert top != "servebench" or mod.startswith("servebench.reference"), \
            mod
    code = ("import sys; from pathlib import Path; sys.path[:0] = ['src', '.'];"
            "from servebench import archs;"
            f"archs.REFERENCE = Path({str(reference_dir)!r});"
            f"archs.reference({name!r});"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FOREIGN)!r} or m.startswith('servebench.') and not "
            "m.startswith(('servebench.reference', 'servebench.archs')) "
            "or m.startswith('servebench.archs.'));"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def count_is_per_token(config) -> None:
    """For a decode-only plan, the step's model FLOPs are the sum of each
    row's alone, and a row at length n does the work of a one-token
    prefill chunk at n - 1 that finishes its prompt; every call is a named
    kind with operations and bytes of at least 0, and the step comes last."""
    count, s = config.arch.count, config.shape()
    lengths = [1, 2, 130, 1023]

    def step(parts, rows):
        calls = count(s, parts, rows, 16)
        assert calls[-1][0] == "step" and calls[-1][2] == 0.0
        assert all(isinstance(k, str) and f >= 0 and b >= 0
                   for k, f, b in calls)
        return calls[-1][1]

    total = step([], lengths)
    assert total == pytest.approx(sum(step([], [n]) for n in lengths),
                                  rel=1e-12)
    for n in lengths:
        assert step([], [n]) == pytest.approx(
            step([(32, n - 1, 1, True)], []), rel=1e-12)
    assert step([(64, 0, 40, True), (32, 0, 8, False)], [5]) > 0
