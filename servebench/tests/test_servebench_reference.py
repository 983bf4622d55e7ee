"""The plain reference and the benchmark's weights, held to the port's CPU
path at small sizes (the only place a test imports the port beside the
reference; the reference itself imports nothing of it)."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from servebench import weights
from servebench.reference import model as ref
from tiny import DENSE, MOE, cell

REF = Path(ref.__file__)


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("config", [DENSE, MOE, dict(DENSE, tie_word_embeddings=True)],
                         ids=["dense", "moe", "tied"])
def test_weights_have_the_ports_tree(config):
    from repro_torch.models import transformer
    from repro_torch.models.layers import MetaGenerator
    c = cell(config, "bfloat16").config
    ours = weights.make(c.shape(), 3, "cpu", c.dtype)
    theirs = transformer.init_lm(MetaGenerator(), c.port_config())
    assert _tree(ours) == _tree(theirs)


def test_redraw_is_make():
    c = cell(MOE).config
    a = weights.make(c.shape(), 11, "cpu", c.dtype)
    b = weights.make(c.shape(), 12, "cpu", c.dtype)
    weights.redraw(b, c.shape(), 11)
    flat = lambda t: [x for v in t.values() for x in (flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


def test_reference_imports_nothing_of_the_port():
    names = set()
    for node in ast.walk(ast.parse(REF.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "dataclasses", "math", "typing", "torch"}


@pytest.mark.parametrize("config", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_equals_the_ports_prefill_and_decode(config):
    from repro_torch.models import api as model_api
    c = cell(config).config
    params = weights.make(c.shape(), 5, "cpu", c.dtype)
    api = model_api.build(c.port_config())
    prepared = api.prepare(params)
    prompt = np.random.default_rng(1).integers(0, 512, 23)
    cache = api.init_cache(1, 64, "cpu")
    toks = torch.as_tensor(prompt[None], dtype=torch.int32)
    logits, cache = api.prefill(prepared, cache, toks,
                                torch.tensor([23], dtype=torch.int32))
    port = [logits[0]]
    served = [int(logits[0].argmax())]
    for step in range(5):
        logits, cache = api.decode(
            prepared, cache, torch.tensor([served[-1]], dtype=torch.int32),
            torch.tensor([23 + step], dtype=torch.int32))
        port.append(logits[0])
        served.append(int(logits[0].argmax()))
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    (got,) = ref.logits(params, c.arch(), [seq], [22])
    assert torch.allclose(got, torch.stack(port), atol=1e-4, rtol=1e-4)


def test_control_rounds_to_e4m3():
    x = torch.randn(4, 64)
    r = ref._round_e4m3(x, -1)
    rel = ((r - x).abs() / x.abs().clamp_min(1e-3)).median()
    assert 0.005 < rel < 0.05
    assert torch.equal(ref._round_e4m3(r, -1), r)
