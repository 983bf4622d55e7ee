"""The room for a new architecture is real: a toy one (``toy/``: the Llama
block with biased q, k and v) in its two files, copied to a directory the
name lookup is pointed at, runs through the weights, its own reference,
the port's CPU path and a whole run of the harness, with no file of the
harness edited."""
import shutil
import sys
from pathlib import Path

import pytest
import torch

import conformance
from servebench import archs, run, serve, traffic, weights
from servebench.reference import llama as llama_ref
from tiny import cell

TOY = Path(__file__).resolve().parent / "toy"
SEED = 2**31 + 91


@pytest.fixture
def toy(tmp_path, monkeypatch):
    for kind in ("archs", "reference"):
        (tmp_path / kind).mkdir()
        shutil.copy(TOY / kind / "toy.py", tmp_path / kind / "toy.py")
    monkeypatch.setattr(archs, "HERE", tmp_path / "archs")
    monkeypatch.setattr(archs, "REFERENCE", tmp_path / "reference")
    yield tmp_path
    for key in ("servebench.archs.toy", "servebench.reference.toy"):
        sys.modules.pop(key, None)


def _config(dtype="float32"):
    raw = archs.harness("toy").TINY[0]
    return cell(raw, dtype).config


def test_toy_is_found_by_name(toy):
    assert archs.names() == ["toy"]
    c = _config()
    assert Path(c.arch.__file__).parent == toy / "archs"
    assert Path(c.reference.__file__).parent == toy / "reference"
    assert "bq" in c.layout()["blocks"]["attn"]


def test_toy_conforms(toy):
    conformance.tree_is_the_ports(_config("bfloat16"))
    conformance.reference_is_the_ports(_config())
    conformance.reference_imports_nothing_of_the_port(toy / "reference",
                                                      "toy")
    conformance.count_is_per_token(_config())


def test_toy_biases_matter(toy):
    """llama's reference, which has no biases, is not the toy's."""
    c = _config()
    params = weights.make(c.layout(), 5, "cpu")
    seq = [torch.arange(1, 20) * 7 % 512]
    ours = c.reference.logits(params, c.reference.arch(c.raw), seq, [0])
    plain = llama_ref.logits(params, llama_ref.arch(c.raw), seq, [0])
    assert (ours[0] - plain[0]).abs().max() > 0.1


def test_toy_run_is_correct(toy):
    out = run.run_cell(cell(archs.harness("toy").TINY[0]), SEED, 5.0, False,
                       "cpu", {})
    assert run.checks_pass(out["checks"])
    assert out["tokens_compared"] > 0


def test_toy_work_is_recorded(toy):
    c = cell(archs.harness("toy").TINY[0])
    port = serve.Port(c, weights.make(c.config.layout(), 2, "cpu"), "cpu")
    arrivals = traffic.generate(c.mix, 2, 2.0, 4.0)
    win = serve.run_window(port, c, arrivals, 12.0, record=True)
    kinds = [k for k, _, _ in win.recorder.calls]
    assert win.drained and {"prefill", "decode", "step"} <= set(kinds)
    assert kinds.count("step") == win.recorder.iterations
