"""Every architecture in ``servebench/archs``, at each of its ``TINY``
configurations, held to the port's CPU path (``conformance.py``): its
weights' tree is the port's, its reference is the port's prefill and
cached decode and imports nothing of the port, and its counts add up per
token. A later architecture is tested here without an edit."""
import pytest
import torch

import conformance
from servebench import archs, weights
from servebench.cells import Config
from servebench.reference import llama as ref
from tiny import MOE, cell

CASES = [(name, raw) for name in archs.names()
         for raw in archs.harness(name).TINY]
IDS = [f"{name}-{raw['name']}" for name, raw in CASES]


def _config(raw):
    return Config(dict(raw, torch_dtype="float32"))


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.parametrize("name, raw", CASES, ids=IDS)
def test_weights_have_the_ports_tree(name, raw):
    conformance.tree_is_the_ports(Config(dict(raw, torch_dtype="bfloat16")))


@pytest.mark.parametrize("name, raw", CASES, ids=IDS)
def test_reference_equals_the_ports_prefill_and_decode(name, raw):
    conformance.reference_is_the_ports(_config(raw))


@pytest.mark.parametrize("name", archs.names())
def test_reference_imports_nothing_of_the_port(name):
    conformance.reference_imports_nothing_of_the_port(archs.REFERENCE, name)


@pytest.mark.parametrize("name, raw", CASES, ids=IDS)
def test_step_flops_are_the_per_token_sum(name, raw):
    conformance.count_is_per_token(_config(raw))


def test_redraw_is_make():
    c = cell(MOE).config
    a = weights.make(c.layout(), 11, "cpu")
    b = weights.make(c.layout(), 12, "cpu")
    weights.redraw(b, c.layout(), 11)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def test_make_takes_a_configurations_shape():
    """A configuration's shape in place of its tree draws the tree of the
    architecture that defines the shape (``step_owners.py`` passes one)."""
    c = cell(MOE, "bfloat16").config
    a = weights.make(c.shape(), 4, "cpu", c.dtype)
    b = weights.make(c.layout(), 4, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def test_control_rounds_to_e4m3():
    x = torch.randn(4, 64)
    r = ref._round_e4m3(x, -1)
    rel = ((r - x).abs() / x.abs().clamp_min(1e-3)).median()
    assert 0.005 < rel < 0.05
    assert torch.equal(ref._round_e4m3(r, -1), r)
