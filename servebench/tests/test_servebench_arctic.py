"""The ``arctic`` architecture (one card's share of the experts) at its
``TINY`` sizes on the CPU: ``conformance``'s checks, a whole run of the
harness judged correct, and the two MoE readers, which read nothing from
a program without the MoE counts and the right numbers from a fixed
backend."""
import types

import pytest

import conformance
from servebench import archs, cost, run
from servebench.metrics import reader
from tiny import cell

ARCTIC = archs.harness("arctic")
SEED = 2**31 + 93


@pytest.mark.parametrize("raw", ARCTIC.TINY, ids=lambda r: r["name"])
def test_arctic_conforms(raw):
    conformance.tree_is_the_ports(cell(raw, "bfloat16").config)
    conformance.reference_is_the_ports(cell(raw).config)
    conformance.count_is_per_token(cell(raw).config)


def test_arctic_reference_imports_nothing_of_the_port():
    conformance.reference_imports_nothing_of_the_port(archs.REFERENCE,
                                                      "arctic")


def test_arctic_layout_holds_the_share_and_a_whole_router():
    c = cell(ARCTIC.TINY[1]).config
    s = c.shape()
    assert (s.routed, s.held, s.first) == (8, 2, 6)
    moe = c.layout()["blocks"]["moe"]
    assert moe["router"][0] == (2, 64, 8)
    assert moe["w_gate"][0] == (2, 2, 64, 32)
    assert list(moe) == ["router", "w_gate", "w_up", "w_down"]
    cfg = c.port_config()
    assert (cfg.num_experts, cfg.router_width) == (2, 8)
    assert cfg.expert_ids == range(6, 8)


def test_arctic_step_counts_the_held_share_of_routed_work():
    """A token's model FLOPs hold top_k x held / routed of its experts'."""
    s = cell(ARCTIC.TINY[0]).config.shape()
    whole = ARCTIC.Shape(**dict(vars(s), held=s.routed))
    per_expert = 2.0 * 3 * s.d_model * s.d_ff * s.layers
    gap = ARCTIC.token_flops(whole, 10.0, False) \
        - ARCTIC.token_flops(s, 10.0, False)
    assert gap == pytest.approx(s.top_k * (1 - s.held / s.routed)
                                * per_expert)


@pytest.mark.parametrize("raw", ARCTIC.TINY, ids=lambda r: r["name"])
def test_arctic_run_is_correct(raw):
    out = run.run_cell(cell(raw), SEED, 10.0, False, "cpu", {})
    assert run.checks_pass(out["checks"])
    assert out["tokens_compared"] > 0


def _run(backend, s=None):
    return types.SimpleNamespace(
        window=types.SimpleNamespace(backend=backend),
        shape=s or cell(ARCTIC.TINY[0]).config.shape(), profile=None)


NAMES = ("moe.expert_ms_per_iter", "kernel.moe_experts_roofline")


@pytest.mark.parametrize("name", NAMES)
def test_moe_readers_read_nothing_without_counts(name):
    plain = types.SimpleNamespace(iterations=10, busy_seconds=0.1)
    assert reader(name)(_run(plain)) is None
    untimed = types.SimpleNamespace(iterations=10, busy_seconds=0.1,
                                    moe_counts=[[[3, 2, 8]]],
                                    moe_expert_seconds=0.0)
    assert reader(name)(_run(untimed)) is None


def test_moe_readers_on_a_fixed_backend():
    s = ARCTIC.Shape(layers=2, d_model=7168, heads=56, kv_heads=8,
                     head_dim=128, d_ff=4864, vocab=32000, routed=128,
                     held=32, first=0, top_k=2, dense_residual_ff=7168)
    # two iterations: a decode step (2 layers), a prefill and a decode step
    counts = [[[10, 8, 40], [12, 9, 40]],
              [[300, 32, 1024], [290, 31, 1024], [9, 7, 40], [11, 8, 40]]]
    b = types.SimpleNamespace(iterations=2, busy_seconds=0.05,
                              moe_counts=counts, moe_expert_seconds=0.04)
    assert reader("moe.expert_ms_per_iter")(_run(b, s)) == \
        pytest.approx(20.0)
    expert = 3 * 7168 * 4864 * 2
    bound = sum(max(6.0 * h * 7168 * 4864 / cost.PEAK_FLOPS,
                    (t * expert + 2 * h * 7168 * 2) / cost.PEAK_BYTES_PER_S)
                for step in counts for h, t, _ in step)
    assert reader("kernel.moe_experts_roofline")(_run(b, s)) == \
        pytest.approx(bound / 0.04 * 100.0)
    # a decode step's 8 experts: bytes bound, 1.67 GB at 3.35 TB/s
    assert cost.bound_s(6.0 * 10 * 7168 * 4864, 8 * expert) == \
        pytest.approx(8 * expert / 3.35e12)
