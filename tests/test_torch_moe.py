"""PyTorch port, MoE: ``models/moe.py`` against ``repro/models/moe.py``
(routing, the dense-dispatch layer, in one group of experts and in
several), then the arctic (dense residual MLP) and kimi (shared expert)
SMOKE models teacher-forced against the JAX model, and the executor's
token streams against the JAX executor's (same converted weights, f32)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import executor as texec  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402
from test_torch_executor import _drive  # noqa: E402

MOE_ARCHS = ["arctic-480b", "kimi-k2-1t"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def models(request):
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return arch, jcfg, tcfg, jm, tm, jp, tp


def _first(tree):
    """Layer 0 of a stacked torch tree."""
    return {k: _first(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("pad_to", [0, 3, 16])
def test_route_matches_jax(pad_to):
    """Ids equal and gates within 1e-6, with padding experts (E = 8 padded
    to 9 or 16) that get -inf and are never picked."""
    cfg = dataclasses.replace(get_smoke("kimi-k2-1t"), expert_pad_to=pad_to)
    e_phys = TM.physical_experts(cfg)
    assert e_phys == {0: 8, 3: 9, 16: 16}[pad_to]
    rng = np.random.default_rng(pad_to)
    x = rng.normal(size=(37, cfg.d_model)).astype(np.float32)
    router = rng.normal(size=(cfg.d_model, cfg.num_experts)).astype(
        np.float32) / 8
    for k in (1, 2, 4):
        jg, ji = JM.route(router, x, k, e_phys)
        tg, ti = TM.route(_t(router), _t(x), k, e_phys)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tg, jg, dict(rtol=1e-6, atol=1e-6))
        assert int(ti.max()) < cfg.num_experts


# ---------------------------------------------------------------- layer


@pytest.mark.parametrize("group_elements", [None, 1])
def test_apply_moe_matches_reference(models, group_elements, monkeypatch):
    """The dense-dispatch layer within 1e-5 of the JAX
    ``apply_moe_reference``, all experts in one group and (group budget 1)
    one expert at a time; arctic adds no shared expert, kimi does."""
    arch, jcfg, tcfg, *_, jp, tp = models
    if group_elements is not None:
        monkeypatch.setattr(TM, "GROUP_ELEMENTS", group_elements)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tl = _first(tp["blocks"]["moe"])
    assert ("shared" in tl) == (arch == "kimi-k2-1t")
    want = JM.apply_moe_reference(jl, x, jcfg)
    _close(TM.apply_moe(tl, _t(x), tcfg), want, LAYER_TOL)
    assert TM.group_size(22, tcfg) == \
        (1 if group_elements else tcfg.num_experts)


def test_apply_moe_with_ep_raises_naming_the_roadmap(models):
    """Expert parallelism is ported (``tests/test_torch_moe_ep.py``):
    ``apply_moe`` takes an ``EPInfo`` and refuses anything else."""
    *_, tcfg, _, _, _, tp = models
    x = torch.zeros((1, 2, tcfg.d_model))
    with pytest.raises(TypeError, match="EPInfo"):
        TM.apply_moe(_first(tp["blocks"]["moe"]), x, tcfg, ep=object())


def test_init_matches_jax_tree_and_scales(models):
    """Same tree, shapes and dtypes as the JAX init (the router f32); the
    same distributions (a std within 10% of the JAX draw's), which for the
    expert stacks is 1/sqrt(E): the JAX package takes fan_in = shape[0]."""
    arch, jcfg, tcfg, jm, tm, jp, _ = models
    tp = tm.init(torch.Generator().manual_seed(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        want = torch.float32 if path[-1].key == "router" else tcfg.dtype
        assert node.dtype == want, path
        js, ts = float(np.std(leaf)), float(node.float().std())
        assert abs(ts - js) <= 0.1 * js + 1e-12, (path, ts, js)
    w_gate = tp["blocks"]["moe"]["w_gate"]
    assert abs(float(w_gate.std()) - tcfg.num_experts ** -0.5) < 0.02


# ------------------------------------------------------------- end to end


def test_teacher_forced_logits_match_jax(models):
    """Prefill, a ragged chunk with ``take``, then decode steps fed the JAX
    model's greedy tokens: logits and caches within 1e-4."""
    arch, jcfg, tcfg, jm, tm, jp, tp = models
    rng = np.random.default_rng(0)
    b, max_len = 2, 48
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, 20)).astype(np.int32)
    lengths = np.array([20, 13], np.int32)
    jl, jc = jm.prefill(jp, jm.init_cache(b, max_len), prompt, lengths)
    tl, tc = tm.prefill(tp, tm.init_cache(b, max_len, "cpu"), _t(prompt),
                        _t(lengths))
    _close(tl, jl, LOGIT_TOL)
    chunk = rng.integers(0, jcfg.vocab_size, size=(b, 8)).astype(np.int32)
    take = np.array([8, 5], np.int32)
    jl, jc = jm.prefill_chunk(jp, jc, chunk, lengths, take=take)
    tl, tc = tm.prefill_chunk(tp, tc, _t(chunk), _t(lengths), take=_t(take))
    _close(tl, jl, LOGIT_TOL)
    pos = lengths + take
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, _t(tok), _t(pos))
        _close(tl, jl, LOGIT_TOL)
        pos = pos + 1
    _close(tc["k"], jc["k"], LOGIT_TOL)
    _close(tc["v"], jc["v"], LOGIT_TOL)


def _port_cluster(arch, batched, n=2, max_slots=4, max_len=64):
    jp = japi.build(jax_smoke(arch)).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), get_smoke(arch),
                             "cpu")
    return ClusterRealExecutors(get_smoke(arch), n, max_slots=max_slots,
                                max_len=max_len, batched=batched,
                                warmup=False, device="cpu", params=params)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_drive_token_streams_equal_jax(arch, batched):
    """tests/test_real_exec_fast.py::_drive: multi-chunk, 2-row,
    left-padded and mixed iterations, a migration, decode on both workers;
    the fast path serves the moe family as the JAX executor does."""
    jax_execs = JaxCluster(jax_smoke(arch), 2, max_slots=4, max_len=64,
                           batched=batched, warmup=False)
    want = _drive(jax_execs, (JRequest, JSLOSpec), JPlan)
    port = _port_cluster(arch, batched)
    got = _drive(port, (Request, SLOSpec), IterationPlan)
    assert port.execs[0].fast == batched
    assert got == want
    assert all(len(toks) >= 2 for toks in got.values())


def test_fast_path_makes_one_host_transfer_per_iteration(monkeypatch):
    calls = []
    real = texec._to_host
    monkeypatch.setattr(texec, "_to_host",
                        lambda t: (calls.append(1), real(t))[1])
    port = _port_cluster("arctic-480b", True)
    runs = []
    for ex in port.execs.values():
        orig = ex.run_plan
        ex.run_plan = lambda plan, _o=orig: (runs.append(plan), _o(plan))
    _drive(port, (Request, SLOSpec), IterationPlan)
    assert len(runs) == 9
    assert len(calls) == len(runs), "one device->host transfer per iteration"
