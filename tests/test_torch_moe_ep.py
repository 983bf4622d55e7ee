"""PyTorch port, expert parallelism: ``models/moe.py``'s ``apply_moe_ep``
against the JAX package's on the same weights and inputs, on a 2 x 2 and a
1 x 4 mesh, and arctic SMOKE's entry points with ``ep`` against the
single-process port.

The JAX side runs once, in a subprocess with 4 forced host devices (the
main pytest process keeps one), and writes its weights, inputs and
outputs to an .npz; the port's side is one spawn of 4 gloo CPU ranks
(``launch.dist.spawn``, a FileStore in tmp_path; the rank bodies are
``tests/_torch_dist_ranks.py``), which reads the .npz and writes each
rank's outputs. Modes: "alltoall" (capacity factor 2), "fused" (one
all-to-all over the EP group), "allgather", and "tight" (capacity factor
1, floor 1: drops). ``_dispatch_indices`` is held to JAX's as integers in this
process."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

import _torch_dist_ranks as ranks  # noqa: E402

WORLD = 4
EP_TOL = 1e-5           # max |port - JAX| / max |JAX|, per mode and mesh
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5

JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import AxisType, make_mesh, set_mesh
    from repro.models.layers import ModelConfig
    from repro.models import moe as M

    cfg = ModelConfig(name="moe-test", family="moe", num_layers=1,
                      d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                      d_ff=96, vocab_size=128, num_experts=6, top_k=2,
                      expert_pad_to=8, moe_capacity_factor=4.0,
                      dtype=jnp.float32)
    params = M.init_moe(jax.random.PRNGKey(0), cfg)
    out = {k: np.asarray(v) for k, v in params.items()}
    # 2 x 2: 2 rows a data shard, 32 tokens split 2 ways; 1 x 4: 14 tokens
    # split 4 ways, padded with 2 zero rows
    xs = {"2x2": ((2, 2), (4, 16, 64)), "1x4": ((1, 4), (2, 7, 64))}
    modes = json.loads(sys.argv[2])
    for i, (name, (shape, xshape)) in enumerate(xs.items()):
        mesh = make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
        set_mesh(mesh)
        x = jax.random.normal(jax.random.PRNGKey(1 + i), xshape, jnp.float32)
        out[f"x_{name}"] = np.asarray(x)
        out[f"ref_{name}"] = np.asarray(M.apply_moe_reference(params, x, cfg))
        for mode, kw in modes.items():
            info = M.EPInfo(mesh=mesh, ep_axes=("data", "model"),
                            batch_axes=("data",), **kw)
            fn = jax.jit(lambda p, xx, info=info: M.apply_moe_ep(p, xx, cfg,
                                                                 info))
            out[f"{name}_{mode}"] = np.asarray(fn(params, x))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_ep")
    env = dict(os.environ)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                          str(root / "jax_ep.npz"),
                          json.dumps(ranks.EP_MODES)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    tdist.spawn(ranks.moe_ep_rank, WORLD, backend="gloo",
                init_method=f"file://{root}/store", args=(str(root),))
    jax_out = dict(np.load(root / "jax_ep.npz"))
    port = [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]
    return jax_out, port


def _assemble(port, key, mesh):
    """The global (B, S, d) output from the ranks' rows: data coordinate c
    holds rows [c*n, (c+1)*n); every rank of a data shard must agree."""
    by_shard = {}
    for out in port:
        c = out[f"{mesh}_coords"][0]
        rows = out[key].numpy()
        if c in by_shard:
            np.testing.assert_array_equal(rows, by_shard[c])
        by_shard[c] = rows
    return np.concatenate([by_shard[c] for c in sorted(by_shard)])


def _rel(a, b, ref):
    return float(np.abs(a - b).max() / np.abs(ref).max())


@pytest.mark.parametrize("mesh", list(ranks.EP_MESHES))
@pytest.mark.parametrize("mode", list(ranks.EP_MODES))
def test_apply_moe_ep_matches_jax(run, mesh, mode):
    """Each mode within 1e-5 (relative to the output's largest value) of
    JAX's same mode on the same mesh: the same tokens dropped."""
    jax_out, port = run
    got = _assemble(port, f"{mesh}_{mode}", mesh)
    want = jax_out[f"{mesh}_{mode}"]
    assert got.shape == want.shape
    assert _rel(got, want, want) <= EP_TOL


@pytest.mark.parametrize("mesh", list(ranks.EP_MESHES))
def test_fused_all_to_all_is_bit_equal_and_allgather_is_the_reference(
        run, mesh):
    jax_out, port = run
    fused = _assemble(port, f"{mesh}_fused", mesh)
    per_axis = _assemble(port, f"{mesh}_alltoall", mesh)
    np.testing.assert_array_equal(fused, per_axis)
    ref = jax_out[f"ref_{mesh}"]
    assert _rel(_assemble(port, f"{mesh}_allgather", mesh), ref, ref) \
        <= EP_TOL
    # capacity factor 1 drops assignments: the port drops JAX's
    tight = _assemble(port, f"{mesh}_tight", mesh)
    assert _rel(tight, ref, ref) > 1e-3
    assert _rel(tight, jax_out[f"{mesh}_tight"], ref) <= EP_TOL


def _model_reference():
    cfg = get_smoke(ranks.MODEL_ARCH)
    tm = tapi.build(cfg)
    params = tm.init(torch.Generator().manual_seed(ranks.MODEL_SEED))
    batch = ranks.model_batch(cfg)
    logits = ranks.model_run(tm, params, batch)
    loss, grads = topt.loss_and_grads(
        lambda p, b: tm.loss(p, b),
        params, {"tokens": batch["tokens"], "labels": batch["labels"]})
    return logits, loss, ranks._leaves(grads), cfg


def test_model_with_ep_matches_single_process(run):
    """arctic SMOKE on the 2 x 2 mesh (allgather): each data shard's
    logits (prefill, prefill_chunk, two decode steps) within 1e-5 of the
    single-process port's rows, the mean of the ranks' losses within 1e-6
    of its loss, and every gradient leaf within 1e-5 (relative to the
    leaf's largest value): the replicated leaves summed over the ranks,
    the expert leaves gathered from them in EP order."""
    _, port = run
    want_logits, want_loss, want_grads, cfg = _model_reference()
    for i, want in enumerate(want_logits):
        by_shard = {}
        for out in port:
            by_shard[out["2x2_coords"][0]] = out["model_logits"][i]
        got = torch.cat([by_shard[c] for c in sorted(by_shard)])
        assert _rel(got.numpy(), want.numpy(), want.numpy()) <= LOGIT_TOL
    got_loss = np.mean([float(out["model_loss"]) for out in port])
    assert abs(got_loss - float(want_loss)) <= LOSS_TOL
    order = sorted(range(WORLD), key=lambda r: port[r]["2x2_coords"][1])
    for k, want in want_grads.items():
        if k.split("/")[-1] in ranks.EXPERT_LEAVES and "moe" in k:
            got = torch.cat([port[r]["model_grads"][k] for r in order], 1)
        else:
            got = port[0]["model_grads"][k]
        assert got.shape == want.shape, k
        assert _rel(got.numpy(), want.numpy(), want.numpy()) <= GRAD_TOL, k


# ------------------------------------------------------------- dispatch


def _dispatch_cases():
    rng = np.random.default_rng(7)
    cases = []
    for t, k, l_e, n_dev, cap in [(16, 2, 2, 4, 4), (33, 2, 1, 8, 1),
                                  (64, 4, 4, 4, 3), (5, 1, 3, 2, 8)]:
        e = l_e * n_dev
        ids = rng.integers(0, e, (t, k))
        cases.append((f"random-{t}x{k}-cap{cap}", ids, l_e, n_dev, cap))
    # every assignment to one expert (ties throughout, one full bucket)
    cases.append(("one-bucket", np.full((12, 2), 3), 2, 2, 4))
    # capacity 1 with every bucket hit twice or more
    cases.append(("cap1", np.tile(np.arange(8), (4, 1)).reshape(16, 2),
                  2, 4, 1))
    return cases


@pytest.mark.parametrize("name,ids,l_e,n_dev,cap", _dispatch_cases(),
                         ids=[c[0] for c in _dispatch_cases()])
def test_dispatch_indices_equal_jax(name, ids, l_e, n_dev, cap):
    gates = np.full(ids.shape, 0.5, np.float32)
    j_slot, j_drop = JM._dispatch_indices(jnp.asarray(ids, jnp.int32),
                                          jnp.asarray(gates), l_e, n_dev,
                                          cap)
    t_slot, t_drop = TM._dispatch_indices(torch.from_numpy(ids),
                                          torch.from_numpy(gates), l_e,
                                          n_dev, cap)
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(t_drop.numpy(), np.asarray(j_drop))
    assert int(t_drop.sum()) > 0 or cap >= ids.size


def test_ep_padded_experts_and_route_ties_match_jax():
    for e, n in [(6, 4), (128, 4), (384, 512), (8, 8)]:
        assert TM.ep_padded_experts(e, n) == JM.ep_padded_experts(e, n)
    router = np.random.default_rng(0).normal(size=(8, 6)).astype(np.float32)
    zeros = np.zeros((3, 8), np.float32)
    for k in (1, 2, 4):
        jg, ji = JM.route(router, zeros, k, 8)
        tg, ti = TM.route(torch.from_numpy(router), torch.from_numpy(zeros),
                          k, 8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


def test_apply_moe_refuses_what_is_not_an_ep_info():
    cfg = get_smoke(ranks.MODEL_ARCH)
    with pytest.raises(TypeError, match="EPInfo"):
        TM.apply_moe({}, torch.zeros(1, 2, cfg.d_model), cfg, ep=object())
    with pytest.raises(ValueError, match="backend"):
        tdist.spawn(print, 1, backend=None, init_method="file:///nowhere")


def test_init_experts_draws_each_expert_from_its_own_seed():
    """A rank's experts equal the same experts of the whole table, drawn
    with init_moe's scales."""
    cfg = get_smoke(ranks.MODEL_ARCH)
    whole = TM.init_experts(cfg, range(cfg.num_experts), 0, "cpu", stack=2)
    mine = TM.init_experts(cfg, range(4, 6), 0, "cpu", stack=2)
    for k, w in whole.items():
        assert w.shape[:2] == (2, cfg.num_experts) and w.dtype == cfg.dtype
        assert torch.equal(mine[k], w[:, 4:6])
    assert not torch.equal(whole["w_up"][0], whole["w_up"][1])
    e = TM.physical_experts(cfg)
    assert abs(float(whole["w_gate"].std()) - e ** -0.5) < 0.1 * e ** -0.5
    assert abs(float(whole["w_down"].std()) - cfg.d_ff ** -0.5) \
        < 0.1 * cfg.d_ff ** -0.5
