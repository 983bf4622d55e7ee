"""PyTorch port, training substrate: the kernel ops' refusal of inputs that
require grad, ``train.data``'s batches, ``train.optimizer``'s update and a
qwen2 SMOKE loss curve, ``train.checkpoint`` in both directions with the
JAX package (bit-exact, bf16 leaves included; the same bytes on disk),
resume after a restart, retention, the launcher's resume, and the remat
policies' gradients."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.data import DataConfig as JDataConfig  # noqa: E402
from repro.train.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402

ARCH = "qwen2-1.5b"


def _np(t):
    """A tensor (bf16 too) or jax array as a numpy f32 array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _jax_leaves(tree):
    """{"/".join(keys): leaf} of a JAX tree (dicts, sorted keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(p.key) for p in path)] = leaf
    return out


def _torch_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out |= _torch_leaves(v, key) if isinstance(v, dict) else {key: v}
    return out


def _to_torch(jtree, device="cpu"):
    """A JAX tree of dicts as torch tensors of the same dtypes."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return {k: _to_torch(v) if isinstance(v, dict) else conv(v)
            for k, v in jtree.items()}


def _batch(jb):
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


# ------------------------------------------------------------ kernel ops


def _grad_inputs(name):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    if name == "chunked_prefill_op":
        args = (rnd(1, 4, 2, 16), rnd(1, 8, 1, 16), rnd(1, 8, 1, 16),
                torch.zeros(1, dtype=torch.int32))
        return ops.chunked_prefill_op, args, (), {}
    if name == "paged_attention_op":
        args = (rnd(1, 2, 16), rnd(2, 4, 1, 16), rnd(2, 4, 1, 16),
                torch.tensor([[0, 1]], dtype=torch.int32),
                torch.tensor([5], dtype=torch.int32))
        return ops.paged_attention_op, args, (), {}
    args = (rnd(1, 3, 1, 64), rnd(1, 3, 1, 64), rnd(1, 3, 1, 64),
            torch.rand((1, 3, 1, 64), generator=g), rnd(1, 64),
            torch.zeros(1, 1, 64, 64))
    return ops.wkv6_op, args, ("chunked",), {}


@pytest.mark.parametrize("name", ["chunked_prefill_op", "paged_attention_op",
                                  "wkv6_op"])
def test_kernel_ops_refuse_inputs_that_require_grad(name):
    """A kernel has no backward: with grad mode on, an input that requires
    grad raises (on the CPU too, where the op runs its plain version), so
    no training code reaches a kernel; without grad mode, or with no such
    input, the op runs."""
    op, args, extra, kw = _grad_inputs(name)
    out = op(*args, *extra, **kw)
    live = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(ValueError, match="requires grad"):
        op(*live, *extra, **kw)
    with torch.no_grad():
        again = op(*live, *extra, **kw)
    torch.testing.assert_close(again, out, rtol=0, atol=0)


# ------------------------------------------------------------ data


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "paligemma-3b",
                                  "whisper-medium"])
def test_synthetic_batches_equal_jax(arch):
    """dense, vlm (prefix_embeds) and encdec (frames, dec_len tokens): the
    same values and dtypes at several steps and seeds."""
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    for seed, step in ((0, 0), (0, 7), (3, 2)):
        jb = JSyntheticLM(jcfg, JDataConfig(batch=2, seq=64, seed=seed)
                          ).batch_at(step)
        tb = SyntheticLM(tcfg, DataConfig(batch=2, seq=64, seed=seed),
                         "cpu").batch_at(step)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].device.type == "cpu"
            assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype), k
            np.testing.assert_array_equal(_np(tb[k]), _np(jb[k]))


# ------------------------------------------------------------ optimizer


def _opt_trees(seed, grad_scale):
    """params (one bf16 and two f32 leaves), grads and a mid-run state, as
    numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4, 2)}}

    def tree(fn):
        return jax.tree.map(lambda s: fn(s), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))
    params = tree(lambda s: rng.normal(size=s).astype(np.float32))
    grads = tree(lambda s: (rng.normal(size=s) * grad_scale).astype(
        np.float32))
    m = tree(lambda s: (rng.normal(size=s) * 0.01).astype(np.float32))
    v = tree(lambda s: (rng.random(size=s) * 1e-3).astype(np.float32))
    return params, grads, m, v


@pytest.mark.parametrize("grad_scale,step", [(1e-2, 2), (1e-2, 40),
                                             (10.0, 2), (10.0, 40)])
def test_apply_updates_matches_jax(grad_scale, step):
    """Clipping inactive (global norm under 1) and active, inside and past
    the warmup of 20 steps: new params and state within 1e-6."""
    params, grads, m, v = _opt_trees(step, grad_scale)
    cfg = dict(lr=1e-2, warmup_steps=20, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    jp["a"] = jp["a"].astype(jnp.bfloat16)
    master = jax.tree.map(lambda a: jnp.asarray(a) * 1.5, params)
    jstate = {"step": jnp.asarray(step, jnp.int32),
              "m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v), "master": master}
    jg = jax.tree.map(jnp.asarray, grads)
    gnorm = float(jopt.global_norm(jg))
    assert (gnorm > 1.0) == (grad_scale > 1.0)
    want_p, want_s = jopt.apply_updates(jp, jg, jstate,
                                        jopt.AdamWConfig(**cfg))

    tp, tg = _to_torch(jp), _to_torch(jg)
    tstate = _to_torch({"m": jstate["m"], "v": jstate["v"],
                        "master": jstate["master"]})
    tstate["step"] = torch.tensor(step, dtype=torch.int32)
    np.testing.assert_allclose(float(topt.global_norm(tg)), gnorm,
                               rtol=1e-6)
    got_p, got_s = topt.apply_updates(tp, tg, tstate,
                                      topt.AdamWConfig(**cfg))
    assert got_s is tstate and int(got_s["step"]) == step + 1
    assert got_p["a"].dtype == torch.bfloat16
    for name, got, want in (("params", got_p, want_p),
                            ("m", got_s["m"], want_s["m"]),
                            ("v", got_s["v"], want_s["v"]),
                            ("master", got_s["master"],
                             want_s["master"])):
        w = _jax_leaves(want)
        for key, t in _torch_leaves(got).items():
            np.testing.assert_allclose(_np(t), _np(w[key]), rtol=0,
                                       atol=1e-6, err_msg=f"{name}/{key}")


def _jax_model(arch=ARCH):
    jcfg = jax_smoke(arch)
    jm = japi.build(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0))


def _port_model(jp, arch=ARCH):
    tcfg = get_smoke(arch)
    return tcfg, tapi.build(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def test_qwen2_loss_curve_matches_jax():
    """10 steps of ``make_train_step`` from the converted init on the same
    synthetic batches: every step's loss within 1e-3 relative of JAX's."""
    jcfg, jm, jp = _jax_model()
    tcfg, tm, tp = _port_model(jp)
    opt = dict(lr=3e-3, warmup_steps=5)
    jstep = jax.jit(jopt.make_train_step(jm.loss, jopt.AdamWConfig(**opt)))
    tstep = topt.make_train_step(tm.loss, topt.AdamWConfig(**opt))
    jdata = JSyntheticLM(jcfg, JDataConfig(batch=4, seq=32))
    tdata = SyntheticLM(tcfg, DataConfig(batch=4, seq=32), "cpu")
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    jl, tl = [], []
    for i in range(10):
        jp, js, loss = jstep(jp, js, jdata.batch_at(i))
        jl.append(float(loss))
        tp, ts, loss = tstep(tp, ts, tdata.batch_at(i))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    assert all(not t.requires_grad for t in topt.leaves(tp))


# ------------------------------------------------------------ checkpoints


def _trained_jax(dtype=jnp.float32, steps=2):
    """A JAX qwen2 SMOKE tree {params, state} after ``steps`` steps, its
    weights in ``dtype``."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    js = jopt.init_state(jp)
    step = jax.jit(jopt.make_train_step(jm.loss, jopt.AdamWConfig(
        lr=3e-3, warmup_steps=5)))
    data = JSyntheticLM(jcfg, JDataConfig(batch=2, seq=16))
    for i in range(steps):
        jp, js, _ = step(jp, js, data.batch_at(i))
    return {"params": jp, "state": js}


def _bits(t):
    """The raw bits of a tensor (bf16 as int16) or jax array."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(torch_tree, jax_tree):
    want = _jax_leaves(jax_tree)
    got = _torch_leaves(torch_tree)
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        w = np.asarray(want[key])
        assert tuple(t.shape) == w.shape, key
        assert str(t.dtype).split(".")[-1] == w.dtype.name, key
        np.testing.assert_array_equal(_bits(t), _bits(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_bit_exact_in_port(tmp_path, dtype):
    """JAX ``save`` -> port ``restore`` gives every leaf's bits, dtype and
    shape (bf16 weights, the f32 state, the int32 step); the port's
    ``save`` of it writes the same two files, byte for byte."""
    tree = _trained_jax(getattr(jnp, dtype))
    jckpt.save(tmp_path / "jax", 2, tree)
    tcfg = dataclasses.replace(get_smoke(ARCH),
                               dtype=getattr(torch, dtype))
    tp = tapi.build(tcfg).init(torch.Generator().manual_seed(1))
    target = {"params": tp, "state": topt.init_state(tp)}
    got = tckpt.restore(tmp_path / "jax", 2, target, "cpu")
    _assert_bit_equal(got, tree)
    tckpt.save(tmp_path / "port", 2, got)
    for name in ("arrays.bin", "manifest.json"):
        assert (tmp_path / "port" / "step_00000002" / name).read_bytes() \
            == (tmp_path / "jax" / "step_00000002" / name).read_bytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_bit_exact_in_jax(tmp_path, dtype):
    """Port ``save`` (after port training steps) -> JAX ``restore``."""
    tcfg = dataclasses.replace(get_smoke(ARCH),
                               dtype=getattr(torch, dtype))
    tm = tapi.build(tcfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    ts = topt.init_state(tp)
    step = topt.make_train_step(tm.loss, topt.AdamWConfig(lr=3e-3,
                                                          warmup_steps=5))
    data = SyntheticLM(tcfg, DataConfig(batch=2, seq=16), "cpu")
    for i in range(2):
        tp, ts, _ = step(tp, ts, data.batch_at(i))
    tckpt.save(tmp_path, 2, {"params": tp, "state": ts})
    target = _trained_jax(getattr(jnp, dtype), steps=0)
    got = jckpt.restore(tmp_path, 2, target)
    _assert_bit_equal({"params": tp, "state": ts}, got)
    meta = json.loads((tmp_path / "step_00000002" / "manifest.json"
                       ).read_text())
    assert meta["arrays"]["state/step"] == {
        "dtype": "int32", "shape": [], "offset": meta["arrays"]["state/step"][
            "offset"], "nbytes": 4}


def test_restart_resumes_the_same_trajectory(tmp_path):
    """Steps 0-5 with a save, a fresh restore and a restart at 3 give the
    weights of an uninterrupted run (atol 1e-6, as
    tests/test_train_e2e.py)."""
    tcfg = get_smoke(ARCH)
    tm = tapi.build(tcfg)
    step = topt.make_train_step(tm.loss, topt.AdamWConfig(lr=3e-3,
                                                          warmup_steps=5))
    data = SyntheticLM(tcfg, DataConfig(batch=4, seq=32), "cpu")

    def fresh():
        p = tm.init(torch.Generator().manual_seed(0))
        return p, topt.init_state(p)

    p, s = fresh()
    for i in range(6):
        p, s, _ = step(p, s, data.batch_at(i))
    p2, s2 = fresh()
    for i in range(3):
        p2, s2, _ = step(p2, s2, data.batch_at(i))
    tckpt.save(tmp_path, 3, {"params": p2, "state": s2})
    target = dict(zip(("params", "state"), fresh()))
    tree = tckpt.restore(tmp_path, tckpt.latest_step(tmp_path), target,
                         "cpu")
    p2, s2 = tree["params"], tree["state"]
    assert int(s2["step"]) == 3
    for i in range(3, 6):
        p2, s2, _ = step(p2, s2, data.batch_at(i))
    for key, t in _torch_leaves(p).items():
        np.testing.assert_allclose(_np(_torch_leaves(p2)[key]), _np(t),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_retention_latest_step_and_refusals(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).view(2, 3),
            "step": torch.tensor(1, dtype=torch.int32)}
    assert tckpt.latest_step(tmp_path / "none") is None
    for s in (1, 2, 3, 4, 5):
        tckpt.save(tmp_path, s, tree, keep=2)
    assert tckpt.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005"]
    with pytest.raises(TypeError, match="api.prepare"):
        tckpt.save(tmp_path, 6, {"layers": [tree]})
    with pytest.raises(TypeError, match="api.prepare"):
        topt.init_state({"w": tree["w"], "layers": [tree]})


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    """``launch/train`` on the CPU: a run of 4 steps saves at 2 and 4; the
    same command with --steps 6 resumes from step 4."""
    argv = ["--device", "cpu", "--arch", ARCH, "--batch", "2", "--seq", "16",
            "--ckpt", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    first = tlaunch.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed" not in out and np.isfinite(first)
    assert tckpt.latest_step(tmp_path) == 4
    second = tlaunch.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert "step     4" in out and "step     3" not in out
    assert np.isfinite(second) and tckpt.latest_step(tmp_path) == 6


# ------------------------------------------------------------ remat


def _grads_under(policy):
    tcfg = dataclasses.replace(get_smoke(ARCH), remat_policy=policy)
    tm = tapi.build(tcfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(tcfg, DataConfig(batch=2, seq=32), "cpu").batch_at(0)
    return topt.loss_and_grads(tm.loss, tp, batch)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_gradients(policy):
    """"full" and "dots" recompute in the backward pass what "none" keeps;
    the loss and every gradient are the same."""
    want_loss, want = _grads_under("none")
    loss, got = _grads_under(policy)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=0)
    for key, g in _torch_leaves(got).items():
        torch.testing.assert_close(g, _torch_leaves(want)[key], rtol=1e-6,
                                   atol=1e-9, msg=key)
    with pytest.raises(ValueError, match="remat policy"):
        _grads_under("some")
