"""PyTorch port, tensor parallelism (``models/tp.py``): every family's
SMOKE model in f32 with its parameters, cache and inputs as DTensors under
the sharding rules' specs on 4 gloo CPU ranks (meshes 1 x 4 and 2 x 2),
against the single-process port and the JAX package on the same weights.

The JAX side runs in this process (one device) on each model's weights
from the port's seeded init, passed as numpy arrays (the two packages'
trees have the same keys and layouts): its prefill and decode logits. The
ranks (``tests/_torch_tp_ranks.py``)
run the same prefill and 4 teacher-forced decode steps, then the loss and
its gradients, counting their collectives with the parameters watched.

* Logits within 1e-5 of the single-process port and 1e-4 of JAX (max
  absolute difference over the reference's largest value).
* The loss within 1e-5 of the single-process port's; every gradient leaf
  within 1e-4 of its leaf (relative to the leaf's largest value, or to
  ``GRAD_FLOOR`` for a leaf whose gradient is zero in exact arithmetic:
  whisper's key biases, which the softmax cancels, come out near 1e-10
  in both).
* No collective takes a parameter (or a view or copy of one) as input.
* Each kernel op saw the local shapes the specs give: query heads split
  over the model axis, the KV heads a rank's query heads read (qwen2-like
  ``gqa``: 8 query heads over 2 KV heads on 1 x 4, 2 query heads a rank
  over the one KV head they share, the cache gathered along its rows).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

import _torch_dist_ranks as DR  # noqa: E402
import _torch_tp_ranks as R  # noqa: E402

WORLD = 4
TP_TOL = 1e-5            # sharded against the single-process port
JAX_TOL = 1e-4           # the port against JAX (the model tests' tolerance)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-3


def _jax_cfg(arch):
    return dataclasses.replace(jax_smoke(R.BASE.get(arch, arch)),
                               **R.ARCHS[arch])


def _jax_run(arch, params, batch):
    """The JAX package's prefill and decode logits on ``batch``."""
    cfg = _jax_cfg(arch)
    api = japi.build(cfg)
    kw = {"enc_len": R.ENC_LEN} if cfg.family == "encdec" else {}
    cache = api.init_cache(R.ROWS, R.MAX_LEN, **kw)
    inp = R.model_inputs(R.config(arch), batch)
    conv = lambda t: jnp.asarray(t.numpy().astype(  # noqa: E731
        np.int32 if t.dtype == torch.int64 else t.numpy().dtype))
    inp = {k: conv(v) for k, v in inp.items()} if isinstance(inp, dict) \
        else conv(inp)
    lengths = jnp.asarray(batch["lengths"].numpy())
    logits, cache = api.prefill(params, cache, inp, lengths)
    out = [np.asarray(logits)]
    pos = lengths
    for tok in batch["decode"]:
        logits, cache = api.decode(params, cache, conv(tok), pos)
        out.append(np.asarray(logits))
        pos = pos + 1
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    jax_logits, single = {}, {}
    for arch in R.ARCHS:
        cfg = R.config(arch)
        params = tapi.build(cfg).init(torch.Generator().manual_seed(0))
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        torch.save(params, root / f"{arch}.pt")
        batch = R.inputs(cfg)
        jax_logits[arch] = _jax_run(arch, jparams, batch)
        api = tapi.build(cfg)
        logits = R.run(api, params, batch, R.cache_for(api, cfg))
        loss, grads = topt.loss_and_grads(lambda p, b: api.loss(p, b),
                                          params, R.train_batch(cfg, batch))
        single[arch] = {"logits": logits, "loss": loss, "grads": grads}
        if arch in R.ZERO1:
            new, _, _ = topt.make_train_step(lambda p, b: api.loss(p, b))(
                params, topt.init_state(params), R.train_batch(cfg, batch))
            single[arch]["stepped"] = new
    ranks = {}
    for mesh in R.MESHES:
        tdist.spawn(R.tp_rank, WORLD, backend="gloo",
                    init_method=f"file://{root}/store_{mesh}",
                    args=(str(root), mesh, list(R.ARCHS)))
        ranks[mesh] = [torch.load(root / f"{mesh}_rank{r}.pt")
                       for r in range(WORLD)]
    return jax_logits, single, ranks


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = [(a, m) for m in R.MESHES for a in R.ARCHS]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_logits_match_single_process_and_jax(run, arch, mesh):
    jax_logits, single, ranks = run
    want = single[arch]["logits"]
    for out in ranks[mesh]:
        got = out[arch]["logits"]
        assert len(got) == len(want) == 1 + R.STEPS
        for g, w, j in zip(got, want, jax_logits[arch]):
            assert _rel(g, w) <= TP_TOL
            assert _rel(g, j) <= JAX_TOL
    for w, j in zip(want, jax_logits[arch]):
        assert _rel(w, j) <= JAX_TOL


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_loss_and_gradients_match_single_process(run, arch, mesh):
    _, single, ranks = run
    want = single[arch]
    want_grads = DR._leaves(want["grads"])
    for out in ranks[mesh]:
        got = out[arch]
        assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_TOL
        grads = DR._leaves(got["grads"])
        assert grads.keys() == want_grads.keys()
        for k, w in want_grads.items():
            g = grads[k]
            assert g.shape == w.shape, k
            scale = max(float(w.abs().max()), GRAD_FLOOR)
            assert float((g - w).abs().max()) / scale <= GRAD_TOL, k


@pytest.mark.parametrize("arch,mesh", CASES)
def test_no_parameter_is_moved(run, arch, mesh):
    _, _, ranks = run
    for out in ranks[mesh]:
        for phase, counts in out[arch]["param_counts"].items():
            assert sum(counts.values()) == 0, (phase, counts)


def _kernel_shapes(ranks, mesh, arch):
    calls = ranks[mesh][0][arch]["kernel_calls"]
    assert calls, "no kernel op ran"
    return {c[:3] for c in calls}


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_kernel_ops_see_the_local_heads(run, mesh):
    """Per rank: the query heads each spec leaves it, over the KV heads
    they read (a cache split along its rows is gathered whole)."""
    _, _, ranks = run
    rows = R.ROWS // R.MESHES[mesh][0]
    tp_size = R.MESHES[mesh][1]
    for arch in ("qwen2-1.5b", "gqa", "gemma2-2b", "arctic-480b"):
        cfg = R.config(arch)
        hq = cfg.num_heads // tp_size if cfg.num_heads % tp_size == 0 \
            else cfg.num_heads
        group = cfg.num_heads // cfg.num_kv_heads
        if cfg.num_kv_heads % tp_size == 0:
            hkv = cfg.num_kv_heads // tp_size
        else:
            hkv = max(1, hq // group)
        d = cfg.head_dim
        want = {("chunked_prefill", (rows, R.PROMPT, hq, d),
                 (rows, R.MAX_LEN, hkv, d)),
                ("paged_attention", (rows, hq, d),
                 (rows * R.MAX_LEN // 16, 16, hkv, d))}
        assert _kernel_shapes(ranks, mesh, arch) == want, arch
    if mesh == "1x4":
        # gqa: 2 query heads a rank over the one KV head they share
        assert ("chunked_prefill", (R.ROWS, R.PROMPT, 2, 16),
                (R.ROWS, R.MAX_LEN, 1, 16)) in _kernel_shapes(ranks, mesh,
                                                              "gqa")


@pytest.mark.parametrize("arch,mesh", [(a, m) for m in R.MESHES
                                       for a in R.ZERO1])
def test_zero1_step_matches_single_process(run, arch, mesh):
    """One AdamW step on DTensor parameters with its state split over the
    data axis as well (``state_specs``): the new parameters, gathered back
    to their specs, within two first-step sizes of the single-process
    step's (AdamW's first step moves every weight by about lr / warmup,
    and a gradient that is 0 in exact arithmetic, as the key biases', may
    take the other sign), the loss within 1e-5. Nothing touches a
    parameter before the gather, and the gather is what moves them back
    (ZeRO-1's own)."""
    _, single, ranks = run
    cfg = topt.AdamWConfig()
    bound = 2 * cfg.lr / cfg.warmup_steps
    want = DR._leaves(single[arch]["stepped"])
    for out in ranks[mesh]:
        got = out[arch + "/zero1"]
        assert abs(float(got["loss"]) - float(single[arch]["loss"])) \
            <= LOSS_TOL
        assert sum(got["param_counts_before_gather"].values()) == 0
        if R.MESHES[mesh][0] > 1:
            assert got["gather"]["all-gather"] > 0
        params = DR._leaves(got["params"])
        assert params.keys() == want.keys()
        for k, w in want.items():
            assert float((params[k] - w).abs().max()) <= bound, k


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_whole_vocab_case_keeps_its_logits_whole(mesh):
    """``whole_vocab``'s logits are not split over the model axis on either
    mesh, so its loss and gradients above hold ``tp.xent``'s plain-ops
    branch to the single-process port; qwen2's are split (the other
    branch)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import sharding as TS
    rules = TS.make_rules(AbstractMesh(R.MESHES[mesh], ("data", "model")))
    split = lambda arch: "model" in TS.io_specs(  # noqa: E731
        R.config(arch), rules, R.ROWS)["logits"]
    assert not split("whole_vocab")
    assert split("qwen2-1.5b")
