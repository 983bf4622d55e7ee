"""PyTorch port, sharding rules: ``models/sharding.py``'s ``param_specs``,
``cache_specs``, ``batch_spec`` and ``io_specs`` and ``train/optimizer.py``'s
``state_specs`` against the JAX package's, spec for spec, for all 11
architectures at full width on the production meshes (16 x 16 and
2 x 16 x 16) and the worker mesh (1 x 4). Shapes only: JAX's trees from
``jax.eval_shape`` of ``api.init`` and ``cache_spec`` on a
``jax.sharding.AbstractMesh``, the port's from its init and ``init_cache``
on the meta device (``layers.MetaGenerator``) on ``launch.mesh.
AbstractMesh``; no device and no process group is needed. Then the
placements a spec turns into."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import sharding as TS  # noqa: E402
from repro_torch.models.layers import MetaGenerator  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}
# gemma2 again with its window-sized ring cache (per-layer tuples)
RING = "gemma2-2b-ring"
ARCHS = list_archs() + [RING]
CASES = [(a, m) for a in ARCHS for m in MESHES]
# the dry-run's batch sizes (train 256, prefill 32, decode 128, long 1)
BATCHES = (256, 32, 128, 1)


def _configs(arch):
    if arch == RING:
        ring = dict(scan_layers=False, window_sized_cache=True)
        return (dataclasses.replace(jax_config("gemma2_2b"), **ring),
                dataclasses.replace(get_config("gemma2_2b"), **ring))
    return jax_config(arch), get_config(arch)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = _configs(arch)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tp = tm.init(MetaGenerator())
    return jcfg, tcfg, jm, tm, jp, tp


def _rules(mesh):
    shape, names = MESHES[mesh]
    return (JS.make_rules(JAbstractMesh(shape, names)),
            TS.make_rules(tmesh.AbstractMesh(shape, names)))


def _jax_flat(specs):
    """{"a/b/[0]": spec tuple} of a JAX tree of PartitionSpecs."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        keys = [str(p.key) if hasattr(p, "key") else f"[{p.idx}]"
                for p in path]
        out["/".join(keys)] = tuple(s)
    return out


def _port_flat(specs, like, prefix=""):
    """The same of a port spec tree, walked beside ``like`` (the tensor
    tree it describes: a ring cache's tuples are containers there)."""
    if isinstance(like, dict):
        out = {}
        for k in like:
            out |= _port_flat(specs[k], like[k], f"{prefix}/{k}".lstrip("/"))
        return out
    if isinstance(like, (tuple, list)):
        out = {}
        for i, (s, x) in enumerate(zip(specs, like)):
            out |= _port_flat(s, x, f"{prefix}/[{i}]")
        return out
    return {prefix: specs}


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_equal_jax(arch, mesh):
    jcfg, tcfg, _, _, jp, tp = _models(arch)
    jr, tr = _rules(mesh)
    want = _jax_flat(JS.param_specs(jcfg, jp, jr))
    got = _port_flat(TS.param_specs(tcfg, tp, tr), tp)
    assert got == want
    assert tr.tp == jr.tp and tr.n_batch == jr.n_batch
    assert tr.batch_axes == jr.batch_axes and tr.ep_axes == jr.ep_axes


@pytest.mark.parametrize("arch,mesh", CASES)
def test_state_specs_equal_jax(arch, mesh):
    """ZeRO-1 at ``zero_size=16``: m / v / master widened over 'data'
    where the param spec leaves a dim replicated that 16 divides; step
    the empty spec. Without shapes no widening."""
    jcfg, tcfg, _, _, jp, tp = _models(arch)
    jr, tr = _rules(mesh)
    jps, tps = JS.param_specs(jcfg, jp, jr), TS.param_specs(tcfg, tp, tr)
    want = jopt.state_specs(jps, jp, zero_size=16)
    got = topt.state_specs(tps, tp, zero_size=16)
    assert got["step"] == tuple(want["step"]) == ()
    for k in ("m", "v", "master"):
        assert _port_flat(got[k], tp) == _jax_flat(want[k])
    plain = topt.state_specs(tps)
    assert _port_flat(plain["m"], tp) == _jax_flat(jopt.state_specs(jps)["m"])


def _cache_cases(jcfg):
    """(batch, JAX cache_spec args, port init_cache args) at the dry-run's
    prefill, decode and long shapes (encdec as ``dryrun._cache_for``)."""
    out = []
    for name in ("prefill_32k", "decode_32k", "long_500k"):
        info = dryrun.SHAPES[name]
        kind, seq, batch = info["kind"], info["seq"], info["batch"]
        if jcfg.family == "encdec":
            if kind == "prefill":
                s, enc = 2 * dryrun.WHISPER_DEC_PREFILL, seq
            else:
                s, enc = seq, dryrun.WHISPER_ENC_DECODE
            out.append((batch, (batch, s), dict(enc_len=enc)))
        else:
            out.append((batch, (batch, seq), {}))
    return out


@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_batch_and_io_specs_equal_jax(arch, mesh):
    jcfg, tcfg, jm, tm, _, _ = _models(arch)
    jr, tr = _rules(mesh)
    for batch, args, kw in _cache_cases(jcfg):
        jc = jm.cache_spec(*args, **kw)
        tc = tm.init_cache(*args, "meta", **kw)
        want = _jax_flat(JS.cache_specs(jcfg, jr, batch, jc))
        got = _port_flat(TS.cache_specs(tcfg, tr, batch, tc), tc)
        assert got == want, (batch, args)
    for batch in BATCHES:
        assert TS.batch_spec(tr, batch) == JS.batch_spec(jr, batch)
        want = {k: tuple(v) for k, v in JS.io_specs(jcfg, jr, batch).items()}
        assert TS.io_specs(tcfg, tr, batch) == want


def test_spec_normalises_as_partition_spec():
    for parts in [(("data",), None), ((), "model"), (["pod", "data"],),
                  (None, ("data", "model"), None), ()]:
        assert TS.spec(*parts) == tuple(P(*parts))


def test_to_placements():
    m2 = tmesh.AbstractMesh((2, 2), ("data", "model"))
    m3 = tmesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert TS.to_placements((None, "model", None), m2) == \
        [Replicate(), Shard(1)]
    assert TS.to_placements((("data", "model"), None, None), m2) == \
        [Shard(0), Shard(0)]
    assert TS.to_placements((("pod", "data"), "model"), m3) == \
        [Shard(0), Shard(0), Shard(1)]
    assert TS.to_placements((None, None), m2) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="not in the mesh's order"):
        TS.to_placements((("model", "data"),), m2)
    with pytest.raises(ValueError, match="not one of the mesh's"):
        TS.to_placements(("pod",), m2)
    with pytest.raises(ValueError, match="twice"):
        TS.to_placements(("data", "data"), m2)


def test_local_slices_row_major_over_axes():
    m3 = tmesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    s = (("pod", "data"), "model")
    coords = dict(pod=1, data=0, model=1)
    assert TS.local_slices((8, 6), s, m3, coords) == \
        (slice(4, 6), slice(3, 6))
    with pytest.raises(ValueError, match="evenly"):
        TS.local_slices((6, 6), s, m3, coords)


def test_meshes_have_jax_shapes():
    assert tmesh.production_shape().shape == {"data": 16, "model": 16}
    assert tmesh.production_shape(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert tmesh.axis_sizes(tmesh.production_shape()) == \
        dict(JAbstractMesh((16, 16), ("data", "model")).shape)
