"""PyTorch port, sharded restore: a checkpoint the JAX package saved
(arctic SMOKE, every leaf cast to bf16, so the raw-word path is read) is
restored by ``train/checkpoint.py::restore(shardings=, mesh=)`` on a
2 x 2 gloo mesh of 4 CPU ranks (one spawn, ``launch.dist``) under the
port's ``param_specs``: each rank's local tensor equals its slice of the
JAX array bit for bit, its placements are ``to_placements`` of the leaf's
spec, and DTensor's own slicing of the whole leaf
(``sharding.distribute``) gives the same local tensor."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import sharding as TS  # noqa: E402
from repro_torch.models.layers import MetaGenerator  # noqa: E402

import _torch_dist_ranks as ranks  # noqa: E402

WORLD = 4
MESH = tmesh.AbstractMesh((2, 2), ("data", "model"))


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_restore")
    params = japi.build(jax_smoke(ranks.RESTORE_ARCH)).init(
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    jckpt.save(root / "ckpt", 0, params)
    tdist.spawn(ranks.restore_rank, WORLD, backend="gloo",
                init_method=f"file://{root}/store", args=(str(root),))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        a = np.asarray(leaf)
        want["/".join(str(p.key) for p in path)] = a.view(np.uint16)
    return want, [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]


def _specs():
    cfg = get_smoke(ranks.RESTORE_ARCH)
    tree = tapi.build(cfg).init(MetaGenerator())
    return ranks._leaves(TS.param_specs(cfg, tree, TS.make_rules(MESH)))


@pytest.mark.parametrize("rank", range(WORLD))
def test_each_rank_holds_its_exact_slice(restored, rank):
    want, port = restored
    out = port[rank]
    specs = _specs()
    assert set(out["local"]) == set(want) == set(specs)
    sharded = 0
    for key, full in want.items():
        assert out["shapes"][key] == full.shape, key
        index = TS.local_slices(full.shape, specs[key], MESH, out["coords"])
        local = out["local"][key]
        assert local.dtype == torch.bfloat16, key
        np.testing.assert_array_equal(local.view(torch.uint16).numpy()
                                      .astype(np.uint16), full[index],
                                      err_msg=key)
        assert list(out["placements"][key]) == \
            TS.to_placements(specs[key], MESH), key
        sharded += local.numel() < full.size
    assert sharded >= 10          # the expert tables, attention, MLP, vocab


@pytest.mark.parametrize("rank", range(WORLD))
def test_distribute_slices_as_restore_does(restored, rank):
    _, port = restored
    out = port[rank]
    for key, local in out["local"].items():
        assert torch.equal(out["distributed"][key], local), key
