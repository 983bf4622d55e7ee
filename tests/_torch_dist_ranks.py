"""Rank bodies for the port's distributed CPU tests (started by
``repro_torch.launch.dist.spawn``: gloo, a FileStore in the test's
tmp_path, one thread a rank). Each reads its inputs from files the test
wrote and writes ``rank<r>.pt`` beside them. This module imports torch
and the port only, so a rank's process never loads JAX."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.models import moe as TM
from repro_torch.models import sharding as TS
from repro_torch.models.layers import MetaGenerator, ModelConfig
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt

# tests/test_moe_ep.py's layer: E = 6 padded to 8, top-2, f32
EP_CFG = ModelConfig(name="moe-test", family="moe", num_layers=1,
                     d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                     d_ff=96, vocab_size=128, num_experts=6, top_k=2,
                     expert_pad_to=8, moe_capacity_factor=4.0,
                     dtype=torch.float32)
# the meshes and the EPInfo variants each test runs
EP_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
EP_MODES = {"alltoall": {}, "fused": dict(fused_a2a=True),
            "allgather": dict(ep_mode="allgather"),
            "tight": dict(capacity_factor=1.0, capacity_floor=1)}
MODEL_ARCH = "arctic-480b"
MODEL_SEED = 0
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _mesh(shape):
    return tmesh.make_mesh(shape, ("data", "model"), "cpu")


def _info(mesh, **kw) -> TM.EPInfo:
    return TM.EPInfo(mesh=mesh, ep_axes=("data", "model"),
                     batch_axes=("data",), **kw)


def _rows(x, info: TM.EPInfo):
    """This rank's batch rows of a full batch-major array."""
    n = x.shape[0] // tmesh.axis_sizes(info.mesh)["data"]
    c = info.coord(info.batch_axes)
    return x[c * n:(c + 1) * n]


def _experts(w, info: TM.EPInfo, dim: int = 0):
    """This rank's experts of a full table (split along ``dim``)."""
    n = w.shape[dim] // info.n_devices
    c = info.coord(info.ep_axes)
    return w.narrow(dim, c * n, n).clone()


def _local_model(params, info):
    """The model's params with this rank's experts only."""
    moe = dict(params["blocks"]["moe"])
    for k in EXPERT_LEAVES:
        moe[k] = _experts(moe[k], info, dim=1)
    return {**params, "blocks": {**params["blocks"], "moe": moe}}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out |= _leaves(v, key) if isinstance(v, dict) else {key: v}
    return out


def moe_ep_rank(rank: int, root: str) -> None:
    """The EP layer in every mode on both meshes, then arctic SMOKE's
    prefill, prefill_chunk, decode and loss with ``ep`` (allgather) on the
    2 x 2 mesh."""
    root = Path(root)
    data = np.load(root / "jax_ep.npz")
    p = {k: torch.from_numpy(data[k].copy())
         for k in ("router", "w_gate", "w_up", "w_down")}
    out = {}
    meshes = {name: _mesh(shape) for name, shape in EP_MESHES.items()}
    for name, mesh in meshes.items():
        x = torch.from_numpy(data[f"x_{name}"].copy())
        for mode, kw in EP_MODES.items():
            info = _info(mesh, **kw)
            local = {"router": p["router"]} | {
                k: _experts(p[k], info) for k in EXPERT_LEAVES}
            out[f"{name}_{mode}"] = TM.apply_moe(local, _rows(x, info),
                                                 EP_CFG, info)
        out[f"{name}_coords"] = (info.coord(info.batch_axes),
                                 info.coord(info.ep_axes))
    out |= _model_rank(meshes["2x2"], root)
    torch.save(out, root / f"rank{rank}.pt")


def model_batch(cfg, rows: int = 4, seq: int = 16):
    """The model test's inputs, from a seed."""
    rng = np.random.default_rng(1)
    return {
        "tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (rows, seq)).astype(np.int64)),
        "labels": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (rows, seq)).astype(np.int64)),
        "lengths": torch.tensor([16, 11, 16, 7], dtype=torch.int32),
        "chunk": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (rows, 4)).astype(np.int64)),
        "decode": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, rows)).astype(np.int64)),
    }


def model_run(tm, params, batch, ep=None, max_len: int = 32):
    """The logits of a prefill, a prefill_chunk after it and two decode
    steps (teacher-forced)."""
    rows = batch["tokens"].shape[0]
    cache = tm.init_cache(rows, max_len, "cpu")
    lengths = batch["lengths"]
    logits = [tm.prefill(params, cache, batch["tokens"], lengths, ep=ep)[0]]
    logits.append(tm.prefill_chunk(params, cache, batch["chunk"], lengths,
                                   ep=ep)[0])
    pos = lengths + batch["chunk"].shape[1]
    for tok in batch["decode"]:
        logits.append(tm.decode(params, cache, tok, pos, ep=ep)[0])
        pos = pos + 1
    return logits


def _model_rank(mesh, root: Path) -> dict:
    cfg = get_smoke(MODEL_ARCH)
    tm = tapi.build(cfg)
    info = _info(mesh, ep_mode="allgather")
    params = tm.init(torch.Generator().manual_seed(MODEL_SEED))
    local = _local_model(params, info)
    batch = {k: (_rows(v, info) if k != "decode" else
                 _rows(v.t(), info).t()) for k, v in
             model_batch(cfg).items()}
    logits = model_run(tm, local, batch, ep=info)
    # the global loss is the mean of every rank's (each data shard's rows
    # are held by all model-axis ranks): each rank's share is loss / world
    world = dist.get_world_size()
    live = topt.tree_map(lambda t: t.detach().requires_grad_(), local)
    loss = tm.loss(live, {"tokens": batch["tokens"],
                          "labels": batch["labels"]}, ep=info)
    names = list(_leaves(live))
    grads = dict(zip(names, torch.autograd.grad(
        loss / world, list(_leaves(live).values()))))
    for k, g in grads.items():
        if k.split("/")[-1] not in EXPERT_LEAVES or "moe" not in k:
            grads[k] = g = g.contiguous()
            dist.all_reduce(g)           # a replicated weight's copies
    return {"model_logits": logits, "model_loss": loss.detach(),
            "model_grads": grads}


RESTORE_ARCH = "arctic-480b"


def restore_rank(rank: int, root: str) -> None:
    """The JAX package's checkpoint of arctic SMOKE restored under
    ``param_specs`` for the 2 x 2 mesh (the target tree on the meta
    device: only its keys are read): each rank's local tensors and
    placements, and ``distribute``'s local tensors of the same leaves read
    whole (DTensor's own slicing)."""
    root = Path(root)
    cfg = get_smoke(RESTORE_ARCH)
    target = tapi.build(cfg).init(MetaGenerator())
    mesh = _mesh((2, 2))
    specs = TS.param_specs(cfg, target, TS.make_rules(mesh))
    got = tckpt.restore(root / "ckpt", 0, target, "cpu", shardings=specs,
                        mesh=mesh)
    full = tckpt.restore(root / "ckpt", 0, target, "cpu")
    placed = TS.distribute(full, specs, mesh)
    coords = {a: mesh.get_local_rank(a) for a in ("data", "model")}
    torch.save({"coords": coords,
                "local": {k: v.to_local() for k, v in _leaves(got).items()},
                "shapes": {k: tuple(v.shape) for k, v in _leaves(got).items()},
                "placements": {k: tuple(v.placements)
                               for k, v in _leaves(got).items()},
                "distributed": {k: v.to_local()
                                for k, v in _leaves(placed).items()}},
               root / f"rank{rank}.pt")
