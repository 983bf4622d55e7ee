"""Checkpoints in the JAX package's format, in PyTorch.

Counterpart of ``repro/train/checkpoint.py``, file for file: a step is a
directory ``step_%08d`` holding ``arrays.bin`` (each leaf's raw bytes, one
after another, C order) and ``manifest.json`` ({"step", "arrays": {key:
{dtype, shape, offset, nbytes}}}), with JAX's keys (the tree's dict keys
joined by "/") and JAX's order (dict keys sorted at every level, as
``jax.tree_util`` flattens a dict), so a checkpoint either package writes
restores in the other. bf16 leaves are written as their raw 2-byte words
under the dtype name "bfloat16", as JAX writes them through ml_dtypes. The
write is atomic (a temporary directory renamed into place) and keeps the
last ``keep`` steps.

``restore`` reads into one device, or with ``shardings`` (a tree of
``models.sharding`` specs) and a ``DeviceMesh`` into any mesh, as JAX's
restores into any sharding: the files are the same (full arrays), and
each rank reads only its own slice of each sharded leaf from a memory map
of ``arrays.bin`` and wraps it as a DTensor. Nothing is sent between
ranks.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import local_slices, to_placements

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree, prefix: str = "") -> dict:
    """{key: tensor} in JAX's order and with JAX's keys."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if not isinstance(tree, dict):
        raise TypeError(f"a checkpoint holds nested dicts of tensors, got "
                        f"{type(tree).__name__} at {prefix!r} (pass params "
                        "without the serving views of api.prepare)")
    flat = {}
    for k in sorted(tree):
        flat |= _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return flat


def save(ckpt_dir, step: int, tree: Any, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    manifest = {}
    with open(tmp / "arrays.bin", "wb") as f:
        for key, leaf in _flatten(tree).items():
            if leaf.dtype not in _NAMES:
                raise TypeError(f"checkpoint: {key} has dtype {leaf.dtype}, "
                                f"not one of {sorted(_DTYPES)}")
            host = leaf.detach().to("cpu").contiguous()
            raw = host.reshape(-1).view(torch.uint8).numpy().tobytes()
            manifest[key] = {
                "dtype": _NAMES[leaf.dtype], "shape": list(leaf.shape),
                "offset": f.tell(), "nbytes": len(raw),
            }
            f.write(raw)
    (tmp / "manifest.json").write_text(json.dumps(
        {"step": step, "arrays": manifest}))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    # retention
    ckpts = sorted(p for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, target_tree: Any, device,
            shardings: Any = None, mesh=None) -> Any:
    """Read ``step`` into the structure of ``target_tree`` (its keys; each
    leaf takes the checkpoint's dtype and shape), as tensors on
    ``device``. With ``shardings`` (a tree of specs matching
    ``target_tree``; a missing or None leaf is read whole), each sharded
    leaf is a DTensor on ``mesh`` under its spec (``sharding.
    to_placements``) whose local tensor is this rank's slice on
    ``device``."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "manifest.json").read_text())["arrays"]
    # copy-on-write map: writable for torch.frombuffer, and only the pages
    # a read touches come from the file
    data = np.memmap(d / "arrays.bin", dtype=np.uint8, mode="c")
    flat_specs = _flatten_specs(shardings) if shardings is not None else {}
    if flat_specs and mesh is None:
        raise ValueError("restore: shardings need the mesh they name")
    coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names} \
        if flat_specs else {}

    def read(key: str) -> torch.Tensor:
        info = meta[key]
        shape = tuple(info["shape"])
        count = 1
        for n in shape:
            count *= n
        full = torch.frombuffer(data, dtype=_DTYPES[info["dtype"]],
                                count=count, offset=info["offset"])
        full = full.reshape(shape)
        spec = flat_specs.get(key)
        if spec is None:
            return full.to(device, copy=True)
        local = full[local_slices(shape, spec, mesh, coords)]
        return DTensor.from_local(
            local.to(device, copy=True), mesh, to_placements(spec, mesh),
            run_check=False, shape=torch.Size(shape),
            stride=full.stride())

    def build(tree, prefix: str = ""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return read(prefix)

    _flatten(target_tree)           # refuses what is not a tree of tensors
    return build(target_tree)


def _flatten_specs(tree, prefix: str = "") -> dict:
    """{key: spec} of a tree of specs (tuples, or None) with the keys of
    ``_flatten``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k in sorted(tree):
        flat |= _flatten_specs(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return flat
