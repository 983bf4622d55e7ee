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
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

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


def restore(ckpt_dir, step: int, target_tree: Any, device) -> Any:
    """Read ``step`` into the structure of ``target_tree`` (its keys; each
    leaf takes the checkpoint's dtype and shape), as tensors on
    ``device``."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "manifest.json").read_text())["arrays"]
    data = bytearray((d / "arrays.bin").read_bytes())

    def read(key: str) -> torch.Tensor:
        info = meta[key]
        shape = tuple(info["shape"])
        count = 1
        for n in shape:
            count *= n
        flat = torch.frombuffer(data, dtype=_DTYPES[info["dtype"]],
                                count=count, offset=info["offset"])
        return flat.reshape(shape).to(device, copy=True)

    def build(tree, prefix: str = ""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return read(prefix)

    _flatten(target_tree)           # refuses what is not a tree of tensors
    return build(target_tree)
