"""Partition specs: map (arch config, mesh) -> a tree of specs, as in
``repro/models/sharding.py``, rule for rule.

Baseline policy (the JAX package's):
  * vocab / d_ff dims        -> 'model' (Megatron TP)
  * attention heads          -> 'model' iff divisible, else replicated
  * MoE expert dim           -> the whole mesh (EP; 1T-class models cannot
                                fit any replicated expert layout)
  * batch                    -> ('pod','data') iff divisible, else the KV
                                cache sequence dim goes to 'data'
                                (long-context split-K decode)
  * mamba d_inner / heads    -> 'model' (head-aligned after proj split)

A spec is a plain tuple laid out as ``jax.sharding.PartitionSpec``: one
entry per tensor dim, each None, an axis name, or a tuple of axis names,
normalised as PartitionSpec normalises (a tuple of one axis is that axis,
an empty one None). Trees are the port's nested dicts (a ring cache's
per-layer tuples too). The rules read only the mesh's axis names and
sizes, so they run on a ``DeviceMesh`` or on ``launch.mesh.AbstractMesh``.

``to_placements`` turns a spec into DTensor placements on a ``DeviceMesh``
(``Shard(d)`` or ``Replicate()`` per mesh dim), and ``distribute`` places a
tree of full tensors under a tree of specs, each rank keeping its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import ModelConfig


def spec(*parts) -> tuple:
    """``PartitionSpec(*parts)`` as a tuple: lists become tuples, a tuple
    of one axis that axis, an empty tuple None."""
    out = []
    for p in parts:
        if isinstance(p, (tuple, list)):
            p = tuple(p)
            p = None if not p else (p[0] if len(p) == 1 else p)
        out.append(p)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any
    batch_axes: tuple[str, ...]          # e.g. ('pod','data') or ('data',)
    model_axis: str = "model"
    ep_axes: tuple[str, ...] = ()        # expert-parallel axes (full mesh)

    @property
    def sizes(self) -> dict:
        return axis_sizes(self.mesh)

    @property
    def tp(self) -> int:
        return int(self.sizes[self.model_axis])

    @property
    def n_batch(self) -> int:
        return int(np.prod([self.sizes[a] for a in self.batch_axes]))


def make_rules(mesh) -> MeshRules:
    names = tuple(axis_sizes(mesh))
    batch = tuple(a for a in names if a != "model")
    return MeshRules(mesh=mesh, batch_axes=batch, ep_axes=names)


def _head_axis(rules: MeshRules, n_heads: int) -> Optional[str]:
    return rules.model_axis if n_heads % rules.tp == 0 else None


def _ff_axis(rules: MeshRules, d_ff: int) -> Optional[str]:
    return rules.model_axis if d_ff % rules.tp == 0 else None


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts (and tuples or lists, whose
    entries take their index as a key), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_with_path(fn, v, path + (f"[{i}]",))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params_tree: Any, rules: MeshRules):
    """Walk the params tree and assign specs by path (shapes only: meta
    tensors do)."""
    m = rules.model_axis
    hq = _head_axis(rules, cfg.num_heads)
    hkv = _head_axis(rules, cfg.num_kv_heads)
    ff = _ff_axis(rules, cfg.d_ff)
    dm = rules.model_axis if cfg.d_model % rules.tp == 0 else None
    ep = rules.ep_axes

    def spec_for(keys: tuple, leaf) -> tuple:
        name = keys[-1]
        nd = leaf.ndim if hasattr(leaf, "ndim") else len(leaf.shape)

        # --- embeddings -------------------------------------------------
        if "embed" in keys and name in ("table", "unembed"):
            v = leaf.shape[0]
            return spec(m if v % rules.tp == 0 else None, None)
        if name == "vision_proj":
            return spec(None, None)
        # --- rwkv (before attention: tm/cm reuse the wk/wv names) -------
        if "tm" in keys:
            if name in ("wr", "wg", "wk", "wv"):
                return spec(None, dm)
            if name == "wo":
                return spec(dm, None)
            if name == "decay_w2":
                return spec(None, dm)
            if name in ("ln_out_scale", "ln_out_bias", "decay_base"):
                return spec(dm)
            if name == "bonus_u":
                return spec(_head_axis(rules, leaf.shape[0]), None)
            return spec(*([None] * nd))
        if "cm" in keys:
            if name == "wk":
                return spec(None, _ff_axis(rules, leaf.shape[1]))
            if name == "wv":
                return spec(_ff_axis(rules, leaf.shape[0]), None)
            return spec(*([None] * nd))
        # --- MoE (before generic mlp rules; expert weights are 3D) ------
        if "moe" in keys:
            if name == "router":
                return spec(None, None)
            if name in ("w_gate", "w_up", "w_down") and nd == 3 \
                    and "shared" not in keys:
                return spec(ep, None, None)
            if name in ("w_gate", "w_up"):
                return spec(None, ff)
            if name == "w_down":
                return spec(ff, None)
        # --- attention ---------------------------------------------------
        if name == "wq":
            return spec(None, hq, None)
        if name in ("wk", "wv"):
            return spec(None, hkv, None)
        if name == "wo":
            return spec(hq, None, None)
        if name == "bq":
            return spec(hq, None)
        if name in ("bk", "bv"):
            return spec(hkv, None)
        # --- dense MLP -----------------------------------------------------
        if name in ("w_gate", "w_up") and nd == 2:
            fdim = leaf.shape[1]
            return spec(None, m if fdim % rules.tp == 0 else None)
        if name == "w_down" and nd == 2:
            fdim = leaf.shape[0]
            return spec(m if fdim % rules.tp == 0 else None, None)
        # --- mamba2 --------------------------------------------------------
        if name in ("in_z", "in_x"):
            return spec(None, m if leaf.shape[1] % rules.tp == 0 else None)
        if name == "in_dt":
            return spec(None, m if leaf.shape[1] % rules.tp == 0 else None)
        if name in ("in_b", "in_c"):
            return spec(None, None)
        if name == "conv_wx":
            return spec(None, m if leaf.shape[1] % rules.tp == 0 else None)
        if name == "conv_bx":
            return spec(m if leaf.shape[0] % rules.tp == 0 else None)
        if name in ("A_log", "dt_bias", "D"):
            return spec(m if leaf.shape[0] % rules.tp == 0 else None)
        if name == "out_proj" and nd == 2:
            return spec(m if leaf.shape[0] % rules.tp == 0 else None, None)
        if "gate_norm" in keys:
            return spec(m if leaf.shape[0] % rules.tp == 0 else None)
        # --- everything else (norms, small projections) -------------------
        return spec(*([None] * nd))

    # blocks are stacked with a leading layer dim — prepend None
    def with_layer_dim(keys, leaf):
        if any(k in ("blocks", "enc_blocks", "dec_blocks") for k in keys):
            return spec(None, *spec_for(keys, _DropLead(leaf)))
        return spec_for(keys, leaf)

    if "layers" in params_tree:
        raise TypeError("param_specs: pass params without the serving "
                        "views of api.prepare")
    return _map_with_path(with_layer_dim, params_tree)


class _DropLead:
    """Shape proxy with the leading (layer) dim removed."""

    def __init__(self, leaf):
        self.shape = tuple(leaf.shape[1:])
        self.ndim = len(self.shape)


def batch_spec(rules: MeshRules, batch: int) -> Optional[tuple]:
    """Returns the batch-dim sharding (or None when batch is too small)."""
    if batch % rules.n_batch == 0:
        return rules.batch_axes
    # try data axis only
    d = int(np.prod([rules.sizes[a] for a in rules.batch_axes
                     if a == "data"]))
    if batch % d == 0:
        return ("data",)
    return None


def io_specs(cfg: ModelConfig, rules: MeshRules, batch: int) -> dict:
    b = batch_spec(rules, batch)
    return {
        "tokens": spec(b, None),
        "labels": spec(b, None),
        "lengths": spec(b),
        "frames": spec(b, None, None),
        "prefix_embeds": spec(b, None, None),
        "logits": spec(b, rules.model_axis
                       if cfg.vocab_size % rules.tp == 0 else None),
    }


def cache_specs(cfg: ModelConfig, rules: MeshRules, batch: int,
                cache_tree: Any):
    """Specs for cache/state trees (transformer / rwkv / zamba / whisper).
    When batch can't be sharded, the KV sequence dim takes 'data'
    (split-K long-context decode)."""
    b = batch_spec(rules, batch)
    seq = None if b is not None else "data"
    hkv = _head_axis(rules, cfg.num_kv_heads)
    m = rules.model_axis

    def spec_of(keys, leaf):
        name = keys[-1]
        nd = len(leaf.shape)
        if any(k in ("k", "v", "cross_k", "cross_v") for k in keys):
            # (L|ninv, B, S, Hkv, D) stacked, or (B, S, Hkv, D) for
            # per-layer ring caches. When Hkv doesn't divide the model
            # axis, shard the *sequence* over 'model' instead — never
            # replicate a multi-GB cache.
            if hkv is not None:
                inner = spec(b, seq, hkv, None)
            else:
                s_axes = ("model",) if b is not None else ("data", "model")
                inner = spec(b, s_axes, None, None)
            if nd == 5:
                return spec(None, *inner)
            if inner[1] is not None and leaf.shape[1] % rules.tp != 0:
                return spec(inner[0], None, *inner[2:])  # small ring
            return inner
        if name in ("ts_tm", "ts_cm"):               # (L, B, d)
            return spec(None, b, m if cfg.d_model % rules.tp == 0 else None)
        if name == "wkv":                             # (L, B, H, hd, hd)
            h = leaf.shape[2]
            return spec(None, b, m if h % rules.tp == 0 else None, None,
                        None)
        if name in ("conv_x",):                       # (L, B, K-1, d_inner)
            return spec(None, b, None,
                        m if leaf.shape[-1] % rules.tp == 0 else None)
        if name in ("conv_bc",):
            return spec(None, b, None, None)
        if name == "ssd":                              # (L, B, H, hd, N)
            h = leaf.shape[2]
            return spec(None, b, m if h % rules.tp == 0 else None, None,
                        None)
        return spec(*([None] * nd))

    return _map_with_path(spec_of, cache_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def to_placements(s: tuple, mesh) -> list:
    """The DTensor placements of spec ``s`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis, else
    ``Replicate()``. An entry naming several axes shards its dim over them
    in mesh order (the first outermost); an entry whose axes are not in the
    mesh's order has no such placement and raises, as does an axis the
    mesh lacks or one named twice."""
    names = tuple(axis_sizes(mesh))
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(s):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"to_placements: {s} names axis {a!r}, "
                                 f"not one of the mesh's {names}")
            if placements[names.index(a)] != Replicate():
                raise ValueError(f"to_placements: {s} names axis {a!r} "
                                 "twice")
            placements[names.index(a)] = Shard(dim)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"to_placements: {s} shards dim {dim} over {axes}, not in "
                f"the mesh's order {names}; Shard placements cannot lay "
                "it out")
    return placements


def distribute(params, specs, mesh):
    """``params`` (full tensors, the same on every rank) as DTensors under
    ``specs`` on ``mesh``: each rank keeps its own slice of its own copy
    (``src_data_rank=None``: no scatter, nothing sent)."""
    def place(tree, sp):
        if isinstance(tree, dict):
            return {k: place(v, sp[k]) for k, v in tree.items()}
        return distribute_tensor(tree, mesh, to_placements(sp, mesh),
                                 src_data_rank=None)
    return place(params, specs)


def local_slices(shape: tuple, s: tuple, mesh, coords: dict) -> tuple:
    """The index (a tuple of slices) of the shard that the rank at
    ``coords`` ({axis: coordinate}) holds of a tensor of ``shape`` under
    spec ``s``: each sharded dim split evenly over its axes, the first
    outermost (DTensor's ``Shard`` layout for even splits)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, n in enumerate(shape):
        entry = s[dim] if dim < len(s) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * sizes[a], idx * sizes[a] + coords[a]
        if n % parts:
            raise ValueError(f"local_slices: dim {dim} of {shape} does not "
                             f"split evenly over {axes}")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)
