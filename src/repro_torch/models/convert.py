"""Weights carried across from the JAX package.

``params_from_jax`` takes the pytree of the JAX ``api.init(PRNGKey)`` as
numpy arrays (``jax.tree.map(np.asarray, params)``), with its stacked
leading layer axis, and returns the port's parameters: the same nested
dict and the same layouts, as tensors on ``device``. Each leaf keeps its
own dtype (bf16 stays bf16, f32 stays f32: rwkv6 keeps ``decay_base`` and
``bonus_u`` in f32 in a bf16 model, mamba2 its ``A_log``, ``dt_bias``
and ``D``, and an MoE router stays f32). With these, both packages compute
the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ModelConfig

# the parameter trees of the families (dense, moe and vlm share the
# transformer's): each top-level key, with the keys a dict under it may hold
_NORM = {"scale", "bias"}
_EMBED = {"table", "unembed"}
_KEYS = {
    "dense": {
        "embed": _EMBED,
        "blocks": {"norm_attn", "attn", "norm_mlp", "mlp", "moe",
                   "norm_attn_post", "norm_mlp_post"},
        "final_norm": _NORM,
        "vision_proj": set(),
    },
    "rwkv": {
        "embed": _EMBED,
        "blocks": {"norm_tm", "norm_cm", "tm", "cm"},
        "final_norm": _NORM,
    },
    "hybrid": {
        "embed": _EMBED,
        "blocks": {"norm", "in_z", "in_x", "in_b", "in_c", "in_dt",
                   "conv_wx", "conv_bx", "conv_wbc", "conv_bbc", "A_log",
                   "dt_bias", "D", "gate_norm", "out_proj"},
        "shared": {"norm_attn", "attn", "norm_mlp", "mlp", "in_proj",
                   "out_proj"},
        "final_norm": _NORM,
    },
    "encdec": {
        "embed": _EMBED,
        "enc_blocks": {"norm_attn", "attn", "norm_mlp", "mlp"},
        "dec_blocks": {"norm_self", "self_attn", "norm_cross", "cross_attn",
                       "norm_mlp", "mlp"},
        "enc_norm": _NORM,
        "final_norm": _NORM,
    },
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def params_from_jax(np_params, cfg: ModelConfig, device) -> dict:
    keys = _KEYS.get(cfg.family, _KEYS["dense"])
    extra = set(np_params) - set(keys)
    for name, allowed in keys.items():
        if allowed and isinstance(np_params.get(name), dict):
            extra |= set(np_params[name]) - allowed
    if extra:
        raise ValueError(f"params_from_jax: {sorted(extra)} are not in a "
                         f"{cfg.family} model's parameter tree")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        dtype = _DTYPES[np.asarray(tree).dtype.name]
        # via f32: numpy has no bf16 torch can read, and bf16 -> f32 -> bf16
        # is exact
        arr = np.array(tree, dtype=np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return conv(np_params)
