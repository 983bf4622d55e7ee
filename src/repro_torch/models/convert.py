"""Weights carried across from the JAX package.

``params_from_jax`` takes the pytree of the JAX ``api.init(PRNGKey)`` as
numpy arrays (``jax.tree.map(np.asarray, params)``), with its stacked
leading layer axis, and returns the port's parameters: the same nested
dict and the same layouts, as tensors of ``cfg.dtype`` on ``device``.
With these, both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ModelConfig

# the dense path's parameter tree; anything else is not ported yet
_DENSE_KEYS = {
    "embed": {"table", "unembed"},
    "blocks": {"norm_attn", "attn", "norm_mlp", "mlp"},
    "final_norm": {"scale", "bias"},
}


def params_from_jax(np_params, cfg: ModelConfig, device) -> dict:
    extra = set(np_params) - set(_DENSE_KEYS)
    extra |= set(np_params.get("blocks", {})) - _DENSE_KEYS["blocks"]
    if extra:
        raise NotImplementedError(
            f"params_from_jax: {sorted(extra)} belong to families not "
            "ported yet (ROADMAP.md)")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        # via f32: numpy has no bf16 torch can read, and bf16 -> f32 -> bf16
        # is exact
        arr = np.array(tree, dtype=np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=cfg.dtype)

    return conv(np_params)
