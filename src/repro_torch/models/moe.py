"""Mixture-of-Experts on one device, in PyTorch.

Counterpart of ``repro/models/moe.py``'s single-device path: the same
parameters (router f32 ``(d, E)``; ``w_gate`` / ``w_up`` ``(E_phys, d, f)``,
``w_down`` ``(E_phys, f, d)``; a ``shared`` expert of width
``d_ff * num_shared_experts``), the same routing (top-k of the f32 router
logits, softmax over the k values) and the same function as
``apply_moe_reference``: every token through every expert, the outputs
combined in f32 with the top-k gates, no capacity, no drops.

The JAX reference builds (T, E, f) and (T, E, d) intermediates; at full
width that is gigabytes (arctic, 8 rows x 256 tokens: 2.5 GB each for the
gate and up products, 7.5 GB for the f32 combine). Here the experts run in
groups of ``group_size(T, cfg)`` whose intermediates stay within
``GROUP_ELEMENTS``, and the combine accumulates a (T, d) f32 sum. The
shapes depend on T alone and nothing waits for the card, so a step still
captures as a CUDA graph: a decode step of 8 tokens runs each of arctic's
matrices as one batched product over all 128 experts (reading every
expert's weights once), a prefill of 8 x 256 tokens two experts at a time.

The expert-parallel path (``apply_moe_ep``: the dispatch indices and the
all-to-alls over a mesh) waits for the multi-device slice (ROADMAP.md,
queue 1 item 5); ``apply_moe`` with ``ep`` raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import ModelConfig, _activate, _dense_init

# Elements of one group's largest intermediate, (G, T, max(d, f)), at most
# (32 Mi: 64 MB in bf16)
GROUP_ELEMENTS = 1 << 25


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def physical_experts(cfg: ModelConfig) -> int:
    if cfg.expert_pad_to <= 0:
        return cfg.num_experts
    return math.ceil(cfg.num_experts / cfg.expert_pad_to) * cfg.expert_pad_to


def init_moe(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    """The JAX ``init_moe``'s tree and distributions (``stack`` layers along
    a new leading axis). The router stays f32 in a bf16 model."""
    e, d, f = physical_experts(cfg), cfg.d_model, cfg.d_ff
    p = {
        "router": _dense_init(gen, (d, cfg.num_experts), torch.float32,
                              stack=stack),
        "w_gate": _dense_init(gen, (e, d, f), cfg.dtype, stack=stack),
        "w_up": _dense_init(gen, (e, d, f), cfg.dtype, stack=stack),
        "w_down": _dense_init(gen, (e, f, d), cfg.dtype, in_axis_size=f,
                              stack=stack),
    }
    if cfg.num_shared_experts:
        fs = cfg.d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": _dense_init(gen, (d, fs), cfg.dtype, stack=stack),
            "w_up": _dense_init(gen, (d, fs), cfg.dtype, stack=stack),
            "w_down": _dense_init(gen, (fs, d), cfg.dtype, in_axis_size=fs,
                                  stack=stack),
        }
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int,
          num_experts_padded: int):
    """x: (T, d) -> (gates (T, k) f32, expert_ids (T, k) int64).

    Padding experts (id >= real E) receive -inf logits and are never
    picked."""
    logits = x.float() @ router_w                             # (T, E)
    e_real = logits.shape[-1]
    if num_experts_padded > e_real:
        pad = torch.full((x.shape[0], num_experts_padded - e_real),
                         float("-inf"), dtype=torch.float32, device=x.device)
        logits = torch.cat([logits, pad], dim=-1)
    gate_vals, ids = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(gate_vals, dim=-1), ids


# ---------------------------------------------------------------------------
# dense dispatch
# ---------------------------------------------------------------------------


def group_size(tokens: int, cfg: ModelConfig) -> int:
    """Experts computed together for ``tokens`` tokens: as many as keep a
    group's (G, T, max(d, f)) intermediate within ``GROUP_ELEMENTS``, at
    least one."""
    per_expert = tokens * max(cfg.d_model, cfg.d_ff)
    return max(1, min(cfg.num_experts, GROUP_ELEMENTS // max(1, per_expert)))


def apply_moe_reference(params, x: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d). Dense dispatch, the JAX ``apply_moe_reference``'s
    function: every token through every real expert (a padding expert's
    combine weight is always 0, so it is skipped), the expert products in
    ``x``'s dtype, the combine in f32, then the cast back and the shared
    expert."""
    b, s, d = x.shape
    e_phys = params["w_gate"].shape[0]
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    gates, ids = route(params["router"], xt, cfg.top_k, e_phys)
    combine = torch.zeros((t, e_phys), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, ids, gates)                       # (T, E)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    step = group_size(t, cfg)
    for lo in range(0, cfg.num_experts, step):
        hi = min(lo + step, cfg.num_experts)
        g = _activate(torch.matmul(xt, params["w_gate"][lo:hi]),
                      cfg.mlp_activation)                     # (G, T, f)
        u = torch.matmul(xt, params["w_up"][lo:hi])
        y = torch.matmul(g * u, params["w_down"][lo:hi])      # (G, T, d)
        w = combine[:, lo:hi].t()[:, :, None]                 # (G, T, 1)
        out += (y.float() * w).sum(dim=0)
    out = out.to(x.dtype).reshape(b, s, d)
    return out + _shared_expert(params, x, cfg)


def _shared_expert(params, x: torch.Tensor, cfg: ModelConfig):
    if "shared" not in params:
        return torch.zeros_like(x)
    sp = params["shared"]
    g = _activate(x @ sp["w_gate"], cfg.mlp_activation)
    return (g * (x @ sp["w_up"])) @ sp["w_down"]


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              ep: Optional[object] = None) -> torch.Tensor:
    if ep is not None:
        raise NotImplementedError(
            "apply_moe(ep=...): expert parallelism across devices is not "
            "ported yet (ROADMAP.md, queue 1 item 5); the port computes the "
            "MoE layer on one device (ep=None)")
    return apply_moe_reference(params, x, cfg)
