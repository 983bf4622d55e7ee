"""Dispatch for the kernels (attention, WKV6, the fused pointwise passes,
the routed expert products).

Tensors on the CPU go to the plain versions in ``kernels.ref``; tensors on
a CUDA device go to the Hopper kernels, which launch or raise. Nothing
falls back: a CUDA tensor the kernel does not take (dtype, head_dim, ...)
raises, and so do tensors on other devices or on mixed ones. The kernels
have no backward, and a launch through ``ctypes`` is invisible to
autograd, so every op refuses, on both devices, inputs that require grad
while grad mode is on: the training forwards compute attention with
``models.layers.attention_scores`` and WKV with ``models.rwkv6``'s
``wkv_chunked`` / ``wkv_scan``, as the JAX package trains through XLA,
the dense block's pointwise work with the plain ops of
``kernels.ref``, which ``models.layers`` calls where the fused passes do
not run, and the experts with ``models.moe``'s dense dispatch.

Every call, on any device, reports its dense count to the listeners of
``kernels.cost`` (nothing is done when there are none).

``LaunchTally`` keeps the wrappers' launch counts true under CUDA graphs:
a wrapper counts in Python where it launches, and a graph replay runs the
captured launches without that code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (chunked_prefill, cost, fused, moe_experts,
                                 paged_attention, ref, wkv6)


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"cuda"}, {"meta"}):
        return kinds.pop()
    raise ValueError(f"{name}: no kernel for tensors on {sorted(kinds)}")


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: an input requires grad, and the kernel has no backward "
            "(its launch is invisible to autograd); the training path "
            "(api.loss, each family's forward_train) takes the plain torch "
            "ops: layers.attention_scores, rwkv6.wkv_chunked / wkv_scan")


def paged_attention_op(q, k_pages, v_pages, block_tables, lengths,
                       softcap=None, window=None):
    args = (q, k_pages, v_pages, block_tables, lengths)
    _refuse_grad("paged_attention_op", *args)
    kind = _device_kind("paged_attention_op", *args)
    if cost.LISTENERS:
        cost.report("paged_attention", q, k_pages,
                    cost.paged_attention_cost(q, k_pages, block_tables))
    if kind == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if kind == "cpu":
        return ref.paged_attention_ref(*args, softcap=softcap, window=window)
    return paged_attention.paged_attention(*args, softcap=softcap,
                                           window=window)


def chunked_prefill_op(q, k_cache, v_cache, starts, softcap=None,
                       window=None):
    args = (q, k_cache, v_cache, starts)
    _refuse_grad("chunked_prefill_op", *args)
    kind = _device_kind("chunked_prefill_op", *args)
    if cost.LISTENERS:
        cost.report("chunked_prefill", q, k_cache,
                    cost.chunked_prefill_cost(q, k_cache, v_cache))
    if kind == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if kind == "cpu":
        return ref.chunked_prefill_attention_ref(*args, softcap=softcap,
                                                 window=window)
    return chunked_prefill.chunked_prefill_attention(*args, softcap=softcap,
                                                     window=window)


def wkv6_op(r, k, v, w, u, s0, mode: str):
    """The RWKV-6 recurrence over (B, T, H, D) inputs; ``mode`` is the
    model's sequence mode, "decode" (T == 1) or "chunked". On the CPU it
    picks the plain form the JAX model picks (``ref.wkv6_ref``); on the card
    the kernel takes every T. Returns (out f32, sT f32)."""
    _refuse_grad("wkv6_op", r, k, v, w, u, s0)
    if mode not in ("decode", "chunked"):
        raise ValueError(f"wkv6_op: mode must be 'decode' or 'chunked', "
                         f"got {mode!r}")
    if mode == "decode" and r.shape[1] != 1:
        raise ValueError(f"wkv6_op: decode takes one token, got T="
                         f"{r.shape[1]}")
    args = (r, k, v, w, u, s0)
    kind = _device_kind("wkv6_op", *args)
    if cost.LISTENERS:
        cost.report("wkv6", r, s0, cost.wkv6_cost(*args, mode))
    if kind == "meta":
        return (torch.empty(r.shape, dtype=torch.float32, device="meta"),
                torch.empty(s0.shape, dtype=torch.float32, device="meta"))
    if kind == "cpu":
        return ref.wkv6_ref(*args, mode)
    return wkv6.wkv6(*args)


def add_rms_norm_op(x, r, w, eps: float):
    """The residual sum x + r (B, S, d) in x's dtype and its RMSNorm with
    the ``1 + w`` scale, one pass on the card; r None: (x, the norm of
    x). Returns (sum, norm)."""
    args = (x, w) if r is None else (x, r, w)
    _refuse_grad("add_rms_norm_op", *args)
    kind = _device_kind("add_rms_norm_op", *args)
    if cost.LISTENERS:
        cost.report("add_rms_norm", x, w, cost.pointwise_cost(
            (x, r, w), (x, x if r is not None else None)))
    if kind == "meta":
        return (x if r is None else torch.empty_like(x),
                torch.empty_like(x))
    if kind == "cpu":
        return ref.add_rms_norm_ref(x, r, w, eps)
    return fused.add_rms_norm(x, r, w, eps)


def rope_cache_write_op(q, k, v, cos, sin, k_cache, v_cache, write_pos,
                        bq=None, bk=None, bv=None):
    """q, k, v (B, S, H, D) with their biases (all three or none) added, q
    and k rotated by ``rope_tables``' (cos, sin), k and v written into the
    (B, Smax, Hkv, D) caches at clamp(write_pos, 0, Smax - S) in place (an
    e4m3 cache by the JAX package's cast); returns the rotated q."""
    biases = tuple(t for t in (bq, bk, bv) if t is not None)
    args = (q, k, v, cos, sin, k_cache, v_cache, write_pos, *biases)
    _refuse_grad("rope_cache_write_op", *args)
    kind = _device_kind("rope_cache_write_op", *args)
    if cost.LISTENERS:
        new_rows = 2.0 * k.numel() * k_cache.element_size()
        flops, nbytes = cost.pointwise_cost(
            (q, k, v, cos, sin, write_pos, *biases), (q,))
        cost.report("rope_cache_write", q, k_cache,
                    (flops, nbytes + new_rows))
    if kind == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if kind == "cpu":
        return ref.rope_cache_write_ref(*args[:8], bq, bk, bv)
    return fused.rope_cache_write(*args[:8], bq, bk, bv)


def gated_act_op(g, u, kind: str):
    """act(g) * u, ``kind`` "silu" or "gelu" (tanh), each rounded to g's
    dtype as the plain ops round."""
    _refuse_grad("gated_act_op", g, u)
    device = _device_kind("gated_act_op", g, u)
    if cost.LISTENERS:
        cost.report("gated_act", g, u, cost.pointwise_cost((g, u), (g,)))
    if device == "meta":
        return torch.empty(g.shape, dtype=g.dtype, device="meta")
    if device == "cpu":
        return ref.gated_act_ref(g, u, kind)
    return fused.gated_act(g, u, kind)


def moe_experts_op(x, w_gate, w_up, w_down, gates, ids, live, first: int,
                   experts: int, activation: str, group_elements: int):
    """A MoE layer's experts over the held tables (E of them, global ids
    ``first`` on, of the ``experts`` the router picks among): each token's
    sum over its held picks (``gates``, ``ids`` (T, k)) of gate x
    expert(x), the products in x's dtype, the sum in f32, cast to x's
    dtype; 0 for the rows ``live`` (T,) leaves out (None: every row). On
    the card only the live tokens' picks run (``moe_experts``); the plain
    version runs every token through every held expert in groups within
    ``group_elements``."""
    args = (x, w_gate, w_up, w_down, gates, ids) \
        + (() if live is None else (live,))
    _refuse_grad("moe_experts_op", *args)
    kind = _device_kind("moe_experts_op", *args)
    if cost.LISTENERS:
        cost.report("moe_experts", x, w_gate,
                    cost.moe_experts_cost(x, w_gate, w_up, w_down))
    if kind == "meta":
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if kind == "cpu":
        return ref.moe_experts_ref(x, w_gate, w_up, w_down, gates, ids, live,
                                   first, activation, group_elements)
    return moe_experts.moe_experts(x, w_gate, w_up, w_down, gates, ids, live,
                                   first, experts, activation, group_elements)


# the wrapper modules that count their launches (``launches``,
# ``launches_by_variant``)
COUNTED = (chunked_prefill, paged_attention, wkv6, fused, moe_experts)


class LaunchTally:
    """The launches one stretch of wrapper calls counted, per module and
    device kernel variant. ``record`` runs ``fn`` (a CUDA graph capture,
    which launches nothing on the card), keeps what its calls counted and
    takes it back off the modules' counts; ``replay`` adds it again, once
    per replay of what was captured."""

    def __init__(self, modules=COUNTED):
        self.modules = tuple(modules)
        self.counts = [(0, {}) for _ in self.modules]

    def _now(self):
        return [(m.launches, dict(m.launches_by_variant))
                for m in self.modules]

    def record(self, fn):
        before = self._now()
        out = fn()
        after = self._now()
        self.counts = [(n1 - n0, {v: by1[v] - by0.get(v, 0) for v in by1})
                       for (n0, by0), (n1, by1) in zip(before, after)]
        for m, (n, by) in zip(self.modules, before):
            m.launches = n
            m.launches_by_variant.update(by)
        return out

    def replay(self) -> None:
        for m, (n, by) in zip(self.modules, self.counts):
            m.launches += n
            for v, k in by.items():
                m.launches_by_variant[v] += k
