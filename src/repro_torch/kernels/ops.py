"""Dispatch for the kernels (attention, WKV6).

Tensors on the CPU go to the plain versions in ``kernels.ref``; tensors on
a CUDA device go to the Hopper kernels, which launch or raise. Nothing
falls back: a CUDA tensor the kernel does not take (dtype, head_dim, ...)
raises, and so do tensors on other devices or on mixed ones.

``LaunchTally`` keeps the wrappers' launch counts true under CUDA graphs:
a wrapper counts in Python where it launches, and a graph replay runs the
captured launches without that code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chunked_prefill, paged_attention, ref, wkv6


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        return kinds.pop()
    raise ValueError(f"{name}: no kernel for tensors on {sorted(kinds)}")


def paged_attention_op(q, k_pages, v_pages, block_tables, lengths,
                       softcap=None, window=None):
    args = (q, k_pages, v_pages, block_tables, lengths)
    if _device_kind("paged_attention_op", *args) == "cpu":
        return ref.paged_attention_ref(*args, softcap=softcap, window=window)
    return paged_attention.paged_attention(*args, softcap=softcap,
                                           window=window)


def chunked_prefill_op(q, k_cache, v_cache, starts, softcap=None,
                       window=None):
    args = (q, k_cache, v_cache, starts)
    if _device_kind("chunked_prefill_op", *args) == "cpu":
        return ref.chunked_prefill_attention_ref(*args, softcap=softcap,
                                                 window=window)
    return chunked_prefill.chunked_prefill_attention(*args, softcap=softcap,
                                                     window=window)


def wkv6_op(r, k, v, w, u, s0, mode: str):
    """The RWKV-6 recurrence over (B, T, H, D) inputs; ``mode`` is the
    model's sequence mode, "decode" (T == 1) or "chunked". On the CPU it
    picks the plain form the JAX model picks (``ref.wkv6_ref``); on the card
    the kernel takes every T. Returns (out f32, sT f32)."""
    if mode not in ("decode", "chunked"):
        raise ValueError(f"wkv6_op: mode must be 'decode' or 'chunked', "
                         f"got {mode!r}")
    if mode == "decode" and r.shape[1] != 1:
        raise ValueError(f"wkv6_op: decode takes one token, got T="
                         f"{r.shape[1]}")
    args = (r, k, v, w, u, s0)
    if _device_kind("wkv6_op", *args) == "cpu":
        return ref.wkv6_ref(*args, mode)
    return wkv6.wkv6(*args)


# the wrapper modules that count their launches (``launches``,
# ``launches_by_variant``)
COUNTED = (chunked_prefill, paged_attention, wkv6)


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
