"""Dispatch for the attention kernels.

Tensors on the CPU go to the plain versions in ``kernels.ref``; tensors on
a CUDA device go to the Hopper kernels, which launch or raise. Nothing
falls back: a CUDA tensor the kernel does not take (dtype, head_dim, ...)
raises, and so do tensors on other devices or on mixed ones.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chunked_prefill, paged_attention, ref


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        return kinds.pop()
    raise ValueError(f"{name}: no kernel for tensors on {sorted(kinds)}")


def paged_attention_op(q, k_pages, v_pages, block_tables, lengths,
                       softcap=None):
    args = (q, k_pages, v_pages, block_tables, lengths)
    if _device_kind("paged_attention_op", *args) == "cpu":
        return ref.paged_attention_ref(*args, softcap=softcap)
    return paged_attention.paged_attention(*args, softcap=softcap)


def chunked_prefill_op(q, k_cache, v_cache, starts, softcap=None,
                       window=None):
    args = (q, k_cache, v_cache, starts)
    if _device_kind("chunked_prefill_op", *args) == "cpu":
        return ref.chunked_prefill_attention_ref(*args, softcap=softcap,
                                                 window=window)
    return chunked_prefill.chunked_prefill_attention(*args, softcap=softcap,
                                                     window=window)


def wkv6_op(*args, **kwargs):
    raise NotImplementedError(
        "wkv6_op: the RWKV-6 kernel is not ported yet; it comes with the "
        "rwkv6 slice (ROADMAP.md, queue 2)")
