"""Plain PyTorch versions of the attention kernels (same math, no tiling).

Counterparts of ``repro/kernels/ref.py``: inputs are upcast to f32 and
masked scores are set to -1e30, exactly as there. ``kernels.ops`` sends
tensors that lie on the CPU here; ``chip_smoke.py`` holds each Hopper
kernel against these on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _soft_cap(s, cap):
    return s if cap is None else cap * torch.tanh(s / cap)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        softcap=None):
    """q: (B, Hq, D); pages (N, ps, Hkv, D); block_tables (B, P); lengths
    (B,) counting tokens including the new one. Gathers each request's
    pages into a dense (P*ps, Hkv, D) cache and runs masked attention."""
    b, hq, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    g = hq // hkv
    s_max = block_tables.shape[1] * ps

    safe = block_tables.long().clamp_min(0)
    k = k_pages[safe].reshape(b, s_max, hkv, d).float()
    v = v_pages[safe].reshape(b, s_max, hkv, d).float()

    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(d)
    s = _soft_cap(s, softcap)
    pos = torch.arange(s_max, device=q.device)
    mask = pos[None, :] < lengths.long()[:, None]               # (B, S)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(b, hq, d).to(q.dtype)


def chunked_prefill_attention_ref(q, k_cache, v_cache, starts, *,
                                  softcap=None, window=None):
    """q: (B, Sq, Hq, D); caches (B, Smax, Hkv, D) that already hold the
    chunk's K/V; starts (B,). Query i of row b sits at starts[b] + i."""
    b, sq, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k_cache.float()) / math.sqrt(d)
    s = _soft_cap(s, softcap)
    qpos = starts.long()[:, None] + torch.arange(sq, device=q.device)[None]
    kpos = torch.arange(smax, device=q.device)
    ok = kpos[None, None, :] <= qpos[:, :, None]                # (B, Sq, Smax)
    if window is not None:
        ok = ok & (kpos[None, None, :] > qpos[:, :, None] - window)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p, v_cache.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)
