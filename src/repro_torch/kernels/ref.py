"""Plain PyTorch versions of the kernels (same math, no tiling).

Attention: counterparts of ``repro/kernels/ref.py``; inputs are upcast to
f32 and masked scores are set to -1e30, exactly as there. K/V stored as
fp8 (e4m3) are first widened to q's dtype, as the JAX model casts its
quantised cache before attention. WKV6: the form of the RWKV-6
recurrence the JAX model picks (``wkv6_ref``), among the three that
``models/rwkv6.py`` keeps where JAX keeps them (``wkv_scan``,
``wkv_chunked``, ``wkv_decode``, in f32). ``kernels.ops`` sends tensors
that lie on the CPU here; ``chip_smoke.py`` holds each Hopper kernel
against these on the card.
"""
from __future__ import annotations

import math

import torch

# the module, not its names: models.rwkv6 imports kernels.ops, which
# imports this module
from repro_torch.models import rwkv6

NEG_INF = -1e30


def _soft_cap(s, cap):
    return s if cap is None else cap * torch.tanh(s / cap)


def _widen(kv, q):
    """K or V in q's dtype (exact from e4m3 into bf16 or f32)."""
    return kv if kv.dtype == q.dtype else kv.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        softcap=None, window=None):
    """q: (B, Hq, D); pages (N, ps, Hkv, D); block_tables (B, P); lengths
    (B,) counting tokens including the new one. Gathers each request's
    pages into a dense (P*ps, Hkv, D) cache and runs masked attention.
    ``window``: only keys at positions >= lengths - window count."""
    b, hq, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    g = hq // hkv
    s_max = block_tables.shape[1] * ps

    safe = block_tables.long().clamp_min(0)
    k = _widen(k_pages, q)[safe].reshape(b, s_max, hkv, d).float()
    v = _widen(v_pages, q)[safe].reshape(b, s_max, hkv, d).float()

    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(d)
    s = _soft_cap(s, softcap)
    pos = torch.arange(s_max, device=q.device)
    mask = pos[None, :] < lengths.long()[:, None]               # (B, S)
    if window is not None:
        mask = mask & (pos[None, :] >= lengths.long()[:, None] - window)
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
    k_cache, v_cache = _widen(k_cache, q), _widen(v_cache, q)
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


# ---------------------------------------------------------------------------
# WKV6: out_t = r_t^T (S + diag(u) k_t v_t^T),  S <- diag(w_t) S + k_t v_t^T
# r, k, v, w: (B, T, H, D); u: (H, D) f32; s0: (B, H, D, D) f32 [key, value]
# ---------------------------------------------------------------------------


def wkv6_ref(r, k, v, w, u, s0, mode: str):
    """The form the JAX model's ``_time_mix`` picks: ``wkv_decode`` for
    decode (T == 1), ``wkv_chunked`` when T is a positive multiple of 64,
    else ``wkv_scan``. Returns (out (B, T, H, D) f32, sT f32)."""
    if mode == "decode":
        out, s = rwkv6.wkv_decode(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
        return out[:, None], s
    return rwkv6.wkv_sequence(r, k, v, w, u, s0)
