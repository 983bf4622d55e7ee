"""Plain PyTorch versions of the kernels (same math, no tiling).

Attention: counterparts of ``repro/kernels/ref.py``; inputs are upcast to
f32 and masked scores are set to -1e30, exactly as there. WKV6: the three
forms of the RWKV-6 recurrence in ``repro/models/rwkv6.py`` (``wkv_scan``,
``wkv_chunked``, ``wkv_decode``), in f32. ``kernels.ops`` sends tensors
that lie on the CPU here; ``chip_smoke.py`` holds each Hopper kernel
against these on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _soft_cap(s, cap):
    return s if cap is None else cap * torch.tanh(s / cap)


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
    k = k_pages[safe].reshape(b, s_max, hkv, d).float()
    v = v_pages[safe].reshape(b, s_max, hkv, d).float()

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


def wkv_scan(r, k, v, w, u, s0):
    """Sequential WKV (the oracle). Returns (out (B, T, H, D), sT) in f32."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, w, u, s0, chunk: int = 64):
    """Chunked-parallel WKV: intra-chunk masked products, the state carried
    across chunks; exponents relative to the chunk's midpoint cumulative
    decay (f32-safe under the model's decay clip). Matches wkv_scan."""
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"wkv_chunked: T={t} is not a multiple of {chunk}")
    n = t // chunk

    def to_chunks(a):                                   # (n, B, H, C, D)
        return a.float().reshape(b, n, chunk, h, d).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, w))
    logw = torch.log(wc.clamp_min(1e-38))
    cum = logw.cumsum(dim=-2)                           # inclusive
    total = cum[..., -1:, :]
    mid = cum[..., chunk // 2:chunk // 2 + 1, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    uf = u.float()[None, :, None, :]
    s = s0.float()
    outs = []
    for i in range(n):
        rt, kt, vt = rc[i], kc[i], vc[i]
        cum_prev = cum[i] - logw[i]
        out_state = torch.einsum("bhcd,bhde->bhce",
                                 rt * torch.exp(cum_prev), s)
        r_dec = rt * torch.exp(cum_prev - mid[i])
        kj = kt * torch.exp(mid[i] - cum[i])
        att = torch.einsum("bhid,bhjd->bhij", r_dec, kj)
        att = torch.where(mask, att, torch.zeros((), device=r.device))
        diag = torch.einsum("bhid,bhid->bhi", rt * uf, kt)
        out_intra = torch.einsum("bhij,bhjd->bhid", att, vt) \
            + diag[..., None] * vt
        k_dec = kt * torch.exp(total[i] - cum[i])
        s = torch.exp(total[i].squeeze(-2))[..., None] * s + torch.einsum(
            "bhcd,bhce->bhde", k_dec, vt)
        outs.append(out_state + out_intra)
    out = torch.stack(outs)                             # (n, B, H, C, D)
    return out.permute(1, 0, 3, 2, 4).reshape(b, t, h, d), s


def wkv_decode(r, k, v, w, u, s):
    """Single-token WKV. r, k, v, w: (B, H, D); s: (B, H, D, D)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhi,bhij->bhj", rf,
                       s + u.float()[None, :, :, None] * kv)
    return out, wf[..., None] * s + kv


def wkv6_ref(r, k, v, w, u, s0, mode: str):
    """The form the JAX model's ``_time_mix`` picks: ``wkv_decode`` for
    decode (T == 1), ``wkv_chunked`` when T is a positive multiple of 64,
    else ``wkv_scan``. Returns (out (B, T, H, D) f32, sT f32)."""
    if mode == "decode":
        out, s = wkv_decode(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
        return out[:, None], s
    t = r.shape[1]
    if t % 64 == 0 and t >= 64:
        return wkv_chunked(r, k, v, w, u, s0)
    return wkv_scan(r, k, v, w, u, s0)
