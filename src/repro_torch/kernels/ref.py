"""Plain PyTorch versions of the kernels (same math, no tiling).

Attention: counterparts of ``repro/kernels/ref.py``; inputs are upcast to
f32 and masked scores are set to -1e30, exactly as there. K/V stored as
fp8 (e4m3) are first widened to q's dtype, as the JAX model casts its
quantised cache before attention. WKV6: the form of the RWKV-6
recurrence the JAX model picks (``wkv6_ref``), among the three that
``models/rwkv6.py`` keeps where JAX keeps them (``wkv_scan``,
``wkv_chunked``, ``wkv_decode``, in f32). The fused pointwise passes
(``kernels/fused.py``): the dense block's own plain ops, RMSNorm, the
rotary embedding, the cache write and the gated activation, as the model
layers compute them wherever the passes do not run (``models/layers.py``
calls these). The routed expert products (``kernels/moe_experts.py``): the
dense dispatch of ``models/moe.py``, every token through every held expert
in groups, the f32 combine with the rows that are not live zeroed (what the
CPU runs for the op; ``models/moe.py`` runs ``expert_sum`` itself where a
gradient is tracked or the tensors are DTensors).
``kernels.ops`` sends tensors that lie on the CPU here;
``chip_smoke.py`` holds each Hopper kernel against these on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# the fused pointwise passes: norms, rope, the cache write, gated activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def add_rms_norm_ref(x, r, w, eps: float):
    """(x + r in x's dtype, ``rms_norm`` of it); r None: (x, its norm)."""
    total = x if r is None else x + r
    return total, rms_norm(total, w, eps)


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (..., seq, heads, head_dim) rotated by ``rope_tables``' (cos,
    sin). Rotates split halves (not interleaved pairs), as the JAX package
    does."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# The e4m3 cast of the JAX package (ml_dtypes): a value whose magnitude
# exceeds 464 (halfway between 448, the largest finite e4m3, and 480)
# becomes NaN, sign kept, where torch's cast saturates to +-448; below
# that the two round alike.
E4M3_OVERFLOW = 464.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to ``torch.float8_e4m3fn`` as JAX casts it."""
    nan = torch.full_like(x, float("nan")).copysign(x)
    return torch.where(x.abs() > E4M3_OVERFLOW, nan, x).to(
        torch.float8_e4m3fn)


def cache_write(cache: torch.Tensor, new: torch.Tensor,
                write_pos: torch.Tensor) -> None:
    """cache (B, Smax, H, D) <- new (B, Snew, H, D) at rows
    [write_pos[b], write_pos[b] + Snew), in place. Positions past the end
    are clamped back as ``lax.dynamic_update_slice`` clamps them. An e4m3
    cache takes ``to_e4m3(new)``, written as bytes."""
    b, smax = cache.shape[:2]
    snew = new.shape[1]
    start = write_pos.long().clamp(0, smax - snew)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(snew, device=cache.device)[None]
    if cache.dtype == torch.float8_e4m3fn:
        cache.view(torch.uint8)[rows, cols] = to_e4m3(new).view(torch.uint8)
    else:
        cache[rows, cols] = new.to(cache.dtype)


def rope_cache_write_ref(q, k, v, cos, sin, k_cache, v_cache, write_pos,
                         bq=None, bk=None, bv=None) -> torch.Tensor:
    """The biases added (all three or none), q and k rotated by (cos,
    sin), k and v written into the caches at ``write_pos`` (in place);
    returns the rotated q."""
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    q = rotate(q, (cos, sin))
    k = rotate(k, (cos, sin))
    cache_write(k_cache, k, write_pos)
    cache_write(v_cache, v, write_pos)
    return q


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def gated_act_ref(g: torch.Tensor, u: torch.Tensor, kind: str) -> torch.Tensor:
    """``activate(g, kind) * u``, each op rounding to g's dtype."""
    return activate(g, kind) * u


# ---------------------------------------------------------------------------
# the experts of a mixture-of-experts layer: dense dispatch
# ---------------------------------------------------------------------------


def held_combine(gates: torch.Tensor, ids: torch.Tensor,
                 held: range) -> torch.Tensor:
    """Each token's combine weight for each expert of ``held`` (global
    ids), from its top-k ``gates`` and ``ids`` (T, k): (T, len(held)) f32,
    a gate where the token picked that expert and 0 where it did not."""
    mine = held.start + torch.arange(len(held), device=ids.device)
    return torch.where(ids[:, :, None] == mine[None, None, :],
                       gates[:, :, None], 0.0).sum(dim=1)


def expert_group(tokens: int, n: int, d: int, f: int, elements: int) -> int:
    """Experts computed together for ``tokens`` tokens: as many of the
    ``n`` as keep a group's (G, T, max(d, f)) intermediate within
    ``elements``, at least one."""
    return max(1, min(n, elements // max(1, tokens * max(d, f))))


def expert_sum(xt, w_gate, w_up, w_down, combine, n: int, activation: str,
               step: int) -> torch.Tensor:
    """sum_e combine[:, e] * expert_e(xt) over the first ``n`` experts of
    the tables, in f32: (T, d). The products run in ``xt``'s dtype, in
    groups of ``step`` experts."""
    t, d = xt.shape
    out = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        g = activate(torch.matmul(xt, w_gate[lo:hi]), activation)  # (G, T, f)
        u = torch.matmul(xt, w_up[lo:hi])
        y = torch.matmul(g * u, w_down[lo:hi])                # (G, T, d)
        w = combine[:, lo:hi].t()[:, :, None]                 # (G, T, 1)
        out += (y.float() * w).sum(dim=0)
    return out


def moe_lists(ids, live, first: int, held: int):
    """The routed products' lists, plainly (``moe_experts.lists``): each
    held expert's count and offset (held,), the tokens of the held picks
    of the live rows in (expert, token) order, and each (token, j)'s place
    in that order or -1 (T * k,); int32. ``live`` None: every row."""
    t, k = ids.shape
    local = ids.long() - first
    mine = (local >= 0) & (local < held)
    if live is not None:
        mine &= live[:, None]
    counts = torch.bincount(local[mine], minlength=held)
    offsets = torch.cumsum(counts, 0) - counts
    token = torch.arange(t, device=ids.device)[:, None].expand(t, k)
    key = torch.where(mine, local * t + token, held * t).reshape(-1)
    order = torch.argsort(key, stable=True)[:int(mine.sum())]
    place = torch.full((t * k,), -1, dtype=torch.int32, device=ids.device)
    place[order] = torch.arange(order.numel(), dtype=torch.int32,
                                device=ids.device)
    return (counts.int(), offsets.int(), token.reshape(-1)[order].int(),
            place)


def moe_experts_ref(x, w_gate, w_up, w_down, gates, ids, live, first: int,
                    activation: str, group_elements: int) -> torch.Tensor:
    """The routed products' plain version: ``expert_sum`` over the E held
    tables (global ids ``first`` on), in groups within ``group_elements``,
    with the combine of the rows ``live`` (T,) leaves out zeroed (None:
    every row live), cast to x's dtype."""
    (t, d), (n, _, f) = x.shape, w_gate.shape
    combine = held_combine(gates, ids, range(first, first + n))
    if live is not None:
        combine = torch.where(live[:, None], combine, 0.0)
    step = expert_group(t, n, d, f, group_elements)
    return expert_sum(x, w_gate, w_up, w_down, combine, n, activation,
                      step).to(x.dtype)
