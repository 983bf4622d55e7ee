"""Core transformer building blocks in PyTorch: the dense path.

Counterpart of ``repro/models/layers.py``. Parameters keep the JAX
package's layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``, ``w_up (d, ff)``)
so that weights convert one to one and the tests compare like with like.

Conventions
-----------
* Params are nested dicts of tensors; weights are stored in ``cfg.dtype``
  (default bf16); norms, rope and softmax run in f32.
* Attention goes through ``repro_torch.kernels.ops``: the Hopper kernels
  for tensors on the card, their plain versions for tensors on the CPU.
* Nothing on a step's path waits for the card (no ``.item()``, no shape
  read from a tensor's values), so a step can be captured as a CUDA graph
  (``serving.executor``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | hybrid | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None      # window for local layers
    local_global_alternating: bool = False    # gemma2: even layers local
    rope_theta: float = 10_000.0
    # mlp
    mlp_activation: str = "silu"              # silu->SwiGLU, gelu->GeGLU
    mlp_gated: bool = True                    # False: plain 2-matrix MLP
    use_layernorm: bool = False               # LN instead of RMSNorm
    use_post_norms: bool = False              # gemma2 sandwich norms
    use_rope: bool = True                     # False: absolute positions
    # moe
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_dense_residual_ff: int = 0            # arctic: parallel dense FFN
    moe_capacity_factor: float = 2.0
    expert_pad_to: int = 0
    # ssm / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0                       # zamba2: shared attn cadence
    # encdec
    encoder_layers: int = 0
    # vlm
    vision_feature_dim: int = 0
    num_patches: int = 0
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # checkpointing / perf knobs (hillclimb surface of the JAX package)
    remat_policy: str = "dots"                # none | dots | full
    scan_layers: bool = True
    attn_q_chunk: int = 512
    attn_unroll_chunks: bool = False
    kv_cache_quant: bool = False              # fp8(e4m3) KV cache storage
    window_sized_cache: bool = False          # gemma2 ring cache

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# ---------------------------------------------------------------------------
# initialisers (same distributions as the JAX package's)
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, in_axis_size=None,
                stack: int = 0):
    """N(0, 1/fan_in) drawn in f32, stored in ``dtype``. ``stack`` > 0 draws
    that many independent layers along a new leading axis."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    scale = 1.0 / math.sqrt(max(1, fan_in))
    full = ((stack,) if stack else ()) + tuple(shape)
    w = torch.randn(full, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def _embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def init_norm(cfg: ModelConfig, device, stack: int = 0):
    shape = ((stack,) if stack else ()) + (cfg.d_model,)
    if cfg.use_layernorm:
        return {"scale": torch.ones(shape, dtype=cfg.dtype, device=device),
                "bias": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    return {"scale": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def apply_norm(params, x, cfg: ModelConfig):
    if cfg.use_layernorm:
        return layer_norm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rms_norm(x, params["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles at ``positions`` (..., seq), shaped
    (..., seq, 1, head_dim/2) in f32: a step builds them once and every
    layer rotates its q and k with them."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs       # (..., seq, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (..., seq, heads, head_dim) rotated by ``rope_tables``' (cos,
    sin). Rotates split halves (not interleaved pairs), as the JAX package
    does."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, h, hd), cfg.dtype, stack=stack),
        "wk": _dense_init(gen, (d, hkv, hd), cfg.dtype, stack=stack),
        "wv": _dense_init(gen, (d, hkv, hd), cfg.dtype, stack=stack),
        "wo": _dense_init(gen, (h, hd, d), cfg.dtype, in_axis_size=cfg.q_dim,
                          stack=stack),
    }
    if cfg.qkv_bias:
        lead = (stack,) if stack else ()
        for name, heads in (("bq", h), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(lead + (heads, hd), dtype=cfg.dtype,
                                  device=gen.device)
    return p


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Attention-mask description, as in the JAX package.

    kind:
      * "causal"  — query i attends to kpos <= q_offset + i
      * "lengths" — decode: kpos <= lengths[b] (lengths is (B,))
      * "chunk"   — chunked prefill: query i of the chunk sits at
                    lengths[b] + i and attends to kpos <= that
    ``window``: additionally restrict to kpos > qpos - window ("lengths":
    kpos > lengths[b] - window).
    The JAX package's "full" kind waits for the whisper slice, and its
    "ring" kind (gemma2's window-sized cache) for the ring's own slice
    (see ROADMAP.md).
    """
    kind: str = "causal"
    window: Optional[int] = None
    q_offset: int = 0


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def apply_attention(params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, mask: MaskSpec,
                    kv_cache: tuple[torch.Tensor, torch.Tensor],
                    cache_positions: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    rope: bool = True, tables: Optional[dict] = None):
    """Self-attention over a KV cache (B, Smax, Hkv, D).

    Writes the new K/V into ``kv_cache`` IN PLACE at ``cache_positions``
    (the JAX version returns an updated copy) and returns
    ``(out, kv_cache)``. Attention goes to ``kernels.ops``:

    * "causal" / "chunk": ``chunked_prefill_op`` with ``starts`` = the
      chunk's first position (0 + q_offset for "causal");
    * "lengths" (decode, S == 1): ``paged_attention_op`` over the cache
      viewed as pages with an identity block table. The model's
      ``lengths`` is the write position (the mask is ``kpos <= lengths``
      and, under a window, ``kpos > lengths - window``), the kernel's
      counts tokens including the new one, hence ``lengths + 1``; its
      window keeps keys from ``lengths + 1 - window`` on, the same set.

    ``tables`` holds what every layer of a step shares, built once by the
    caller: ``"rope"`` (``rope_tables`` at ``positions``) and, for a
    decode, ``"pages"`` (``decode_block_table``); what is missing is built
    here. An fp8 (e4m3) cache stores K/V through ``to_e4m3`` and the
    kernels widen it to q's dtype, as the JAX model casts the cache.
    """
    tables = tables or {}
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if rope:
        rot = tables.get("rope") or rope_tables(positions, cfg.head_dim,
                                                cfg.rope_theta)
        q = rotate(q, rot)
        k = rotate(k, rot)

    k_cache, v_cache = kv_cache
    _cache_write(k_cache, k, cache_positions)
    _cache_write(v_cache, v, cache_positions)

    if mask.kind == "lengths":
        pages = tables.get("pages")
        if pages is None:
            pages = decode_block_table(*k_cache.shape[:2], x.device)
        out = _decode_attention(q[:, 0], k_cache, v_cache, pages,
                                lengths + 1, cfg.attn_softcap,
                                mask.window)[:, None]
    elif mask.kind in ("causal", "chunk"):
        if mask.kind == "causal":
            starts = torch.full((x.shape[0],), mask.q_offset,
                                dtype=torch.int32, device=x.device)
        else:
            starts = lengths.to(torch.int32)
        out = ops.chunked_prefill_op(q, k_cache, v_cache, starts,
                                     softcap=cfg.attn_softcap,
                                     window=mask.window)
    else:
        raise NotImplementedError(
            f"mask kind {mask.kind!r} is not ported yet (ROADMAP.md)")
    h, hd, d = params["wo"].shape
    out = out.reshape(*out.shape[:-2], h * hd) @ params["wo"].reshape(h * hd, d)
    return out, (k_cache, v_cache)


def decode_page_size(max_len: int) -> int:
    """Page size for viewing a (B, S) slotted cache as pages: the largest
    divisor of S up to 64, so the view needs no copy."""
    return math.gcd(max_len, 64)


def decode_block_table(batch: int, max_len: int, device) -> torch.Tensor:
    """The identity block table (B, P) that views a (B, S) slotted cache as
    pages of ``decode_page_size(S)`` tokens: row b holds pages
    [b*P, b*P + P)."""
    n_pp = max_len // decode_page_size(max_len)
    return torch.arange(batch * n_pp, dtype=torch.int32,
                        device=device).view(batch, n_pp)


def _decode_attention(q, k_cache, v_cache, tables, lengths, softcap,
                      window=None):
    """q (B, Hq, D) over a dense (B, S, Hkv, D) cache through the paged
    decode op, the cache viewed as the pages ``tables`` names."""
    b, s, hkv, d = k_cache.shape
    ps = decode_page_size(s)
    k_pages = k_cache.view(b * (s // ps), ps, hkv, d)
    v_pages = v_cache.view(b * (s // ps), ps, hkv, d)
    return ops.paged_attention_op(q, k_pages, v_pages, tables,
                                  lengths.to(torch.int32), softcap=softcap,
                                  window=window)


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


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
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


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, stack: int = 0):
    d_ff = d_ff or cfg.d_ff
    p = {}
    if cfg.mlp_gated:
        p["w_gate"] = _dense_init(gen, (cfg.d_model, d_ff), cfg.dtype,
                                  stack=stack)
    p["w_up"] = _dense_init(gen, (cfg.d_model, d_ff), cfg.dtype, stack=stack)
    p["w_down"] = _dense_init(gen, (d_ff, cfg.d_model), cfg.dtype,
                              stack=stack)
    return p


def _activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    u = x @ params["w_up"]
    if "w_gate" in params:
        u = _activate(x @ params["w_gate"], cfg.mlp_activation) * u
    else:
        u = _activate(u, cfg.mlp_activation)
    return u @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    p = {"table": _embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = _embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                   cfg.dtype)
    return p


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The rows of ``tokens`` scaled by sqrt(d_model) rounded to the
    weights' dtype (as JAX rounds it). The scale is a CPU scalar: a CUDA op
    reads it on the host as a kernel argument, so a captured graph holds it
    as a constant."""
    x = params["table"][tokens.long()]
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)


def _soft_cap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params.get("unembed", params["table"])
    logits = (x @ table.t()).float()
    return _soft_cap(logits, cfg.final_softcap)
