"""Core transformer building blocks in PyTorch: the dense path.

Counterpart of ``repro/models/layers.py``. Parameters keep the JAX
package's layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``, ``w_up (d, ff)``)
so that weights convert one to one and the tests compare like with like.

Conventions
-----------
* Params are nested dicts of tensors; weights are stored in ``cfg.dtype``
  (default bf16); norms, rope and softmax run in f32.
* Attention over a KV cache goes through ``repro_torch.kernels.ops``: the
  Hopper kernels for tensors on the card, their plain versions for tensors
  on the CPU. Attention without a cache (training, whisper's encoder and
  cross-attention) is ``attention_scores``, plain torch ops under autograd
  as the JAX ``_attn_block`` is XLA; the kernels refuse inputs that
  require grad.
* The pointwise work between the dense block's matrix products (the
  residual add and RMSNorm, bias, rope and the cache write, the gated
  activation) is one fused pass a gap (``kernels.ops``' ``add_rms_norm_op``,
  ``rope_cache_write_op``, ``gated_act_op``) where ``fuses`` holds: plain
  tensors on the card with no gradient to track. Everywhere else (the
  CPU, the meta device, DTensors, training) it is the plain ops of
  ``kernels.ref``, the same arithmetic op by op.
* Nothing on a step's path waits for the card (no ``.item()``, no shape
  read from a tensor's values), so a step can be captured as a CUDA graph
  (``serving.executor``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops, ref
from repro_torch.models import tp


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

    @property
    def router_width(self) -> int:
        """Experts the router scores: every expert of the model."""
        return self.num_experts

    @property
    def expert_ids(self) -> range:
        """Global ids of the experts whose tables the weights hold: all of
        them (``ExpertShare`` holds a part)."""
        return range(self.num_experts)


@dataclasses.dataclass(frozen=True)
class ExpertShare(ModelConfig):
    """A MoE model of which this card holds a contiguous share of the
    experts: ``num_experts`` of them, global ids ``first_expert`` on, out
    of the ``routed_experts`` the router scores (one rank of expert
    parallelism, run without its exchange). ``num_experts`` counts the
    held tables, so what prices the card's weights (``perf``'s cost model)
    prices the share. Every token is routed over all ``routed_experts``;
    the layer adds only the held experts' part, and that partial sum is
    what the next layer takes in (``moe.apply_moe_reference``). A subclass,
    so that ``ModelConfig``'s fields stay the JAX package's."""
    routed_experts: int = 0
    first_expert: int = 0

    def __post_init__(self):
        if not 0 < self.num_experts \
                or self.first_expert < 0 \
                or self.first_expert + self.num_experts > self.routed_experts:
            raise ValueError(
                f"{self.name}: experts {self.first_expert}.."
                f"{self.first_expert + self.num_experts - 1} are not a share "
                f"of {self.routed_experts}")
        if self.expert_pad_to:
            raise ValueError(f"{self.name}: a share of the experts is not "
                             "padded (expert_pad_to is expert parallelism's)")

    @property
    def router_width(self) -> int:
        return self.routed_experts

    @property
    def expert_ids(self) -> range:
        return range(self.first_expert, self.first_expert + self.num_experts)


# ---------------------------------------------------------------------------
# initialisers (same distributions as the JAX package's)
# ---------------------------------------------------------------------------


# Elements an initialiser draws in f32 at a time (256 MB): a larger tensor is
# drawn piece by piece along its leading axes, straight into its storage
# dtype, so that a full-width expert stack (arctic's two layers of w_gate
# are 17.8 GB in bf16) never has an f32 copy of itself.
DRAW_ELEMENTS = 1 << 26


class MetaGenerator:
    """Stands in for a ``torch.Generator`` in an init (``api.init``): every
    tensor is made on the meta device, shapes and dtypes with no storage
    and no draws (JAX's ``jax.eval_shape`` of an init), so the sharding
    rules see a full-width model of any size."""
    device = torch.device("meta")


def _normal(gen: torch.Generator, shape, dtype, scale: float):
    """N(0, scale^2) drawn in f32 and stored in ``dtype``, in pieces of at
    most ``DRAW_ELEMENTS`` consecutive elements (row-major, so along the
    leading axes); a tensor of one piece is drawn as one call. On the meta
    device (``MetaGenerator``) nothing is drawn."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    flat = out.view(-1)
    for lo in range(0, flat.numel(), DRAW_ELEMENTS):
        n = min(DRAW_ELEMENTS, flat.numel() - lo)
        w = torch.randn((n,), generator=gen, dtype=torch.float32,
                        device=gen.device)
        flat[lo:lo + n] = (w * scale).to(dtype)
    return out


def _dense_init(gen: torch.Generator, shape, dtype, in_axis_size=None,
                stack: int = 0):
    """N(0, 1/fan_in) drawn in f32, stored in ``dtype``; fan_in is
    ``in_axis_size`` or ``shape[0]``, as in the JAX package (so an expert
    stack (E, d, f) scales by 1/sqrt(E)). ``stack`` > 0 draws that many
    independent layers along a new leading axis."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    full = ((stack,) if stack else ()) + tuple(shape)
    return _normal(gen, full, dtype, 1.0 / math.sqrt(max(1, fan_in)))


def _embed_init(gen: torch.Generator, shape, dtype):
    return _normal(gen, shape, dtype, 0.02)


def layer(tree, i: int):
    """Layer ``i``'s views of a tree of weights (or states) stacked on a
    leading layer axis (``jax.tree.map(lambda a: a[i], tree)``)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack(tree) -> list:
    """Every layer's views of a stacked tree, one ``torch.unbind`` per
    leaf: the training forwards' per-layer weights. Under autograd the
    layers' gradients are stacked once; ``layer``'s indexing would give
    each layer a zero-filled gradient of the whole stack, summed over the
    layers (28 passes over qwen2-1.5b's 2.6 GB of blocks)."""
    if not isinstance(tree, dict):
        return list(tree.unbind(0))
    per_key = {k: unstack(v) for k, v in tree.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def untracked(*tensors: torch.Tensor) -> bool:
    """Plain tensors (not DTensors) with no gradient to track, on any
    device: what a kernel op takes (it has no backward and no sharding
    rule)."""
    return (not any(tp.is_dt(t) for t in tensors)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in tensors)))


def fuses(*tensors: torch.Tensor) -> bool:
    """Whether the fused pointwise passes take these tensors: ``untracked``
    ones on a CUDA device. The CPU, the meta device, DTensors and the
    training forwards keep the plain ops."""
    return tensors[0].device.type == "cuda" and untracked(*tensors)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``kernels.ref.rms_norm``: f32 statistics, the ``1 + scale`` form, the
    result in x's dtype (one pass on the card)."""
    if fuses(x, scale):
        return ops.add_rms_norm_op(x, None, scale, eps)[1]
    return ref.rms_norm(x, scale, eps)


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


def add_norm(params, x, r, cfg: ModelConfig):
    """The residual stream x + r and its norm: (x + r, apply_norm of it);
    r None: (x, apply_norm(x)). On the card an RMSNorm and the sum before
    it are one pass; elsewhere the sum in x's layout, then the norm."""
    if r is None:
        return x, apply_norm(params, x, cfg)
    if not cfg.use_layernorm and fuses(x, r, params["scale"]):
        return ops.add_rms_norm_op(x, r, params["scale"], cfg.norm_eps)
    x = tp.keep(x + r, x)
    return x, apply_norm(params, x, cfg)


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
    sin): ``kernels.ref.rotate``, split halves (not interleaved pairs), as
    the JAX package does."""
    return ref.rotate(x, tables)


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
      * "ring"    — decode over a window-sized ring cache of Sk slots:
                    kpos <= lengths[b], or every slot once the ring has
                    wrapped (lengths[b] + 1 >= Sk)
      * "full"    — bidirectional (whisper's encoder and cross-attention)
    ``window``: additionally restrict to kpos > qpos - window ("lengths":
    kpos > lengths[b] - window).
    """
    kind: str = "causal"
    window: Optional[int] = None
    q_offset: int = 0

    def block(self, sq: int, sk: int, q_start: int,
              device) -> Optional[torch.Tensor]:
        """The (sq, sk) mask of queries [q_start, q_start + sq) over keys
        [0, sk) for the kinds that need no cache: None for "full", the
        causal (and window) mask for "causal", as JAX's ``MaskSpec.block``."""
        if self.kind == "full":
            return None
        if self.kind != "causal":
            raise ValueError(f"attention without a cache takes MaskSpec "
                             f"'causal' or 'full', got {self.kind!r}")
        qpos = torch.arange(sq, device=device)[:, None] + q_start \
            + self.q_offset
        kpos = torch.arange(sk, device=device)[None, :]
        ok = kpos <= qpos
        if self.window is not None:
            ok = ok & (kpos > qpos - self.window)
        return ok


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def apply_attention(params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, mask: MaskSpec,
                    kv_cache: Optional[tuple] = None,
                    cache_positions: Optional[torch.Tensor] = None,
                    lengths: Optional[torch.Tensor] = None,
                    rope: bool = True, tables: Optional[dict] = None,
                    cross_kv: Optional[tuple] = None):
    """Self-attention over a KV cache (B, Smax, Hkv, D), over x itself, or
    cross-attention over fixed K/V.

    * ``cross_kv`` (k, v) of (B, Sk, Hkv, D): q attends over them (whisper's
      cross-attention); no rope on q, no cache written; returns
      ``(out, None)``.
    * no ``kv_cache``: self-attention over x's own K/V under
      ``MaskSpec("full")`` (whisper's encoder) or ``MaskSpec("causal")``
      (the training forwards); returns ``(out, (k, v))``.

    Both run ``attention_scores``, plain torch ops as the JAX
    ``_attn_block`` computes them (XLA there, no Pallas kernel), so
    autograd sees them. With a cache, the new K/V
    are written into ``kv_cache`` IN PLACE at ``cache_positions`` (the JAX
    version returns an updated copy) and ``(out, kv_cache)`` is returned.
    Attention over a cache goes to ``kernels.ops``:

    * "causal" / "chunk": ``chunked_prefill_op`` with ``starts`` = the
      chunk's first position (0 + q_offset for "causal");
    * "lengths" (decode, S == 1): ``paged_attention_op`` over the cache
      viewed as pages with an identity block table. The model's
      ``lengths`` is the write position (the mask is ``kpos <= lengths``
      and, under a window, ``kpos > lengths - window``), the kernel's
      counts tokens including the new one, hence ``lengths + 1``; its
      window keeps keys from ``lengths + 1 - window`` on, the same set.
    * "ring" (decode over a ring of Sk slots; the caller writes at
      ``cache_positions mod Sk``): the same op with kernel lengths
      ``min(lengths + 1, Sk)`` and no window, which keeps the slots
      ``kpos <= lengths`` before the ring wraps and every slot after.

    ``tables`` holds what every layer of a step shares, built once by the
    caller: ``"rope"`` (``rope_tables`` at ``positions``) and, for a
    decode, ``"pages"`` (``decode_block_table`` of this layer's cache
    length) and ``"kv_lengths"`` (the kernel's int32 lengths above); what
    is missing is built here. An fp8 (e4m3) cache stores K/V through
    ``to_e4m3`` and the kernels widen it to q's dtype, as the JAX model
    casts the cache. Where ``fuses`` holds and the cache is in q's dtype
    or e4m3, the biases, the rope and the cache write are one pass
    (``ops.rope_cache_write_op``).
    """
    tables = tables or {}
    q = _project(x, params["wq"])
    if kv_cache is not None and cross_kv is None and rope and fuses(q) \
            and kv_cache[0].dtype in (q.dtype, torch.float8_e4m3fn):
        rot = tables.get("rope") or rope_tables(positions, cfg.head_dim,
                                                cfg.rope_theta)
        biases = [params[n] for n in ("bq", "bk", "bv")] \
            if cfg.qkv_bias else []
        k_cache, v_cache = kv_cache
        q = ops.rope_cache_write_op(
            q, _project(x, params["wk"]), _project(x, params["wv"]), *rot,
            k_cache, v_cache, cache_positions.to(torch.int32), *biases)
    else:
        if cfg.qkv_bias:
            q = q + params["bq"]
        scores = tp.scores_attention if tp.is_dt(q) else attention_scores
        if cross_kv is not None:
            out = scores(q, *cross_kv, mask, cfg.attn_softcap,
                         cfg.attn_q_chunk)
            return _out_project(params, out), None
        k, v = compute_kv(params, x, cfg)
        if rope:
            rot = tables.get("rope") or rope_tables(positions, cfg.head_dim,
                                                    cfg.rope_theta)
            q = rotate(q, rot)
            k = rotate(k, rot)
        if kv_cache is None:
            out = scores(q, k, v, mask, cfg.attn_softcap, cfg.attn_q_chunk)
            return _out_project(params, out), (k, v)

        k_cache, v_cache = kv_cache
        if tp.is_dt(q):
            out = tp.cache_attention(q, k, v, k_cache, v_cache,
                                     cache_positions=cache_positions,
                                     lengths=lengths, mask=mask,
                                     softcap=cfg.attn_softcap)
            return _out_project(params, out), (k_cache, v_cache)
        _cache_write(k_cache, k, cache_positions)
        _cache_write(v_cache, v, cache_positions)

    if mask.kind in ("lengths", "ring"):
        pages = tables.get("pages")
        if pages is None:
            pages = decode_block_table(*k_cache.shape[:2], x.device)
        n = tables.get("kv_lengths")
        if n is None:
            n = decode_lengths(lengths, k_cache.shape[1], mask.kind == "ring")
        out = _decode_attention(q[:, 0], k_cache, v_cache, pages, n,
                                cfg.attn_softcap, mask.window)[:, None]
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
        raise ValueError(f"mask kind {mask.kind!r} over a KV cache: the "
                         "cache's kinds are causal, chunk, lengths and ring")
    return _out_project(params, out), (k_cache, v_cache)


def decode_lengths(lengths: torch.Tensor, size: int,
                   ring: bool) -> torch.Tensor:
    """The decode kernel's int32 lengths over a cache of ``size`` rows for
    the model's write positions ``lengths``: ``lengths + 1``, at most
    ``size`` over a ring (``apply_attention``), built once a step."""
    n = lengths + 1
    if ring:
        n = n.clamp(max=size)
    return n.to(torch.int32)


def _out_project(params, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul over the flattened heads."""
    h, hd, d = params["wo"].shape
    y = out.reshape(*out.shape[:-2], h * hd) @ params["wo"].reshape(h * hd, d)
    return tp.rows_layout(y, out)


def compute_kv(params, x: torch.Tensor, cfg: ModelConfig):
    """The K/V projections (and biases) of x, no rope: whisper's cross-K/V
    precompute, as the JAX ``compute_kv``."""
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return k, v


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: MaskSpec, softcap: Optional[float] = None,
                     q_chunk: int = 512) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, D) over k, v (B, Sk, Hkv, D) under a
    "causal" or "full" ``mask``, as the JAX ``attention_scores`` computes
    it: the queries in chunks of ``q_chunk`` (a ragged last chunk where
    JAX asserts Sq % q_chunk == 0; each query's row is the same either
    way), each chunk through ``_attn_block``."""
    sq = q.shape[1]
    if sq <= q_chunk:
        return _attn_block(q, k, v, mask, 0, softcap)
    return torch.cat([_attn_block(q[:, i:i + q_chunk], k, v, mask, i,
                                  softcap)
                      for i in range(0, sq, q_chunk)], dim=1)


def _attn_block(q, k, v, mask: MaskSpec, q_start: int, softcap):
    """The JAX ``_attn_block``: logits in f32 scaled by 1/sqrt(D),
    softcapped, masked to -1e30, softmax in f32, the probabilities cast to
    V's dtype for the product, which accumulates in f32; the output in q's
    dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) \
        * (1.0 / math.sqrt(d))
    logits = _soft_cap(logits, softcap)
    ok = mask.block(sq, sk, q_start, q.device)
    if ok is not None:
        logits = logits.masked_fill(~ok, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


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


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to ``torch.float8_e4m3fn`` as JAX casts it
    (``kernels.ref.to_e4m3``: NaN, sign kept, past 464)."""
    return ref.to_e4m3(x)


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 write_pos: torch.Tensor) -> None:
    """cache (B, Smax, H, D) <- new (B, Snew, H, D) at rows
    [write_pos[b], write_pos[b] + Snew), in place, clamped back as
    ``lax.dynamic_update_slice`` clamps (``kernels.ref.cache_write``)."""
    ref.cache_write(cache, new, write_pos)


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
    """SiLU or tanh-GELU (``kernels.ref.activate``)."""
    return ref.activate(x, kind)


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP's activation and product are one pass where ``fuses``
    holds (``ops.gated_act_op``)."""
    u = x @ params["w_up"]
    if "w_gate" in params:
        g = x @ params["w_gate"]
        if fuses(g, u):
            u = ops.gated_act_op(g, u, cfg.mlp_activation)
        else:
            g = _activate(g, cfg.mlp_activation)  # the pre-activation freed
            u = g * u
        del g                             # before the down projection
    else:
        u = _activate(u, cfg.mlp_activation)
    return tp.rows_layout(u @ params["w_down"], x)


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
    if tp.is_dt(params["table"]):
        x = tp.embed(params["table"], tokens)
    else:
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


def token_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy (B, S) of logits (B, S, V) against labels
    (B, S), on plain tensors: ``logsumexp - logits[label]``."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, labels.long()[..., None])[..., 0]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits (B, S, V) f32 against labels (B, S):
    ``logsumexp - logits[label]``, the JAX ``softmax_xent``'s function
    without its (B, S, V) one-hot."""
    if tp.is_dt(logits):
        return tp.xent(logits, labels).mean()
    return token_xent(logits, labels).mean()


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> x[b, idx[b]] (B, d)."""
    if tp.is_dt(x):
        return tp.take_rows(x, idx)
    return x[torch.arange(x.shape[0], device=x.device), idx]


# ---------------------------------------------------------------------------
# rematerialisation (the JAX ``jax.checkpoint`` policies)
# ---------------------------------------------------------------------------

# the ops whose outputs the "dots" policy keeps (JAX's
# ``dots_with_no_batch_dims_saveable`` keeps the projections' dots; here
# every matrix product, the attention's batched ones too)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str):
    """``fn`` under a rematerialisation ``policy``, the counterpart of
    ``transformer._remat`` / ``jax.checkpoint``: "none" runs it as it is;
    "full" keeps only its inputs and recomputes the rest in the backward
    pass; "dots" keeps the outputs of the matrix products as well and
    recomputes the rest. The values and gradients are the same under each."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat policy must be none, full or dots, got "
                     f"{policy!r}")
