"""The plain reference of the ``llama`` architecture (``servebench/archs``):
the forward pass in f32 with plain torch operations, one layer at a time
over a few whole sequences.

It imports nothing of the port. It reads the benchmark's weights (the
port's parameter tree, ``servebench/weights.py``) and casts each matrix to
f32 when it uses it, so that it fits beside them. The block is the one the
port runs (``models/transformer.py``), which is the published Llama block
with two conventions of the port that its configuration files list under
``departures``: token embeddings scaled by sqrt(d_model) rounded to bf16,
and RMSNorm weights in the ``1 + w`` form. For a MoE layer (Arctic): the
router's logits in f32, the top-k experts by a stable sort (ties to the
lower id), their gates the softmax over the k logits, each token through
its k experts only, plus the dense residual MLP on the same normalised
input.

``precision="e4m3"`` is the control: every matrix product's operands (the
router's excepted, which the configuration keeps in f32) and the attention's
q, K and V are rounded to float8 e4m3 first, each row of an activation and
each column of a weight scaled by its own largest magnitude to e4m3's 448,
then multiplied in f32. That is the precision a later change to fp8 would
serve in, one step below the bf16 that the configurations state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
Q_BLOCK = 1024          # queries per block of an attention's scores


@dataclasses.dataclass(frozen=True)
class Arch:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    experts: int = 0
    top_k: int = 0
    dense_residual_ff: int = 0


def arch(raw: dict) -> Arch:
    """The sizes from the published ``config.json`` keys: ``head_dim``
    hidden_size / heads where the config gives none; the dense residual
    MLP beside a MoE layer (``parallel_attn_mlp_res``) as wide as its own
    key, ``residual_mlp_ffn_dim``."""
    return Arch(
        layers=raw["num_hidden_layers"], d_model=raw["hidden_size"],
        heads=raw["num_attention_heads"],
        kv_heads=raw["num_key_value_heads"],
        head_dim=raw.get("head_dim", raw["hidden_size"]
                         // raw["num_attention_heads"]),
        d_ff=raw["intermediate_size"], vocab=raw["vocab_size"],
        rope_theta=float(raw["rope_theta"]),
        norm_eps=float(raw["rms_norm_eps"]),
        experts=raw.get("num_local_experts", 0),
        top_k=raw.get("num_experts_per_tok", 0),
        dense_residual_ff=raw["residual_mlp_ffn_dim"]
        if raw.get("parallel_attn_mlp_res") else 0)


def _round_e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3, scaled along ``dim`` so that its largest
    magnitude maps to 448."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("f32", "e4m3"):
            raise ValueError(f"precision must be f32 or e4m3, got "
                             f"{precision!r}")
        self.low = precision == "e4m3"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (in, out) weight in f32, or rounded per output column."""
        w = w.float()
        return _round_e4m3(w, 0) if self.low else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _round_e4m3(x, -1) if self.low else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (T, in) f32 times an already prepared (in, out) weight."""
        return self.act(x) @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + w.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) rotated at positions 0..S-1, split halves."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(ops: _Ops, q, k, v, arch: Arch) -> torch.Tensor:
    """Causal attention of q (S, H, D) over k, v (S, Hkv, D): (S, H*D)."""
    s = q.shape[0]
    g = arch.heads // arch.kv_heads
    q, k, v = ops.act(q), ops.act(k), ops.act(v)
    qg = q.view(s, arch.kv_heads, g, arch.head_dim)
    out = []
    for lo in range(0, s, Q_BLOCK):
        hi = min(s, lo + Q_BLOCK)
        sc = torch.einsum("qhgd,khd->hgqk", qg[lo:hi], k[:hi]) \
            / math.sqrt(arch.head_dim)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out.append(torch.einsum("hgqk,khd->qhgd", p, v[:hi]))
    return torch.cat(out).reshape(s, arch.heads * arch.head_dim)


def _mlp(ops: _Ops, x, wg, wu, wd) -> torch.Tensor:
    return ops.mm(F.silu(ops.mm(x, wg)) * ops.mm(x, wu), wd)


def _moe(ops: _Ops, p: dict, layer: int, x: torch.Tensor,
         arch: Arch) -> tuple:
    """Each token through its top-k experts, weighted by their gates; and
    each token's routing margin, its k-th router logit less its (k+1)-th."""
    logits = x @ p["router"][layer].float()
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    margin = vals[:, arch.top_k - 1] - vals[:, arch.top_k]
    gates = torch.softmax(vals[:, :arch.top_k], dim=-1)
    ids = ids[:, :arch.top_k]
    out = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        y = _mlp(ops, x[tok], ops.weight(p["w_gate"][layer, e]),
                 ops.weight(p["w_up"][layer, e]),
                 ops.weight(p["w_down"][layer, e]))
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out, margin


def logits(params: dict, arch: Arch, seqs: list, firsts: list,
           precision: str = "f32", margins: Optional[list] = None) -> list:
    """For each token sequence (1-D int64 on the weights' device) the f32
    logits (n, vocab) at positions ``firsts[i]`` .. end; embeddings scaled
    by sqrt(d_model) rounded to bf16, as the port does. ``margins``, if
    given, receives for each sequence of a MoE model the smallest routing
    margin over its MoE layers at those positions; a dense model routes
    nothing and adds none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = _Ops(precision)
    emb_scale = float(torch.tensor(math.sqrt(arch.d_model),
                                   dtype=torch.bfloat16))
    emb = params["embed"]
    h = [emb["table"][s].float() * emb_scale for s in seqs]
    low = [torch.full((len(s),), float("inf"), device=s.device) for s in seqs]
    blocks = params["blocks"]
    at = blocks["attn"]
    d, hd = arch.d_model, arch.head_dim
    for layer in range(arch.layers):
        wq = ops.weight(at["wq"][layer].reshape(d, -1))
        wk = ops.weight(at["wk"][layer].reshape(d, -1))
        wv = ops.weight(at["wv"][layer].reshape(d, -1))
        wo = ops.weight(at["wo"][layer].reshape(-1, d))
        na = blocks["norm_attn"]["scale"][layer]
        nm = blocks["norm_mlp"]["scale"][layer]
        mlp = blocks.get("mlp")
        if mlp is not None:
            wg, wu, wd = (ops.weight(mlp[k][layer])
                          for k in ("w_gate", "w_up", "w_down"))
        for i, x in enumerate(h):
            s = x.shape[0]
            xn = _rms(x, na, arch.norm_eps)
            q = _rope(ops.mm(xn, wq).view(s, arch.heads, hd), arch.rope_theta)
            k = _rope(ops.mm(xn, wk).view(s, arch.kv_heads, hd),
                      arch.rope_theta)
            v = ops.mm(xn, wv).view(s, arch.kv_heads, hd)
            x = x + ops.mm(_attention(ops, q, k, v, arch), wo)
            xn = _rms(x, nm, arch.norm_eps)
            y = _mlp(ops, xn, wg, wu, wd) if mlp is not None else 0.0
            if arch.experts:
                routed, margin = _moe(ops, blocks["moe"], layer, xn, arch)
                y = y + routed
                low[i] = torch.minimum(low[i], margin)
            h[i] = x + y
        del wq, wk, wv, wo
        if mlp is not None:
            del wg, wu, wd
    if margins is not None and arch.experts:
        margins.extend(m[f:] for m, f in zip(low, firsts))
    table = ops.weight(emb.get("unembed", emb["table"]).t())
    fn = params["final_norm"]["scale"]
    return [ops.mm(_rms(x[f:], fn, arch.norm_eps), table)
            for x, f in zip(h, firsts)]
