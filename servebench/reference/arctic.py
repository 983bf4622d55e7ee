"""The plain reference of the ``arctic`` architecture
(``servebench/archs/arctic.py``): llama's reference block
(``reference/llama.py``, whose helpers it takes) with a MoE layer of which
the weights hold a contiguous share of the experts.

It imports nothing of the port. Every token is routed over all
``routed`` router logits in f32 (the top-k by a stable sort, ties to the
lower id, their gates the softmax over the k logits); only the experts the
weights hold, global ids ``first`` .. ``first + experts - 1``, add their
part, each token through those of its k experts alone. Attention and the
dense residual MLP are whole, on the same normalised post-attention
stream, and the next layer takes in the sum: what the port computes on
one card of an expert-parallel group, without the exchange
(``layers.ExpertShare``). A token's routing margin is its k-th logit less
its (k+1)-th over all the router's experts: a flip between a held and an
absent expert moves the result as much as one between two held ones.

``precision="e4m3"`` is llama's control: every matrix product's operands
but the router's, and attention's q, K and V, rounded to e4m3 first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from servebench.reference import llama
from servebench.reference.llama import _Ops, _attention, _mlp, _rms, _rope


@dataclasses.dataclass(frozen=True)
class Arch(llama.Arch):
    routed: int = 0             # experts the router scores
    first: int = 0              # global id of the first held expert


def arch(raw: dict) -> Arch:
    """llama's sizes, with ``experts`` the held ones (``held_experts``),
    ``routed`` all the router scores (``num_local_experts``) and the
    share's first id (``held_expert_first``)."""
    base = dataclasses.asdict(llama.arch(raw))
    routed, base["experts"] = base["experts"], raw["held_experts"]
    return Arch(**base, routed=routed, first=raw.get("held_expert_first", 0))


def _moe(ops: _Ops, p: dict, layer: int, x: torch.Tensor,
         arch: Arch) -> tuple:
    """Each token through those of its top-k experts the weights hold,
    weighted by their gates; and each token's routing margin over all the
    router's experts."""
    logits = x @ p["router"][layer].float()
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    margin = vals[:, arch.top_k - 1] - vals[:, arch.top_k]
    gates = torch.softmax(vals[:, :arch.top_k], dim=-1)
    ids = ids[:, :arch.top_k]
    out = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        i = e - arch.first
        if not 0 <= i < arch.experts:
            continue
        tok, slot = (ids == e).nonzero(as_tuple=True)
        y = _mlp(ops, x[tok], ops.weight(p["w_gate"][layer, i]),
                 ops.weight(p["w_up"][layer, i]),
                 ops.weight(p["w_down"][layer, i]))
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out, margin


def logits(params: dict, arch: Arch, seqs: list, firsts: list,
           precision: str = "f32", margins: Optional[list] = None) -> list:
    """For each token sequence (1-D int64 on the weights' device) the f32
    logits (n, vocab) at positions ``firsts[i]`` .. end, as llama's
    ``logits``; ``margins``, if given, receives for each sequence the
    smallest routing margin over its layers at those positions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = _Ops(precision)
    emb_scale = float(torch.tensor(math.sqrt(arch.d_model),
                                   dtype=torch.bfloat16))
    emb, blocks = params["embed"], params["blocks"]
    at, mlp = blocks["attn"], blocks["mlp"]
    h = [emb["table"][s].float() * emb_scale for s in seqs]
    low = [torch.full((len(s),), float("inf"), device=s.device) for s in seqs]
    d, hd = arch.d_model, arch.head_dim
    for layer in range(arch.layers):
        wq, wk, wv = (ops.weight(at[k][layer].reshape(d, -1))
                      for k in ("wq", "wk", "wv"))
        wo = ops.weight(at["wo"][layer].reshape(-1, d))
        wg, wu, wd = (ops.weight(mlp[k][layer])
                      for k in ("w_gate", "w_up", "w_down"))
        na = blocks["norm_attn"]["scale"][layer]
        nm = blocks["norm_mlp"]["scale"][layer]
        for i, x in enumerate(h):
            s = x.shape[0]
            xn = _rms(x, na, arch.norm_eps)
            q = _rope(ops.mm(xn, wq).view(s, arch.heads, hd), arch.rope_theta)
            k = _rope(ops.mm(xn, wk).view(s, arch.kv_heads, hd),
                      arch.rope_theta)
            v = ops.mm(xn, wv).view(s, arch.kv_heads, hd)
            x = x + ops.mm(_attention(ops, q, k, v, arch), wo)
            xn = _rms(x, nm, arch.norm_eps)
            routed, margin = _moe(ops, blocks["moe"], layer, xn, arch)
            h[i] = x + _mlp(ops, xn, wg, wu, wd) + routed
            low[i] = torch.minimum(low[i], margin)
        del wq, wk, wv, wo, wg, wu, wd
    if margins is not None:
        margins.extend(m[f:] for m, f in zip(low, firsts))
    table = ops.weight(emb.get("unembed", emb["table"]).t())
    fn = params["final_norm"]["scale"]
    return [ops.mm(_rms(x[f:], fn, arch.norm_eps), table)
            for x, f in zip(h, firsts)]
