"""The toy architecture's plain reference: llama's dense block, with each
of q, k and v biased before the rope, as qwen2's."""
from __future__ import annotations

import math
from typing import Optional

import torch

from servebench.reference.llama import (_Ops, _attention, _mlp, _rms,
                                        _rope, arch)  # noqa: F401


def logits(params: dict, arch, seqs: list, firsts: list,
           precision: str = "f32", margins: Optional[list] = None) -> list:
    """As llama's ``logits`` for a dense model (no routes, so no
    margins), with the biases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = _Ops(precision)
    scale = float(torch.tensor(math.sqrt(arch.d_model), dtype=torch.bfloat16))
    emb, blocks = params["embed"], params["blocks"]
    at, mlp = blocks["attn"], blocks["mlp"]
    d, hd = arch.d_model, arch.head_dim
    h = [emb["table"][s].float() * scale for s in seqs]
    for layer in range(arch.layers):
        w = {k: ops.weight(at[k][layer].reshape(d, -1))
             for k in ("wq", "wk", "wv")}
        wo = ops.weight(at["wo"][layer].reshape(-1, d))
        wg, wu, wd = (ops.weight(mlp[k][layer])
                      for k in ("w_gate", "w_up", "w_down"))
        for i, x in enumerate(h):
            xn = _rms(x, blocks["norm_attn"]["scale"][layer], arch.norm_eps)
            q, k, v = (ops.mm(xn, w[n]).view(len(x), -1, hd)
                       + at[b][layer].float()
                       for n, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
            q, k = _rope(q, arch.rope_theta), _rope(k, arch.rope_theta)
            x = x + ops.mm(_attention(ops, q, k, v, arch), wo)
            xn = _rms(x, blocks["norm_mlp"]["scale"][layer], arch.norm_eps)
            h[i] = x + _mlp(ops, xn, wg, wu, wd)
    table = ops.weight(emb.get("unembed", emb["table"]).t())
    fn = params["final_norm"]["scale"]
    return [ops.mm(_rms(x[f:], fn, arch.norm_eps), table)
            for x, f in zip(h, firsts)]
