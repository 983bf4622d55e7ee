"""A toy architecture for the tests, in the two files a new one adds: the
Llama block with biased q, k and v projections (qwen2's), which the port
runs under ``qkv_bias``. Its sizes, counts and vocabulary are llama's."""
import dataclasses

import torch

from servebench.archs import llama
from servebench.archs.llama import count, shape, vocab  # noqa: F401

TINY = [dict(llama.TINY[0], name="tiny-toy", arch="toy")]
BIAS_STD = 0.5          # large enough that a reference without it fails


def layout(s, dtype=torch.bfloat16) -> dict:
    tree = llama.layout(s, dtype)
    heads = {"bq": s.heads, "bk": s.kv_heads, "bv": s.kv_heads}
    tree["blocks"]["attn"].update(
        {k: ((s.layers, h, s.head_dim), dtype, BIAS_STD)
         for k, h in heads.items()})
    return tree


def port_config(raw: dict, dtype):
    return dataclasses.replace(llama.port_config(raw, dtype), qkv_bias=True)
