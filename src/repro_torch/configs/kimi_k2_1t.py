"""kimi-k2-1t-a32b [moe] — arXiv:2501.kimi2 (paper-table); unverified.

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840; MoE 384 experts
top-8 + 1 shared expert. head_dim 128 (q_dim 8192 decoupled from d_model).
"""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    num_experts=384, top_k=8, num_shared_experts=1,
)

SMOKE = dataclasses.replace(
    CONFIG, name="kimi-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=512,
    num_experts=8, top_k=2, num_shared_experts=1, dtype=torch.float32,
)
