"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b; unverified.

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352; LayerNorm.
Simplification vs HF (noted in DESIGN.md): full rotary instead of partial
(25%) rotary dims.
"""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352, use_layernorm=True, norm_eps=1e-5,
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="stablelm-smoke", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, dtype=torch.float32,
)
