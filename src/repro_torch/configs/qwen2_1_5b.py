"""qwen2-1.5b [dense] — arXiv:2407.10671; hf.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; QKV bias."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-smoke", num_layers=4, d_model=96, num_heads=6,
    num_kv_heads=2, head_dim=16, d_ff=192, vocab_size=512, dtype=torch.float32,
)
