"""rwkv6-7b "Finch" [ssm] — arXiv:2404.05892; hf.

32L d_model=4096 (attn-free, 64 heads x 64 dims) d_ff=14336 vocab=65536."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
)

SMOKE = dataclasses.replace(
    CONFIG, name="rwkv6-smoke", num_layers=3, d_model=128, num_heads=2,
    num_kv_heads=2, head_dim=64, d_ff=256, vocab_size=512, dtype=torch.float32,
)
