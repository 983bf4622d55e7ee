"""zamba2-2.7b [hybrid] — arXiv:2411.15242; hf.

54 Mamba2 blocks d_model=2560 (d_inner 5120, ssm_state 64) + shared
attention block (32H, head_dim 80, d_ff 10240) every 6 blocks."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, ssm_state=64, attn_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", num_layers=6, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, ssm_state=16,
    attn_every=3, dtype=torch.float32,
)
