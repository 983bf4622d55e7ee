"""deepseek-7b [dense] — arXiv:2401.02954; hf. llama-arch.

30L d_model=4096 32H (kv=32, MHA) d_ff=11008 vocab=102400."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400, rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, dtype=torch.float32,
)
