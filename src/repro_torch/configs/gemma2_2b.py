"""gemma2-2b [dense] — arXiv:2408.00118; hf.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; local+global
alternating sliding window (4096), attention softcap 50, final softcap 30,
GeGLU, head_dim 256, sandwich norms.
"""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global_alternating=True,
    mlp_activation="gelu", use_post_norms=True, rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma2-smoke", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, sliding_window=8,
    dtype=torch.float32,
)
