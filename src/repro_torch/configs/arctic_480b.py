"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000; MoE 128 experts
top-2 PLUS a parallel dense residual MLP (dense-MoE hybrid)."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    num_experts=128, top_k=2, moe_dense_residual_ff=4864,
)

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=512,
    num_experts=8, top_k=2, moe_dense_residual_ff=96, dtype=torch.float32,
)
