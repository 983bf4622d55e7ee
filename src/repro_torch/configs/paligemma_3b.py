"""paligemma-3b [vlm] — arXiv:2407.07726; hf.

Gemma-2b backbone: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216,
head_dim 256, GeGLU. SigLIP frontend is a STUB: input_specs() provides
precomputed patch embeddings (dim 1152) projected into the backbone."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, mlp_activation="gelu",
    vision_feature_dim=1152, num_patches=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, name="paligemma-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
    vision_feature_dim=48, num_patches=8, dtype=torch.float32,
)
