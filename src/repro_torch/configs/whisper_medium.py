"""whisper-medium [audio enc-dec] — arXiv:2212.04356; unverified.

24L enc + 24L dec, d_model=1024 16H d_ff=4096 vocab=51865; plain GELU MLP,
LayerNorm, sinusoidal positions, conv frontend STUBBED (input_specs
provides frame embeddings)."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=51865,
    use_layernorm=True, mlp_gated=False, mlp_activation="gelu",
    use_rope=False, qkv_bias=True, norm_eps=1e-5,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", num_layers=3, encoder_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    dtype=torch.float32,
)
