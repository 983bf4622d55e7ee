"""internlm2-20b — the paper's evaluation model (arXiv InternLM2 tech report).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544; llama-arch; 200K
max context. Used by the serving cost model + paper-figure benchmarks."""
import dataclasses
import torch
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="internlm-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92544, rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="internlm-smoke", num_layers=4, d_model=64, num_heads=8,
    num_kv_heads=2, head_dim=8, d_ff=128, vocab_size=512, dtype=torch.float32,
)
