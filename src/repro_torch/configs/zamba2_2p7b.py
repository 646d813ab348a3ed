"""zamba2-2.7b — Mamba2 backbone + weight-shared attention block
[arXiv:2411.15242; hf].

54L d_model=2560 32H d_ff=10240 vocab=32000, ssm_state=64.
Shared attention+MLP block applied every 6 mamba layers (9 applications).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    ssm_chunk=256, hybrid_period=6,
    tie_embeddings=True,
    param_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=32, hybrid_period=2, param_dtype="float32", remat="none",
)
