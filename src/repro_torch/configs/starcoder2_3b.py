"""starcoder2-3b — GQA, RoPE [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
LayerNorm + bias MLP per the starcoder2 reference.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    norm="layernorm", mlp="gelu_mlp", mlp_bias=True, qkv_bias=True,
    rope_theta=100000.0, tie_embeddings=True,
    param_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, param_dtype="float32",
    remat="none",
)
