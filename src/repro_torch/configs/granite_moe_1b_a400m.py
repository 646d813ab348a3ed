"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    n_experts=32, top_k=8, d_expert=512, n_shared_experts=0,
    tie_embeddings=True, rope_theta=10000.0,
    param_dtype="float32", remat="dots",
)

SMOKE = CONFIG.replace(
    name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=64, d_expert=64, n_experts=8, top_k=2,
    vocab_size=256, remat="none",
)
