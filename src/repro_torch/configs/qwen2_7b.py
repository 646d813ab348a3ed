"""qwen2-7b — GQA, QKV bias [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
28 heads % 16 != 0: heads replicate on the model axis; ffn/vocab shard
(sharding fallback recorded in EXPERIMENTS.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1000000.0,
    param_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    name="qwen2-smoke", n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
    head_dim=8, d_ff=96, vocab_size=256, param_dtype="float32",
    remat="none",
)
