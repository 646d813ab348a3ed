"""qwen1.5-110b — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1000000.0,
    param_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    name="qwen110-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, param_dtype="float32", remat="none",
)
