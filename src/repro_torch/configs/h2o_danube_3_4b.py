"""h2o-danube-3-4b — llama+mistral mix, sliding-window attention
[arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window 4096.
SWA => KV cache bounded by the window: long_500k runs (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    sliding_window=4096, rope_theta=10000.0,
    param_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    name="danube-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, sliding_window=32,
    param_dtype="float32", remat="none",
)
