"""chameleon-34b — early-fusion, VQ image tokens [arXiv:2405.09818;
unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  QK-norm per the
chameleon paper.  Early fusion: image VQ tokens share the token stream
(frontend stub — input_specs provides the fused int32 token ids).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, rope_theta=10000.0,
    param_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    name="chameleon-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, param_dtype="float32",
    remat="none",
)
