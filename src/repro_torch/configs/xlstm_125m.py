"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own internal projections (mLSTM 2x up-proj; sLSTM pf=4/3 FFN).
Blocks alternate mLSTM / sLSTM (scan unit = one double block, 6 pairs).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    use_rope=False, tie_embeddings=True,
    slstm_every=2, mlstm_chunk=256,
    param_dtype="float32", remat="dots",
)

SMOKE = CONFIG.replace(
    name="xlstm-smoke", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
    vocab_size=256, mlstm_chunk=32, remat="none",
)
