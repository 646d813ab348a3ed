"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified].

12L (enc) + 12L (dec), d_model=768 12H d_ff=3072 vocab=51865.
Frontend stub: input_specs provides precomputed (B, 1500, 768) frame
embeddings (post-conv).  Decode shapes exercise the decoder with self-attn
KV cache + cross-attn cache over the 1500 encoder frames.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    enc_dec=True, n_enc_layers=12, n_frames=1500,
    norm="layernorm", mlp="gelu_mlp", use_rope=False,
    tie_embeddings=True,
    param_dtype="float32", remat="dots",
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, n_frames=16,
    remat="none",
)
