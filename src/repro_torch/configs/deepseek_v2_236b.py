"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H d_ff=1536(expert) vocab=102400, MoE 160e top-6.
MLA: q_lora=1536, kv_lora=512, nope=128, rope=64, v_head=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab_size=102400,
    n_experts=160, top_k=6, d_expert=1536, n_shared_experts=2,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    rope_theta=10000.0,
    param_dtype="bfloat16", act_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    name="deepseek-v2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=32, d_expert=32, n_experts=8, top_k=2,
    n_shared_experts=1, q_lora_rank=16, kv_lora_rank=16,
    rope_head_dim=8, nope_head_dim=16, v_head_dim=16, vocab_size=256,
    param_dtype="float32", remat="none",
)
