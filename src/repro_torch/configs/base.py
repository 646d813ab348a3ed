"""Architecture config schema + shape registry.

One ``ArchConfig`` describes any member of the supported model zoo
(dense / GQA / MLA / MoE / SSM / hybrid / enc-dec).  Each assigned
architecture gets a module ``src/repro_torch/configs/<id>.py`` exporting
``CONFIG`` (full size) and ``SMOKE`` (reduced same-family config for CPU
tests).  ``repro_torch.configs.registry`` resolves ``--arch <id>``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 -> full attention
    use_rope: bool = True
    # norms / activations
    norm: str = "rmsnorm"
    mlp: str = "glu"                # glu | gelu_mlp
    mlp_bias: bool = False
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): shared attention block every `hybrid_period` layers
    hybrid_period: int = 0
    # xLSTM
    slstm_every: int = 0            # every k-th block is sLSTM (0 = none)
    mlstm_chunk: int = 256
    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500
    max_decode_positions: int = 0   # 0 -> unlimited (learned pos off)
    # numerics / execution
    param_dtype: str = "float32"
    act_dtype: str = "bfloat16"
    attn_chunk: int = 1024          # memory-efficient attention kv-chunk
    remat: str = "dots"             # none | dots | full  (scan remat policy)
    scan_layers: bool = True
    # perf knobs (hillclimbed by SHARDING-SEARCH / §Perf; defaults = paper-
    # faithful baseline)
    pad_vocab_to_multiple: int = 0  # pad embed/lm_head so vocab shards
    mea_bf16: bool = False          # bf16 operands in MEA attention einsums
    loss_chunk: int = 0             # tokens per loss chunk (0 = one shot)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def pdt(self):
        return getattr(torch, self.param_dtype)

    @property
    def adt(self):
        return getattr(torch, self.act_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear-attn / SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# smoke-scale shapes for CPU tests
SMOKE_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 64, 4, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 128, 4, "decode"),
    "long_500k": ShapeSpec("long_500k", 256, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Skip policy of DESIGN.md §4."""
    if shape.name == "long_500k":
        if cfg.enc_dec:
            return False, "enc-dec audio backbone is length-bounded (1500 frames)"
        if not cfg.subquadratic:
            return False, "pure full-attention arch: 500k dense KV decode excluded"
    if shape.is_decode and cfg.enc_dec and cfg.n_layers == 0:
        return False, "encoder-only arch has no decode step"
    return True, ""


def model_flops_per_token(cfg: ArchConfig) -> float:
    """6*N(_active)*1 — MODEL_FLOPS per token for the roofline table."""
    n = active_params(cfg)
    return 6.0 * n


def active_params(cfg: ArchConfig) -> float:
    """Parameter count (active params for MoE) — analytic, no allocation."""
    d = cfg.d_model
    hd = cfg.hd
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    if cfg.family == "ssm" or cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        # mamba2 block: in_proj (z,x,B,C,dt) + conv + out_proj
        nh = d_in // cfg.ssm_head_dim
        per_layer += d * (2 * d_in + 2 * cfg.ssm_state + nh) + d_in * d
        per_layer += cfg.ssm_conv * (d_in + 2 * cfg.ssm_state)
    if cfg.family in ("dense", "moe", "vlm", "audio") or cfg.hybrid_period:
        # attention
        if cfg.use_mla:
            qdim = cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
            attn = d * cfg.q_lora_rank + cfg.q_lora_rank * qdim \
                if cfg.q_lora_rank else d * qdim
            attn += d * (cfg.kv_lora_rank + cfg.rope_head_dim)
            attn += cfg.kv_lora_rank * cfg.n_heads * (
                cfg.nope_head_dim + cfg.v_head_dim)
            attn += cfg.n_heads * cfg.v_head_dim * d
        else:
            attn = d * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd) \
                + cfg.n_heads * hd * d
        # mlp (active)
        if cfg.is_moe:
            mlp = cfg.top_k * 3 * d * cfg.d_expert \
                + cfg.n_shared_experts * 3 * d * cfg.d_expert
        else:
            mult = 3 if cfg.mlp == "glu" else 2
            mlp = mult * d * cfg.d_ff
        if cfg.hybrid_period:
            # shared block applied every hybrid_period layers; weights shared,
            # but *active* compute counts each application.
            frac = 1.0 / cfg.hybrid_period
            per_layer += frac * (attn + mlp)
        else:
            per_layer += attn + mlp
    if cfg.family == "ssm" and cfg.slstm_every:
        pass  # xLSTM per-layer terms handled in its config notes
    total = emb + cfg.n_layers * per_layer
    if cfg.enc_dec:
        # encoder layers + decoder cross-attention
        enc = cfg.n_enc_layers * (4 * d * d + 2 * d * cfg.d_ff)
        cross = cfg.n_layers * 4 * d * d
        total += enc + cross
    return float(total)


def total_params(cfg: ArchConfig) -> float:
    """Total parameter count (all experts for MoE)."""
    if not cfg.is_moe:
        return active_params(cfg)
    d = cfg.d_model
    act = active_params(cfg)
    routed_all = cfg.n_layers * cfg.n_experts * 3 * d * cfg.d_expert
    routed_active = cfg.n_layers * cfg.top_k * 3 * d * cfg.d_expert
    return act - routed_active + routed_all


def config_summary(cfg: ArchConfig) -> dict[str, Any]:
    return {
        "name": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size,
        "params_total_B": total_params(cfg) / 1e9,
        "params_active_B": active_params(cfg) / 1e9,
    }
