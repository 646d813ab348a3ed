"""``--arch <id>`` resolution for all assigned architectures (+ the paper's
own benchmarks).  Each arch module exports CONFIG (full) and SMOKE
(reduced same-family config for CPU tests)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, SHAPES, SMOKE_SHAPES, ShapeSpec

ARCH_IDS = [
    "xlstm_125m",
    "granite_moe_1b_a400m",
    "deepseek_v2_236b",
    "zamba2_2p7b",
    "h2o_danube_3_4b",
    "qwen1p5_110b",
    "qwen2_7b",
    "starcoder2_3b",
    "chameleon_34b",
    "whisper_small",
]

# canonical external ids → module names
ALIASES = {
    "xlstm-125m": "xlstm_125m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "zamba2-2.7b": "zamba2_2p7b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen1.5-110b": "qwen1p5_110b",
    "qwen2-7b": "qwen2_7b",
    "starcoder2-3b": "starcoder2_3b",
    "chameleon-34b": "chameleon_34b",
    "whisper-small": "whisper_small",
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict[str, ArchConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


def get_shape(name: str, smoke: bool = False) -> ShapeSpec:
    return (SMOKE_SHAPES if smoke else SHAPES)[name]
