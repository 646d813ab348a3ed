"""Per-layer mixed-precision policies (QUANTIZATION O-task substrate).

A *policy* maps layer-name patterns to precision levels, and the model's
``linear`` primitive (models/common.py) dispatches on the matched level:
FP32 and BF16 products, FP8 weight storage with bf16 products, and INT8
through the quant_matmul kernel (kernels/quant_matmul.py).

Levels (most → least precise): fp32 > bf16 > fp8 > int8.
"""

from __future__ import annotations

import fnmatch
import math

import torch

FP32 = "fp32"
BF16 = "bf16"
FP8 = "fp8"      # float8_e4m3
INT8 = "int8"

# Lattice ordered most → least precise (greedy_lattice_descent walks down it).
LEVELS = (FP32, BF16, FP8, INT8)

# Bytes per weight at each level — the LUT/BRAM-analogue resource metric.
LEVEL_BYTES = {FP32: 4.0, BF16: 2.0, FP8: 1.0, INT8: 1.0}

_DTYPES = {
    FP32: torch.float32,
    BF16: torch.bfloat16,
    FP8: torch.float8_e4m3fn,
    INT8: torch.int8,
}

# Largest magnitude that rounds to a finite float8_e4m3fn (448, ties to
# even); anything above becomes NaN in the reference's conversion.
FP8_E4M3FN_ROUND_LIMIT = 464.0


class PrecisionPolicy:
    """Ordered pattern→level map with an exemption list.

    Patterns are ``fnmatch`` globs matched against hierarchical layer names
    (e.g. ``layers/attn/wq``, ``layers/moe/experts/w_up``).  First match wins;
    unmatched names use ``default``.  ``exempt`` patterns always stay at the
    default level (router/gate weights etc.).
    """

    def __init__(self, default: str = BF16,
                 rules: list[tuple[str, str]] | None = None,
                 exempt: list[str] | None = None):
        if default not in LEVELS:
            raise ValueError(f"unknown precision level {default!r}")
        self.default = default
        self.rules: list[tuple[str, str]] = list(rules or [])
        self.exempt: list[str] = list(exempt or [])

    def copy(self) -> "PrecisionPolicy":
        return PrecisionPolicy(self.default, list(self.rules),
                               list(self.exempt))

    def with_rule(self, pattern: str, level: str) -> "PrecisionPolicy":
        p = self.copy()
        # prepend so newer (more specific, search-driven) rules win
        p.rules.insert(0, (pattern, level))
        return p

    def level_for(self, name: str) -> str:
        for pat in self.exempt:
            if fnmatch.fnmatch(name, pat):
                return self.default
        for pat, level in self.rules:
            if fnmatch.fnmatch(name, pat):
                return level
        return self.default

    def as_dict(self) -> dict:
        return {"default": self.default, "rules": list(self.rules),
                "exempt": list(self.exempt)}

    def __repr__(self) -> str:
        return f"PrecisionPolicy({self.as_dict()})"


def quantize_int8(w: torch.Tensor, axis: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``, the *contraction* axis
    (reduced over), so a weight's scales are per output channel.

    ``scale = max(absmax, 1e-8) / 127`` in fp32, ``q = clip(round(w /
    scale), -127, 127)`` with round-half-to-even — the reference's
    arithmetic operation for operation, so the int8 values and scales are
    bit-equal.  Returns (int8 values, fp32 scales with ``axis`` kept)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def fake_quant_int8(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Quantize→dequantize with a straight-through gradient: the forward
    value is the dequantized weight, the gradient flows to ``w``
    unchanged."""
    q, scale = quantize_int8(w, axis)
    deq = q.float() * scale
    return w + (deq - w.float()).detach().to(w.dtype)


def to_fp8_e4m3fn(w: torch.Tensor) -> torch.Tensor:
    """``w`` stored as float8_e4m3fn, round to nearest even.  Magnitudes
    that round past the largest finite value (448) become NaN, as in the
    reference's conversion; torch's own cast saturates them to ±448 in
    some versions, so the overflow is made explicit here."""
    over = w.float().abs() > FP8_E4M3FN_ROUND_LIMIT
    return torch.where(over, float("nan"), w).to(torch.float8_e4m3fn)


def cast_level(w: torch.Tensor, level: str) -> torch.Tensor:
    """Round-trip a weight through the storage dtype of ``level``."""
    if level == INT8:
        q, scale = quantize_int8(w, axis=0)
        return (q.float() * scale).to(w.dtype)
    if level == FP8:
        return to_fp8_e4m3fn(w).to(w.dtype)
    return w.to(_DTYPES[level]).to(w.dtype)


def weight_bytes(shape: tuple[int, ...], level: str) -> float:
    return float(math.prod(shape)) * LEVEL_BYTES[level]
