"""Per-layer mixed-precision policies (QUANTIZATION O-task substrate).

A *policy* maps layer-name patterns to precision levels, and the model's
``linear`` primitive (models/common.py) dispatches on the matched level.
The port executes the BF16 and FP32 levels; FP8 and INT8 are named here
so that policies written for the JAX package load unchanged, and
``linear`` rejects them until their kernels are ported.

Levels (most → least precise): fp32 > bf16 > fp8 > int8.
"""

from __future__ import annotations

import fnmatch

FP32 = "fp32"
BF16 = "bf16"
FP8 = "fp8"      # float8_e4m3
INT8 = "int8"

# Lattice ordered most → least precise (greedy_lattice_descent walks down it).
LEVELS = (FP32, BF16, FP8, INT8)


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
