"""The Python side of the tensor-core attention main loop
(``csrc/attention_tc.cuh``) shared by the bf16 variants of
``flash_attention`` and ``flash_prefill_ragged``: which inputs take it, the
tiles it takes, and the shared memory a launch requests (the number both
kernel libraries export, and the autotuner filters on).
"""

from __future__ import annotations

import torch

TILES = (64, 128)           # query rows (block_q) and keys (block_kv) a tile
HEAD_DIMS = (64, 128)
SMEM_LIMIT = 232_448        # opt-in dynamic shared memory of a CTA (H100)
SMEM_EXTRA = 256 + 1024     # barriers, and slack to align the base to 1 KB
MAX_STAGES = 4


def _dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, dt)


def variant(q_dtype, kv_dtype, d: int) -> str:
    """``"tc"`` for bf16 q and K/V at D = 64 or 128 (the tensor-core
    kernels), ``"ffma"`` (the fp32 CUDA-core kernels) otherwise; dtypes as
    torch dtypes or names."""
    return "tc" if _dtype(q_dtype) == _dtype(kv_dtype) == torch.bfloat16 \
        and d in HEAD_DIMS else "ffma"


def tile(requested: int, n: int) -> int:
    """The tile (64 or 128) nearest to ``requested``, and 64 where that
    covers the ``n`` rows."""
    return 64 if requested < 96 or n <= 64 else 128


def stages(block_q: int, block_kv: int, d: int) -> int:
    """Stages of the K/V ring: as many as fit beside the Q tile, at most
    4 (``stages`` in the header)."""
    return min(MAX_STAGES, (SMEM_LIMIT - SMEM_EXTRA - 2 * block_q * d)
               // (4 * block_kv * d))


def smem_bytes(block_q: int, block_kv: int, d: int) -> int:
    """Dynamic shared memory of one CTA: the bf16 Q tile, the stages of a
    K and a V tile, the barriers and the alignment slack."""
    return 2 * d * (block_q + 2 * stages(block_q, block_kv, d) * block_kv) \
        + SMEM_EXTRA
