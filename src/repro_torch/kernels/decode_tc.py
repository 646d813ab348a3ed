"""The Python side of the split-KV tensor-core decode main loop
(``csrc/decode_tc.cuh``) shared by the bf16 variants of
``flash_decode_paged`` and ``flash_decode``: which inputs take it, the
chunk plan, the shared memory a partial CTA requests (the number both
kernel libraries export) and the workspace of the chunks' partials.

The plan depends on the page size alone (never on the batch, the table
width, the card or the data), so a request's output bits do not change
when it moves between rows or pages (the header's invariance contract).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention_tc import _dtype

CHUNK = 128         # slots of a contiguous chunk; the most a paged one takes
SUB = 32            # slots of a sub-tile (one per lane of a warp)
WARPS = 4           # warps of a partial CTA
MAX_STAGES = 2      # sub-tiles a warp keeps in flight
HEAD_DIMS = (64, 80, 128)   # head dims the launch tables instantiate


def variant(q_dtype, kv_dtype, d: int) -> str:
    """``"tc"`` for bf16 q and K/V at D = 64, 80 or 128 (the split-KV
    tensor-core kernels), ``"ffma"`` (the fp32 CUDA-core kernels)
    otherwise; dtypes as torch dtypes or names.  The prefill pair's rule
    (``attention_tc.variant``) stays at D = 64 and 128.  Any g takes
    either: the tensor-core kernels cover g query heads in row groups of
    16."""
    return "tc" if _dtype(q_dtype) == _dtype(kv_dtype) == torch.bfloat16 \
        and d in HEAD_DIMS else "ffma"


def paged_chunk(page_size: int) -> int:
    """Slots of one chunk of the paged kernel: the most whole pages that
    fit in :data:`CHUNK` slots, and one page when a page is larger."""
    return max(1, CHUNK // page_size) * page_size


def n_chunks(n_slots: int, chunk: int) -> int:
    """Chunks over ``n_slots`` logical slots; the last may be ragged."""
    return -(-n_slots // chunk)


def stages(chunk: int) -> int:
    """Sub-tiles of K and V each warp keeps in flight: two when a warp
    walks more than one sub-tile of the chunk."""
    return MAX_STAGES if -(-chunk // SUB) > WARPS else 1


def smem_bytes(d: int, chunk: int) -> int:
    """Dynamic shared memory of a partial CTA: every warp's ring of bf16
    K and V sub-tiles, rows padded by 16 bytes."""
    return WARPS * stages(chunk) * 2 * SUB * (d + 8) * 2


def workspace_shapes(r: int, kv: int, n: int, g: int, d: int) -> dict:
    """The fp32 partials, one flat buffer in this order: acc, m, l."""
    return {"acc": (r, kv, n, g, d), "m": (r, kv, n, g), "l": (r, kv, n, g)}


def workspace_floats(r: int, kv: int, n: int, g: int, d: int) -> int:
    return sum(math.prod(s) for s in workspace_shapes(r, kv, n, g, d)
               .values())

