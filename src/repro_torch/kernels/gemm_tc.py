"""The Python side of the tensor-core GEMM main loop (``csrc/gemm_tc.cuh``)
shared by the s8 variant of ``quant_matmul`` and the bf16 variant of
``block_sparse_matmul``: which inputs take it, the plan of a launch
(tiles, stages, split-K) and the shared memory it requests.

The plan is a pure function of the shapes (never of the card, the data or
the launch history), written once here and mirrored by the kernel
libraries (``quant_matmul_tc_plan``, ``block_sparse_matmul_smem_bytes``),
which ``chip_smoke.py`` holds equal.
"""

from __future__ import annotations

import torch

SMEM_LIMIT = 232_448        # opt-in dynamic shared memory of a CTA (H100)
SMEM_EXTRA = 256 + 1024     # barriers, and slack to align the base to 1 KB
MAX_STAGES = 4
BLOCK_K = 128               # k elements of a stage (one k-block)

# quant_matmul's plan
SMS = 132                   # H100 SXM: the plan's fixed card
WAVES = 2                   # CTAs wanted: two waves of the SMs ...
SWAP_WAVES = 1              # ... or one where the operands swap (decode)
MIN_SPLIT_KB = 4            # k-blocks a split takes at least
SWAP_MAX_M = 64             # M up to this swaps the operands (decode)
TILE_A = 128                # rows of A a CTA: two m64 consumer warpgroups
TILE_B = 256                # rows of B (N) a CTA, unswapped
SWAP_N = (8, 16, 32, 64)    # wgmma N of the swapped B side (M rounded up)

# block_sparse_matmul's tiles: rows of x a CTA (block_m maps to the nearest)
BSMM_TILES = (64, 128, 256)


def _dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, dt)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def qmm_variant(k: int) -> str:
    """``"tc"`` (TMA + wgmma) where K is a multiple of 16 (a TMA row pitch
    of int8), ``"mma"`` (the mma.sync kernel) otherwise."""
    return "tc" if k % 16 == 0 else "mma"


def bsmm_variant(dtype) -> str:
    """``"tc"`` for bf16, ``"ffma"`` (the fp32 CUDA-core kernel) for
    fp32."""
    return "tc" if _dtype(dtype) == torch.bfloat16 else "ffma"


def stages(stage_bytes: int) -> int:
    """Stages of the ring: as many as fit, at most 4."""
    return min(MAX_STAGES, (SMEM_LIMIT - SMEM_EXTRA) // stage_bytes)


def smem_bytes(stage_bytes: int) -> int:
    """Dynamic shared memory a launch requests: the ring, the barriers and
    the alignment slack."""
    return stages(stage_bytes) * stage_bytes + SMEM_EXTRA


def qmm_plan(m: int, n: int, k: int) -> dict:
    """The tc plan of an (M, K) x (K, N) int8 product.

    - ``swap``: M <= 64, C^T = wq . xq^T (the weight on wgmma's 64-row A
      side, M rounded up to 8, 16, 32 or 64 on its N side);
    - ``block_a`` rows of A (128) and ``block_b`` rows of B a CTA (256
      rows of N without the swap);
    - ``splits`` ranges of ``k_per_split`` k-blocks of 128: as many as
      bring the grid to :data:`WAVES` waves of :data:`SMS` CTAs, or
      :data:`SWAP_WAVES` when swapped (a swapped CTA streams its weight
      rows with 4 stages in flight, more than an SM's share of the memory
      bandwidth needs: more CTAs only add the combine), each at least
      :data:`MIN_SPLIT_KB` k-blocks, none empty;
    - ``stages`` and ``smem_bytes`` of the ring.
    """
    swap = m <= SWAP_MAX_M
    a_rows, b_rows = (n, m) if swap else (m, n)
    block_b = next(t for t in SWAP_N if m <= t) if swap else TILE_B
    tiles = _cdiv(a_rows, TILE_A) * _cdiv(b_rows, block_b)
    kb = _cdiv(k, BLOCK_K)
    want = min(_cdiv(SMS * (SWAP_WAVES if swap else WAVES), tiles),
               max(1, kb // MIN_SPLIT_KB))
    per = _cdiv(kb, want)
    stage = (TILE_A + block_b) * BLOCK_K
    return {"swap": swap, "block_a": TILE_A, "block_b": block_b,
            "splits": _cdiv(kb, per), "k_per_split": per,
            "stages": stages(stage), "smem_bytes": smem_bytes(stage)}


def split_ranges(k: int, splits: int) -> list[tuple[int, int]]:
    """The k ranges [k0, k1) of ``splits`` splits over K, in split order:
    ceil(k-blocks / splits) k-blocks each, the last cut at K (a forced
    count may leave trailing splits empty; the plan's never does)."""
    kb = _cdiv(k, BLOCK_K)
    per = _cdiv(kb, splits)
    return [(min(k, s * per * BLOCK_K), min(k, (s + 1) * per * BLOCK_K))
            for s in range(splits)]


def qmm_workspace_shape(m: int, n: int, splits: int):
    """The int32 partials of a split launch, (splits, M, N); None without
    a split."""
    return (splits, m, n) if splits > 1 else None


def bsmm_tile(block_m: int) -> int:
    """The tc tile (64, 128 or 256 rows) nearest to ``block_m``."""
    return 64 if block_m < 96 else 128 if block_m < 192 else 256


def bsmm_smem_bytes(block_m: int) -> int:
    """Dynamic shared memory of the bf16 kernel's CTA for ``block_m``: the
    ring of x tiles (tile rows x 128, bf16) and w blocks (128 x 128)."""
    return smem_bytes(2 * (bsmm_tile(block_m) + BLOCK_K) * BLOCK_K)
