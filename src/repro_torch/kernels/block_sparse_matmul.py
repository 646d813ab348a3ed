"""Block-sparse matmul over a static 128 x 128 block mask: the CUDA
kernel's wrapper, its plain PyTorch version, the host helper
:func:`compact_block_index` and the launch count.

Executes the PRUNING O-task's block masks: the mask is known before the
product runs, so each 128-column block of the output walks only a
compacted list of its live k-blocks (host-computed, -1 padded; the trip
count is ``max_live``, the densest column), and compute drops with block
sparsity.  The kernel (``csrc/block_sparse_matmul.cu``) replaces the Pallas
TPU kernel of the JAX package's ``kernels/block_sparse_matmul.py``.

Two variants, picked by ``gemm_tc.bsmm_variant`` from the dtype: bf16
takes the tensor-core kernel (``"tc"``: TMA and wgmma on the shared main
loop of ``csrc/gemm_tc.cuh``, tiles of 64, 128 or 256 rows, a
``block_m`` request mapped to the nearest); fp32 takes the CUDA-core FFMA
kernel (``"ffma"``).  ``launches`` counts every launch, ``launches_tc``
those of the tensor-core variant, and ``last_launch`` holds the variant
and the M tile of the last one.

A CPU tensor goes to :func:`block_sparse_matmul_plain`; a CUDA tensor goes
to the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gemm_tc

BLOCK = 128
SMEM_LIMIT = 232_448         # dynamic shared memory a CTA may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROW_F32 = BLOCK + 4         # padded fp32 x-tile rows, as the .cu

# kernel launches since the counts were last set to 0: all, and those of
# the tensor-core variant
launches = 0
launches_tc = 0
last_launch: dict = {}


def compact_block_index(block_map: np.ndarray) -> np.ndarray:
    """(kb, nb) 0/1 occupancy -> (nb, max_live) k-block indices, -1
    padded (numpy int32, as the JAX package's helper)."""
    kb, nb = block_map.shape
    cols = [np.nonzero(block_map[:, j])[0] for j in range(nb)]
    max_live = max([len(c) for c in cols] + [1])
    out = -np.ones((nb, max_live), np.int32)
    for j, c in enumerate(cols):
        out[j, :len(c)] = c
    return out


def tile_rows(block_m: int) -> int:
    """Rows of one CTA's tile in the fp32 kernel: block_m padded to 32,
    64, 128 or 256."""
    for rows in (32, 64, 128):
        if block_m <= rows:
            return rows
    return 256


def smem_bytes(block_m: int, dtype) -> int:
    """Dynamic shared memory the kernel's launch requests for an M tile
    of ``block_m`` rows (``block_sparse_matmul_smem_bytes`` in the .cu):
    bf16, the tc kernel's ring (``gemm_tc.bsmm_smem_bytes``); fp32, the x
    tile (rows padded) and one w block."""
    if gemm_tc.bsmm_variant(dtype) == "tc":
        return gemm_tc.bsmm_smem_bytes(block_m)
    return 4 * (tile_rows(block_m) * _ROW_F32 + BLOCK * BLOCK)


def block_sparse_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                              kindex: torch.Tensor, *,
                              block: int = BLOCK) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: step ``t`` adds, to each
    output column block ``j`` with ``kindex[j, t] >= 0``, the fp32 product
    of x's k-block and w's (k-block, j) block; blocks that kindex leaves
    out are never read.  Output in x's dtype."""
    m, k = x.shape
    n = w.shape[1]
    kb, nb = k // block, n // block
    xb = x.float().reshape(m, kb, block)
    wb = w.float().reshape(kb, block, nb, block)
    cols = torch.arange(nb, device=x.device)
    acc = torch.zeros((m, nb, block), dtype=torch.float32, device=x.device)
    kidx = kindex.to(device=x.device, dtype=torch.long)
    for t in range(kidx.shape[1]):
        idx = kidx[:, t]
        live = (idx >= 0) & (idx < kb)
        safe = torch.where(live, idx, 0)
        part = torch.einsum("mjk,jkn->mjn", xb[:, safe], wb[safe, :, cols])
        acc += torch.where(live[None, :, None], part, 0.0)
    return acc.reshape(m, n).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("block_sparse_matmul")
    if lib.block_sparse_matmul_launch.argtypes is None:
        for fn in (lib.block_sparse_matmul_launch,
                   lib.block_sparse_matmul_tc_launch):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        sm = lib.block_sparse_matmul_smem_bytes
        sm.argtypes = [ctypes.c_int] * 2
        sm.restype = ctypes.c_longlong
    return lib


def _check(x, w, kindex, block, bm) -> None:
    for name, t in (("x", x), ("w", w), ("kindex", kindex)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x, w and kindex must "
                             f"be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"/ {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must be one of float32 / bfloat16, got "
                         f"{x.dtype} / {w.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if block != BLOCK:
        raise ValueError(f"the kernel takes {BLOCK} x {BLOCK} blocks, got "
                         f"block={block}")
    if k % block or n % block or m % bm or not 1 <= bm <= 256:
        raise ValueError(f"need K, N divisible by {block} and M by block_m "
                         f"<= 256: M={m} K={k} N={n} block_m={bm}")
    if kindex.dtype != torch.int32 or kindex.ndim != 2 \
            or kindex.shape[0] != n // block or kindex.shape[1] < 1:
        raise ValueError(f"kindex must be int32 (N / {block}, max_live), got "
                         f"{kindex.dtype} {tuple(kindex.shape)}")


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                        kindex: torch.Tensor, *, block: int = BLOCK,
                        block_m: int | None = None) -> torch.Tensor:
    """x: (M, K); w: (K, N) (already masked); kindex: (N / block,
    max_live) int32 from :func:`compact_block_index`.  Returns x @ w over
    the live blocks, (M, N) in x's dtype.

    ``block`` is the mask granularity (fixed by the kindex layout; the
    kernel takes 128); ``block_m`` is the free M-tile dimension (autotuned
    through kernels/autotune.py), clamped to M as in the JAX package."""
    global launches, launches_tc, last_launch
    if x.device.type == "cpu":
        return block_sparse_matmul_plain(x, w, kindex, block=block)
    bm = min(block_m or block, x.shape[0])
    _check(x, w, kindex, block, bm)
    if smem_bytes(bm, x.dtype) > SMEM_LIMIT:
        raise ValueError(f"block_sparse_matmul: block_m={bm} needs "
                         f"{smem_bytes(bm, x.dtype)} bytes of shared memory")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    var = gemm_tc.bsmm_variant(x.dtype)
    launch = _lib().block_sparse_matmul_tc_launch if var == "tc" \
        else _lib().block_sparse_matmul_launch
    err = launch(_build.ptr(x), _build.ptr(w), _build.ptr(kindex),
                 _build.ptr(out), m, k, n, bm, kindex.shape[1],
                 _build.current_stream(x.device))
    if err != 0:
        raise RuntimeError(f"block_sparse_matmul ({var}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_tc += var == "tc"
    last_launch = {"variant": var, "block_m": gemm_tc.bsmm_tile(bm)
                   if var == "tc" else bm}
    return out
