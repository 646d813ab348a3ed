"""Batched ragged prefill attention over a paged KV cache: the CUDA
kernel's wrapper, its plain PyTorch version and its launch count.

Each admission's suffix queries ``q[r, :lens[r]]`` (absolute positions
``offsets[r] + i``) attend causally over the request's pages — shared
prefix plus the suffix the layer has just written — through its block
table.  Rows at or past ``lens[r]`` are 0.  The kernel
(``csrc/flash_prefill_ragged.cu``) replaces the Pallas TPU kernel of the
JAX package's ``kernels/flash_prefill_ragged.py``.

A CPU tensor goes to :func:`flash_prefill_ragged_plain`; a CUDA tensor
goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.models import layers as L

BQ = 32
SMEM_LIMIT = 227 * 1024      # dynamic shared memory a CTA may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0
launches = 0


def _align4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(block_q: int, g: int, d: int, page_size: int) -> int:
    """Dynamic shared memory the kernel's launch requests for a q tile of
    ``block_q`` positions (``Layout`` in ``csrc/flash_prefill_ragged.cu``,
    whose ``flash_prefill_ragged_smem_bytes`` exports the same number):
    the block_q * g rows' acc, scores and state, and one page's K
    (transposed, slots padded to 16) and V, in floats."""
    rows, ps_pad = block_q * g, -(-page_size // 16) * 16
    floats = (_align4(rows * d) + _align4(d * ps_pad) + _align4(page_size * d)
              + _align4(rows * page_size) + 3 * _align4(rows))
    return 4 * floats


def flash_prefill_ragged_plain(q, k_pages, v_pages, block_tables, offsets,
                               lens):
    """Gather each request's pages into contiguous K/V, run the layer's
    chunked memory-efficient attention at the per-request query positions
    and zero the rows at or past ``lens``."""
    r, s, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    n = block_tables.shape[1] * ps
    idx = block_tables.long()
    kf = k_pages[idx].reshape(r, n, kvh, d)
    vf = v_pages[idx].reshape(r, n, kvh, d)
    pos = L.ragged_prefill_positions(offsets, s)
    out = L.mea_attention(q, L._expand_kv(kf, h), L._expand_kv(vf, h), pos,
                          torch.arange(n, device=q.device), causal=True)
    valid = torch.arange(s, device=q.device)[None] < lens[:, None]
    return torch.where(valid[:, :, None, None], out, 0).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_prefill_ragged")
    fn = lib.flash_prefill_ragged_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        sm = lib.flash_prefill_ragged_smem_bytes
        sm.argtypes = [ctypes.c_int] * 4
        sm.restype = ctypes.c_longlong
    return lib


def _check(q, k_pages, v_pages, block_tables, offsets, lens) -> None:
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "offsets": offsets,
               "lens": lens}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.ndim != 4:
        raise ValueError(f"q must be (R, S, H, D), got {tuple(q.shape)}")
    r, _, h, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages must be one (P, ps, KV, D) shape, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    _, _, kvh, dk = k_pages.shape
    if dk != d or h % kvh or d % 4:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)} (D must be a multiple of 4)")
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"unsupported dtypes q={q.dtype} "
                         f"pages={k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 \
            or block_tables.shape[0] != r or block_tables.shape[1] < 1:
        raise ValueError("block_tables must be int32 (R, M), got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    for name, t in (("offsets", offsets), ("lens", lens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (r,):
            raise ValueError(f"{name} must be int32 (R,), got {t.dtype} "
                             f"{tuple(t.shape)}")


def flash_prefill_ragged(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         offsets: torch.Tensor, lens: torch.Tensor, *,
                         block_q: int = BQ) -> torch.Tensor:
    """q: (R,S,H,D) suffix queries; k/v_pages: (P, page_size, KV, D) with
    H % KV == 0; block_tables: (R, M) int32 (entries past a request's
    pages parked on the serving layer's scratch page); offsets/lens: (R,)
    int32 — absolute position of q[:, 0] (the shared prefix length) and
    valid suffix tokens per request (0 = idle slot).  Suffix K/V must
    already be in the pages.  Returns (R,S,H,D) in q's dtype; rows at or
    past ``lens`` are zero.  ``block_q`` is the query tile of one CTA,
    halved while its shared memory would not fit."""
    global launches
    if q.device.type == "cpu":
        return flash_prefill_ragged_plain(q, k_pages, v_pages, block_tables,
                                          offsets, lens)
    _check(q, k_pages, v_pages, block_tables, offsets, lens)
    r, s, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    lib = _lib()
    bq = max(1, min(block_q, s))
    while bq > 1 and smem_bytes(bq, h // kvh, d, ps) > SMEM_LIMIT:
        bq //= 2
    if smem_bytes(bq, h // kvh, d, ps) > SMEM_LIMIT:
        raise ValueError(f"flash_prefill_ragged: one query row of g="
                         f"{h // kvh}, D={d}, page_size={ps} does not fit "
                         f"in shared memory")
    out = torch.empty_like(q)
    err = lib.flash_prefill_ragged_launch(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(block_tables), _build.ptr(offsets), _build.ptr(lens),
        _build.ptr(out), r, s, h, kvh, d, ps, block_tables.shape[1], bq,
        _DTYPES[q.dtype], _DTYPES[k_pages.dtype], 1.0 / math.sqrt(d),
        _build.current_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_prefill_ragged launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
