"""Batched ragged prefill attention over a paged KV cache: the CUDA
kernel's wrapper, its plain PyTorch version and its launch count.

Each admission's suffix queries ``q[r, :lens[r]]`` (absolute positions
``offsets[r] + i``) attend causally over the request's pages — shared
prefix plus the suffix the layer has just written — through its block
table.  Rows at or past ``lens[r]`` are 0.  The kernel
(``csrc/flash_prefill_ragged.cu``) replaces the Pallas TPU kernel of the
JAX package's ``kernels/flash_prefill_ragged.py``.

Two variants, picked by ``attention_tc.variant`` from the dtypes and D:
bf16 q and pages at D = 64 or 128 take the tensor-core kernel (``"tc"``: wgmma
products, pages gathered with cp.async, P rounded to bf16, one CTA per
query head and 64 or 128 suffix positions; the main loop it shares with
``flash_attention``'s); fp32, mixed fp32/bf16 and
other head dims take the fp32 CUDA-core kernel (``"ffma"``).
``launches`` counts every launch, ``launches_tc`` those of the
tensor-core variant, and ``last_launch`` holds the variant and
``block_q`` the last launch ran.

A CPU tensor goes to :func:`flash_prefill_ragged_plain`; a CUDA tensor
goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention_tc as tc
from repro_torch.models import layers as L

BQ = 32                      # block_q of the "ffma" variant
TC_BQ = 128                  # default block_q of the "tc" variant
TC_BLOCK_KV = 64             # keys per kv tile of the "tc" variant
SMEM_LIMIT = 227 * 1024      # dynamic shared memory a CTA may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the counts were last set to 0: all, and those of
# the tensor-core variant
launches = 0
launches_tc = 0
last_launch: dict = {}


def effective_block_q(block_q: int | None, s: int, variant: str, g: int,
                      d: int, page_size: int) -> int:
    """The q tile a launch runs with.  ``"tc"``: 64 or 128, the one
    nearer the request (32 maps to 64), 64 where that covers the ``s``
    suffix positions; default :data:`TC_BQ`.  ``"ffma"``: the request
    (default :data:`BQ`) clamped to ``s`` and halved while its shared
    memory would not fit."""
    if variant == "tc":
        return tc.tile(TC_BQ if block_q is None else block_q, s)
    bq = max(1, min(BQ if block_q is None else block_q, s))
    while bq > 1 and smem_bytes(bq, g, d, page_size) > SMEM_LIMIT:
        bq //= 2
    return bq


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


def smem_bytes_tc(block_q: int, d: int) -> int:
    """Dynamic shared memory of a ``"tc"`` launch
    (``flash_prefill_ragged_tc_smem_bytes``): the plan of the shared
    tensor-core main loop with 64-key tiles."""
    return tc.smem_bytes(block_q, TC_BLOCK_KV, d)


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
        tc = lib.flash_prefill_ragged_tc_launch
        tc.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        tc.restype = ctypes.c_int
        sm = lib.flash_prefill_ragged_tc_smem_bytes
        sm.argtypes = [ctypes.c_int] * 2
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
    if tc.variant(q.dtype, k_pages.dtype, d) == "tc" and any(
            t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("flash_prefill_ragged: the bf16 kernel's 16-byte "
                         "copies need 16-byte aligned q and pages")


def flash_prefill_ragged(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         offsets: torch.Tensor, lens: torch.Tensor, *,
                         block_q: int | None = None) -> torch.Tensor:
    """q: (R,S,H,D) suffix queries; k/v_pages: (P, page_size, KV, D) with
    H % KV == 0; block_tables: (R, M) int32 (entries past a request's
    pages parked on the serving layer's scratch page); offsets/lens: (R,)
    int32 — absolute position of q[:, 0] (the shared prefix length) and
    valid suffix tokens per request (0 = idle slot).  Suffix K/V must
    already be in the pages.  Returns (R,S,H,D) in q's dtype; rows at or
    past ``lens`` are zero.  ``block_q`` is the query tile of one CTA
    (:func:`effective_block_q` gives the one that runs)."""
    global launches, launches_tc, last_launch
    if q.device.type == "cpu":
        return flash_prefill_ragged_plain(q, k_pages, v_pages, block_tables,
                                          offsets, lens)
    _check(q, k_pages, v_pages, block_tables, offsets, lens)
    r, s, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    lib = _lib()
    var = tc.variant(q.dtype, k_pages.dtype, d)
    bq = effective_block_q(block_q, s, var, h // kvh, d, ps)
    if var == "ffma" and smem_bytes(bq, h // kvh, d, ps) > SMEM_LIMIT:
        raise ValueError(f"flash_prefill_ragged: one query row of g="
                         f"{h // kvh}, D={d}, page_size={ps} does not fit "
                         f"in shared memory")
    out = torch.empty_like(q)
    ptrs = (_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(block_tables), _build.ptr(offsets), _build.ptr(lens),
            _build.ptr(out))
    dims = (r, s, h, kvh, d, ps, block_tables.shape[1], bq)
    stream = _build.current_stream(q.device)
    if var == "tc":
        err = lib.flash_prefill_ragged_tc_launch(*ptrs, *dims,
                                                 1.0 / math.sqrt(d), stream)
    else:
        err = lib.flash_prefill_ragged_launch(
            *ptrs, *dims, _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill_ragged ({var}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_tc += var == "tc"
    last_launch = {"variant": var, "block_q": bq}
    return out
