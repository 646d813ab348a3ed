"""Paged flash-decoding attention: the CUDA kernel's wrapper, its plain
PyTorch version and its launch count.

One generated token per request attends over that request's K/V held in
a shared page pool ``(P, page_size, KV, D)`` through a block table
``(R, M)``, under a precomputed ``(R, M * page_size)`` validity mask built
by ``models/layers.py::paged_kv_positions`` /
``paged_decode_attention_mask``.  The kernel (``csrc/flash_decode_paged.cu``)
replaces the Pallas TPU kernel of the JAX package's
``kernels/flash_decode_paged.py``.

Two variants, picked by ``decode_tc.variant`` from the dtypes and D: bf16
q and pages at D = 64 or 128 take the split-KV tensor-core kernel
(``"tc"``: fixed chunks of whole pages, one CTA per chunk, kv head and
request writing partials to a workspace, a second kernel combining them
in chunk order; the main loop it shares with ``flash_decode``'s); fp32,
mixed fp32/bf16 and other head dims take the fp32 CUDA-core kernel
(``"ffma"``).  ``launches`` counts every call, ``launches_tc`` those of
the tensor-core variant, and ``last_launch`` holds the variant, the
chunk and the number of chunks the last call ran.

A CPU tensor goes to :func:`flash_decode_paged_plain`; a CUDA tensor goes
to the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_tc as dtc
from repro_torch.models import layers as L

SMEM_LIMIT = 227 * 1024      # dynamic shared memory a CTA may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel calls since the counts were last set to 0: all, and those of the
# tensor-core variant
launches = 0
launches_tc = 0
last_launch: dict = {}


def _align4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(g: int, d: int, page_size: int) -> int:
    """Dynamic shared memory the kernel's launch requests (``Layout`` in
    ``csrc/flash_decode_paged.cu``, whose ``flash_decode_paged_smem_bytes``
    exports the same number): a tile of whole pages covering 64 slots (one
    page when pages are larger), its K, V and scores, q, acc, row state
    and per-slot liveness and offsets, in floats."""
    nt = (1 if page_size >= 64 else 64 // page_size) * page_size
    floats = (2 * _align4(g * d) + _align4(nt * (d + 1)) + _align4(nt * d)
              + _align4(g * nt) + 3 * _align4(g) + _align4(nt) + 2 * nt)
    return 4 * floats


def smem_bytes_tc(d: int, page_size: int) -> int:
    """Dynamic shared memory of a ``"tc"`` partial CTA
    (``flash_decode_paged_tc_smem_bytes``) for the page size's chunk."""
    return dtc.smem_bytes(d, dtc.paged_chunk(page_size))


def flash_decode_paged_plain(q, k_pages, v_pages, block_tables, mask):
    """Gather each request's pages through the block table into contiguous
    K/V and run the masked one-token attention of the model layer."""
    r, _, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    n = block_tables.shape[1] * ps
    idx = block_tables.long()
    kf = k_pages[idx].reshape(r, n, kvh, d)
    vf = v_pages[idx].reshape(r, n, kvh, d)
    return L._masked_decode_attention(q, kf, vf, mask.bool(), h)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode_paged")
    fn = lib.flash_decode_paged_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        sm = lib.flash_decode_paged_smem_bytes
        sm.argtypes = [ctypes.c_int] * 3
        sm.restype = ctypes.c_longlong
        tc = lib.flash_decode_paged_tc_launch
        tc.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        tc.restype = ctypes.c_int
        sm = lib.flash_decode_paged_tc_smem_bytes
        sm.argtypes = [ctypes.c_int] * 2
        sm.restype = ctypes.c_longlong
    return lib


def _check(q, k_pages, v_pages, block_tables, mask) -> None:
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "mask": mask}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (R, 1, H, D), got {tuple(q.shape)}")
    r, _, h, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages must be one (P, ps, KV, D) shape, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    _, ps, kvh, dk = k_pages.shape
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
    if mask.dtype not in (torch.bool, torch.uint8) \
            or tuple(mask.shape) != (r, block_tables.shape[1] * ps):
        raise ValueError(f"mask must be bool/uint8 (R, M*ps), got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if dtc.variant(q.dtype, k_pages.dtype, d) == "tc" and any(
            t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("flash_decode_paged: the bf16 kernel's 16-byte "
                         "copies need 16-byte aligned q and pages")


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """q: (R,1,H,D); k/v_pages: (P, page_size, KV, D) with H % KV == 0;
    block_tables: (R, M) int32 physical page per logical block (entries
    past a request's pages must still be valid page indices — the serving
    layer parks them on its scratch page); mask: (R, M * page_size) bool
    — True where the logical slot participates.  Returns (R,1,H,D) in q's
    dtype (fp32 inside)."""
    global launches, launches_tc, last_launch
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pages, v_pages, block_tables,
                                        mask)
    _check(q, k_pages, v_pages, block_tables, mask)
    r, _, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    m = block_tables.shape[1]
    lib = _lib()
    var = dtc.variant(q.dtype, k_pages.dtype, d)
    if var == "ffma" and smem_bytes(h // kvh, d, ps) > SMEM_LIMIT:
        raise ValueError(f"flash_decode_paged: g={h // kvh}, D={d}, "
                         f"page_size={ps} does not fit in shared memory")
    mask_u8 = mask.view(torch.uint8) if mask.dtype == torch.bool else mask
    out = torch.empty_like(q)
    ptrs = (_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(block_tables), _build.ptr(mask_u8), _build.ptr(out))
    stream = _build.current_stream(q.device)
    if var == "tc":
        chunk = dtc.paged_chunk(ps)
        n = dtc.n_chunks(m * ps, chunk)
        ws = torch.empty(dtc.workspace_floats(r, kvh, n, h // kvh, d),
                         dtype=torch.float32, device=q.device)
        err = lib.flash_decode_paged_tc_launch(
            *ptrs, _build.ptr(ws), r, h, kvh, d, ps, m, chunk, n,
            1.0 / math.sqrt(d), stream)
        launch = {"variant": var, "chunk": chunk, "n_chunks": n}
    else:
        err = lib.flash_decode_paged_launch(
            *ptrs, r, h, kvh, d, ps, m, _DTYPES[q.dtype],
            _DTYPES[k_pages.dtype], 1.0 / math.sqrt(d), stream)
        launch = {"variant": var}
    if err != 0:
        raise RuntimeError(f"flash_decode_paged ({var}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_tc += var == "tc"
    last_launch = launch
    return out
