"""Contiguous-cache flash-decoding attention: the CUDA kernel's wrapper,
its plain PyTorch version and its launch count.

One generated token per sequence attends over the contiguous decode cache
``(B, L, KV, D)`` under a batch-shared ``(L,)`` validity mask built by
``models/layers.py::kv_positions_for_cache`` / ``decode_attention_mask``
(linear cache or sliding-window ring).  The kernel
(``csrc/flash_decode.cu``) replaces the Pallas TPU kernel of the JAX
package's ``kernels/flash_decode.py``; it picks its own tiling (no
``block_kv`` argument) and handles any cache length without a pad copy.

Two variants, picked by ``decode_tc.variant`` from the dtypes and D: bf16
q and cache at D = 64, 80 or 128 take the split-KV tensor-core kernel
(``"tc"``: fixed chunks of ``decode_tc.CHUNK`` slots, one CTA per chunk,
kv head and sequence writing partials to a workspace, a second kernel
combining them in chunk order; the main loop it shares with
``flash_decode_paged``'s); fp32, mixed fp32/bf16 and other head dims take
the fp32 CUDA-core kernel (``"ffma"``).  ``launches`` counts every call,
``launches_tc`` those of the tensor-core variant, and ``last_launch``
holds the variant, the chunk and the number of chunks the last call ran.

A CPU tensor goes to :func:`flash_decode_plain`; a CUDA tensor goes to the
kernel or raises.
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


def smem_bytes(g: int, d: int) -> int:
    """Dynamic shared memory the kernel's launch requests for g query
    heads per kv head at head_dim d (``Layout`` in ``csrc/flash_decode.cu``,
    whose ``flash_decode_smem_bytes`` exports the same number): the fixed
    64-slot tile's q, acc, K, V, scores and row state, in floats."""
    nt = 64
    floats = (2 * _align4(g * d) + _align4(nt * (d + 1)) + _align4(nt * d)
              + _align4(g * nt) + 3 * _align4(g) + nt)
    return 4 * floats


def flash_decode_plain(q, k, v, mask):
    """The masked one-token attention of the model layer."""
    return L._masked_decode_attention(q, k, v, mask.bool(), q.shape[2])


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        sm = lib.flash_decode_smem_bytes
        sm.argtypes = [ctypes.c_int] * 2
        sm.restype = ctypes.c_longlong
        tc = lib.flash_decode_tc_launch
        tc.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        tc.restype = ctypes.c_int
        sm = lib.flash_decode_tc_smem_bytes
        sm.argtypes = [ctypes.c_int] * 2
        sm.restype = ctypes.c_longlong
    return lib


def _check(q, k, v, mask) -> None:
    for name, t in {"q": q, "k": k, "v": v, "mask": mask}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"k/v must be one (B, L, KV, D) shape fitting q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if h % k.shape[2] or d % 4:
        raise ValueError(f"H = {h} must be a multiple of KV = {k.shape[2]} "
                         f"and D = {d} a multiple of 4")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"unsupported dtypes q={q.dtype} k/v={k.dtype}/"
                         f"{v.dtype}")
    if mask.dtype not in (torch.bool, torch.uint8) \
            or tuple(mask.shape) != (k.shape[1],):
        raise ValueError(f"mask must be bool/uint8 (L,), got {mask.dtype} "
                         f"{tuple(mask.shape)}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """q: (B,1,H,D); k/v: (B,L,KV,D) with H % KV == 0; mask: (L,) bool —
    True where the cache slot participates (shared across the batch: the
    decode position is a scalar).  Returns (B,1,H,D) in q's dtype (fp32
    inside)."""
    global launches, launches_tc, last_launch
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, mask)
    _check(q, k, v, mask)
    b, _, h, d = q.shape
    _, cache_len, kvh, _ = k.shape
    lib = _lib()
    var = dtc.variant(q.dtype, k.dtype, d)
    if var == "ffma" and smem_bytes(h // kvh, d) > SMEM_LIMIT:
        raise ValueError(f"flash_decode: g={h // kvh}, D={d} does not fit "
                         f"in shared memory")
    mask_u8 = mask.view(torch.uint8) if mask.dtype == torch.bool else mask
    out = torch.empty_like(q)
    ptrs = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask_u8),
            _build.ptr(out))
    stream = _build.current_stream(q.device)
    if var == "tc":
        n = dtc.n_chunks(cache_len, dtc.CHUNK)
        ws = torch.empty(dtc.workspace_floats(b, kvh, n, h // kvh, d),
                         dtype=torch.float32, device=q.device)
        err = lib.flash_decode_tc_launch(
            *ptrs, _build.ptr(ws), b, h, kvh, d, cache_len, dtc.CHUNK, n,
            1.0 / math.sqrt(d), stream)
        launch = {"variant": var, "chunk": dtc.CHUNK, "n_chunks": n}
    else:
        err = lib.flash_decode_launch(
            *ptrs, b, h, kvh, d, cache_len, _DTYPES[q.dtype],
            _DTYPES[k.dtype], 1.0 / math.sqrt(d), stream)
        launch = {"variant": var}
    if err != 0:
        raise RuntimeError(f"flash_decode ({var}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_tc += var == "tc"
    last_launch = launch
    return out
