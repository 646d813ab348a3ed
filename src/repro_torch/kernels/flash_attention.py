"""Flash attention (causal / sliding-window / GQA) over contiguous q, k,
v: the CUDA kernel's wrapper, its plain PyTorch version and its launch
count.

The same function as the model layer's memory-efficient attention: q
(B, Sq, H, D), k and v (B, Skv, KV, D) with H % KV == 0; query and key
positions both count from 0; a key is masked where it lies past Skv,
under ``causal`` where it lies after the query, and under ``window``
where the query is ``window`` or more positions after it.  The kernel
(``csrc/flash_attention.cu``) replaces the Pallas TPU kernel of the JAX
package's ``kernels/flash_attention.py``.  A query row that sees no key
at all (possible only when Sq exceeds Skv) is left undefined, as it is
between the JAX kernel and its oracle.

Two variants, picked by ``attention_tc.variant`` from the dtypes and D:
bf16 q, k and v at D = 64 or 128 take the tensor-core kernel (``"tc"``:
wgmma products fed by TMA, P rounded to bf16, tiles of 64 or 128 rows);
every other input (fp32) takes the fp32 CUDA-core kernel (``"ffma"``).
``launches`` counts every launch, ``launches_tc`` those of the
tensor-core variant, and ``last_launch`` holds the variant and tiles the
last launch ran.

A CPU tensor goes to :func:`flash_attention_plain`; a CUDA tensor goes to
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention_tc as tc

NEG_INF = -1e30
BQ, BKV = 128, 128
Q_TILES = (32, 64, 128, 256)     # block_q values the kernel is built for
HEAD_DIMS = (64, 128)            # head_dim values the kernel is built for
SMEM_LIMIT = 232_448             # dynamic shared memory a CTA may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the counts were last set to 0: all, and those of
# the tensor-core variant
launches = 0
launches_tc = 0
last_launch: dict = {}


def effective_tiles(block_q: int | None, block_kv: int | None, sq: int,
                    skv: int, variant: str = "ffma") -> tuple[int, int]:
    """The tiles a launch runs with: as in the JAX package each is clamped
    to its sequence, here to the smallest tile the kernel takes that
    covers it (q tiles of 32 to 256 rows, kv tiles a multiple of 32).  The
    ``"tc"`` variant takes 64 or 128 for each: a request maps to the
    nearer (32 to 64, 256 to 128), and to 64 where that covers the
    sequence."""
    bq, bkv = block_q or BQ, block_kv or BKV
    if bq not in Q_TILES or bkv < 32 or bkv % 32:
        raise ValueError(f"flash_attention: block_q must be one of {Q_TILES} "
                         f"and block_kv a multiple of 32, got {bq} / {bkv}")
    if variant == "tc":
        return tc.tile(bq, sq), tc.tile(bkv, skv)
    cover_q = next(t for t in Q_TILES if t >= min(sq, Q_TILES[-1]))
    return min(bq, cover_q), min(bkv, -(-skv // 32) * 32)


def smem_bytes(block_q: int, block_kv: int, d: int, dtype) -> int:
    """Dynamic shared memory the kernel's launch requests for effective
    tiles (``flash_attention_smem_bytes`` in the .cu): the scaled fp32 q
    tile, the fp32 score tile and the K/V tile, rows padded."""
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)
    item, kv_row = (2, d + 2) if dt == torch.bfloat16 else (4, d + 1)
    return (4 * block_q * (d + 1) + 4 * block_q * (block_kv + 1)
            + item * block_kv * kv_row)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Softmax attention over the whole score matrix in fp32 (the JAX
    package's ``ref.flash_attention_ref``), each kv head shared by its
    H / KV query heads without a repeat; output in q's dtype."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        sm = lib.flash_attention_smem_bytes
        sm.argtypes = [ctypes.c_int] * 4
        sm.restype = ctypes.c_longlong
        tc = lib.flash_attention_tc_launch
        tc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        tc.restype = ctypes.c_int
        sm = lib.flash_attention_tc_smem_bytes
        sm.argtypes = [ctypes.c_int] * 3
        sm.restype = ctypes.c_longlong
    return lib


def _check(q, k, v, window) -> None:
    # the kernel loads single elements: any element-aligned base works
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; q, k and v must be "
                             f"on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim must be one of "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of float32 / bfloat16, got "
                         f"{q.dtype} / {k.dtype} / {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if tc.variant(q.dtype, k.dtype, d) == "tc" and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel's TMA loads need "
                         "16-byte aligned q, k and v")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int | None = None,
                    block_kv: int | None = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Skv,KV,D) with H % KV == 0.  Returns
    (B,Sq,H,D) in q's dtype.  ``block_q``/``block_kv`` override the
    default 128 x 128 tiling (autotuned through kernels/autotune.py)."""
    global launches, launches_tc, last_launch
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    var = tc.variant(q.dtype, k.dtype, d)
    bq, bkv = effective_tiles(block_q, block_kv, sq, skv, var)
    need = tc.smem_bytes(bq, bkv, d) if var == "tc" \
        else smem_bytes(bq, bkv, d, q.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"flash_attention: tiles ({bq}, {bkv}) at D={d} need "
                         f"{need} bytes of shared memory (> {SMEM_LIMIT})")
    out = torch.empty_like(q)
    ptrs = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out))
    dims = (b, sq, skv, h, kvh, d, bq, bkv, int(bool(causal)), int(window))
    stream = _build.current_stream(q.device)
    if var == "tc":
        err = _lib().flash_attention_tc_launch(*ptrs, *dims,
                                               1.0 / math.sqrt(d), stream)
    else:
        err = _lib().flash_attention_launch(*ptrs, *dims, _DTYPES[q.dtype],
                                            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({var}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_tc += var == "tc"
    last_launch = {"variant": var, "block_q": bq, "block_kv": bkv}
    return out
