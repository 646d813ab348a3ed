"""Dynamic-activation int8 x int8 matmul: the CUDA kernel's wrapper, its
plain PyTorch version and its launch count.

``x @ w`` through int8: the activation is quantized per row and the
weight per output column (absmax / 127, round half to even, clip ±127;
``quant/policy.py::quantize_int8``), the int8 products are summed exactly
in int32 and the sum is dequantized as ``(acc * xs) * ws`` in fp32.  The
quantization runs here as torch ops, outside the kernel, as the JAX
package runs it outside its ``pallas_call``; the weight is quantized on
every call.  The kernel (``csrc/quant_matmul.cu``) replaces the Pallas TPU
kernel of the JAX package's ``kernels/quant_matmul.py``.

No overflow: ``|acc| <= 127 * 127 * K`` stays below 2**31 for
K < 133,143 (the largest K on the serving path is Qwen2-7B's d_ff,
18,944); larger K raises.

A CPU tensor goes to :func:`quant_matmul_plain`; a CUDA tensor goes to
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.quant.policy import quantize_int8

K_LIMIT = 133_143            # 127 * 127 * K < 2**31

# kernel launches since the count was last set to 0
launches = 0


def quantize_operands(x: torch.Tensor, w: torch.Tensor):
    """x (M, K), w (K, N) -> (xq (M, K) int8, xs (M, 1) fp32,
    wq (N, K) int8 — k contiguous, the kernel's layout — ws (1, N))."""
    xq, xs = quantize_int8(x, axis=1)
    wq, ws = quantize_int8(w, axis=0)
    return xq, xs, wq.t().contiguous(), ws


def int8_matmul_plain(xq, xs, wq, ws) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch on any device: the int8
    products summed in float64, which holds every partial sum exactly
    (|acc| < 2**31 < 2**53), so the sum equals the int32 one; then the
    same rounding to fp32 and the same two products."""
    acc = torch.matmul(xq.double(), wq.double().t())
    return (acc.float() * xs) * ws


def quant_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) float @ w (K, N) float through int8; (M, N) fp32."""
    return int8_matmul_plain(*quantize_operands(x, w))


def _lib() -> ctypes.CDLL:
    lib = _build.load("quant_matmul")
    fn = lib.quant_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x and w must be on one CUDA device, got "
                         f"{x.device} / {w.device}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"/ {tuple(w.shape)}")
    m, k = x.shape
    if m < 1 or k < 1 or w.shape[1] < 1:
        raise ValueError(f"empty product {tuple(x.shape)} x {tuple(w.shape)}")
    if not (x.is_floating_point() and w.is_floating_point()):
        raise ValueError(f"x and w must be floating point, got {x.dtype} / "
                         f"{w.dtype}")


def int8_matmul(xq, xs, wq, ws) -> torch.Tensor:
    """Launch the kernel on quantized CUDA operands (the layout of
    :func:`quantize_operands`); (M, N) fp32."""
    global launches
    m, k = xq.shape
    n = wq.shape[0]
    for name, t, dt, shape in (("xq", xq, torch.int8, (m, k)),
                               ("xs", xs, torch.float32, (m, 1)),
                               ("wq", wq, torch.int8, (n, k)),
                               ("ws", ws, torch.float32, (1, n))):
        if t.device != xq.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all operands must "
                             f"be on one CUDA device")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k >= K_LIMIT:
        raise ValueError(f"K = {k} could overflow the int32 sum "
                         f"(needs K < {K_LIMIT})")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    err = _lib().quant_matmul_launch(
        _build.ptr(xq), _build.ptr(xs), _build.ptr(wq), _build.ptr(ws),
        _build.ptr(out), m, n, k, _build.current_stream(xq.device))
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: cudaError {err}")
    launches += 1
    return out


def quant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float; w: (K, N) float.  Returns (M, N) fp32 ≈ x @ w
    computed through int8 with int32 accumulation."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)
    _check(x, w)
    return int8_matmul(*quantize_operands(x, w))
