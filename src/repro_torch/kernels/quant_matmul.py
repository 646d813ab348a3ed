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

Any K: the int32 sum wraps modulo 2**32 as the JAX package's int32
``dot_general`` does (two's complement, no saturation).  ``|acc| <=
127 * 127 * K`` can pass 2**31 only for K >= 133,143 (the TUNE problem
of Qwen2-7B's embedding has K = 152,064).

Two variants, picked by ``gemm_tc.qmm_variant`` from K alone: K % 16 == 0
(every Qwen2-7B shape) takes the tensor-core kernel (``"tc"``: TMA and
wgmma s8 on the shared main loop of ``csrc/gemm_tc.cuh``, the operands
swapped at M <= 64, split K by ``gemm_tc.qmm_plan`` where the tiles alone
leave the card short of two waves, the int32 partials combined in split
order); any other K takes the mma.sync kernel (``"mma"``).  Both are bit
for bit :func:`int8_matmul_plain`.  ``launches`` counts every launch,
``launches_tc`` those of the tensor-core variant, and ``last_launch``
holds the variant, tiles and splits of the last one.

A CPU tensor goes to the plain version (:func:`int8_matmul_plain` after
the same quantization, :func:`quant_matmul_plain`'s bits); a CUDA tensor
goes to the kernel or raises.  The product on quantized operands is the
op ``torch.ops.repro_torch.int8_matmul``, so that a selective activation
checkpoint (``models/transformer.py::_remat``, ``"dots"``) sees it, keeps
its output and does not launch it again in the backward.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gemm_tc
from repro_torch.quant.policy import quantize_int8

# shared memory of one CTA of the mma.sync kernel: two 64 x 64 int8 slabs,
# rows padded to 80 bytes (static in csrc/quant_matmul.cu)
MMA_SMEM_BYTES = 2 * 64 * 80
MMA_TILES = (64, 64)

# kernel launches since the counts were last set to 0: all, and those of
# the tensor-core variant
launches = 0
launches_tc = 0
last_launch: dict = {}


def smem_bytes(m: int, n: int, k: int) -> int:
    """Dynamic shared memory of one CTA of the variant an (M, K) x (K, N)
    product takes (the launch takes no tile config)."""
    if gemm_tc.qmm_variant(k) == "tc":
        return gemm_tc.qmm_plan(m, n, k)["smem_bytes"]
    return MMA_SMEM_BYTES


def quantize_operands(x: torch.Tensor, w: torch.Tensor):
    """x (M, K), w (K, N) -> (xq (M, K) int8, xs (M, 1) fp32,
    wq (N, K) int8 — k contiguous, the kernel's layout — ws (1, N))."""
    xq, xs = quantize_int8(x, axis=1)
    wq, ws = quantize_int8(w, axis=0)
    return xq, xs, wq.t().contiguous(), ws


def wrap_int32(acc: torch.Tensor) -> torch.Tensor:
    """An exact integer sum held in float64, wrapped to int32's range as
    two's-complement int32 addition wraps it (values stay float64)."""
    return torch.remainder(acc + 2.0 ** 31, 2.0 ** 32) - 2.0 ** 31


def int8_matmul_plain(xq, xs, wq, ws) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch on any device: the int8
    products summed in float64, which holds every partial sum exactly for
    any K up to 5.5e11 (127 * 127 * K < 2**53), then wrapped to int32 as
    the kernel's int32 sum wraps; then the same rounding to fp32 and the
    same two products."""
    acc = wrap_int32(torch.matmul(xq.double(), wq.double().t()))
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
        tc = lib.quant_matmul_tc_launch
        tc.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        tc.restype = ctypes.c_int
        plan = lib.quant_matmul_tc_plan
        plan.argtypes = [ctypes.c_int] * 3 \
            + [ctypes.POINTER(ctypes.c_longlong)]
        plan.restype = None
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


@torch.library.custom_op("repro_torch::int8_matmul", mutates_args=())
def int8_matmul(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                ws: torch.Tensor) -> torch.Tensor:
    """The product on quantized operands (the layout of
    :func:`quantize_operands`): the kernel on CUDA tensors, the plain
    version on CPU ones; (M, N) fp32."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, xs, wq, ws)
    return _launch(xq, xs, wq, ws)


def _launch(xq, xs, wq, ws, splits: int | None = None) -> torch.Tensor:
    """The launch behind :func:`int8_matmul`.  ``splits`` (tc only) forces
    a split count other than the plan's: the bits must not change, and a
    check may show it; the wrapper never passes one."""
    global launches, launches_tc, last_launch
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
    var = gemm_tc.qmm_variant(k)
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    ptrs = (_build.ptr(xq), _build.ptr(xs), _build.ptr(wq), _build.ptr(ws),
            _build.ptr(out))
    stream = _build.current_stream(xq.device)
    if var == "tc":
        plan = gemm_tc.qmm_plan(m, n, k)
        s = plan["splits"] if splits is None else splits
        shape = gemm_tc.qmm_workspace_shape(m, n, s)
        part = None if shape is None else torch.empty(
            shape, dtype=torch.int32, device=xq.device)
        err = _lib().quant_matmul_tc_launch(
            *ptrs, None if part is None else _build.ptr(part), m, n, k, s,
            stream)
        launch = {"variant": "tc", "tiles": (plan["block_a"],
                                             plan["block_b"]),
                  "swap": plan["swap"], "splits": s}
    else:
        if splits is not None:
            raise ValueError("quant_matmul: only the tc variant splits K")
        err = _lib().quant_matmul_launch(*ptrs, m, n, k, stream)
        launch = {"variant": "mma", "tiles": MMA_TILES, "swap": False,
                  "splits": 1}
    if err != 0:
        raise RuntimeError(f"quant_matmul ({var}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_tc += var == "tc"
    last_launch = launch
    return out


def quant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float; w: (K, N) float.  Returns (M, N) fp32 ≈ x @ w
    computed through int8 with int32 accumulation."""
    if x.device.type != "cpu":
        _check(x, w)
    return int8_matmul(*quantize_operands(x, w))
