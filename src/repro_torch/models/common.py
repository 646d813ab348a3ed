"""Shared model-substrate utilities: apply context, device, inits, norms.

Conventions used across the model code:

- Weights are stored ``(in_features, out_features)`` as in the JAX
  package and applied as ``x @ w``; contraction is always on axis 0 of
  the weight.
- ``Ctx`` carries cross-cutting state through apply functions: the
  quantization policy (the QUANTIZATION O-task's output), whether the
  call is a cached (decode / paged) one, and the device mesh when the
  parameters are DTensors (``parallel/sharding.py``).
- Random init draws from an explicit ``torch.Generator``; the numbers
  differ from ``jax.random`` for the same seed, so cross-framework tests
  move JAX parameters over with :mod:`repro_torch.convert`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.parallel.sharding import is_dtensor
from repro_torch.quant.policy import (BF16, FP32, FP8, INT8, PrecisionPolicy,
                                     to_fp8_e4m3fn)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  A CUDA request on a machine without a card raises — the
    port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Apply-time context threaded through every layer."""
    policy: PrecisionPolicy | None = None
    decode: bool = False
    mesh: Any = None

    def level_for(self, name: str) -> str:
        if self.policy is None:
            return BF16
        return self.policy.level_for(name)


# ------------------------------------------------------------------ init
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ------------------------------------------------------------- linear op
def linear(ctx: Ctx, name: str, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """Policy-dispatched linear layer: ``x @ w + b``.

    The precision level for ``name`` decides the executed product — the
    cross-stage hook where the QUANTIZATION O-task's per-layer policy
    reaches the kernel:

    - FP32: an fp32 product;
    - BF16: bf16 operands with fp32 accumulation, rounded once to the
      activation dtype, as the JAX package's ``preferred_element_type``
      product: with bf16 activations a bf16 ``matmul``, with fp32
      activations the bf16-rounded operands multiplied in fp32;
    - FP8: the weight stored as float8_e4m3fn, then the BF16 product;
    - INT8: the quant_matmul kernel (dynamic per-row activation and
      per-column weight quantization, int32 accumulation), with a
      straight-through backward (:class:`Int8MatmulSTE`).
    """
    level = ctx.level_for(name)
    out_dtype = x.dtype
    if level == INT8:
        y = _int8_matmul(x, w)
    elif level == FP8:
        y = _bf16_matmul(x, to_fp8_e4m3fn(w).to(torch.bfloat16))
    elif level == FP32:
        y = row_invariant_matmul(x.float(), w.float())
    else:
        y = _bf16_matmul(x, w)
    y = y.to(out_dtype)
    if b is not None:
        y = y + b.to(out_dtype)
    return y


# cuBLAS picks a product's algorithm (tiles, split K) by its row count,
# so on the card a row's bits move with the number of rows multiplied
# beside it (the bf16 K/V and down projections of Qwen2-7B do).  Serving
# recovery rests on a request's greedy tokens being bit-identical
# whatever batch its prefill ran in — a restarted or failed-over request
# is prefilled again beside other requests — so on the card a product over
# more than one token a row runs in blocks of ROW_BLOCK rows, the last one
# padded: every such call has one row count.  Within a call a row's bits
# do not depend on its position.  Decode products (one token a row) keep
# the engine's fixed slot count and run as they are.
ROW_BLOCK = 256


def row_invariant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` (..., S, K) and ``w`` (K, N); on the card with
    S > 1 through :func:`blocked_matmul`.  A DTensor ``x`` (B, S, K), and
    a card's with S > 1, go through the op ``repro_torch::matmul``: its
    sharding rule lets DTensor place the product (batch rows, the
    weight's columns, or its rows with a partial sum) and its backward is
    written out, so that one product on a one-rank mesh has the bits of
    the same product on plain tensors."""
    if x.dim() == 3 and (is_dtensor(x) or (x.is_cuda and x.shape[1] > 1)):
        return torch.ops.repro_torch.matmul(x, w)
    return torch.matmul(x, w)


def _row_invariant_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.is_cuda and x.shape[-2] > 1:
        return blocked_matmul(x, w)
    return torch.matmul(x, w)


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def _matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, K) @ w (K, N) on plain (local) tensors: the card's fixed
    row blocks for S > 1, else one product."""
    return _row_invariant_local(x, w)


@_matmul_op.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[1]))


def _matmul_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _matmul_backward(ctx, g):
    """``gx = g @ w.T`` (the same op: row blocks on the card) and ``gw =
    x.T @ g`` over the flattened rows (one product)."""
    x, w = ctx.saved_tensors
    gx = gw = None
    if ctx.needs_input_grad[0]:
        gx = like(torch.ops.repro_torch.matmul(g, w.t()), x)
    if ctx.needs_input_grad[1]:
        gw = like(torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                               g.reshape(-1, g.shape[-1])), w)
    return gx, gw


def like(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A gradient in the placements of the DTensor ``t`` it belongs to
    (DTensor runs an op in the placements its rule picks, below autograd,
    so a backward's result may come out in others); plain tensors, and
    the gradient of a partial sum (no placement to return to), pass."""
    if (is_dtensor(g) and tuple(g.placements) != tuple(t.placements)
            and not any(p.is_partial() for p in t.placements)):
        return g.redistribute(t.device_mesh, t.placements)
    return g


_matmul_op.register_autograd(_matmul_backward, setup_context=_matmul_setup)


def _matmul_sharding(x, w):
    """DTensor strategies of ``repro_torch::matmul`` on one mesh dim:
    replicated; the batch rows sharded; the weight's columns sharded
    (the output's); the weight's rows and x's K sharded (a partial
    sum)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [([Replicate()], [Replicate(), Replicate()]),
            ([Shard(0)], [Shard(0), Replicate()]),
            ([Shard(2)], [Replicate(), Shard(1)]),
            ([Partial()], [Shard(2), Shard(0)])]


register_sharding(torch.ops.repro_torch.matmul.default)(_matmul_sharding)


def blocked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as products of :data:`ROW_BLOCK` rows of the flattened
    ``x`` each, the last block padded with zero rows."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    pad = -m % ROW_BLOCK
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, k))])
    y = torch.cat([torch.matmul(xb, w) for xb in x2.split(ROW_BLOCK)])
    return y[:m].reshape(*lead, w.shape[-1])


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return row_invariant_matmul(x, w.to(torch.bfloat16))
    return row_invariant_matmul(x.to(torch.bfloat16).float(),
                                w.to(torch.bfloat16).float())


class Int8MatmulSTE(torch.autograd.Function):
    """Dynamic-activation int8 x int8 product with a straight-through
    backward: the port of the JAX package's ``_int8_mm_ste`` custom_vjp.

    The forward is :func:`quant_matmul` on (M, K) x (K, N) — the CUDA
    kernel for CUDA tensors, ``quant_matmul_plain`` for CPU ones — fp32
    out.  The backward is ``_int8_mm_bwd``: the gradients of the
    full-precision product, ``gx = g @ w.T`` and ``gw = x.T @ g`` in fp32,
    cast to x's and w's dtypes, so int8 policies train (QAT semantics);
    through the rounding alone every gradient would be 0.  These two are
    plain products, outside any kernel, in the JAX package too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return quant_matmul(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gf = g.float()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = like(torch.matmul(gf, w.float().t()).to(x.dtype), x)
        if ctx.needs_input_grad[1]:
            gw = like(torch.matmul(x.float().t(), gf).to(w.dtype), w)
        return gx, gw


def _int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Flatten the leading axes to (M, K), run :class:`Int8MatmulSTE`
    (quant_matmul forward, fp32 out) and cast to the activation dtype, as
    the JAX package's kernel path does."""
    lead = x.shape[:-1]
    y2 = Int8MatmulSTE.apply(x.reshape(-1, x.shape[-1]), w)
    return y2.reshape(*lead, w.shape[-1]).to(x.dtype)


# ------------------------------------------------------------------ norms
def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def norm_apply(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


class Norm(torch.nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``) params."""

    def __init__(self, kind: str, d: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.scale = torch.nn.Parameter(
            torch.ones((d,), dtype=dtype, device=device),
            requires_grad=False)
        if kind != "rmsnorm":
            self.bias = torch.nn.Parameter(
                torch.zeros((d,), dtype=dtype, device=device),
                requires_grad=False)


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Rotates interleaved pairs ``(x[0::2], x[1::2])`` — the JAX package's
    layout, not the half-split ``rotate_half`` convention."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)       # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    out = torch.stack([xr1, xr2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ------------------------------------------------------ sinusoid positions
@functools.lru_cache(maxsize=4)
def sinusoid_positions(n: int, d: int) -> torch.Tensor:
    """(n, d) fp32 ``sin || cos`` position table on the CPU, computed as
    the JAX package's (numpy float64 angles, one cast to fp32), so the
    two are bit-equal.  Cached per ``(n, d)``; a model keeps its own copy
    on its device (:class:`~repro_torch.models.transformer.EncDec`'s
    ``enc_pos``/``dec_pos``), so a decode step neither rebuilds nor moves
    it.  Callers must not write into it."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32))


# ------------------------------------------------------------- activations
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(kind: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[kind]


def shard_hidden(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    """Activations sharded on batch over (pod, data): a DTensor ``x`` is
    redistributed to its batch rows over the data-parallel mesh axes,
    replicated over the others (the reference's sharding constraint).
    Plain tensors, and a context without a mesh, pass through."""
    if ctx.mesh is None or not is_dtensor(x):
        return x
    from repro_torch.parallel.sharding import batch_placements
    return x.redistribute(ctx.mesh, batch_placements(ctx.mesh,
                                                     rows=x.shape[0]))
