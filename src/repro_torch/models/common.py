"""Shared model-substrate utilities: apply context, device, inits, norms.

Conventions used across the model code:

- Weights are stored ``(in_features, out_features)`` as in the JAX
  package and applied as ``x @ w``; contraction is always on axis 0 of
  the weight.
- ``Ctx`` carries cross-cutting state through apply functions: the
  quantization policy (the QUANTIZATION O-task's output) and whether the
  call is a cached (decode / paged) one.
- Random init draws from an explicit ``torch.Generator``; the numbers
  differ from ``jax.random`` for the same seed, so cross-framework tests
  move JAX parameters over with :mod:`repro_torch.convert`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.quant.policy import BF16, FP32, FP8, INT8, PrecisionPolicy


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

    The precision level for ``name`` decides the executed product.  BF16
    multiplies bf16 operands with fp32 accumulation and rounds once to the
    activation dtype, as the JAX package's ``preferred_element_type``
    product does: with bf16 activations that is a bf16 ``matmul``; with
    fp32 activations the bf16-rounded operands are multiplied in fp32.
    """
    level = ctx.level_for(name)
    out_dtype = x.dtype
    if level in (FP8, INT8):
        raise NotImplementedError(
            f"{level} linear ({name}) is not ported yet: it waits for the "
            f"slice that ports the quant_matmul kernel and fp8 storage")
    if level == FP32:
        y = torch.matmul(x.float(), w.float())
    elif out_dtype == torch.bfloat16:
        y = torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))
    else:
        y = torch.matmul(x.to(torch.bfloat16).float(),
                         w.to(torch.bfloat16).float())
    y = y.to(out_dtype)
    if b is not None:
        y = y + b.to(out_dtype)
    return y


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


# ------------------------------------------------------------- activations
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(kind: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[kind]
