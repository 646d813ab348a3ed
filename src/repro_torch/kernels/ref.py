"""Plain PyTorch oracles of the JAX package's ``kernels/ref.py`` for the
block-sparse and attention kernels (allclose targets for tests)."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Naive softmax attention with GQA/causal/window semantics."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def block_sparse_matmul_ref(x: torch.Tensor, w_masked: torch.Tensor
                            ) -> torch.Tensor:
    """Dense reference over the (already masked) weight, in fp32."""
    return x.float() @ w_masked.float()
