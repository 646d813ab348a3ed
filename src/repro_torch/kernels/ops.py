"""Convenience wrappers around the kernels (the JAX package's
``kernels/ops.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.block_sparse_matmul import (block_sparse_matmul,
                                                     compact_block_index)
from repro_torch.sparsity.masks import block_map

__all__ = ["masked_matmul", "compact_block_index"]


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, *,
                  block: int = 128) -> torch.Tensor:
    """Derive the live-block index from a full-resolution mask and run the
    block-sparse kernel over ``w * mask``.  (A deployment would keep the
    index with the pruned checkpoint.)"""
    wm = (w.float() * mask.to(w.device)).to(w.dtype)
    kidx = torch.from_numpy(compact_block_index(block_map(mask, block)))
    return block_sparse_matmul(x, wm, kidx.to(x.device), block=block)
