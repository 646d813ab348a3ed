"""Pruning masks (PRUNING O-task substrate).

Paper §V-B: the PRUNING O-task "gradually zeroes out weights during training
to create a more compact and efficient network while maintaining accuracy",
with auto-pruning maximizing the rate subject to ``accuracy_loss <= alpha_p``.

Two granularities, as in the JAX package's ``sparsity/masks.py``:

- ``unstructured``: magnitude pruning (the paper's accuracy/rate curves;
  the resource proxy counts effective MACs).
- ``block``: 128x128-block magnitude pruning; zero blocks are skipped by
  the block-sparse kernel (``kernels/block_sparse_matmul.py``), so the
  compute saving is structural.

Masks are ``{path: fp32 0/1 tensor}`` on the weight's device, keyed by the
JAX package's ``/``-joined pytree paths.  Parameters are nested dicts of
tensors (the bench models) or an LM module, whose path-keyed view is
:meth:`repro_torch.models.transformer.LM.param_tree`: the same paths,
shapes, dtypes and order as the JAX pytree of the same model, with the
per-layer matrices as shape-only stacked leaves.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

BLOCK = 128


def magnitude_mask(w: torch.Tensor, rate: float) -> torch.Tensor:
    """Unstructured magnitude mask keeping the top (1-rate) fraction."""
    if rate <= 0.0:
        return torch.ones(w.shape, dtype=torch.float32, device=w.device)
    a = w.abs().float()
    flat = a.reshape(-1)
    k = int(round((1.0 - rate) * flat.numel()))
    if k <= 0:
        return torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    thresh = torch.sort(flat).values[flat.numel() - k]
    return (a >= thresh).float()


def block_mask(w: torch.Tensor, rate: float, block: int = BLOCK
               ) -> torch.Tensor:
    """Block-granular magnitude mask for a 2-D weight.

    Blocks are scored by their L1 norm; the lowest-norm ``rate`` fraction of
    blocks is zeroed.  The returned mask is full-resolution (same shape as
    ``w``) so it can also be consumed by the dense masked path; the
    block-sparse kernel re-derives the block map from it.
    """
    if w.ndim != 2:
        raise ValueError("block masks are for 2-D weights")
    m, n = w.shape
    bm, bn = -(-m // block), -(-n // block)
    a = w.abs().float()
    if (bm * block, bn * block) != (m, n):
        a = torch.nn.functional.pad(a, (0, bn * block - n, 0, bm * block - m))
    scores = a.reshape(bm, block, bn, block).sum(dim=(1, 3))
    flat = scores.reshape(-1)
    k = int(round((1.0 - rate) * flat.numel()))
    if k <= 0:
        return torch.zeros((m, n), dtype=torch.float32, device=w.device)
    thresh = torch.sort(flat).values[flat.numel() - k]
    bmask = (scores >= thresh).float()
    full = bmask.repeat_interleave(block, 0).repeat_interleave(block, 1)
    return full[:m, :n].contiguous()


def block_map(mask: torch.Tensor, block: int = BLOCK) -> np.ndarray:
    """(bm, bn) 0/1 block occupancy map (numpy int32) from a
    full-resolution mask; reduced on the mask's device."""
    m, n = mask.shape
    bm, bn = -(-m // block), -(-n // block)
    a = torch.as_tensor(mask).abs().float()
    if (bm * block, bn * block) != (m, n):
        a = torch.nn.functional.pad(a, (0, bn * block - n, 0, bm * block - m))
    occ = a.reshape(bm, block, bn, block).sum(dim=(1, 3)) > 0
    return occ.cpu().numpy().astype(np.int32)


def prunable_paths(params, min_size: int = 1024,
                   exempt: tuple[str, ...] = ("embed", "router", "norm",
                                              "bias", "scale", "gate_logit",
                                              "dt_", "A_log")) -> list[str]:
    """Paths of 2-D weights worth pruning (skips tiny/exempt tensors)."""
    out = []
    for path, leaf in flatten_params(params).items():
        if leaf.ndim != 2 or leaf.numel() < min_size:
            continue
        if any(tok in path for tok in exempt):
            continue
        out.append(path)
    return sorted(out)


def build_masks(params, rate: float, granularity: str = "block",
                paths: list[str] | None = None,
                block: int = BLOCK) -> dict[str, torch.Tensor]:
    """{path: mask} for the selected (or all prunable) paths."""
    flat = flatten_params(params)
    paths = paths if paths is not None else prunable_paths(params)
    masks = {}
    for p in paths:
        masks[p] = (block_mask(flat[p], rate, block) if granularity == "block"
                    else magnitude_mask(flat[p], rate))
    return masks


def _masked(w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return (w.float() * m.to(w.device)).to(w.dtype)


def apply_masks(params, masks: dict[str, torch.Tensor]):
    """Multiply masked weights into new parameters.  Nested dicts give a
    new nested dict; an LM module gives a shallow copy that shares every
    parameter except the masked ones (a stacked ``blocks/...`` mask
    (L, ...) masks layer i with its slice i)."""
    if not isinstance(params, torch.nn.Module):
        flat = flatten_params(params)
        for p, m in masks.items():
            flat[p] = _masked(flat[p], m)
        return unflatten_params(flat)
    out = _shallow(params)
    for path, m in masks.items():
        parts = path.split("/")
        if parts[0] == "blocks":
            for i in range(len(params.blocks)):
                _replace(out, ["blocks", str(i), *parts[1:]], m[i])
        else:
            _replace(out, parts, m)
    return out


def _shallow(module: torch.nn.Module) -> torch.nn.Module:
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._modules = dict(module._modules)
    return new


def _replace(module: torch.nn.Module, parts: list[str],
             mask: torch.Tensor) -> None:
    for part in parts[:-1]:
        child = _shallow(module._modules[part])
        module._modules[part] = child
        module = child
    w = module._parameters[parts[-1]]
    module._parameters[parts[-1]] = torch.nn.Parameter(_masked(w, mask),
                                                       requires_grad=False)


def sparsity_report(masks: dict[str, torch.Tensor]) -> dict[str, float]:
    total = sum(int(m.numel()) for m in masks.values())
    zeros = sum(int(m.numel()) - int(torch.count_nonzero(m))
                for m in masks.values())
    return {"masked_params": total, "zeros": zeros,
            "sparsity": zeros / max(1, total)}


# ------------------------------------------------------------ path helpers
def flatten_params(params) -> dict[str, torch.Tensor]:
    """``{"a/b/c": leaf}`` over nested dicts, or over an LM module's
    JAX-shaped :meth:`param_tree`."""
    if isinstance(params, torch.nn.Module):
        params = params.param_tree()
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    rec("", params)
    return flat


def unflatten_params(flat: dict[str, torch.Tensor]):
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root
