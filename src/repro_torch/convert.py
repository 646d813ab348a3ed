"""Move JAX-package parameters and cache state into the port.

:func:`params_from_jax` takes the JAX parameter pytree of a dense LM
(``repro.models.transformer.init_lm``) with numpy leaves and returns the
port's ``state_dict``: nested keys join with ``.``, and the stacked
``blocks`` axis splits into ``blocks.{i}.…``.  :func:`cache_from_jax`
takes a contiguous decode cache (``init_lm_cache``'s ``k``, ``v``,
``pos``, or one layer's).  bf16 leaves are read through their 16-bit
patterns, so no bf16 numpy dtype is needed here.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts of arrays) -> ``state_dict`` of
    :class:`repro_torch.models.transformer.LM` (CPU tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(path: tuple, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (str(k),), v)
            return
        a = np.asarray(node)
        if path[0] == "blocks":
            for i in range(a.shape[0]):
                out[".".join(("blocks", str(i)) + path[1:])] = _tensor(a[i])
        else:
            out[".".join(path)] = _tensor(a)

    walk((), tree)
    return out


def cache_from_jax(tree) -> dict[str, torch.Tensor | int]:
    """JAX contiguous cache ``{"k", "v", "pos"}`` with numpy leaves -> the
    port's cache (CPU tensors): the stacked model cache keeps ``pos`` as an
    (L,) int32 tensor, one layer's cache as a Python int."""
    out = {name: _tensor(np.asarray(tree[name])) for name in ("k", "v")}
    pos = np.asarray(tree["pos"])
    out["pos"] = int(pos) if pos.ndim == 0 else _tensor(
        pos.astype(np.int32))
    return out
