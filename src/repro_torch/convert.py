"""Move JAX-package parameters into the port.

:func:`params_from_jax` takes the JAX parameter pytree of a dense LM
(``repro.models.transformer.init_lm``) with numpy leaves and returns the
port's ``state_dict``: nested keys join with ``.``, and the stacked
``blocks`` axis splits into ``blocks.{i}.…``.  bf16 leaves are read
through their 16-bit patterns, so no bf16 numpy dtype is needed here.
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
