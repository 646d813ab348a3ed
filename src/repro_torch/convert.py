"""Move JAX-package parameters and cache state into the port.

:func:`params_from_jax` takes the JAX parameter pytree of a decoder-only
LM (``repro.models.transformer.init_lm``) or of an encoder-decoder model
(``init_encdec``) with numpy leaves and returns the port's
``state_dict``: nested keys join with ``.``, and each stacked layer axis
— ``blocks``, and the enc-dec ``enc_blocks`` and ``dec_blocks`` — splits
into ``blocks.{i}.…`` (dense and MoE blocks, GQA or MLA attention;
xLSTM's ``(mLSTM, sLSTM)`` pairs; zamba2's Mamba2 blocks;
``dec_blocks.{i}.cross.wq``), while zamba2's unstacked ``shared``
subtree keeps its nesting (``shared.attn.wq``).  :func:`cache_from_jax`
takes a contiguous decode cache (``init_lm_cache``'s, or one layer's),
nested dicts included:

- dense: ``{"k", "v", "pos"}``; MLA: ``{"ckv", "krope", "pos"}``;
- xLSTM: ``{"blocks": {"mlstm": {"conv", "C", "n", "m"}, "slstm": {"h",
  "c", "n", "m"}}, "pos": ()}``;
- zamba2: ``{"mamba": {"conv", "ssd"}, "shared": {"k", "v", "pos"}}``;
- enc-dec (``init_encdec_cache``'s): ``{"self": {"k", "v", "pos"},
  "cross_k", "cross_v"}``.

:func:`bench_params_from_jax` takes the parameters of a bench model
(``models/cnn.py``: ``{"fc0": {"w", "b"}}``, ``{"conv0": {"w", "bn":
{...}}}``) and keeps their nesting.  bf16 leaves are read through their
16-bit patterns, so no bf16 numpy dtype is needed here.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# the subtrees whose leaves carry a leading layer axis
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts of arrays) -> ``state_dict`` of
    :class:`repro_torch.models.transformer.LM` or ``EncDec`` (CPU
    tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(path: tuple, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (str(k),), v)
            return
        a = np.asarray(node)
        if path[0] in STACKED:
            for i in range(a.shape[0]):
                out[".".join((path[0], str(i)) + path[1:])] = _tensor(a[i])
        else:
            out[".".join(path)] = _tensor(a)

    walk((), tree)
    return out


def bench_params_from_jax(tree):
    """JAX bench-model parameters (nested dicts of arrays) -> the same
    nesting of CPU tensors, the port's ``models/cnn.py`` layout (HWIO
    convolution weights, (in, out) dense weights)."""
    if isinstance(tree, dict):
        return {str(k): bench_params_from_jax(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree))


def cache_from_jax(tree) -> dict:
    """JAX contiguous cache (nested dicts with numpy leaves) -> the port's
    cache (CPU tensors, the same nesting): a stacked ``pos`` stays an
    int32 tensor ((L,), or zamba2's one per shared-attention
    application), a scalar one (one layer's, xLSTM's) becomes a Python
    int."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = cache_from_jax(leaf)
        elif name == "pos":
            pos = np.asarray(leaf)
            out[name] = int(pos) if pos.ndim == 0 else _tensor(
                pos.astype(np.int32))
        else:
            out[name] = _tensor(np.asarray(leaf))
    return out
