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

The other way, for checkpoints: :func:`state_to_jax` lays a decoder-only
LM's train state out as the JAX package's train state (``params`` keyed
as its pytree with each block leaf one :class:`Stacked` (L, …) leaf,
``opt/step``, ``opt/m``, ``opt/v``, ``residuals``), and
:func:`state_from_jax` takes such a tree — the port's own checkpoints or
the JAX package's — back into a train state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_map, tree_unflatten


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


# ----------------------------------------------------------- train state
class Stacked(list):
    """The per-block tensors of one block parameter (or of its gradient,
    moment or residual), in layer order: one leaf of the JAX layout,
    stacked (L, …) when it is copied to the host
    (``checkpoint/manager.py``), never on the device."""


def _jax_layout(tree):
    """A per-block tree (``LM.param_tree(per_block=True)``'s structure)
    with each list of per-block tensors as one :class:`Stacked` leaf."""
    if isinstance(tree, dict):
        return {k: _jax_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return Stacked(tree)
    return tree


def state_to_jax(state: dict) -> dict:
    """A train state (``runtime/train_loop.py``: ``{"params": LM, "opt":
    {"step": int, "m": tree, "v": tree}[, "residuals": tree]}``) as the
    JAX package's train state: the same paths and shapes, each stacked
    leaf a :class:`Stacked` of the device tensors (nothing is copied
    here), ``opt/step`` an int32 0-d tensor."""
    out = {"params": _jax_layout(state["params"].param_tree(per_block=True))}
    opt = {k: v for k, v in state["opt"].items() if k != "step"}
    out["opt"] = dict(_jax_layout(opt), step=torch.tensor(
        int(state["opt"]["step"]), dtype=torch.int32))
    if "residuals" in state:
        out["residuals"] = _jax_layout(state["residuals"])
    return out


def _pairs(template, tree, path: str):
    """(template leaf, stored leaf) pairs of ``template`` (a per-block
    tree) and ``tree`` (the JAX layout, CPU tensors): a list of the
    template pairs with the rows of the stacked leaf.  Every stored
    leaf's shape and dtype must be the template's."""
    if isinstance(template, dict):      # in tree_leaves' order
        for k in sorted(template):
            yield from _pairs(template[k], tree[k], f"{path}/{k}")
        return
    if isinstance(template, list) and isinstance(tree, list):
        # restored onto a mesh: one DTensor a block (``Stacked``)
        for i, (t, leaf) in enumerate(zip(template, tree, strict=True)):
            yield from _pairs(t, leaf, f"{path}/{i}")
        return
    want = template
    if isinstance(template, list):
        want = torch.empty((len(template), *template[0].shape),
                           dtype=template[0].dtype, device="meta")
    if tuple(tree.shape) != tuple(want.shape) or tree.dtype != want.dtype:
        raise ValueError(f"checkpoint leaf {path}: {tree.dtype} "
                         f"{tuple(tree.shape)}, the model wants {want.dtype} "
                         f"{tuple(want.shape)}")
    if isinstance(template, list):
        yield from zip(template, tree)
    else:
        yield template, tree


@torch.no_grad()
def state_from_jax(tree: dict, model, shardings: dict | None = None) -> dict:
    """A train state from a tree in the JAX package's layout (nested
    dicts of CPU tensors, as ``CheckpointManager.restore`` returns them):
    the parameters loaded into ``model.empty_params()``, the optimizer
    state and residuals in the per-block structure on the model's
    device.  Every leaf's shape and dtype must be the model's.  With
    ``shardings`` (``runtime/train_loop.py::state_shardings``) the
    parameters are DTensors placed by them, and ``tree`` holds DTensors
    in the same placements (``restore(shardings=...)``)."""
    params = model.empty_params()
    if shardings is not None:
        from repro_torch.runtime.train_loop import shard_params
        shard_params(params, shardings["params"])
    template = params.param_tree(per_block=True)
    for p, stored in _pairs(template, tree["params"], "params"):
        p.copy_(stored)

    def fp32_tree(node, path):
        return tree_unflatten(template, [
            stored.to(model.device)
            for _, stored in _pairs(_f32(template), node, path)])

    opt = tree["opt"]
    state = {"params": params, "opt": {"step": int(opt["step"])}}
    for k, v in opt.items():
        if k != "step":
            state["opt"][k] = fp32_tree(v, f"opt/{k}")
    if "residuals" in tree:
        state["residuals"] = fp32_tree(tree["residuals"], "residuals")
    return state


def _f32(template):
    """``template``'s structure with fp32 meta leaves: the shapes and
    dtype of the optimizer's moments and the residuals."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                          device="meta"), template)
