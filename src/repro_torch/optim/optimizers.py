"""Optimizers over nested dicts of tensors: SGD, Adam, AdamW with fp32
accumulators, global-norm clipping, LR schedules — the port of the JAX
package's ``optim/optimizers.py``, built from tensor ops as it is built
from ``jnp`` ops (``torch.optim.AdamW`` differs from it: see :func:`adamw`).

The same (init, update) pair:

    opt = adamw(lr=schedule, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

A *tree* is a nested dict (or list) of tensors.  Its leaves are visited
in the JAX pytree's order: dict keys sorted, list items in order — so a
global norm sums the leaves in the order the JAX package sums them.  An
LM's stacked block parameters are a list of the per-block parameters
(``LM.param_tree(per_block=True)``): the gradients and moments live per
block, in the stacked leaf's layer order.

Optimizer state is fp32 whatever the parameter dtype (bf16 params + fp32
moments).  The step count is a host integer, and the scalar factors (the
rate, the bias corrections) are rounded to fp32 on the host, as the JAX
package computes them in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

Schedule = Callable[[int], float]


def _f32(x: float) -> float:
    """``x`` rounded to the nearest fp32 value (a product of two fp32
    values rounded once is the fp32 product)."""
    return float(np.float32(x))


# ------------------------------------------------------------- trees
def tree_leaves(tree) -> list:
    """Leaves in the JAX pytree's order (sorted dict keys, lists in order);
    ``None`` is an empty subtree, as in JAX.  Tuples are leaves."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [rec(v) for v in node]
        return None if node is None else next(it)

    return rec(tree)


# ---------------------------------------------------------- schedules
def constant_schedule(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def cosine_schedule(peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1) -> Schedule:
    def fn(step):
        s = np.float32(step)
        if s < warmup_steps:
            return float(np.float32(peak_lr) * s
                         / np.float32(max(1, warmup_steps)))
        prog = np.clip((s - np.float32(warmup_steps))
                       / np.float32(max(1, total_steps - warmup_steps)),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(peak_lr) * (
            np.float32(final_frac) + np.float32(1 - final_frac)
            * np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi)
                                                        * prog)))
        return float(np.float32(cos))
    return fn


# ------------------------------------------------------------ clipping
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves
    summed in pytree order (a 0-d tensor on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-9))``, the factor of
    :func:`clip_by_global_norm`."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by :func:`clip_scale` (in fp32, cast back to the
    leaf's dtype).  Returns (tree, norm)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# ---------------------------------------------------------- optimizers
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    name: str = "optimizer"


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros of ``p``'s shape on its device (a DTensor's on its
    mesh, with its placements)."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def sgd(lr: float | Schedule, momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        state = {"step": 0}
        if momentum:
            state["mom"] = tree_map(_zeros32, params)
        return state

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _f32(sched(step))
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state["mom"], grads)
            updates = tree_map(lambda m: -lr_t * m, mom)
            return updates, {"step": step, "mom": mom}
        updates = tree_map(lambda g: -lr_t * g.float(), grads)
        return updates, {"step": step}

    return Optimizer(init, update, "sgd")


def adamw(lr: float | Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW as the JAX package defines it, which ``torch.optim.AdamW``
    does not: ``b2 = 0.95`` by default; the decay ``lr * wd * p`` only on
    leaves with ``ndim >= 2`` and added to the Adam step, not applied to
    ``p`` before it; fp32 moments for any parameter dtype; the bias
    corrections ``1 - b ** step`` in fp32."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return {"step": 0, "m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _f32(sched(step))
        c1 = _f32(1.0 - np.float32(b1) ** np.float32(step))
        c2 = _f32(1.0 - np.float32(b2) ** np.float32(step))
        decay = _f32(lr_t * _f32(weight_decay))

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m + (1 - b1) * gf
            v_new = b2 * v + (1 - b2) * gf * gf
            mhat = m_new / c1
            vhat = v_new / c2
            u = -lr_t * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay and p is not None and p.ndim >= 2:
                u = u - decay * p.float()
            return u, m_new, v_new

        if params is None:
            params = tree_map(lambda g: None, grads)
        out = tree_map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), {"step": step, "m": pick(1), "v": pick(2)}

    return Optimizer(init, update, "adamw")


def adam(lr: float | Schedule, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


@torch.no_grad()
def apply_updates(params, updates):
    """``(p.float() + u)`` cast back to ``p``'s dtype, as new tensors."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)



def opt_state_axes(opt_name: str, param_axes):
    """Logical axes for the optimizer state (moments mirror params)."""
    if opt_name == "sgd":
        return {"step": ()}
    return {"step": (), "m": param_axes, "v": param_axes}
