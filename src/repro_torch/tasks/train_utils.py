"""Small training loops used inside O-tasks (fine-tune under masks,
retrain after scaling): the port of the JAX package's
``tasks/train_utils.py``, step for step.

Each step differentiates the loss (``torch.autograd.grad``), clips the
gradients to global norm 1.0, takes an AdamW step (``optim/optimizers.py``)
and, with masks, projects the updated weights onto them again — the masks
are also applied inside the loss, as the JAX package applies them.
Batches come from the same ``np.random.default_rng(seed).permutation``
per epoch, so both packages see the same batches.  The loops run where
the parameters live; bench-model steps run inside ``cnn.conv_flags``, so
the convolutions' backward is fp32 and deterministic on a card as well.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from repro_torch.models.cnn import conv_flags
from repro_torch.models.common import Ctx
from repro_torch.optim.optimizers import (adamw, apply_updates,
                                          clip_by_global_norm, tree_leaves,
                                          tree_map, tree_unflatten)
from repro_torch.sparsity.masks import (apply_masks, flatten_params,
                                        mask_module_)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def train_classifier(params, apply_fn: Callable, train_data, *,
                     epochs: int = 3, batch: int = 128, lr: float = 3e-3,
                     masks: dict | None = None,
                     policy=None, seed: int = 0,
                     mask_schedule: Callable[[int], dict] | None = None):
    """Train/fine-tune a classifier (nested dicts of tensors, left as they
    are; returns new ones).  ``masks`` are re-applied after every update
    (projected masked training — the Keras pruning recipe the paper
    uses).  ``mask_schedule(step)`` overrides masks per step for gradual
    sparsity ramps."""
    x, y = train_data
    n = len(x)
    steps_per_epoch = max(1, n // batch)
    opt = adamw(lr, weight_decay=1e-4)
    dev = next(iter(flatten_params(params).values())).device
    params = tree_map(lambda p: p.detach(), params)
    opt_state = opt.init(params)
    ctx = Ctx(policy=policy)
    xd = torch.from_numpy(np.asarray(x)).to(dev)
    yd = torch.from_numpy(np.asarray(y)).to(dev)

    rng = np.random.default_rng(seed)
    losses = []
    global_step = 0
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(steps_per_epoch):
            idx = torch.from_numpy(perm[i * batch:(i + 1) * batch]).to(dev)
            xb, yb = xd[idx], yd[idx]
            cur = mask_schedule(global_step) if mask_schedule else masks
            tree = tree_map(lambda p: p.requires_grad_(True), params)
            with conv_flags():
                view = apply_masks(tree, cur) if cur is not None else tree
                loss = softmax_xent(apply_fn(ctx, view, xb), yb)
                grads = torch.autograd.grad(loss, tree_leaves(tree))
            with torch.no_grad():
                gtree, _ = clip_by_global_norm(
                    tree_unflatten(tree, grads), 1.0)
                updates, opt_state = opt.update(gtree, opt_state, tree)
                params = apply_updates(tree, updates)
            if cur is not None:
                params = apply_masks(params, cur)
            losses.append(float(loss.detach()))
            global_step += 1
    return params, losses


def lm_batch(batch: dict, device) -> dict:
    """A token batch (numpy or tensors) as int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).long().to(device)
            for k, v in batch.items()}


def lm_finetune(model, params, token_batches, *, steps: int = 20,
                lr: float = 1e-3, masks: dict | None = None):
    """Brief LM fine-tune under masks (used by O-tasks on LM archs).

    ``params`` (an ``LM`` module, frozen) is left as it is: a copy is
    trained and handed back frozen again, ready for serving and
    ``DNNHandle``.  The optimizer runs over the copy's per-block tree
    (``LM.param_tree(per_block=True)``), so gradients and moments live on
    each block's own parameters, in the JAX pytree's leaf order.  AdamW
    without weight decay, as the JAX package's.  After the global-norm
    clip the update is elementwise, so it is applied one leaf at a time,
    in place: a Qwen2-7B leaf (the 545 M-entry embedding) then holds its
    fp32 temporaries alone, not beside every other leaf's."""
    opt = adamw(lr)
    trained = copy.deepcopy(params)
    tree = trained.param_tree(per_block=True)
    leaves = tree_leaves(tree)
    state = opt.init(tree)
    ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
    del state
    step = 0
    losses = []
    for p in leaves:
        p.requires_grad_(True)
    try:
        for s in range(steps):
            batch = lm_batch(token_batches(s), model.device)
            view = (apply_masks(trained, masks, keep_graph=True)
                    if masks is not None else trained)
            loss = model.loss(view, batch)[0]
            grads = torch.autograd.grad(loss, leaves)
            del view
            with torch.no_grad():
                clipped, _ = clip_by_global_norm(list(grads), 1.0)
                del grads
                for i, p in enumerate(leaves):
                    u, new = opt.update(clipped[i], {
                        "step": step, "m": ms[i], "v": vs[i]}, p)
                    clipped[i] = None
                    ms[i], vs[i] = new["m"], new["v"]
                    p.copy_(apply_updates(p, u))
                    del u, new
                step += 1
                if masks is not None:
                    mask_module_(trained, masks)
            losses.append(float(loss.detach()))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return trained, losses
