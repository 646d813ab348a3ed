"""Train/serve step functions and the fault-tolerant training loop: the
port of the JAX package's ``runtime/train_loop.py`` on one device.

The training loop keeps the reference's runnability contract:

- checkpoint/restart (atomic async checkpoints, ``checkpoint/manager.py``;
  restore-on-failure from the newest committed step);
- failure injection and recovery: a simulated node loss
  (:class:`NodeFailure`) restarts from the last checkpoint, and the data
  pipeline, deterministic in the step index, replays the same batches;
- straggler accounting: a step slower than ``straggler_factor`` times the
  running median is logged and counted;
- optional int8 gradient compression with error feedback
  (``optim/compression.py``), and microbatched gradient accumulation.

A train state is ``{"params": LM, "opt": {"step": int, "m": tree, "v":
tree}[, "residuals": tree]}``: the model's parameters (a module, updated
in place) and the optimizer state and residuals over its per-block tree
(``LM.param_tree(per_block=True)``), fp32.  Checkpoints hold it in the
JAX package's layout (``convert.state_to_jax``), so the two packages
read each other's fp32 checkpoints.

The loop catches only :class:`NodeFailure`.  The reference catches any
``RuntimeError`` as a node loss; in torch a CUDA error, an out-of-memory
error and a kernel that fails to build or launch are ``RuntimeError``\\ s
too, and catching them would restart forever and hide the device's
fault.

The distribution pieces (``state_shardings``, ``batch_shardings``,
``cache_shardings``) wait for the port of ``parallel/sharding.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import state_from_jax, state_to_jax
from repro_torch.models.api import LMModel
from repro_torch.models.common import resolve_device
from repro_torch.optim import compression as C
from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_scale, cosine_schedule,
                                          global_norm, tree_leaves,
                                          tree_unflatten)


# ------------------------------------------------------------ train step
def make_train_step(model: LMModel, optimizer: Optimizer,
                    *, grad_compression: bool = False,
                    microbatches: int = 1,
                    unroll_microbatches: bool = False,
                    clip_norm: float = 1.0) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    In the reference's order: gradients (``microbatches`` > 1 splits the
    batch, sums the gradients in fp32 and divides; the metrics are the
    microbatches' means) → error-feedback compression → global-norm clip
    → the optimizer → the update, one leaf at a time and in place (the
    clip scales each leaf as it reaches the optimizer), so the step
    holds no second copy of the gradients or of the parameters.  The
    state's parameters, moments and residuals are updated in place; the
    returned state is ``state``.  ``unroll_microbatches`` changes
    nothing here: the microbatches are a Python loop either way (in the
    reference it unrolls a ``lax.scan`` for the dry-run's cost probes)."""
    del unroll_microbatches
    ctx = model.ctx()

    def compute_grads(params, leaves, batch):
        if microbatches <= 1:
            loss, metrics = model.loss(params, batch, ctx)
            return loss, metrics, list(torch.autograd.grad(loss, leaves))
        mb = {k: t.reshape(microbatches, t.shape[0] // microbatches,
                           *t.shape[1:]) for k, t in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        losses, ms = [], []
        for i in range(microbatches):
            loss, metrics = model.loss(params,
                                       {k: t[i] for k, t in mb.items()}, ctx)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g.float())
            del grads
            losses.append(loss.detach())
            ms.append({k: v.detach() for k, v in metrics.items()})
        with torch.no_grad():
            for a in acc:
                a.div_(microbatches)
        metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                   for k in ms[0]}
        return torch.mean(torch.stack(losses)), metrics, acc

    def train_step(state, batch):
        params = state["params"]
        tree = params.param_tree(per_block=True)
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics, grads = compute_grads(params, leaves, batch)
        # the old residuals and moments are dropped from ``state`` before
        # their leaves are replaced: the lists hold the only references,
        # so each old leaf is freed as its new one is made
        with torch.no_grad():
            if grad_compression:
                # one scale per JAX leaf: a block parameter's blocks share it
                res = tree_leaves(state.pop("residuals"))
                for idx in C.leaf_groups(tree):
                    gs, rs = C.compress_stack_with_feedback(
                        [grads[i] for i in idx], [res[i] for i in idx])
                    for i, g, r in zip(idx, gs, rs):
                        grads[i], res[i] = g, r
                state["residuals"] = tree_unflatten(tree, res)
            gnorm = global_norm(grads)
            scale = clip_scale(gnorm, clip_norm)
            opt = state.pop("opt")
            step = opt.pop("step")
            trees = {k: tree_leaves(v) for k, v in opt.items()}
            del opt
            for i, p in enumerate(leaves):
                g, grads[i] = grads[i], None
                g = (g.float() * scale).to(g.dtype)
                u, new = optimizer.update(
                    g, {"step": step, **{k: t[i] for k, t in trees.items()}},
                    p)
                del g
                for k, t in trees.items():
                    t[i] = new[k]
                p.copy_(apply_updates(p, u))
                del u, new
            state["opt"] = {"step": step + 1,
                            **{k: tree_unflatten(tree, t)
                               for k, t in trees.items()}}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return state, metrics

    return train_step


def make_decode_step(model: LMModel) -> Callable:
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode_step


def make_prefill_step(model: LMModel, cache_len: int) -> Callable:
    def prefill_step(params, batch):
        cache = model.init_cache(batch["tokens"].shape[0], cache_len)
        return model.prefill(params, batch, cache=cache)
    return prefill_step


def init_train_state(model: LMModel, optimizer: Optimizer, seed: int = 0,
                     grad_compression: bool = False) -> dict:
    """Parameters from ``model.init(seed)``, the optimizer's state and,
    with ``grad_compression``, zero fp32 residuals."""
    params = model.init(seed)
    tree = params.param_tree(per_block=True)
    state = {"params": params, "opt": optimizer.init(tree)}
    if grad_compression:
        state["residuals"] = C.init_residuals(tree)
    return state


# ------------------------------------------------------- failure handling
class NodeFailure(RuntimeError):
    """A simulated node loss: the one error the loop restarts from."""


class FailureInjector:
    """Deterministically raises :class:`NodeFailure` at configured steps,
    once each."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: int = 0
    losses: list = dataclasses.field(default_factory=list)
    final_loss: float = float("nan")


def train_loop(model: LMModel, *, steps: int, batcher,
               ckpt: CheckpointManager, optimizer: Optimizer | None = None,
               ckpt_every: int = 10, seed: int = 0,
               injector: FailureInjector | None = None,
               straggler_factor: float = 3.0,
               grad_compression: bool = False,
               log: Callable[[str], None] = lambda s: None) -> LoopReport:
    """Fault-tolerant loop: restores from the newest committed checkpoint
    (or initialises from ``seed`` and snapshots that as step -1),
    checkpoints every ``ckpt_every`` steps and at the last, and on a
    :class:`NodeFailure` restarts from the last checkpoint — the
    deterministic data pipeline replays the same batches."""
    resolve_device(model.device)     # a CUDA model needs a card
    optimizer = optimizer or adamw(cosine_schedule(3e-4, 10, steps))
    train_step = make_train_step(model, optimizer,
                                 grad_compression=grad_compression)

    def load_or_init():
        tree, meta = ckpt.restore()
        if tree is None:
            return init_train_state(model, optimizer, seed,
                                    grad_compression=grad_compression), 0
        return state_from_jax(tree, model), meta["step"] + 1

    report = LoopReport()
    state, start = load_or_init()
    if start == 0:
        ckpt.save(-1, state_to_jax(state))  # step "-1" = init snapshot
        ckpt.wait()
    step = start
    durations: list[float] = []
    while step < steps:
        try:
            if injector is not None:
                injector.check(step)
            batch = batcher.get(step)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if len(durations) >= 5:
                med = sorted(durations)[len(durations) // 2]
                if dt > straggler_factor * med:
                    report.straggler_events += 1
                    log(f"straggler: step {step} took {dt:.3f}s "
                        f"(median {med:.3f}s)")
            durations.append(dt)
            report.losses.append(loss)
            report.steps_run += 1
            if (step + 1) % ckpt_every == 0 or step + 1 == steps:
                ckpt.save(step, state_to_jax(state))
            step += 1
        except NodeFailure as e:
            log(f"failure at step {step}: {e}; restarting from checkpoint")
            report.restarts += 1
            ckpt.wait()
            state = None  # free the lost state before the restore
            state, step = load_or_init()
    ckpt.wait()
    report.final_loss = report.losses[-1] if report.losses else float("nan")
    return report
