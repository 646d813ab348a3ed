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

On a device mesh (``build_model(cfg, mesh=...)``) the state's
parameters, moments and the batches are DTensors: :func:`state_shardings`
places them by the logical-axis rules (``fsdp``: parameters and moments
over the data-parallel axes too; ``zero1``: the moments alone),
:func:`shard_state` distributes a state drawn on every rank from one
seed, and the train step runs unchanged on them — each gradient is
reduced to its parameter's placements, the clipping norm is a full
reduction over the DTensors, and each leaf's AdamW update runs in its
moments' placements (the same fp32 arithmetic, on each rank's shard)
before the parameter takes it back in its own.
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
                                          global_norm, opt_state_axes,
                                          tree_leaves, tree_unflatten)
from repro_torch.parallel.sharding import (NamedSharding, ShardingRules,
                                           block_spec, distribute, is_dtensor)
from repro_torch.parallel import sharding as Sh


# ------------------------------------------------------------- shardings
def _named(rules: ShardingRules, specs, axes):
    """Specs (JAX layout) as :class:`NamedSharding` leaves; a block leaf's
    (axes leading with ``"layers"``) on each block's tensor."""
    def one(spec, ax):
        if ax and ax[0] == "layers":
            return NamedSharding(rules.mesh, block_spec(spec), stacked=True)
        return NamedSharding(rules.mesh, spec)
    return Sh.tree_map(one, specs, axes)


def state_shardings(model: LMModel, rules: ShardingRules,
                    opt_name: str = "adamw", fsdp: bool = False,
                    zero1: bool = False) -> dict:
    """Shardings for {params, opt}, in the JAX layout, from the stacked
    shapes (``param_specs``' FSDP threshold and "largest dim" see the
    reference's leaves):

    - ``fsdp``: params AND moments sharded over the dp axes (ZeRO-3-style).
    - ``zero1``: moments only — params stay TP-sharded/replicated, the
      fp32 Adam m/v shard over (pod, data) on top (ZeRO-1)."""
    p_shapes = model.abstract_params().param_tree()
    p_axes = model.param_axes()
    p_specs = rules.param_specs(p_axes, p_shapes, fsdp=fsdp)
    o_axes = opt_state_axes(opt_name, p_axes)
    o_specs = {"step": ()}
    if opt_name != "sgd":
        m_specs = rules.param_specs(p_axes, p_shapes, fsdp=fsdp or zero1
                                    or bool(rules.fsdp_axes))
        o_specs = {"step": (), "m": m_specs, "v": m_specs}
    return {"params": _named(rules, p_specs, p_axes),
            "opt": {k: _named(rules, o_specs[k], o_axes[k])
                    for k in o_specs}}


def batch_shardings(model: LMModel, rules: ShardingRules,
                    specs: dict) -> dict:
    return {k: rules.sharding_for(("batch",) + (None,) * (v.ndim - 1),
                                  tuple(v.shape))
            for k, v in specs.items()}


def cache_shardings(model: LMModel, rules: ShardingRules, batch: int,
                    seq_len: int) -> dict:
    """Shardings of the contiguous cache's tensors (its ``pos`` stays on
    the host); a stacked cache tensor is one tensor here, as in the
    reference."""
    shapes, axes = model.abstract_cache(batch, seq_len)
    specs = rules.tree_specs(axes, Sh.tree_map(
        lambda t: tuple(getattr(t, "shape", ())), shapes,
        is_leaf=lambda t: not isinstance(t, dict)))
    return Sh.tree_map(lambda sp: NamedSharding(rules.mesh, sp), specs)


def place_cache(cache: dict, shardings: dict) -> dict:
    """A contiguous cache made whole on every rank (or on the ``meta``
    device) as DTensors placed by ``shardings``
    (:func:`cache_shardings`); ``pos`` stays on the host."""
    return {k: place_cache(v, shardings[k]) if isinstance(v, dict)
            else v if k == "pos"
            else distribute(v, shardings[k].mesh, shardings[k].placements)
            for k, v in cache.items()}


def _pairs(tree, shardings):
    """(leaf, sharding) pairs of a per-block tree and its JAX-layout
    shardings: a stacked sharding serves each block's tensor."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], shardings[k])
    elif isinstance(tree, list):
        for t in tree:
            yield t, shardings
    elif tree is not None:
        yield tree, shardings


@torch.no_grad()
def shard_params(params, shardings: dict):
    """Replace every parameter of the module ``params`` by a DTensor
    parameter placed by ``shardings`` (``state_shardings(...)["params"]``):
    this rank's shard of the full tensor, no collective."""
    new = {id(t): distribute(t, s.mesh, s.placements) for t, s in
           _pairs(params.param_tree(per_block=True), shardings)}
    for mod in params.modules():
        for name, t in list(mod._parameters.items()):
            if id(t) in new:
                mod._parameters[name] = torch.nn.Parameter(
                    new[id(t)], requires_grad=False)
    return params


def place(tree, shardings):
    """A per-block tree of full tensors (moments, residuals) as DTensors
    placed by ``shardings`` (JAX layout)."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(t, shardings) for t in tree]
    return distribute(tree, shardings.mesh, shardings.placements)


def shard_state(state: dict, shardings: dict) -> dict:
    """A train state drawn whole on every rank (one seed) as DTensors:
    parameters and moments placed by ``shardings``
    (:func:`state_shardings`)."""
    shard_params(state["params"], shardings["params"])
    opt = state["opt"]
    state["opt"] = dict(opt, **{k: place(opt[k], shardings["opt"][k])
                                for k in opt if k != "step"})
    if "residuals" in state:
        raise NotImplementedError("gradient compression on a mesh")
    return state


# ------------------------------------------------------------ train step
def make_train_step(model: LMModel, optimizer: Optimizer,
                    *, grad_compression: bool = False,
                    microbatches: int = 1,
                    clip_norm: float = 1.0) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    In the reference's order: gradients (``microbatches`` > 1 splits the
    batch, sums the gradients in fp32 and divides; the metrics are the
    microbatches' means) → error-feedback compression → global-norm clip
    → the optimizer → the update, one leaf at a time and in place (the
    clip scales each leaf as it reaches the optimizer), so the step
    holds no second copy of the gradients or of the parameters.  The
    state's parameters, moments and residuals are updated in place; the
    returned state is ``state``."""
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
        if is_dtensor(leaves[0]):
            if grad_compression:
                raise NotImplementedError("gradient compression on a mesh")
            # partial sums over the batch shards reduced, to each
            # parameter's placements (all-reduce or reduce-scatter)
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
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
                moments = {k: t[i] for k, t in trees.items()}
                pm = p
                if is_dtensor(p) and moments:
                    # the update in the moments' placements (ZeRO-1:
                    # each rank's shard), the parameter gathered back
                    mpl = next(iter(moments.values())).placements
                    g = g.redistribute(p.device_mesh, mpl)
                    pm = p.redistribute(p.device_mesh, mpl)
                u, new = optimizer.update(g, {"step": step, **moments}, pm)
                del g
                for k, t in trees.items():
                    t[i] = new[k]
                upd = apply_updates(pm, u)
                if pm is not p:
                    upd = upd.redistribute(p.device_mesh, p.placements)
                p.copy_(upd)
                del u, new, upd, pm
            state["opt"] = {"step": step + 1,
                            **{k: tree_unflatten(tree, t)
                               for k, t in trees.items()}}
        metrics = {k: _whole(v.detach()) for k, v in metrics.items()}
        metrics.update(loss=_whole(loss.detach()), grad_norm=_whole(gnorm))
        return state, metrics

    return train_step


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as one value: a DTensor's partial or sharded parts
    combined (every rank gets it)."""
    return t.full_tensor() if is_dtensor(t) else t


def make_decode_step(model: LMModel) -> Callable:
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode_step


def make_prefill_step(model: LMModel, cache_len: int) -> Callable:
    """``prefill_step(params, batch, cache=None)``: a fresh cache of
    ``cache_len`` slots unless one is given (on a mesh, a placed one:
    :func:`cache_shardings`)."""
    def prefill_step(params, batch, cache=None):
        if cache is None:
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
    # each step's seconds: the step and its loss read back, no checkpoint
    step_s: list = dataclasses.field(default_factory=list)


def train_loop(model: LMModel, *, steps: int, batcher,
               ckpt: CheckpointManager, optimizer: Optimizer | None = None,
               ckpt_every: int = 10, seed: int = 0,
               injector: FailureInjector | None = None,
               straggler_factor: float = 3.0,
               grad_compression: bool = False,
               shardings: dict | None = None,
               log: Callable[[str], None] = lambda s: None) -> LoopReport:
    """Fault-tolerant loop: restores from the newest committed checkpoint
    (or initialises from ``seed`` and snapshots that as step -1),
    checkpoints every ``ckpt_every`` steps and at the last, and on a
    :class:`NodeFailure` restarts from the last checkpoint — the
    deterministic data pipeline replays the same batches.  With
    ``shardings`` (:func:`state_shardings`, the model on their mesh) the
    state is sharded, and a restore reads each rank's shards."""
    resolve_device(model.device)     # a CUDA model needs a card
    optimizer = optimizer or adamw(cosine_schedule(3e-4, 10, steps))
    train_step = make_train_step(model, optimizer,
                                 grad_compression=grad_compression)

    def load_or_init():
        tree, meta = ckpt.restore(shardings=shardings)
        if tree is None:
            state = init_train_state(model, optimizer, seed,
                                     grad_compression=grad_compression)
            if shardings is not None:
                state = shard_state(state, shardings)
            return state, 0
        return state_from_jax(tree, model, shardings), meta["step"] + 1

    report = LoopReport()
    state, start = load_or_init()
    if start == 0:
        ckpt.save(-1, state_to_jax(state))  # step "-1" = init snapshot
        ckpt.wait()
    step = start
    durations = report.step_s
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
