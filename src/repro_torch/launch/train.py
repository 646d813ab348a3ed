"""Training launcher: the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        [--smoke] [--steps 50] [--ckpt-dir DIR] [--inject-failures 5,9] \\
        [--grad-compression] [--mesh DxM] [--int8] [--device cpu]

The same flags as the JAX launcher, plus ``--device`` (CUDA unless it
names another) and ``--int8`` (the int8-mlp policy: every ``mlp/…``
product through quant_matmul).  It runs ``runtime/train_loop.py::train_loop``: the
deterministic data pipeline, atomic async checkpoints, restarts from the
newest committed step after an injected node failure, and int8 gradient
compression with error feedback.

Without ``--mesh`` the model trains on one device with plain tensors.
``--mesh DxM`` trains on a ("data", "model") device mesh, clamped to the
world as the reference's ``make_host_mesh`` clamps it to the local
devices: parameters, moments and batches are DTensors placed by the
logical-axis rules (``parallel/sharding.py``), checkpoints keep the JAX
layout.  The world comes from the usual ``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``/``MASTER_PORT`` environment (gloo on the CPU, NCCL on
the card; ``LOCAL_RANK`` picks the card), or from a default process group
the caller already started; with neither (no ``WORLD_SIZE``) the world
is this one device, any ``--mesh`` clamps to 1 x 1, and it trains as
without one.  The last output (rank 0's) is the reference's JSON report.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ShardedBatcher, TokenSource
from repro_torch.launch.mesh import host_mesh_shape, make_host_mesh
from repro_torch.launch.serve import serve_policy
from repro_torch.models.api import build_model
from repro_torch.models.common import resolve_device
from repro_torch.optim.optimizers import adamw, cosine_schedule
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.runtime.train_loop import (FailureInjector, state_shardings,
                                            train_loop)

__all__ = ["host_mesh_shape", "main"]


def _start_world(device: torch.device) -> bool | None:
    """The default process group from the environment (NCCL for a card,
    gloo for the CPU), unless one runs: True if this call started it,
    False if one ran, None if there is no world (no ``WORLD_SIZE``)."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ:
        return None
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--mesh", default=None,
                    help="dataxmodel, e.g. 2x4 (the world's ranks); "
                         "without it one device, no mesh")
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps to fail at")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="the int8-mlp policy")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    started = None
    mesh = rules = shardings = None
    rank = 0
    if args.mesh is not None:
        started = _start_world(device)
    if started is not None:
        rank = dist.get_rank()
        dp, tp = (int(t) for t in args.mesh.split("x"))
        mesh = make_host_mesh(dp, tp, device)
        rules = ShardingRules.default(mesh)
    try:
        model = build_model(cfg, serve_policy(True) if args.int8 else None,
                            device=device, mesh=mesh)
        if mesh is not None:
            shardings = state_shardings(model, rules, "adamw")
        source = TokenSource(cfg.vocab_size, args.batch, args.seq_len)
        batcher = ShardedBatcher(source, rules, device=model.device)
        ckpt_dir = args.ckpt_dir
        if ckpt_dir is None:
            ckpt_dir = [tempfile.mkdtemp(prefix="repro_ckpt_")
                        if rank == 0 else None]
            if mesh is not None:       # one directory for every rank
                dist.broadcast_object_list(ckpt_dir, src=0)
            ckpt_dir = ckpt_dir[0]
        ckpt = CheckpointManager(ckpt_dir)
        injector = None
        if args.inject_failures:
            injector = FailureInjector(
                tuple(int(s) for s in args.inject_failures.split(",")))
        optimizer = adamw(cosine_schedule(args.lr, 10, args.steps))

        report = train_loop(
            model, steps=args.steps, batcher=batcher, ckpt=ckpt,
            optimizer=optimizer, ckpt_every=args.ckpt_every,
            injector=injector,
            grad_compression=args.grad_compression,
            shardings=shardings,
            log=print if rank == 0 else (lambda s: None))
        n_dev = 1 if mesh is None else mesh.size()
    finally:
        if started:
            dist.destroy_process_group()

    if rank == 0:
        print(json.dumps({
            "arch": cfg.name, "steps_run": report.steps_run,
            "restarts": report.restarts,
            "straggler_events": report.straggler_events,
            "first_loss": report.losses[0] if report.losses else None,
            "final_loss": report.final_loss,
            "step_ms": [1e3 * t for t in report.step_s],
            "ckpt_dir": ckpt_dir,
            "devices": n_dev,
            "mesh": None if mesh is None else list(mesh.shape),
        }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
