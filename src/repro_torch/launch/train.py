"""Training launcher: the JAX package's ``launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        [--smoke] [--steps 50] [--ckpt-dir DIR] [--inject-failures 5,9] \\
        [--grad-compression] [--device cpu]

The same flags as the JAX launcher, plus ``--device`` (CUDA unless it
names another).  It runs ``runtime/train_loop.py::train_loop``: the
deterministic data pipeline, atomic async checkpoints, restarts from the
newest committed step after an injected node failure, and int8 gradient
compression with error feedback.  ``--mesh`` is clamped to the devices
there are, as the JAX package's ``make_host_mesh`` clamps it; a mesh
larger than 1 x 1 waits for the distribution slice.  The last output is
the reference's JSON report.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ShardedBatcher, TokenSource
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import adamw, cosine_schedule
from repro_torch.runtime.train_loop import FailureInjector, train_loop


def host_mesh_shape(data: int, model: int, n: int) -> tuple[int, int]:
    """``(data, model)`` clamped to ``n`` devices, as the JAX package's
    ``make_host_mesh`` clamps them."""
    data = min(data, n)
    return data, max(1, min(model, n // data))


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
    ap.add_argument("--mesh", default="1x1",
                    help="dataxmodel, e.g. 2x4 (local devices)")
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps to fail at")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    n_dev = torch.cuda.device_count() if model.device.type == "cuda" else 1
    dp, tp = (int(t) for t in args.mesh.split("x"))
    mesh = host_mesh_shape(dp, tp, n_dev)
    if mesh != (1, 1):
        raise NotImplementedError(
            f"--mesh {args.mesh} resolves to {mesh[0]}x{mesh[1]} devices; "
            f"a mesh waits for the distribution slice (parallel/sharding.py)")
    source = TokenSource(cfg.vocab_size, args.batch, args.seq_len)
    batcher = ShardedBatcher(source, None, device=model.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
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
        log=print)

    print(json.dumps({
        "arch": cfg.name, "steps_run": report.steps_run,
        "restarts": report.restarts,
        "straggler_events": report.straggler_events,
        "first_loss": report.losses[0] if report.losses else None,
        "final_loss": report.final_loss,
        "ckpt_dir": ckpt_dir,
        "devices": n_dev,
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
