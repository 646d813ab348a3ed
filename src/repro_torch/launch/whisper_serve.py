"""Enc-dec (whisper-small family) serving: encode the frames once, cache
every decoder layer's cross K/V, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.whisper_serve \\
        [--batch 2 --gen 16] [--full] [--device cpu]

Without ``--full`` it runs ``whisper-smoke`` (2 + 2 layers, d_model 64,
16 frames); with it whisper-small (12 + 12 layers, d_model 768, 1,500
frames).  The frames are the conv frontend's stub, as in the JAX
package's ``examples/whisper_serve.py``: precomputed frame embeddings,
here drawn from a numpy seed (normal, scaled by 0.1); the weights come
from seed 0.  The decoder prompt is BOS (token 0).  ``prefill`` encodes
the frames into the cache's cross K/V and runs the prompt; each decode
step then attends its self cache through the flash_decode kernel on the
card and the cached frames through the chunked attention.  A warm-up
pass runs first (it builds the kernels), and ``prefill_s`` (encoder
included) is timed apart from the decode steps.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import (generate, make_serve_fns, serve_policy,
                                      timed_generate)
from repro_torch.models.api import build_model

BOS = 0


def stub_frames(batch: int, n_frames: int, d_model: int,
                seed: int = 1) -> torch.Tensor:
    """(batch, n_frames, d_model) fp32 post-conv frame embeddings."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n_frames, d_model)) * 0.1
    return torch.from_numpy(x.astype(np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="whisper-small itself, not the smoke config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("whisper_small", smoke=not args.full)
    model = build_model(cfg, serve_policy(False), device=args.device)
    params = model.init(seed=0)
    frames = stub_frames(args.batch, cfg.n_frames, cfg.d_model)
    bos = torch.full((args.batch, 1), BOS, dtype=torch.int32)
    cache_len = args.gen + 2
    fns = make_serve_fns(model)
    generate(model, params, bos, args.gen, cache_len, fns=fns,
             frames=frames)                             # warm-up
    out, t = timed_generate(model, params, bos, args.gen, cache_len,
                            fns=fns, frames=frames)
    cross = cfg.n_layers * cfg.n_frames * 2 * cfg.n_kv_heads * cfg.hd * 2
    print(json.dumps({
        "arch": cfg.name, "device": str(model.device), "policy": "bf16",
        "batch": args.batch, "frames": cfg.n_frames,
        "generated": int(out.shape[1]),
        "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
        "decode_tokens_per_s": args.batch * (out.shape[1] - 1)
        / max(t["decode_s"], 1e-9),
        "cross_kv_bytes_per_request": cross,
        "sample": out[0, :8].tolist(),
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
