"""Serving launcher: batched prefill + greedy decode over a contiguous KV
cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_7b \\
        [--int8] [--batch 4 --prompt-len 32 --gen 16] [--no-scan] \\
        [--device cpu --smoke]

``--arch`` takes any config the port builds: the dense ones, the MoE
family (``granite_moe_1b_a400m``; ``deepseek_v2_236b``, whose MLA cache
holds the compressed ``ckv``/``krope``), the SSM family
(``xlstm_125m``: mLSTM/sLSTM pairs, a recurrent state of one size at any
context) and the hybrid one (``zamba2_2p7b``: Mamba2 blocks and one
weight-shared attention+MLP block every ``hybrid_period`` layers).  The
encoder-decoder family has its own entry point,
:mod:`repro_torch.launch.whisper_serve`.

One prefill fills the cache, then ``--gen`` greedy tokens are generated
(the first from the prefill's logits).  On the card the decode attention
runs the flash_decode kernel (MLA's is plain PyTorch, as in the JAX
package; zamba2's shared block takes it at head_dim 80, on the fp32
CUDA-core variant) and, under ``--int8`` (the int8-mlp policy of the JAX
package's ``examples/serve_lm.py``: ``*mlp*`` → int8), the MLP products
run the quant_matmul kernel: in an MoE model the shared experts', in
zamba2 the shared block's ``mlp/w_*``; xLSTM's products are named
``mlstm/…`` and ``slstm/…``, so the rule matches none of them and
``--int8`` changes nothing there.  The SSM mixers are plain PyTorch, as
they are outside any Pallas kernel in the JAX package.  There is no
switch to turn the kernels off.  The default decode loop keeps the
greedy tokens on the device and reads them back once (the counterpart of
the JAX package's ``lax.scan``); ``--no-scan`` reads every token back to
the host before the next step.  Both give the same tokens.

Timing: a warm-up pass runs first (it builds the kernels), and prefill is
timed apart from decode — ``prefill_s`` and ``decode_tokens_per_s`` are
independent numbers; with ``--device cuda`` each ends in a synchronise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import lm_tokens
from repro_torch.models.api import build_model
from repro_torch.quant.policy import INT8, PrecisionPolicy
from repro_torch.serving.engine import greedy_argmax


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return greedy_argmax(logits[:, -1:]).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class ServeFns:
    """The serving entry points: ``prefill(params, batch, cache)``,
    ``decode_scan(params, cache, tok, steps)`` (tokens stay on the device)
    and ``decode_one(params, cache, tok)``."""
    prefill: Callable[..., Any]
    decode_scan: Callable[..., Any]
    decode_one: Callable[..., Any]


def make_serve_fns(model) -> ServeFns:
    def _decode_scan(params, cache, tok, steps: int):
        toks = []
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, tok)
            tok = _greedy(logits)
            toks.append(tok)
        return torch.cat(toks, dim=1), cache

    return ServeFns(prefill=model.prefill, decode_scan=_decode_scan,
                    decode_one=model.decode_step)


def generate(model, params, prompts: torch.Tensor, gen: int,
             cache_len: int, *, scan: bool = True,
             fns: ServeFns | None = None,
             cache_dtype: torch.dtype = torch.bfloat16,
             frames: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy-generate ``gen`` tokens after prefilling ``prompts`` (B, S)
    (all of one length: the cache position is batch-shared) into a
    ``cache_dtype`` cache; an enc-dec model's prefill also encodes
    ``frames`` (B, n_frames, d_model).  Returns (B, gen) int32 on the
    model's device."""
    fns = fns or make_serve_fns(model)
    return timed_generate(model, params, prompts, gen, cache_len,
                          scan=scan, fns=fns, cache_dtype=cache_dtype,
                          frames=frames)[0]


def timed_generate(model, params, prompts: torch.Tensor, gen: int,
                   cache_len: int, *, fns: ServeFns, scan: bool = True,
                   cache_dtype: torch.dtype = torch.bfloat16,
                   frames: torch.Tensor | None = None):
    """One timed prefill + decode pass.  Returns (tokens,
    {"prefill_s", "decode_s"}); the argmax of the prefill logits counts
    on the decode side of the split, and an enc-dec model's encoder runs
    inside ``prefill_s``.  Run :func:`generate` once first so that
    building the kernels stays out of the timed region."""
    dev = model.device
    prompts = prompts.to(dev)
    b = prompts.shape[0]
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames.to(dev)
    cache = model.init_cache(b, cache_len, cache_dtype)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = fns.prefill(params, batch, cache)
    _sync(dev)
    t1 = time.perf_counter()
    tok = _greedy(logits)
    out = [tok]
    if gen > 1:
        if scan:
            rest, _ = fns.decode_scan(params, cache, tok, gen - 1)
            out.append(rest)
        else:
            for _ in range(gen - 1):
                logits, cache = fns.decode_one(params, cache, tok)
                tok = _greedy(logits).cpu().to(dev)   # host round trip
                out.append(tok)
    toks = torch.cat(out, dim=1)
    _sync(dev)
    t2 = time.perf_counter()
    return toks, {"prefill_s": t1 - t0, "decode_s": t2 - t1}


def serve_policy(int8: bool) -> PrecisionPolicy:
    """bf16 throughout, or the int8-mlp policy (``*mlp*`` → int8)."""
    policy = PrecisionPolicy(default="bf16")
    return policy.with_rule("*mlp*", INT8) if int8 else policy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1",
                    help="one device only: 1x1")
    ap.add_argument("--int8", action="store_true",
                    help="serve under the int8-mlp policy")
    ap.add_argument("--no-scan", action="store_true",
                    help="read every token back before the next step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh}: the port serves on one "
                         f"device (1x1) only")

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.enc_dec:
        raise SystemExit("use python -m repro_torch.launch.whisper_serve "
                         "for enc-dec")
    model = build_model(cfg, serve_policy(args.int8), device=args.device)
    params = model.init(seed=0)
    toks = lm_tokens(args.batch * args.prompt_len, cfg.vocab_size,
                     seed=1).reshape(args.batch, args.prompt_len)
    prompts = torch.from_numpy(toks)
    cache_len = args.prompt_len + args.gen + 1
    scan = not args.no_scan
    fns = make_serve_fns(model)
    generate(model, params, prompts, args.gen, cache_len, scan=scan,
             fns=fns)                                   # warm-up
    out, t = timed_generate(model, params, prompts, args.gen, cache_len,
                            scan=scan, fns=fns)
    decode_tokens = args.batch * (out.shape[1] - 1)
    print(json.dumps({
        "arch": cfg.name, "device": str(model.device),
        "policy": "int8-mlp" if args.int8 else "bf16",
        "batch": args.batch, "prompt_len": args.prompt_len,
        "generated": int(out.shape[1]), "scan": scan,
        "prefill_s": t["prefill_s"],
        "prefill_tokens_per_s": args.batch * args.prompt_len
        / max(t["prefill_s"], 1e-9),
        "decode_s": t["decode_s"],
        "decode_tokens_per_s": decode_tokens / max(t["decode_s"], 1e-9),
        "sample": out[0, :8].tolist(),
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
