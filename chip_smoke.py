#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each printing one JSON line or more:

1. device    — ``nvidia-smi`` name and power limit;
2. build     — every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, one
               process per source, all started together);
3. kernels   — each kernel against its plain PyTorch version on CUDA
               tensors at smoke and full-width shapes: the attention
               kernels and block_sparse_matmul in fp32 and bf16 within
               tolerance, quant_matmul exactly equal (int32 wrap past
               K = 133,143 included); each wrapper's shared-memory model
               against the number its kernel library exports;
4. cpu_vs_gpu — Qwen2-7B at full width cut to 2 layers in fp32: the port
               on the CPU (plain versions) and on the card (kernels) must
               emit equal greedy tokens — the paged engine through a
               preemption and restore, then contiguous ``generate`` and
               the serial-admission engine under the bf16 and the
               int8-mlp policy;
5. serve     — all 28 layers of Qwen2-7B in bf16: the paged engine serving
               a 16-request burst (8 sharing a 256-token prefix), then
               contiguous ``generate`` (batch 8, 512-token prompts, 64 new
               tokens) under the bf16 and the int8-mlp policy; each run's
               launch counts must match its layers × steps;
6. timing    — kernel, plain-version, roofline-bound and library times at
               the phase-5 shapes, and at the phase-8 shapes for
               block_sparse_matmul and flash_attention;
8. tune      — the TUNE O-task's flow at full width: ``ModelGen``
               (Qwen2-7B, 28 layers, bf16, seed 0) → a 50 % block mask
               on ``lm_head`` (standing in for PRUNING, whose LM path
               fine-tunes and waits for the training slice) → ``Tune``
               over the four largest problems, with launch counts equal
               to the trials' (warmup + iters), a second execution all
               cache hits, and the tuned dispatchers against their plain
               versions.  Runs before phase 6, whose rows report its
               launch counts.

Then one ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line, and the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits 2 and prints no
result.  Longer logs go to ``chiprun_out/``.

Phase 7 (profile: torch.profiler over a shortened phase-5 burst and over
16 contiguous decode steps under each policy — device busy share, the top
kernels and host ops) runs only when asked.

Usage: ``python3 chip_smoke.py [--phases 1,2,3,4,5,6,8[,7]]``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
H100_INT8_OPS = 1979e12             # dense int8 tensor-core peak
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores
FP32_TOL = 2e-5                     # as tests/test_paged.py
MM_FP32_REL = 1e-5                  # fp32 products: of the largest output
KERNELS = ("flash_decode_paged", "flash_prefill_ragged", "flash_decode",
           "quant_matmul", "block_sparse_matmul", "flash_attention")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bf16_tol(ref) -> float:
    """Kernel and plain version both accumulate in fp32 (in different
    orders) and round once to bf16, so an output may land one bf16 ulp
    apart: at most 2**-7 of the largest output magnitude."""
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-6


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    import torch
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    ptxas = {}
    for name in libs:
        log = _build.build_log.get(name, "")
        (OUT / f"build_{name}.log").write_text(log)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "build", "seconds": round(secs, 3),
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "ptxas": ptxas})


def _decode_inputs(gen, r, h, kvh, d, ps, m, seq_lens, dtype):
    import torch
    from repro_torch.models import layers as L
    n_pages = r * m + 1
    q = torch.randn((r, 1, h, d), generator=gen).to(dtype)
    kp = torch.randn((n_pages, ps, kvh, d), generator=gen).to(dtype)
    vp = torch.randn((n_pages, ps, kvh, d), generator=gen).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    bt = perm[:r * m].reshape(r, m).to(torch.int32)
    sl = torch.tensor(seq_lens, dtype=torch.int32)
    mask = L.paged_decode_attention_mask(L.paged_kv_positions(sl, m * ps),
                                         sl)
    return [t.cuda() for t in (q, kp, vp, bt, mask)]


def _prefill_inputs(gen, r, s, h, kvh, d, ps, m, offs, lens, dtype):
    import torch
    n_pages = r * m + 1
    q = torch.randn((r, s, h, d), generator=gen).to(dtype)
    kp = torch.randn((n_pages, ps, kvh, d), generator=gen).to(dtype)
    vp = torch.randn((n_pages, ps, kvh, d), generator=gen).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    bt = perm[:r * m].reshape(r, m).to(torch.int32)
    off = torch.tensor(offs, dtype=torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32)
    return [t.cuda() for t in (q, kp, vp, bt, off, ln)]


def _compare(name, out, ref, dtype, worst, case, fp32_tol=None):
    import torch
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name} {case}: {out.dtype} {tuple(out.shape)} "
                             f"!= plain {ref.dtype} {tuple(ref.shape)}")
    err = float((out.float() - ref.float()).abs().max())
    if dtype != torch.float32:
        tol = bf16_tol(ref)
    else:
        tol = FP32_TOL if fp32_tol is None else fp32_tol
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{name} {case}: max abs err {err} > {tol}")
    key = str(dtype).removeprefix("torch.")
    worst[name][key] = max(worst[name].get(key, 0.0), err)


def _kernel_modules() -> dict:
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in KERNELS}


def _zero_counts() -> None:
    for mod in _kernel_modules().values():
        mod.launches = 0


def _read_counts() -> dict:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def _contig_inputs(gen, b, cache_len, h, kvh, d, dtype):
    import torch
    q = torch.randn((b, 1, h, d), generator=gen).to(dtype)
    k = torch.randn((b, cache_len, kvh, d), generator=gen).to(dtype)
    v = torch.randn((b, cache_len, kvh, d), generator=gen).to(dtype)
    return [t.cuda() for t in (q, k, v)]


def _contig_masks(cache_len: int) -> list:
    """Linear-cache masks at position 0, mid-cache and full, and two
    sliding-window ring masks after the ring wrapped (live slots not a
    prefix), from the model layer's own helpers."""
    from repro_torch.models import layers as L
    out = []
    for pos, window in ((0, 0), (cache_len // 2, 0), (cache_len - 1, 0),
                        (cache_len + cache_len // 3, cache_len),
                        (2 * cache_len + 5, cache_len // 2 + 1)):
        kv_pos = L.kv_positions_for_cache(pos, cache_len, window,
                                          device="cuda")
        out.append(((pos, window),
                    L.decode_attention_mask(kv_pos, pos, window)))
    return out


QMM_SHAPES = ((8, 3584, 18944), (8, 18944, 3584), (4096, 3584, 18944),
              (4096, 18944, 3584), (3, 56, 40), (5, 100, 17),
              (130, 72, 200), (128, 152064, 3584))


def _check_quant_matmul(gen) -> int:
    """quant_matmul against its plain version, exactly: the decode
    (M = 8) and prefill (M = 4096) shapes of Qwen2-7B's MLP, and ragged
    shapes whose K is no multiple of 16 (the kernel's scalar load path)."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    n = 0
    for m, k, nn in QMM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            if (m == 4096 or k > 100_000) and dtype == torch.float32:
                continue
            x = torch.randn((m, k), generator=gen).to(dtype).cuda()
            w = (0.02 * torch.randn((k, nn), generator=gen)).to(dtype).cuda()
            out = qmm.quant_matmul(x, w)
            ref = qmm.quant_matmul_plain(x, w)
            torch.cuda.synchronize()
            if out.shape != (m, nn) or not torch.equal(out, ref):
                bad = int((out != ref).sum()) if out.shape == ref.shape \
                    else -1
                raise AssertionError(
                    f"quant_matmul {(m, k, nn)} {dtype}: {bad} elements "
                    f"differ from the plain version")
            n += 1
    # every product at +-127: 127 * 127 * 152,064 passes 2**31, so the
    # int32 sums wrap (to negative values) in the kernel and the plain
    # version alike
    x = torch.ones((8, 152064), device="cuda")
    w = torch.ones((152064, 64), device="cuda")
    w[:, 32:] = -1.0
    out = qmm.quant_matmul(x, w)
    ref = qmm.quant_matmul_plain(x, w)
    torch.cuda.synchronize()
    if not torch.equal(out, ref) or not bool((out[:, :32] < 0).all()):
        raise AssertionError(f"quant_matmul int32 wrap: kernel {out[0, :2]} "
                             f"plain {ref[0, :2]}")
    return n + 1


# index lists of a (384, 256) weight (3 x 2 blocks): a dead column and a
# dense one; then a column that skips block 1 (nonzero in w, never read)
BSMM_KINDEX = {"dead_and_dense": [[-1, -1, -1], [0, 1, 2]],
               "excluded_nonzero": [[0, 2], [1, -1]]}


def _check_block_sparse(gen, worst) -> int:
    """block_sparse_matmul against its plain version: the CPU tests'
    (256, 384) @ (384, 256) cases, then problem 3 of phase 8 — Qwen2-7B's
    lm_head shape (3584, 152064) under a 50 % block mask from
    ``sparsity.masks.block_mask``, at M = 128 — with the masked weight and
    with the unmasked one (blocks outside kindex must not be read)."""
    import torch
    from repro_torch.kernels import block_sparse_matmul as bsmm
    from repro_torch.sparsity.masks import block_map, block_mask
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((256, 384), generator=gen).to(dtype).cuda()
        w = torch.randn((384, 256), generator=gen).to(dtype).cuda()
        for case, rows in BSMM_KINDEX.items():
            kidx = torch.tensor(rows, dtype=torch.int32, device="cuda")
            ref = bsmm.block_sparse_matmul_plain(x, w, kidx)
            for bm in (32, 64, 128):
                _compare("block_sparse_matmul",
                         bsmm.block_sparse_matmul(x, w, kidx, block_m=bm),
                         ref, dtype, worst, (case, bm),
                         MM_FP32_REL * float(ref.float().abs().max()))
                n += 1
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((128, 3584), generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn((3584, 152064), generator=g, device="cuda")).to(
        torch.bfloat16)
    mask = block_mask(w, 0.5)
    kidx = torch.from_numpy(bsmm.compact_block_index(block_map(mask))).cuda()
    wm = (w.float() * mask).to(w.dtype)
    del mask
    for label, ww in (("masked", wm), ("unmasked", w)):
        ref = bsmm.block_sparse_matmul_plain(x, ww, kidx)
        for bm in (32, 64, 128):
            _compare("block_sparse_matmul",
                     bsmm.block_sparse_matmul(x, ww, kidx, block_m=bm), ref,
                     torch.bfloat16, worst, ("lm_head", label, bm))
            n += 1
    xf, wf = x.float(), wm.float()
    del w, wm
    ref = bsmm.block_sparse_matmul_plain(xf, wf, kidx)
    _compare("block_sparse_matmul", bsmm.block_sparse_matmul(xf, wf, kidx),
             ref, torch.float32, worst, ("lm_head", "fp32"),
             MM_FP32_REL * float(ref.abs().max()))
    return n + 1


def _check_flash_attention(gen, worst) -> int:
    """flash_attention against its plain version: the CPU tests' grid
    (g in {1, 2, 4}, Sq = Skv in {64, 100}, causal on and off, window in
    {0, 16}, tiles (32, 32) and (64, 32)) at D = 64, then Qwen2-7B's
    shapes (H = 28 over KV = 4, g = 7, D = 128): problem 4 of phase 8
    (1, 512) in fp32 under every tile pair that fits, and prefill scale
    (1, 4096) in bf16, causal and causal with a 1,024-key window."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for g in (1, 2, 4):
            for s in (64, 100):
                q = torch.randn((2, s, 4, 64), generator=gen).to(dtype).cuda()
                k = torch.randn((2, s, 4 // g, 64), generator=gen).to(
                    dtype).cuda()
                v = torch.randn((2, s, 4 // g, 64), generator=gen).to(
                    dtype).cuda()
                for causal in (True, False):
                    for window in (0, 16):
                        ref = fa.flash_attention_plain(
                            q, k, v, causal=causal, window=window)
                        for bq, bkv in ((32, 32), (64, 32)):
                            _compare("flash_attention", fa.flash_attention(
                                q, k, v, causal=causal, window=window,
                                block_q=bq, block_kv=bkv), ref, dtype, worst,
                                (g, s, causal, window, bq, bkv))
                            n += 1
    g = torch.Generator(device="cuda").manual_seed(4)
    for s, dtype, cases in (
            (512, torch.float32, [(True, 0), (True, 128), (False, 128)]),
            (4096, torch.bfloat16, [(True, 0), (True, 1024)])):
        q = torch.randn((1, s, 28, 128), generator=g, device="cuda").to(dtype)
        k = torch.randn((1, s, 4, 128), generator=g, device="cuda").to(dtype)
        v = torch.randn((1, s, 4, 128), generator=g, device="cuda").to(dtype)
        tiles = [(bq, bkv) for bq in fa.Q_TILES for bkv in fa.Q_TILES
                 if fa.smem_bytes(bq, bkv, 128, dtype) <= fa.SMEM_LIMIT]
        if s > 512:
            tiles = [(128, 128), (64, 64)]
        for causal, window in cases:
            ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
            for bq, bkv in tiles:
                _compare("flash_attention", fa.flash_attention(
                    q, k, v, causal=causal, window=window, block_q=bq,
                    block_kv=bkv), ref, dtype, worst,
                    (s, causal, window, bq, bkv))
                n += 1
            del ref
    return n


def _check_smem_models() -> int:
    """Each wrapper's Python shared-memory model (what the autotuner
    filters on and the wrapper checks) equals the number its kernel
    library computes for the launch."""
    from repro_torch.kernels import block_sparse_matmul as bsmm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_decode_paged as fdp
    from repro_torch.kernels import flash_prefill_ragged as fpr
    pairs = []
    for code, name in ((0, "float32"), (1, "bfloat16")):
        for bm in (8, 32, 64, 96, 128, 256):
            pairs.append((("bsmm", bm, name), bsmm.smem_bytes(bm, name),
                          bsmm._lib().block_sparse_matmul_smem_bytes(bm,
                                                                     code)))
        for bq in fa.Q_TILES:
            for bkv in (32, 64, 96, 128, 256):
                for d in fa.HEAD_DIMS:
                    pairs.append((("fa", bq, bkv, d, name),
                                  fa.smem_bytes(bq, bkv, d, name),
                                  fa._lib().flash_attention_smem_bytes(
                                      bq, bkv, d, code)))
    for g in (1, 2, 7):
        for d in (8, 64, 128):
            pairs.append((("fd", g, d), fd.smem_bytes(g, d),
                          fd._lib().flash_decode_smem_bytes(g, d)))
            for ps in (4, 8, 16, 48, 64, 128, 256):
                pairs.append((("fdp", g, d, ps), fdp.smem_bytes(g, d, ps),
                              fdp._lib().flash_decode_paged_smem_bytes(
                                  g, d, ps)))
                for bq in (1, 8, 32):
                    pairs.append((("fpr", bq, g, d, ps),
                                  fpr.smem_bytes(bq, g, d, ps),
                                  fpr._lib().flash_prefill_ragged_smem_bytes(
                                      bq, g, d, ps)))
    bad = [(case, py, c) for case, py, c in pairs if py != c]
    if bad:
        raise AssertionError(f"shared-memory models differ from the kernels' "
                             f"(case, python, library): {bad[:8]}")
    return len(pairs)


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_decode_paged as fdp
    from repro_torch.kernels import flash_prefill_ragged as fpr
    gen = torch.Generator().manual_seed(0)
    worst = {"flash_decode_paged": {}, "flash_prefill_ragged": {},
             "flash_decode": {}}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        # smoke shapes: g in {1, 2, 7}, ps in {4, 8, 16}, D = 8
        for h, kvh in ((4, 4), (4, 2), (7, 1)):
            for ps in (4, 8, 16):
                r, m, d = 4, 3, 8
                cap = m * ps
                args = _decode_inputs(gen, r, h, kvh, d, ps, m,
                                      [0, cap // 2, cap - 1, 5], dtype)
                _compare("flash_decode_paged", fdp.flash_decode_paged(*args),
                         fdp.flash_decode_paged_plain(*args), dtype, worst,
                         (h, kvh, ps))
                s = 7                                  # not a multiple of bq
                args = _prefill_inputs(
                    gen, r, s, h, kvh, d, ps, m + 1,
                    [0, ps, 2 * ps + 1, 3], [s, 4, 0, 1], dtype)
                for bq in (32, 4):
                    _compare("flash_prefill_ragged",
                             fpr.flash_prefill_ragged(*args, block_q=bq),
                             fpr.flash_prefill_ragged_plain(*args), dtype,
                             worst, (h, kvh, ps, bq))
                n_cases += 3
        # full width: R = 8, H = 28, KV = 4, D = 128, ps = 16, M = 37
        r, h, kvh, d, ps, m = 8, 28, 4, 128, 16, 37
        cap = m * ps
        args = _decode_inputs(gen, r, h, kvh, d, ps, m,
                              [0, 1, 17, 255, 300, 511, 576, cap - 1],
                              dtype)
        _compare("flash_decode_paged", fdp.flash_decode_paged(*args),
                 fdp.flash_decode_paged_plain(*args), dtype, worst, "full")
        s = 77                                         # 3 tiles, last ragged
        args = _prefill_inputs(
            gen, r, s, h, kvh, d, ps, m,
            [0, 16, 256, 256, 100, 0, 500, 3], [77, 77, 40, 0, 77, 1, 77, 9],
            dtype)
        _compare("flash_prefill_ragged", fpr.flash_prefill_ragged(*args),
                 fpr.flash_prefill_ragged_plain(*args), dtype, worst, "full")
        n_cases += 2
        # contiguous decode: g in {1, 2, 7} at D = 8 over cache lengths a
        # tile divides, none divides and 577 = 512 + 64 + 1, then the
        # full-width serving shape; linear and wrapped-ring masks
        shapes = [(3, h, kvh, 8, n) for h, kvh in ((4, 4), (4, 2), (7, 1))
                  for n in (16, 37, 577)] + [(8, 28, 4, 128, 577)]
        for b, h, kvh, d, n in shapes:
            q, k, v = _contig_inputs(gen, b, n, h, kvh, d, dtype)
            for case, mask in _contig_masks(n):
                _compare("flash_decode", fd.flash_decode(q, k, v, mask),
                         fd.flash_decode_plain(q, k, v, mask), dtype, worst,
                         (b, h, kvh, d, n, case))
                n_cases += 1
    n_qmm = _check_quant_matmul(gen)
    worst["quant_matmul"] = {"bfloat16": 0.0, "float32": 0.0}
    worst["block_sparse_matmul"], worst["flash_attention"] = {}, {}
    n_cases += _check_block_sparse(gen, worst)
    n_cases += _check_flash_attention(gen, worst)
    n_smem = _check_smem_models()
    emit({"phase": "kernels", "cases": n_cases + n_qmm, "fp32_tol": FP32_TOL,
          "block_sparse_fp32_tol": "1e-5 * max|plain|",
          "bf16_tol": "2**-7 * max|plain| + 1e-6 (one bf16 ulp)",
          "quant_matmul": f"{n_qmm} cases exactly equal, int32 wrap "
                          f"included",
          "smem_models_checked": n_smem, "max_abs_err": worst})
    return worst


def _requests(rng, n, prompt_len, n_shared, prefix_len, vocab, max_new):
    import numpy as np
    from repro_torch.serving import Request
    prefix = rng.integers(0, vocab, prefix_len)
    reqs = []
    for i in range(n):
        if i < n_shared:
            p = np.concatenate([prefix,
                                rng.integers(0, vocab,
                                             prompt_len - prefix_len)])
        else:
            p = rng.integers(0, vocab, prompt_len)
        reqs.append(Request(rid=i, prompt=p.astype(np.int32),
                            max_new_tokens=max_new))
    return reqs


def _copy_requests(reqs):
    from repro_torch.serving import Request
    return [Request(rid=r.rid, prompt=r.prompt.copy(),
                    max_new_tokens=r.max_new_tokens) for r in reqs]


def phase_cpu_vs_gpu() -> None:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.serving import PagedCacheConfig, PagedServingEngine
    cfg = get_config("qwen2_7b").replace(n_layers=2, param_dtype="float32",
                                         act_dtype="float32")
    policy = PrecisionPolicy(default="fp32")
    t0 = time.perf_counter()
    m_cpu = build_model(cfg, policy, device="cpu")
    lm_cpu = m_cpu.init(seed=0)
    gen = torch.Generator().manual_seed(1)
    for blk in lm_cpu.blocks:                  # exercise the QKV bias path
        for b in (blk.attn.bq, blk.attn.bk, blk.attn.bv):
            b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    m_gpu = build_model(cfg, policy, device="cuda")
    lm_gpu = m_gpu.empty_params()
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    t_init = time.perf_counter() - t0
    # 48 + 20 + 1 tokens need a 5th page that the admission (48 + 4 + 1)
    # does not back, and 15 allocatable pages cannot grow all four:
    # one preemption and one restore
    pcfg = PagedCacheConfig(page_size=16, n_pages=16, max_slots=4,
                            max_blocks=5, segment_len=4)
    reqs = _requests(np.random.default_rng(0), 4, 48, 2, 32,
                     cfg.vocab_size, 20)
    tokens, stats, secs = {}, {}, {}
    for name, model, lm in (("cpu", m_cpu, lm_cpu), ("gpu", m_gpu, lm_gpu)):
        rs = _copy_requests(reqs)
        t0 = time.perf_counter()
        st = PagedServingEngine(model, pcfg,
                                cache_dtype=torch.float32).run(rs, lm)
        secs[name] = round(time.perf_counter() - t0, 3)
        tokens[name] = {r.rid: list(r.tokens) for r in rs}
        stats[name] = {k: st[k] for k in ("preemptions", "restores",
                                          "n_finished", "prefix_hits")}
        if st["n_finished"] != 4 or st["preemptions"] < 1 \
                or st["restores"] < 1 \
                or any(len(r.tokens) != 20 for r in rs):
            raise AssertionError(f"phase 4 {name}: {stats[name]}")
    if tokens["cpu"] != tokens["gpu"]:
        raise AssertionError(f"CPU and GPU tokens differ: {tokens}")
    emit({"phase": "cpu_vs_gpu", "layers": cfg.n_layers,
          "d_model": cfg.d_model, "equal_tokens": True,
          "tokens_per_request": [len(t) for t in tokens["gpu"].values()],
          "stats": stats, "init_s": round(t_init, 3), "run_s": secs})
    _contiguous_cpu_vs_gpu(cfg, lm_cpu, lm_gpu)
    del lm_gpu, m_gpu
    torch.cuda.empty_cache()


# Under the bf16 and int8 policies a logit moves by ~0.01 between two fp32
# summation orders (bf16 operand rounding and int8 quantization flip on
# tiny differences), and a greedy step whose top-2 logits are closer than
# that may go either way.  This seed's two prompts keep every step's top-2
# gap several times wider on the CPU under both policies, found by running
# this model on the CPU over the first few seeds.
PHASE4_PROMPT_SEED = 3


def _contiguous_cpu_vs_gpu(cfg, lm_cpu, lm_gpu) -> None:
    """Contiguous ``generate`` and the serial-admission engine, CPU vs
    card, under the bf16 and the int8-mlp policy (fp32 activations and
    caches)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate, serve_policy
    from repro_torch.models.api import build_model
    from repro_torch.serving import (PagedCacheConfig, PagedServingEngine,
                                     Request)
    prompt_len, gen = 16, 8
    prompts = np.random.default_rng(PHASE4_PROMPT_SEED).integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    pcfg = PagedCacheConfig(page_size=16, n_pages=5, max_slots=2,
                            max_blocks=2, segment_len=4)
    out, secs = {}, {}
    for pname, int8 in (("bf16", False), ("int8-mlp", True)):
        res = {}
        for side, lm, dev in (("cpu", lm_cpu, "cpu"), ("gpu", lm_gpu,
                                                        "cuda")):
            model = build_model(cfg, serve_policy(int8), device=dev)
            t0 = time.perf_counter()
            g = generate(model, lm, torch.from_numpy(prompts), gen,
                         prompt_len + gen + 1, cache_dtype=torch.float32)
            # both prompts, then the first again with fewer new tokens: a
            # third admission that waits for a slot
            reqs = [Request(rid=i, prompt=prompts[i % 2].copy(),
                            max_new_tokens=gen - 3 * (i // 2))
                    for i in range(3)]
            st = PagedServingEngine(model, pcfg, cache_dtype=torch.float32,
                                    prefill_mode="serial").run(reqs, lm)
            secs[f"{pname}/{side}"] = round(time.perf_counter() - t0, 3)
            if st["n_finished"] != 3 or st["n_prefill_dispatches"] != 3:
                raise AssertionError(f"phase 4 serial {pname} {side}: {st}")
            res[side] = {"generate": g.cpu().tolist(),
                         "serial": {r.rid: list(r.tokens) for r in reqs}}
        if res["cpu"] != res["gpu"]:
            raise AssertionError(f"phase 4 {pname}: CPU and GPU tokens "
                                 f"differ: {res}")
        gpu = res["gpu"]
        if [gpu["serial"][0], gpu["serial"][1]] != gpu["generate"] \
                or gpu["serial"][2] != gpu["generate"][0][:gen - 3]:
            raise AssertionError(f"phase 4 {pname}: serial engine and "
                                 f"generate differ: {gpu}")
        out[pname] = res["gpu"]["generate"]
    emit({"phase": "cpu_vs_gpu_contiguous", "layers": cfg.n_layers,
          "equal_tokens": True, "batch": 2, "prompt_len": prompt_len,
          "gen": gen, "generate_tokens": out, "run_s": secs})


SERVE = dict(n=16, prompt_len=512, n_shared=8, prefix_len=256, max_new=64,
             page_size=16, max_slots=8, max_blocks=37, segment_len=8)


def _serve_engine():
    """Qwen2-7B at full width and depth in bf16 (random weights from seed
    0) behind the phase-5 engine, warmed up on one short request."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import (PagedCacheConfig, PagedServingEngine,
                                     warmup)
    c = SERVE
    cfg = get_config("qwen2_7b")
    t0 = time.perf_counter()
    model = build_model(cfg)                          # bf16 policy, cuda
    lm = model.init(seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pcfg = PagedCacheConfig(page_size=c["page_size"],
                            n_pages=c["max_slots"] * c["max_blocks"] + 1,
                            max_slots=c["max_slots"],
                            max_blocks=c["max_blocks"],
                            segment_len=c["segment_len"])
    eng = PagedServingEngine(model, pcfg)             # bf16 cache
    warmup(eng, lm, prompt_len=64, max_new_tokens=9)
    return cfg, pcfg, lm, eng, t_init


def phase_serve() -> dict:
    import numpy as np
    import torch
    c = SERVE
    cfg, pcfg, lm, eng, t_init = _serve_engine()
    reqs = _requests(np.random.default_rng(1), c["n"], c["prompt_len"],
                     c["n_shared"], c["prefix_len"], cfg.vocab_size,
                     c["max_new"])
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before, read just after
    _zero_counts()
    t0 = time.perf_counter()
    st = eng.run(reqs, lm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    expected = {
        "flash_decode_paged": cfg.n_layers * st["n_segments"]
        * pcfg.segment_len,
        "flash_prefill_ragged": cfg.n_layers * st["n_prefill_dispatches"],
        "flash_decode": 0, "quant_matmul": 0, "block_sparse_matmul": 0,
        "flash_attention": 0}
    n_tokens = sum(len(r.tokens) for r in reqs)
    bad = [r.rid for r in reqs
           if len(r.tokens) != c["max_new"]
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if bad or st["n_dead_lettered"] or st["n_finished"] != c["n"]:
        raise AssertionError(
            f"phase 5: bad requests {bad}, finished {st['n_finished']}, "
            f"dead-lettered {st['n_dead_lettered']}")
    if counts != expected or min(expected["flash_decode_paged"],
                                 expected["flash_prefill_ragged"]) < 1:
        raise AssertionError(f"launch counts {counts} != {expected}")
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": "bfloat16", **c, "init_s": round(t_init, 3),
          "wall_s": wall, "prefill_s": st["prefill_s"],
          "decode_s": st["decode_s"], "tokens": n_tokens,
          "tokens_per_s": n_tokens / wall,
          "n_segments": st["n_segments"],
          "n_prefill_dispatches": st["n_prefill_dispatches"],
          "prefix_hits": st["prefix_hits"],
          "preemptions": st["preemptions"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts, "expected_launches": expected})
    del eng
    torch.cuda.empty_cache()
    launches = {k: counts[k] for k in ("flash_decode_paged",
                                       "flash_prefill_ragged")}
    launches.update(phase_generate(cfg, lm))
    return launches


GENERATE = dict(batch=8, prompt_len=512, gen=64)


def phase_generate(cfg, lm) -> dict:
    """Contiguous ``generate`` at full width and depth in bf16 (batch 8,
    512-token prompts, 64 new tokens) once under the bf16 policy and once
    under the int8-mlp policy, on the phase-5 parameters (the policy lives
    on the model, not on the parameters).  Each run is a main path: counts
    set to 0 just before it, read just after.  Returns the launches of
    flash_decode (bf16 run) and quant_matmul (int8-mlp run)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.launch.serve import (generate, make_serve_fns,
                                          serve_policy, timed_generate)
    from repro_torch.models.api import build_model
    c = GENERATE
    b, s, n_gen = c["batch"], c["prompt_len"], c["gen"]
    prompts = torch.from_numpy(lm_tokens(b * s, cfg.vocab_size, seed=1)
                               .reshape(b, s).astype(np.int32))
    cache_len = s + n_gen + 1
    n_mlp = 3 if cfg.mlp == "glu" else 2
    launches = {}
    for pname, int8 in (("bf16", False), ("int8-mlp", True)):
        model = build_model(cfg, serve_policy(int8))
        fns = make_serve_fns(model)
        generate(model, lm, prompts[:, :64], 4, 69, fns=fns)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        toks, t = timed_generate(model, lm, prompts, n_gen, cache_len,
                                 fns=fns)
        counts = _read_counts()
        expected = {"flash_decode_paged": 0, "flash_prefill_ragged": 0,
                    "flash_decode": cfg.n_layers * (n_gen - 1),
                    "quant_matmul": n_mlp * cfg.n_layers * n_gen if int8
                    else 0, "block_sparse_matmul": 0, "flash_attention": 0}
        if counts != expected:
            raise AssertionError(f"generate {pname}: launch counts {counts} "
                                 f"!= {expected}")
        host = toks.cpu()
        if host.shape != (b, n_gen) or not bool(
                ((host >= 0) & (host < cfg.vocab_size)).all()):
            raise AssertionError(f"generate {pname}: bad tokens "
                                 f"{tuple(host.shape)}")
        decode_tokens = b * (n_gen - 1)
        emit({"phase": "generate", "arch": cfg.name, "layers": cfg.n_layers,
              "policy": pname, "dtype": "bfloat16", **c,
              "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
              "decode_step_ms": 1e3 * t["decode_s"] / (n_gen - 1),
              "decode_tokens_per_s": decode_tokens / t["decode_s"],
              "prefill_tokens_per_s": b * s / t["prefill_s"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts, "sample": host[0, :8].tolist()})
        if int8:
            launches["quant_matmul"] = counts["quant_matmul"]
        else:
            launches["flash_decode"] = counts["flash_decode"]
        del fns, model
        torch.cuda.empty_cache()
    return launches


def _block_masks_task():
    """A λ-task that puts ``handle.child(masks=build_masks(handle.params,
    rate, "block"))`` into the model space: it stands in for the PRUNING
    O-task, whose LM path fine-tunes and waits for the training slice."""
    from repro_torch.core.metamodel import LEVEL_DNN
    from repro_torch.core.task import LambdaTask
    from repro_torch.sparsity.masks import build_masks

    class BlockMasks(LambdaTask):
        defaults = {"rate": 0.5}

        def execute(self, meta, inputs):
            art = meta.model(inputs[0])
            handle = art.payload
            masks = build_masks(handle.params, self.param(meta, "rate"),
                                "block")
            child = handle.child(masks=masks)
            return [meta.add_model(f"{handle.name}+mask", LEVEL_DNN, child,
                                   parent=inputs[0],
                                   metrics=child.summary_metrics())]

    return BlockMasks()


def _tune_flow(cache_path):
    from repro_torch.core.flow import DesignFlow
    from repro_torch.tasks.model_gen import ModelGen
    from repro_torch.tasks.tune import Tune
    flow = DesignFlow("tune(qwen2-7b)")
    flow.chain(ModelGen(model="qwen2-7b", train_en=False, device="cuda"),
               _block_masks_task(),
               Tune(cache_path=cache_path, device="cuda"))
    return flow


def _expected_problems(max_live: int) -> list:
    """The four problems of ``derive_problems`` on Qwen2-7B with a block
    mask on lm_head, largest first (the JAX package's list)."""
    v, d = 152064, 3584
    return [
        {"kernel": "quant_matmul", "m": 128, "k": v, "n": d,
         "dtype": "bfloat16", "out_dtype": "float32"},
        {"kernel": "quant_matmul", "m": 128, "k": d, "n": v,
         "dtype": "bfloat16", "out_dtype": "float32"},
        {"kernel": "block_sparse_matmul", "m": 128, "k": d, "n": v,
         "block": 128, "max_live": max_live, "dtype": "bfloat16"},
        {"kernel": "flash_attention", "b": 1, "sq": 512, "h": 28, "d": 128,
         "skv": 512, "kv_heads": 4, "dtype": "float32", "causal": True,
         "window": 0}]


def phase_tune() -> dict:
    """MODEL-GEN → block mask → TUNE at full width on the card, executed
    twice: the first run's launch counts must equal the trials' (warmup +
    iters); then the tuned dispatchers and ``ops.masked_matmul`` on the
    real masked lm_head and at problem 4's shape against their plain
    versions; then, with the first run's model freed, the second run must
    hit the cache for every problem and launch nothing.  Returns the first
    run's launch counts."""
    import tempfile

    import torch
    from repro_torch.kernels import autotune
    from repro_torch.tasks.tune import derive_problems
    cache_path = str(Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
                     / "autotune.json")
    autotune.clear_memory_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    meta = _tune_flow(cache_path).execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    masked = meta.latest("dnn", lambda a: a.name.startswith("qwen2-7b+mask"))
    handle = masked.payload
    max_live = int(block_map_of(handle).sum(axis=0).max())
    problems = derive_problems(handle, device="cuda", cache_path=cache_path)
    if problems != _expected_problems(max_live):
        raise AssertionError(f"phase 8: derived problems {problems}")
    probes = meta.trace("tune.probe")
    done = meta.trace("tune.done")
    if [d["kernel"] for d in done] != [p["kernel"] for p in problems] \
            or any(d["cached"] for d in done):
        raise AssertionError(f"phase 8 first run: {done}")
    per_call = 1 + 3                                  # Tune's warmup + iters
    expected = {name: 0 for name in KERNELS}
    for p in probes:
        expected[p["kernel"]] += per_call
    if counts != expected:
        raise AssertionError(f"phase 8 launch counts {counts} != {expected}")
    tuned = meta.latest("dnn").payload.meta["tile_configs"]
    for d in done:
        trials = [p for p in probes if p["key"] == d["key"]]
        best = next(p for p in trials if p["config"] == d["config"])
        emit({"phase": "tune_problem", "kernel": d["kernel"],
              "problem": json.loads(d["key"].split("|", 1)[1]),
              "config": d["config"], "us": d["us"], "trials": len(trials),
              "smem_bytes": best["smem_bytes"],
              "smem_budget": best["smem_budget"],
              "trial_us": {json.dumps(p["config"], sort_keys=True): p["us"]
                           for p in trials}})
    gen_art = meta.latest("dnn", lambda a: a.parent is None)
    summary = {"phase": "tune", "arch": "qwen2-7b", "layers": 28,
               "dtype": "bfloat16", "accuracy": gen_art.metrics["accuracy"],
               "pruning": "50 % block mask on lm_head from build_masks; "
                          "stands in for the PRUNING O-task (LM pruning "
                          "fine-tunes and waits for the training slice)",
               "sparsity": masked.metrics["sparsity"], "max_live": max_live,
               "problems": len(problems),
               "search_steps": meta.get("tune.result")["search_steps"],
               "launches": counts, "expected_launches": expected,
               "wall_s": wall, "peak_mem_gb": peak, "tile_configs": tuned}
    summary["dispatch"] = _tuned_dispatch(handle, tuned, cache_path)
    del meta, masked, handle
    torch.cuda.empty_cache()

    _zero_counts()
    t0 = time.perf_counter()
    meta = _tune_flow(cache_path).execute()
    torch.cuda.synchronize()
    counts2 = _read_counts()
    probes2 = meta.trace("tune.probe")
    if len(probes2) != len(problems) or not all(p.get("cached")
                                                for p in probes2) \
            or any(counts2.values()):
        raise AssertionError(f"phase 8 second run: probes {probes2}, "
                             f"launches {counts2}")
    summary["second_run"] = {"cached_probes": len(probes2),
                             "launches": counts2,
                             "wall_s": time.perf_counter() - t0}
    emit(summary)
    del meta
    autotune.clear_memory_cache()
    torch.cuda.empty_cache()
    return counts


def block_map_of(handle):
    from repro_torch.sparsity.masks import block_map
    return block_map(handle.masks["lm_head"], 128)


def _tuned_dispatch(handle, tuned, cache_path) -> dict:
    """``tuned_block_sparse_matmul`` on the real masked lm_head with its
    mask's ``compact_block_index``, ``tuned_flash_attention`` at problem
    4's shape and ``ops.masked_matmul``: each launches its kernel once, the
    tuned_* at the tuned config (equal output to a direct launch with it),
    and matches its plain version."""
    import torch
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import block_sparse_matmul as bsmm
    from repro_torch.kernels import flash_attention as fa
    cfg = handle.model.cfg
    g = torch.Generator(device="cuda").manual_seed(5)
    mask = handle.masks["lm_head"]
    wm = handle.effective_params().lm_head.detach()
    x = torch.randn((128, wm.shape[0]), generator=g, device="cuda").to(
        wm.dtype)
    kidx = torch.from_numpy(bsmm.compact_block_index(
        block_map_of(handle))).cuda()
    q = torch.randn((1, 512, cfg.n_heads, cfg.hd), generator=g,
                    device="cuda")
    k = torch.randn((1, 512, cfg.n_kv_heads, cfg.hd), generator=g,
                    device="cuda")
    v = torch.randn((1, 512, cfg.n_kv_heads, cfg.hd), generator=g,
                    device="cuda")
    worst = {"block_sparse_matmul": {}, "flash_attention": {}}
    out = {}
    for name, call, direct, plain, dtype in (
            ("block_sparse_matmul",
             lambda: autotune.tuned_block_sparse_matmul(
                 x, wm, kidx, cache_path=cache_path),
             lambda c: bsmm.block_sparse_matmul(x, wm, kidx,
                                                block_m=c["block_m"]),
             lambda: bsmm.block_sparse_matmul_plain(x, wm, kidx),
             torch.bfloat16),
            ("flash_attention",
             lambda: autotune.tuned_flash_attention(q, k, v,
                                                    cache_path=cache_path),
             lambda c: fa.flash_attention(q, k, v, block_q=c["block_q"],
                                          block_kv=c["block_kv"]),
             lambda: fa.flash_attention_plain(q, k, v), torch.float32)):
        cfg = next(c for key, c in tuned.items()
                   if key.startswith(name + "|"))
        _zero_counts()
        got = call()
        torch.cuda.synchronize()
        n = _read_counts()[name]
        if n != 1 or not torch.equal(got, direct(cfg)):
            raise AssertionError(f"tuned {name}: {n} launches, or not the "
                                 f"tuned config's output")
        _compare(name, got, plain(), dtype, worst, "tuned")
        out[name] = {"config": cfg, "launches": n}
    _zero_counts()
    got = ops.masked_matmul(x, wm, mask)
    torch.cuda.synchronize()
    n = _read_counts()["block_sparse_matmul"]
    if n != 1:
        raise AssertionError(f"ops.masked_matmul: {n} launches")
    _compare("block_sparse_matmul", got,
             bsmm.block_sparse_matmul_plain(x, wm, kidx), torch.bfloat16,
             worst, "masked_matmul")
    out["masked_matmul"] = {"launches": n}
    out["max_abs_err"] = worst
    return out


def phase_profile() -> None:
    """torch.profiler over a shortened phase-5 burst (8 requests, 4 of
    them sharing the prefix, 16 new tokens): device busy share and the
    kernels and host ops that take the time.  Not run by default."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    c = SERVE
    cfg, pcfg, lm, eng, _ = _serve_engine()
    reqs = _requests(np.random.default_rng(1), 8, c["prompt_len"], 4,
                     c["prefix_len"], cfg.vocab_size, 16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = eng.run(reqs, lm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = st["n_segments"] * pcfg.segment_len
    emit({"phase": "profile", "requests": len(reqs), "new_tokens": 16,
          "wall_s": wall, "prefill_s": st["prefill_s"],
          "decode_s": st["decode_s"], "decode_steps": steps,
          "n_prefill_dispatches": st["n_prefill_dispatches"],
          **_profile_summary(prof, wall, "profile.txt")})
    del eng
    torch.cuda.empty_cache()
    _profile_generate(cfg, lm)


def _profile_summary(prof, wall: float, table: str) -> dict:
    """Device busy time and idle share over ``wall``, the top kernels
    and host ops; the full table goes to ``chiprun_out/<table>``."""
    import torch
    events = prof.key_averages()
    # device-side events only: a host op's device time repeats its
    # kernels' time
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    top_dev = sorted(dev, key=lambda e: e.self_device_time_total,
                     reverse=True)[:15]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:15]
    OUT.mkdir(exist_ok=True)
    (OUT / table).write_text(events.table(
        sort_by="self_device_time_total", row_limit=60))
    return {"device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "device_events": sum(e.count for e in dev),
            "top_device": [[e.key[:60], round(e.self_device_time_total / 1e3,
                                              3), e.count] for e in top_dev],
            "top_host": [[e.key[:60], round(e.self_cpu_time_total / 1e3, 3),
                          e.count] for e in top_cpu]}


def _profile_generate(cfg, lm) -> None:
    """torch.profiler over 16 contiguous decode steps of the phase-5
    ``generate`` shape (after an unprofiled prefill), once per policy."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.launch.serve import (generate, make_serve_fns,
                                          serve_policy)
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import greedy_argmax
    b, s, steps = GENERATE["batch"], GENERATE["prompt_len"], 16
    prompts = torch.from_numpy(lm_tokens(b * s, cfg.vocab_size, seed=1)
                               .reshape(b, s).astype(np.int32)).cuda()
    for pname, int8 in (("bf16", False), ("int8-mlp", True)):
        model = build_model(cfg, serve_policy(int8))
        fns = make_serve_fns(model)
        generate(model, lm, prompts[:, :64], 4, 69, fns=fns)   # warm-up
        cache = model.init_cache(b, s + steps + 1)
        logits, cache = fns.prefill(lm, {"tokens": prompts}, cache)
        tok = greedy_argmax(logits[:, -1:]).to(torch.int32)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fns.decode_scan(lm, cache, tok, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit({"phase": "profile_generate", "policy": pname, "batch": b,
              "prompt_len": s, "decode_steps": steps, "wall_s": wall,
              "decode_step_ms": 1e3 * wall / steps,
              **_profile_summary(prof, wall,
                                 f"profile_generate_{pname}.txt")})
        del fns, model, cache, logits
        torch.cuda.empty_cache()


def _time_ms(fn, reps: int, flush) -> float:
    """Median of CUDA-event times of single calls, with the 50 MB L2
    flushed before each (the serving path finds K/V cold)."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_timing(launches: dict) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode_paged as fdp
    from repro_torch.kernels import flash_prefill_ragged as fpr
    from repro_torch.models import layers as L
    c = SERVE
    r, h, kvh, d = c["max_slots"], 28, 4, 128
    ps, m = c["page_size"], c["max_blocks"]
    dt = torch.bfloat16
    item = 2
    gen = torch.Generator().manual_seed(2)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    # scaled_dot_product_attention takes enable_gqa from torch 2.5 on
    sdpa_gqa = tuple(int(x) for x in
                     torch.__version__.split("+")[0].split(".")[:2]) >= (2, 5)
    rows = []

    # decode: 8 requests mid-generation (512-token prompt + 32 tokens)
    seq = [c["prompt_len"] + 32] * r
    q, kp, vp, bt, mask = _decode_inputs(gen, r, h, kvh, d, ps, m, seq, dt)
    out = fdp.flash_decode_paged(q, kp, vp, bt, mask)
    ref = fdp.flash_decode_paged_plain(q, kp, vp, bt, mask)
    err = float((out.float() - ref.float()).abs().max())
    live = sum(s + 1 for s in seq)
    nbytes = (2 * live * kvh * d * item + 2 * q.numel() * item
              + mask.numel() + bt.numel() * 4)
    flops = 4 * h * d * live
    kf = kp[bt.long()].reshape(r, m * ps, kvh, d).transpose(1, 2)
    vf = vp[bt.long()].reshape(r, m * ps, kvh, d).transpose(1, 2)
    qs = q.transpose(1, 2)
    am = mask[:, None, None, :]
    lib = (lambda: F.scaled_dot_product_attention(
        qs, kf, vf, attn_mask=am, enable_gqa=True)) if sdpa_gqa else None
    rows.append(_row("flash_decode_paged",
                     "src/repro_torch/csrc/flash_decode_paged.cu",
                     "src/repro/kernels/flash_decode_paged.py:74",
                     launches, err, bf16_tol(ref),
                     lambda: fdp.flash_decode_paged(q, kp, vp, bt, mask),
                     lambda: fdp.flash_decode_paged_plain(q, kp, vp, bt,
                                                          mask),
                     lib, nbytes, flops, flush,
                     {"R": r, "H": h, "KV": kvh, "D": d, "page_size": ps,
                      "M": m, "seq_lens": seq[0], "dtype": "bfloat16"}))

    # prefill: the burst's fresh dispatch, 8 x 512-token prompts
    s = c["prompt_len"]
    offs, lens = [0] * r, [s] * r
    args = _prefill_inputs(gen, r, s, h, kvh, d, ps, m, offs, lens, dt)
    q, kp, vp, bt, off, ln = args
    out = fpr.flash_prefill_ragged(*args)
    ref = fpr.flash_prefill_ragged_plain(*args)
    err = float((out.float() - ref.float()).abs().max())
    pairs = sum(sum(o + i + 1 for i in range(n)) for o, n in zip(offs, lens))
    live = sum(o + n for o, n in zip(offs, lens))
    nbytes = (2 * live * kvh * d * item + 2 * q.numel() * item
              + bt.numel() * 4 + 8 * r)
    flops = 4 * h * d * pairs
    n = m * ps
    kf = kp[bt.long()].reshape(r, n, kvh, d).transpose(1, 2)
    vf = vp[bt.long()].reshape(r, n, kvh, d).transpose(1, 2)
    qs = q.transpose(1, 2)
    am = L.ragged_prefill_attention_mask(off, ln, s, n)[:, None]
    lib = (lambda: F.scaled_dot_product_attention(
        qs, kf, vf, attn_mask=am, enable_gqa=True)) if sdpa_gqa else None
    rows.append(_row("flash_prefill_ragged",
                     "src/repro_torch/csrc/flash_prefill_ragged.cu",
                     "src/repro/kernels/flash_prefill_ragged.py:110",
                     launches, err, bf16_tol(ref),
                     lambda: fpr.flash_prefill_ragged(*args),
                     lambda: fpr.flash_prefill_ragged_plain(*args),
                     lib, nbytes, flops, flush,
                     {"R": r, "S": s, "H": h, "KV": kvh, "D": d,
                      "page_size": ps, "M": m, "offsets": 0, "lens": s,
                      "dtype": "bfloat16"}))
    rows.append(_flash_decode_row(gen, launches, flush, sdpa_gqa))
    rows.append(_quant_matmul_row(gen, launches, flush))
    rows.append(_block_sparse_row(launches, flush))
    rows.append(_flash_attention_row(launches, flush, sdpa_gqa))
    emit({"phase": "timing", "kernels": rows})
    return rows


def _block_sparse_row(launches, flush) -> dict:
    """Problem 3 of phase 8: x (128, 3584) bf16 @ a (3584, 152064) bf16
    weight under a 50 % block mask (``block_mask``), at each block_m the
    tuner tries (the row's ``ms`` at the default 128).  Bytes: x, the live
    w blocks and out once; operations: 2 * 128 * 128 * 128 per live block.
    Library: ``torch.matmul`` on the masked dense weight."""
    import torch
    from repro_torch.kernels import block_sparse_matmul as bsmm
    from repro_torch.sparsity.masks import block_map, block_mask
    g = torch.Generator(device="cuda").manual_seed(6)
    m, k, n = 128, 3584, 152064
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn((k, n), generator=g, device="cuda")).to(
        torch.bfloat16)
    mask = block_mask(w, 0.5)
    occ = block_map(mask, 128)
    wm = (w.float() * mask).to(torch.bfloat16)
    del w, mask
    kidx = torch.from_numpy(bsmm.compact_block_index(occ)).cuda()
    live = int(occ.sum())
    out = bsmm.block_sparse_matmul(x, wm, kidx)
    ref = bsmm.block_sparse_matmul_plain(x, wm, kidx)
    err = float((out.float() - ref.float()).abs().max())
    nbytes = 2 * m * k + 2 * live * 128 * 128 + 4 * kidx.numel() + 2 * m * n
    flops = 2 * m * 128 * 128 * live
    row = _row("block_sparse_matmul",
               "src/repro_torch/csrc/block_sparse_matmul.cu",
               "src/repro/kernels/block_sparse_matmul.py:62", launches, err,
               bf16_tol(ref), lambda: bsmm.block_sparse_matmul(x, wm, kidx),
               lambda: bsmm.block_sparse_matmul_plain(x, wm, kidx),
               lambda: torch.matmul(x, wm), nbytes, flops, flush,
               {"M": m, "K": k, "N": n, "block": 128, "block_m": 128,
                "live_blocks": live, "max_live": int(kidx.shape[1]),
                "dtype": "bfloat16"})
    row["library_note"] = "torch.matmul on the masked dense weight"
    row["ms_by_block_m"] = {bm: _time_ms(
        lambda bm=bm: bsmm.block_sparse_matmul(x, wm, kidx, block_m=bm), 20,
        flush) for bm in (32, 64, 128)}
    return row


def _flash_attention_row(launches, flush, sdpa_gqa) -> dict:
    """Problem 4 of phase 8: (1, 512) queries and keys, H = 28 over KV = 4,
    D = 128, fp32, causal, default tiles (128, 128); then Qwen2-7B prefill
    scale (1, 4096) in bf16, causal.  Bytes: q, k, v and out once;
    operations: 4 * D * H * the causal pairs, over the fp32 (67 TFLOP/s,
    CUDA cores) or bf16 (989) peak.  Library:
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for s, dtype, peak in ((512, torch.float32, H100_FP32_FLOPS),
                           (4096, torch.bfloat16, H100_BF16_FLOPS)):
        h, kvh, d = 28, 4, 128
        q = torch.randn((1, s, h, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((1, s, kvh, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((1, s, kvh, d), generator=g, device="cuda").to(dtype)
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        err = float((out.float() - ref.float()).abs().max())
        tol = FP32_TOL if dtype == torch.float32 else bf16_tol(ref)
        del out, ref
        item = q.element_size()
        nbytes = item * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * d * h * (s * (s + 1) // 2)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)) if sdpa_gqa \
            else None
        rows.append(_row(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:91", launches, err, tol,
            lambda: fa.flash_attention(q, k, v),
            lambda: fa.flash_attention_plain(q, k, v), lib, nbytes, flops,
            flush, {"B": 1, "S": s, "H": h, "KV": kvh, "D": d,
                    "causal": True, "block_q": 128, "block_kv": 128,
                    "dtype": str(dtype).removeprefix("torch.")},
            peak_ops=peak))
    row, prefill = rows
    row["prefill_4096"] = {key: prefill[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err", "shapes")}
    return row


def _flash_decode_row(gen, launches, flush, sdpa_gqa) -> dict:
    """Contiguous decode at the phase-5 shape: 8 sequences mid-generation
    (512-token prompt + 32 tokens) over the 577-slot cache."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers as L
    c = GENERATE
    b, h, kvh, d = c["batch"], 28, 4, 128
    n = c["prompt_len"] + c["gen"] + 1
    pos = c["prompt_len"] + 32
    item = 2
    q, k, v = _contig_inputs(gen, b, n, h, kvh, d, torch.bfloat16)
    mask = L.decode_attention_mask(
        L.kv_positions_for_cache(pos, n, 0, device="cuda"), pos, 0)
    out = fd.flash_decode(q, k, v, mask)
    ref = fd.flash_decode_plain(q, k, v, mask)
    err = float((out.float() - ref.float()).abs().max())
    live = pos + 1
    nbytes = 2 * b * live * kvh * d * item + 2 * q.numel() * item + n
    flops = 4 * b * h * d * live
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    am = mask[None, None, None, :]
    lib = (lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=am, enable_gqa=True)) if sdpa_gqa else None
    return _row("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
                "src/repro/kernels/flash_decode.py:130", launches, err,
                bf16_tol(ref), lambda: fd.flash_decode(q, k, v, mask),
                lambda: fd.flash_decode_plain(q, k, v, mask), lib, nbytes,
                flops, flush,
                {"B": b, "H": h, "KV": kvh, "D": d, "L": n, "pos": pos,
                 "dtype": "bfloat16"})


# Qwen2-7B's gate/up projection at decode and at the phase-5 prefill
QMM_ROW = dict(k=3584, n=18944, m=(8, 4096))


def _quant_matmul_row(gen, launches, flush) -> dict:
    """The int8 product at the decode shape (M = 8, the 63 of 64 calls per
    layer and MLP weight that decode makes) on operands already quantized,
    with the prefill shape (M = 4096) and the weight quantization that
    every call also pays timed beside it.  Library: ``torch._int_mm`` on
    the same int8 operands (int32 out, no dequantization), which refuses
    M <= 16."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    k, n = QMM_ROW["k"], QMM_ROW["n"]
    extra = {}
    row = None
    for m in QMM_ROW["m"]:
        x = torch.randn((m, k), generator=gen).to(torch.bfloat16).cuda()
        w = (0.02 * torch.randn((k, n), generator=gen)).to(
            torch.bfloat16).cuda()
        ops = qmm.quantize_operands(x, w)
        xq, xs, wq, ws = ops
        out = qmm.int8_matmul(*ops)
        ref = qmm.int8_matmul_plain(*ops)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        nbytes = m * k + 4 * m + n * k + 4 * n + 4 * m * n
        flops = 2 * m * n * k
        wt = wq.t()
        try:
            torch._int_mm(xq, wt)
            lib, why = (lambda: torch._int_mm(xq, wt)), None
        except RuntimeError as e:
            lib, why = None, str(e).splitlines()[0][:160]
        r = _row("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
                 "src/repro/kernels/quant_matmul.py:55", launches, err, 0.0,
                 lambda: qmm.int8_matmul(*ops),
                 lambda: qmm.int8_matmul_plain(*ops), lib, nbytes, flops,
                 flush, {"M": m, "K": k, "N": n, "x": "bfloat16",
                         "operands": "int8, quantized"},
                 peak_ops=H100_INT8_OPS)
        r["library_note"] = why or "torch._int_mm, int32 out"
        r["quantize_ms"] = _time_ms(lambda: qmm.quantize_operands(x, w), 5,
                                    flush)
        r["wrapper_ms"] = _time_ms(lambda: qmm.quant_matmul(x, w), 5, flush)
        if row is None:
            row = r
        else:
            extra = {key: r[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_note", "quantize_ms", "wrapper_ms", "max_abs_err",
                "shapes")}
    row["prefill"] = extra
    return row


def _row(name, source, replaces, launches, err, tol, kernel, plain, lib,
         nbytes, flops, flush, shapes, peak_ops=H100_BF16_FLOPS) -> dict:
    if not err <= tol:
        raise AssertionError(f"{name} at serving shapes: err {err} > {tol}")
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_ops * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": err, "tol": tol,
            "ms": _time_ms(kernel, 20, flush),
            "plain_ms": _time_ms(plain, 5, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lib is None else _time_ms(lib, 20, flush),
            "bytes": nbytes, "flops": flops, "shapes": shapes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,8",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # fp32 products and convolutions in full fp32 on the card, as the
    # plain versions they are compared with (cuDNN would use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device()
    if 2 in phases:
        phase_build()
    if 3 in phases:
        phase_kernels()
    if 4 in phases:
        phase_cpu_vs_gpu()
    launches = {}
    if 5 in phases:
        launches = phase_serve()
    tune_launches = phase_tune() if 8 in phases else {}
    # block_sparse_matmul and flash_attention run on phase 8's path only
    for name in ("block_sparse_matmul", "flash_attention"):
        launches[name] = tune_launches.get(name, 0)
    rows = phase_timing(launches) if 6 in phases else []
    for row in rows:
        row["tune_launches"] = tune_launches.get(row["name"], 0)
    if 7 in phases:
        phase_profile()
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
