#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each printing one JSON line:

1. device    — ``nvidia-smi`` name and power limit;
2. build     — both CUDA kernels from ``src/repro_torch/csrc`` (nvcc);
3. kernels   — each kernel against its plain PyTorch version on CUDA
               tensors, fp32 and bf16, at smoke and full-width shapes;
4. cpu_vs_gpu — Qwen2-7B at full width cut to 2 layers in fp32: the port
               on the CPU (plain versions) and on the card (kernels) must
               emit equal greedy tokens through a preemption and restore;
5. serve     — all 28 layers of Qwen2-7B in bf16 serving a 16-request
               burst (8 sharing a 256-token prefix); the launch counts of
               both kernels must match the engine's dispatch counts;
6. timing    — kernel, plain-version, roofline-bound and library times at
               the phase-5 shapes.

Then one ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line, and the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits 2 and prints no
result.  Longer logs go to ``chiprun_out/``.

Phase 7 (profile: torch.profiler over a shortened phase-5 burst, device
busy share and the top kernels and host ops) runs only when asked.

Usage: ``python3 chip_smoke.py [--phases 1,2,3,4,5,6[,7]]``.
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
FP32_TOL = 2e-5                     # as tests/test_paged.py


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


def _compare(name, out, ref, dtype, worst, case):
    import torch
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = FP32_TOL if dtype == torch.float32 else bf16_tol(ref)
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{name} {case}: max abs err {err} > {tol}")
    key = str(dtype).removeprefix("torch.")
    worst[name][key] = max(worst[name].get(key, 0.0), err)


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels import flash_decode_paged as fdp
    from repro_torch.kernels import flash_prefill_ragged as fpr
    gen = torch.Generator().manual_seed(0)
    worst = {"flash_decode_paged": {}, "flash_prefill_ragged": {}}
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
    emit({"phase": "kernels", "cases": n_cases, "fp32_tol": FP32_TOL,
          "bf16_tol": "2**-7 * max|plain| + 1e-6 (one bf16 ulp)",
          "max_abs_err": worst})
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
    del lm_gpu, m_gpu
    torch.cuda.empty_cache()


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
    from repro_torch.kernels import flash_decode_paged as fdp
    from repro_torch.kernels import flash_prefill_ragged as fpr
    c = SERVE
    cfg, pcfg, lm, eng, t_init = _serve_engine()
    reqs = _requests(np.random.default_rng(1), c["n"], c["prompt_len"],
                     c["n_shared"], c["prefix_len"], cfg.vocab_size,
                     c["max_new"])
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before, read just after
    fdp.launches = 0
    fpr.launches = 0
    t0 = time.perf_counter()
    st = eng.run(reqs, lm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_decode_paged": fdp.launches,
                "flash_prefill_ragged": fpr.launches}
    expected = {
        "flash_decode_paged": cfg.n_layers * st["n_segments"]
        * pcfg.segment_len,
        "flash_prefill_ragged": cfg.n_layers * st["n_prefill_dispatches"]}
    n_tokens = sum(len(r.tokens) for r in reqs)
    bad = [r.rid for r in reqs
           if len(r.tokens) != c["max_new"]
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if bad or st["n_dead_lettered"] or st["n_finished"] != c["n"]:
        raise AssertionError(
            f"phase 5: bad requests {bad}, finished {st['n_finished']}, "
            f"dead-lettered {st['n_dead_lettered']}")
    if launches != expected or min(launches.values()) < 1:
        raise AssertionError(f"launch counts {launches} != {expected}")
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
          "launches": launches, "expected_launches": expected})
    del lm, eng
    torch.cuda.empty_cache()
    return launches


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
    events = prof.key_averages()
    # device-side events only: a host op's device time repeats its
    # kernels' time
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    n_kernels = sum(e.count for e in dev)
    top_dev = sorted(dev, key=lambda e: e.self_device_time_total,
                     reverse=True)[:15]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:15]
    OUT.mkdir(exist_ok=True)
    (OUT / "profile.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=60))
    steps = st["n_segments"] * pcfg.segment_len
    emit({"phase": "profile", "requests": len(reqs), "new_tokens": 16,
          "wall_s": wall, "prefill_s": st["prefill_s"],
          "decode_s": st["decode_s"], "decode_steps": steps,
          "n_prefill_dispatches": st["n_prefill_dispatches"],
          "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1 - busy_us / 1e6 / wall,
          "device_events": n_kernels,
          "top_device": [[e.key[:60], round(e.self_device_time_total / 1e3,
                                            3), e.count] for e in top_dev],
          "top_host": [[e.key[:60], round(e.self_cpu_time_total / 1e3, 3),
                        e.count] for e in top_cpu]})


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
    emit({"phase": "timing", "kernels": rows})
    return rows


def _row(name, source, replaces, launches, err, tol, kernel, plain, lib,
         nbytes, flops, flush, shapes) -> dict:
    if not err <= tol:
        raise AssertionError(f"{name} at serving shapes: err {err} > {tol}")
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
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
    ap.add_argument("--phases", default="1,2,3,4,5,6",
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
    rows = phase_timing(launches) if 6 in phases else []
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
