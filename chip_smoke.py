#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each printing one JSON line or more:

1. device    — ``nvidia-smi`` name and power limit;
2. build     — every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, one
               process per source, all started together), its time, and
               ``cuobjdump -sass`` of the libraries with tensor-core
               variants: every instance of the prefill pair's holds
               HGMMA (flash_attention's also UTMALDG, TMA), every one of
               the decode pair's HMMA (mma.sync) and LDGSTS (cp.async),
               every one of the GEMM pair's UTMALDG and IGMMA
               (quant_matmul, s8) or HGMMA (block_sparse_matmul, bf16),
               and ptxas reports no spill in the decode and GEMM pairs';
3. kernels   — each kernel against its plain PyTorch version on CUDA
               tensors at smoke and full-width shapes: the attention
               kernels and block_sparse_matmul in fp32 and bf16 within
               tolerance (bf16 at each tensor-core tile, and two launches
               bit for bit), quant_matmul exactly equal on the variant
               each shape takes (int32 wrap past K = 133,143 included),
               and equal bits from two launches and from forced split
               counts; the INT8 straight-through product
               (``Int8MatmulSTE``): forward bit-equal, backward the fp32
               products of ``_int8_mm_bwd``; each wrapper's shared-memory model and
               quant_matmul's split plan against the numbers its kernel
               library exports; then the bf16 tensor-core variants of
               flash_prefill_ragged and flash_attention at D = 64 and
               128 (page sizes 4 to 128, ragged offsets and lens,
               Sq != Skv, windows, every tile) and two launches of each,
               bit for bit; then the bf16
               split-KV variants of flash_decode_paged and flash_decode
               at D = 64 and 128 (page sizes 4 to 256, ragged last
               chunks, wrapped rings, rows with no live slot), two
               launches bit for bit, and a request's bits unchanged by
               its row, its siblings, its page numbers, the table width
               and the batch;
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
               launch counts must match its layers × steps, and every
               flash_prefill_ragged and flash_decode_paged launch of the
               burst, every flash_decode launch of bf16 ``generate`` and
               every quant_matmul launch of int8-mlp ``generate`` must
               take the tensor-core variant;
6. timing    — kernel, plain-version, roofline-bound and library times at
               the phase-5 shapes (flash_prefill_ragged also at the
               burst's shared-prefix dispatch), and at the phase-8 shapes
               for block_sparse_matmul and flash_attention (also bf16 at
               (1, 512) and (1, 4096)); quant_matmul also at the down
               projection (M = 8) and TUNE's two problems (M = 128); the
               rows name the variant and tiles (decode: chunk and
               chunks; quant_matmul: splits) that ran, and the decode
               rows split their device time by kernel (torch.profiler);
8. tune      — the TUNE O-task's flow at full width: ``ModelGen``
               (Qwen2-7B, 28 layers, bf16, seed 0) → a 50 % block mask
               on ``lm_head`` (standing in for PRUNING, whose LM
               fine-tune keeps AdamW's fp32 moments and does not fit 28
               layers on one card; phase 11 runs PRUNING itself on a
               2-layer cut) → ``Tune``
               over the four largest problems, with launch counts equal
               to the trials' (warmup + iters), every GEMM launch on its
               tensor-core variant, a second execution all cache hits,
               and the tuned dispatchers against their plain versions.
               Runs before phase 6, whose rows report its launch counts;
9. serveflow — the SERVE O-task's flow at full width: ``serve_strategy``
               (MODEL-GEN: Qwen2-7B, 28 layers, bf16, seed 0 → TUNE over
               the flash_decode_paged, flash_prefill_ragged and
               paged_segment problems → SERVE on an 8-request profile of
               256-token prompts, 4 slots), after TUNE has settled the
               page size those problems are keyed against.  TUNE's
               launches equal trials × (warmup + iters) (× SEGMENT_TOKENS
               for paged_segment), the default plan's page size and
               cadence read back ``tuned`` or ``relaxed``, stage 2 runs at
               most half the grid, the winner scores at least the
               default, the plan artifact round-trips and deploys (also in
               a fresh process), and every replay launch is on the
               tensor-core variants;
10. durable  — on the same model: a journaled 8-request burst (256-token
               prompts, 32 new tokens, 4 slots, a pool that preempts so
               swap images spill) in turns with the same burst
               unjournaled (the journal's overhead), crashed at a
               mid-burst boundary and finished by ``RestartRecovery``;
               a 2-replica ``ServingCluster`` losing a replica; the same
               cluster journaled, crashed and resumed.  Every request's
               tokens equal the unjournaled engine's, no swap image of the
               single engine outlives it, the surviving pools drain.
               Phases 9 and 10 run before phase 6, whose rows report
               their launch counts;
11. designflow — the paper's design flow with training, at the JAX
               package's defaults: (a) ``combined_strategy("resnet9",
               "SPQ")`` (Fig. 2(b)) at published widths, each O-task's
               probes, the selected results and effective MACs / weight
               bits against MODEL-GEN's; (b) ``combined_strategy(
               "jet_dnn", "QP")`` twice, PRUNING fine-tuning under the
               INT8 policy QUANTIZATION chose (quant_matmul in training's
               forward): launches equal to the INT8 ``linear`` forwards,
               each on the variant its K gives, and the two runs' traces
               and final weights equal bit for bit; (c)
               ``combined_strategy("qwen2-7b", "QP")`` with MODEL-GEN
               training, full width cut to 2 layers (AdamW's fp32
               moments), every quant_matmul launch on "tc"; (d)
               ``train_classifier`` (jet_dnn, INT8) and ``lm_finetune``
               (qwen2-smoke, masked) for 3 steps on the CPU and on the
               card from one init, within stated tolerances.  Runs before
               phase 6, whose rows report its launch counts.

Then one ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line, and the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits 2 and prints no
result.  Longer logs go to ``chiprun_out/``, and every JSON line also to
``chiprun_out/chip_smoke.jsonl``.

Phase 7 (profile: torch.profiler over a shortened phase-5 burst — device
busy share, the admission dispatches' share of device time, the top
kernels and host ops — and over 16 contiguous decode steps under each
policy) runs only when asked.

Usage: ``python3 chip_smoke.py [--phases 1,2,3,4,5,6,8,9,10,11[,7]]
[--src DIR]``; ``--phases 1,2,9,10`` builds the kernels and drives the
SERVE and durability paths alone, ``--phases 1,2,3,11`` the design flow
with training.
``--src`` drives the ``repro_torch`` under another tree (e.g. the parent
commit unpacked beside this one) with this script's phases; with
``--phases 1,6`` that times both commits' kernels with the same rows in one
call.
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
    """Print one JSON line, and keep it in ``chiprun_out/chip_smoke.jsonl``
    (a caller may see only the end of a long output)."""
    line = json.dumps(obj)
    print(line, flush=True)
    OUT.mkdir(exist_ok=True)
    with open(OUT / "chip_smoke.jsonl", "a") as f:
        f.write(line + "\n")


def bf16_tol(ref) -> float:
    """Kernel and plain version both accumulate in fp32 (in different
    orders) and round once to bf16, so an output may land one bf16 ulp
    apart: at most 2**-7 of the largest output magnitude."""
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-6


# ------------------------------------------------------------------ phases
def phase_device(src: Path) -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    import torch
    emit({"phase": "device", "nvidia_smi": line, "src": str(src),
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
    ptxas, tc_ptxas = {}, {}
    for name in libs:
        log = _build.build_log.get(name, "")
        (OUT / f"build_{name}.log").write_text(log)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln][:8]
        tc_ptxas[name] = _tc_ptxas(log)
    for name in DECODE_TC + GEMM_TC:
        spills = {f: v for f, v in tc_ptxas[name].items()
                  if v["spill_stores"] or v["spill_loads"]}
        if len(tc_ptxas[name]) != TC_INSTANCES[name][0] or spills:
            raise AssertionError(f"{name}: ptxas of the tensor-core "
                                 f"instances {tc_ptxas[name]}")
    emit({"phase": "build", "seconds": round(secs, 3),
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "ptxas": ptxas, "tc_ptxas": {k: v for k, v in tc_ptxas.items()
                                       if v},
          "tc_sass": _check_tc_sass(libs)})


def _tc_ptxas(log: str) -> dict:
    """Registers and spills of every ``*_tc_kernel`` instance in a
    ``-Xptxas -v`` build log, by mangled name."""
    import re
    out, func = {}, None
    for ln in log.splitlines():
        hit = re.search(r"Function properties for (\S+)", ln)
        if hit:
            func = hit.group(1) if "_tc_kernel" in hit.group(1) else None
            continue
        if func is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        ln)
        if hit:
            out.setdefault(func, {}).update(
                spill_stores=int(hit.group(1)), spill_loads=int(hit.group(2)))
        hit = re.search(r"Used (\d+) registers", ln)
        if hit:
            out.setdefault(func, {})["registers"] = int(hit.group(1))
            func = None
    return out


# instances of each tensor-core variant and the SASS instructions each
# must hold: (block_q, block_kv, D) and (block_q, D) with wgmma for the
# prefill pair (TMA for flash_attention), (D, stages) with mma.sync and
# cp.async for the decode pair, and wgmma fed by TMA for the GEMM pair
# (IGMMA: the integer wgmma of quant_matmul): quant_matmul's for 256
# rows of N unswapped and M up to 8, 16, 32 and 64 swapped,
# block_sparse_matmul's M tiles 64, 128 and 256
TC_INSTANCES = {"flash_attention": (8, ("HGMMA", "UTMALDG")),
                "flash_prefill_ragged": (4, ("HGMMA",)),
                "flash_decode_paged": (4, ("HMMA", "LDGSTS")),
                "flash_decode": (4, ("HMMA", "LDGSTS")),
                "quant_matmul": (5, ("IGMMA", "UTMALDG")),
                "block_sparse_matmul": (3, ("HGMMA", "UTMALDG"))}
DECODE_TC = ("flash_decode_paged", "flash_decode")
GEMM_TC = ("quant_matmul", "block_sparse_matmul")


def _check_tc_sass(libs) -> dict:
    """``cuobjdump -sass`` of the libraries with tensor-core variants:
    every instance of one must hold its product and copy instructions
    (:data:`TC_INSTANCES`); the counts of HGMMA and IGMMA (wgmma, float
    and integer), HMMA (mma.sync), TMA loads (UTMALDG) and cp.async copies
    (LDGSTS) show how its tiles arrive and multiply."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = {}
    for name, (n_inst, need) in TC_INSTANCES.items():
        sass = subprocess.run([str(tool), "-sass", str(libs[name])],
                              check=True, capture_output=True,
                              text=True).stdout
        funcs = [f for f in sass.split("Function : ")[1:]
                 if "_tc_kernel" in f.split("\n", 1)[0]]
        counts = [{op: f.count(op) for op in ("HGMMA", "IGMMA", "HMMA",
                                              "UTMALDG", "LDGSTS")}
                  for f in funcs]
        if len(funcs) != n_inst or any(c[op] == 0 for c in counts
                                       for op in need):
            raise AssertionError(f"{name}: {len(funcs)} tensor-core "
                                 f"instances (want {n_inst}, each with "
                                 f"{need}) with SASS counts {counts}")
        out[name] = counts
    return out


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
        if hasattr(mod, "launches_tc"):
            mod.launches_tc = 0


def _read_counts() -> dict:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def _read_tc_counts() -> dict:
    """Launches of the tensor-core variants."""
    return {name: mod.launches_tc for name, mod in _kernel_modules().items()
            if hasattr(mod, "launches_tc")}


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


# Qwen2-7B's MLP at decode (M = 8) and prefill (M = 4096), TUNE's embed
# product at M = 128, K no multiple of 16 (the mma.sync kernel), then the
# tensor-core kernel's ragged edges: M, N and the last k-block ragged,
# swapped (M <= 64) and not, with and without a split
QMM_SHAPES = ((8, 3584, 18944), (8, 18944, 3584), (4096, 3584, 18944),
              (4096, 18944, 3584), (3, 56, 40), (5, 100, 17),
              (130, 72, 200), (128, 152064, 3584), (3, 80, 40),
              (17, 2064, 1000), (64, 1024, 200), (65, 272, 136),
              (70, 4112, 300), (200, 512, 520), (512, 16, 64), (512, 32, 5),
              (512, 512, 10))
# the INT8 straight-through product (models/common.py::Int8MatmulSTE) at
# the bench models' evaluation shapes and a Qwen2-7B training forward
STE_SHAPES = ((512, 16, 64), (512, 32, 5), (512, 512, 10),
              (256, 3584, 18944))


def _expect_qmm(qmm, gemm_tc, m, k, n, splits=None) -> None:
    """The launch took the variant (and the tc plan) that the shape
    gives."""
    if gemm_tc.qmm_variant(k) == "tc":
        plan = gemm_tc.qmm_plan(m, n, k)
        want = {"variant": "tc", "tiles": (plan["block_a"], plan["block_b"]),
                "swap": plan["swap"],
                "splits": plan["splits"] if splits is None else splits}
    else:
        want = {"variant": "mma", "tiles": qmm.MMA_TILES, "swap": False,
                "splits": 1}
    if qmm.last_launch != want:
        raise AssertionError(f"quant_matmul {(m, k, n)}: launch "
                             f"{qmm.last_launch}, expected {want}")


def _check_quant_matmul(gen) -> dict:
    """quant_matmul against its plain version, exactly, each shape of
    :data:`QMM_SHAPES` on the variant it takes; the int32 wrap (K =
    152,064 at +-127) on the tensor-core kernel; then the same bits from
    two launches and from forced split counts (1, 3 and 37 besides the
    plan's) through the launcher's split argument, at the down projection
    (M = 8) and TUNE's embed product (M = 128)."""
    import torch
    from repro_torch.kernels import gemm_tc
    from repro_torch.kernels import quant_matmul as qmm
    n_cases, variants = 0, {}
    for m, k, nn in QMM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            if (m == 4096 or k > 100_000) and dtype == torch.float32:
                continue
            x = torch.randn((m, k), generator=gen).to(dtype).cuda()
            w = (0.02 * torch.randn((k, nn), generator=gen)).to(dtype).cuda()
            out = qmm.quant_matmul(x, w)
            _expect_qmm(qmm, gemm_tc, m, k, nn)
            ref = qmm.quant_matmul_plain(x, w)
            torch.cuda.synchronize()
            if out.shape != (m, nn) or not torch.equal(out, ref):
                bad = int((out != ref).sum()) if out.shape == ref.shape \
                    else -1
                raise AssertionError(
                    f"quant_matmul {(m, k, nn)} {dtype}: {bad} elements "
                    f"differ from the plain version ({qmm.last_launch})")
            variants[str((m, k, nn))] = dict(qmm.last_launch)
            n_cases += 1
    # every product at +-127: 127 * 127 * 152,064 passes 2**31, so the
    # int32 sums wrap (to negative values) in the kernel and the plain
    # version alike
    x = torch.ones((8, 152064), device="cuda")
    w = torch.ones((152064, 64), device="cuda")
    w[:, 32:] = -1.0
    out = qmm.quant_matmul(x, w)
    _expect_qmm(qmm, gemm_tc, 8, 152064, 64)
    ref = qmm.quant_matmul_plain(x, w)
    torch.cuda.synchronize()
    if not torch.equal(out, ref) or not bool((out[:, :32] < 0).all()):
        raise AssertionError(f"quant_matmul int32 wrap: kernel {out[0, :2]} "
                             f"plain {ref[0, :2]}")
    variants["wrap (8, 152064, 64)"] = dict(qmm.last_launch)
    bits = {}
    for m, k, nn in ((8, 18944, 3584), (128, 152064, 3584)):
        x = torch.randn((m, k), generator=gen).to(torch.bfloat16).cuda()
        w = (0.02 * torch.randn((k, nn), generator=gen)).to(
            torch.bfloat16).cuda()
        ops = qmm.quantize_operands(x, w)
        base = qmm.int8_matmul(*ops)
        same = {"two_launches": torch.equal(base, qmm.int8_matmul(*ops))}
        for splits in (1, 3, 37):
            out = qmm._launch(*ops, splits=splits)
            _expect_qmm(qmm, gemm_tc, m, k, nn, splits)
            same[f"splits_{splits}"] = torch.equal(out, base)
        same["plain"] = torch.equal(base, qmm.int8_matmul_plain(*ops))
        same["plan_splits"] = gemm_tc.qmm_plan(m, nn, k)["splits"]
        if not all(same.values()):
            raise AssertionError(f"quant_matmul {(m, k, nn)} bits: {same}")
        bits[str((m, k, nn))] = same
    return {"cases": n_cases + 1, "variants": variants, "bits": bits}


def _check_ste(gen) -> dict:
    """``Int8MatmulSTE`` on CUDA tensors at :data:`STE_SHAPES`, fp32 and
    bf16: the forward launches quant_matmul once and equals its plain
    version bit for bit; the backward launches nothing and gives the fp32
    products of the JAX package's ``_int8_mm_bwd`` — equal to the card's
    own fp32 products, and within 5e-5 of the largest of the CPU's
    float64 products (fp32: a sum over K = 18,944; bf16: 2**-7)."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.models.common import Int8MatmulSTE
    out = {}
    for m, k, n in STE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen).to(dtype)
            w = (0.02 * torch.randn((k, n), generator=gen)).to(dtype)
            g = torch.randn((m, n), generator=gen)
            xd = x.cuda().requires_grad_(True)
            wd = w.cuda().requires_grad_(True)
            before = qmm.launches
            y = Int8MatmulSTE.apply(xd, wd)
            fwd = qmm.launches - before
            y.backward(g.cuda())
            torch.cuda.synchronize()
            bwd = qmm.launches - before - fwd
            gx = torch.matmul(g.cuda(), wd.detach().float().t()).to(dtype)
            gw = torch.matmul(xd.detach().float().t(), g.cuda()).to(dtype)
            gx_cpu = (g.double() @ w.double().t()).float()
            gw_cpu = (x.double().t() @ g.double()).float()
            rel = max(float((xd.grad.float().cpu() - gx_cpu).abs().max()
                            / gx_cpu.abs().max()),
                      float((wd.grad.float().cpu() - gw_cpu).abs().max()
                            / gw_cpu.abs().max()))
            ok = {"forward_equal": torch.equal(
                      y.detach(), qmm.quant_matmul_plain(xd.detach(),
                                                         wd.detach())),
                  "launches": (fwd, bwd) == (1, 0),
                  "grads_equal": torch.equal(xd.grad, gx)
                  and torch.equal(wd.grad, gw),
                  "grad_dtypes": xd.grad.dtype == wd.grad.dtype == dtype,
                  "cpu_rel": rel <= (5e-5 if dtype == torch.float32
                                     else 2**-7)}
            if not all(ok.values()):
                raise AssertionError(f"Int8MatmulSTE {(m, k, n)} {dtype}: "
                                     f"{ok} (rel {rel})")
            out[f"{(m, k, n)} {str(dtype)[6:]}"] = {
                "variant": qmm.last_launch["variant"], "grad_rel_cpu": rel}
    return out


# index lists of a (384, 256) weight (3 x 2 blocks): a dead column and a
# dense one; then a column that skips block 1 (nonzero in w, never read)
BSMM_KINDEX = {"dead_and_dense": [[-1, -1, -1], [0, 1, 2]],
               "excluded_nonzero": [[0, 2], [1, -1]]}


def _expect_bsmm(bsmm, gemm_tc, dtype, bm) -> None:
    import torch
    on_tc = dtype == torch.bfloat16
    want = {"variant": "tc" if on_tc else "ffma",
            "block_m": gemm_tc.bsmm_tile(bm) if on_tc else bm}
    if bsmm.last_launch != want:
        raise AssertionError(f"block_sparse_matmul: launch "
                             f"{bsmm.last_launch}, expected {want}")


def _check_block_sparse(gen, worst) -> int:
    """block_sparse_matmul against its plain version: the CPU tests'
    (256, 384) @ (384, 256) cases (a dead column, a dense one, a column
    that skips a block that is nonzero in w) at block_m 32, 64 and 128 and,
    in bf16, 256 (the tensor-core tiles 64, 64, 128, 256), then problem 3
    of phase 8 — Qwen2-7B's lm_head shape (3584, 152064) under a 50 %
    block mask from ``sparsity.masks.block_mask``, at M = 128 — with the
    masked weight and with the unmasked one (blocks outside kindex must
    not be read), and two bf16 launches bit for bit."""
    import torch
    from repro_torch.kernels import block_sparse_matmul as bsmm
    from repro_torch.kernels import gemm_tc
    from repro_torch.sparsity.masks import block_map, block_mask
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((256, 384), generator=gen).to(dtype).cuda()
        w = torch.randn((384, 256), generator=gen).to(dtype).cuda()
        bms = (32, 64, 128, 256) if dtype == torch.bfloat16 else (32, 64, 128)
        for case, rows in BSMM_KINDEX.items():
            kidx = torch.tensor(rows, dtype=torch.int32, device="cuda")
            ref = bsmm.block_sparse_matmul_plain(x, w, kidx)
            for bm in bms:
                out = bsmm.block_sparse_matmul(x, w, kidx, block_m=bm)
                _expect_bsmm(bsmm, gemm_tc, dtype, bm)
                _compare("block_sparse_matmul", out, ref, dtype, worst,
                         (case, bm),
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
            out = bsmm.block_sparse_matmul(x, ww, kidx, block_m=bm)
            _expect_bsmm(bsmm, gemm_tc, torch.bfloat16, bm)
            _compare("block_sparse_matmul", out, ref, torch.bfloat16, worst,
                     ("lm_head", label, bm))
            n += 1
    a, b = (bsmm.block_sparse_matmul(x, wm, kidx) for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("block_sparse_matmul bf16: two launches differ")
    xf, wf = x.float(), wm.float()
    del w, wm
    ref = bsmm.block_sparse_matmul_plain(xf, wf, kidx)
    out = bsmm.block_sparse_matmul(xf, wf, kidx)
    _expect_bsmm(bsmm, gemm_tc, torch.float32, 128)
    _compare("block_sparse_matmul", out, ref, torch.float32, worst,
             ("lm_head", "fp32"), MM_FP32_REL * float(ref.abs().max()))
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


TC_PAGE_SIZES = (4, 8, 16, 64, 128)
TC_FA_CASES = ((200, 333, False, 0), (333, 200, True, 0),
               (300, 300, True, 100), (256, 320, False, 64))


def _expect_tc(mod, **tiles) -> None:
    want = {"variant": "tc", **tiles}
    if mod.last_launch != want:
        raise AssertionError(f"{mod.__name__}: launch {mod.last_launch}, "
                             f"expected {want}")


def _check_tc_variants(gen, worst) -> int:
    """The bf16 tensor-core variants at D in {64, 128}.
    flash_prefill_ragged: g in {1, 2, 7}, page sizes 4 to 128, offsets
    that are no page multiple, lens in {S, 1, 0} with S = 100 (no tile
    multiple), block_q 64 and 128.  flash_attention: g = 7 with
    Sq != Skv, causal off, windows with and without causal, every tile
    pair.  Each against its plain version within ``bf16_tol``."""
    import torch
    from repro_torch.kernels import attention_tc as tc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_prefill_ragged as fpr
    dt, n = torch.bfloat16, 0
    for d in (64, 128):
        for g in (1, 2, 7):
            for ps in TC_PAGE_SIZES:
                r, s, kvh = 4, 100, 2
                offs = [0, ps + 3, 37, 2 * ps + 5]
                args = _prefill_inputs(gen, r, s, g * kvh, kvh, d, ps,
                                       -(-(max(offs) + s) // ps), offs,
                                       [s, 1, 0, s], dt)
                ref = fpr.flash_prefill_ragged_plain(*args)
                for bq in tc.TILES:
                    out = fpr.flash_prefill_ragged(*args, block_q=bq)
                    _expect_tc(fpr, block_q=bq)
                    _compare("flash_prefill_ragged", out, ref, dt, worst,
                             ("tc", d, g, ps, bq))
                    n += 1
        g7 = torch.Generator(device="cuda").manual_seed(8)
        for sq, skv, causal, window in TC_FA_CASES:
            q = torch.randn((2, sq, 14, d), generator=g7, device="cuda").to(dt)
            k = torch.randn((2, skv, 2, d), generator=g7, device="cuda").to(dt)
            v = torch.randn((2, skv, 2, d), generator=g7, device="cuda").to(dt)
            ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
            for bq in tc.TILES:
                for bkv in tc.TILES:
                    out = fa.flash_attention(q, k, v, causal=causal,
                                             window=window, block_q=bq,
                                             block_kv=bkv)
                    _expect_tc(fa, block_q=bq, block_kv=bkv)
                    _compare("flash_attention", out, ref, dt, worst,
                             ("tc", d, sq, skv, causal, window, bq, bkv))
                    n += 1
    return n


def _check_tc_bit_equal(gen) -> dict:
    """Two launches of each tensor-core variant on the same full-width
    inputs give bit-equal outputs (no split over kv, no atomics)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_prefill_ragged as fpr
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((1, 1000, 28, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((1, 1000, 4, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((1, 1000, 4, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    args = _prefill_inputs(gen, 8, 300, 28, 4, 128, 16, 37,
                           [0, 16, 256, 100, 0, 5, 200, 3],
                           [300, 300, 40, 300, 1, 0, 300, 9], torch.bfloat16)
    out = {}
    for name, call, mod in (
            ("flash_attention", lambda: fa.flash_attention(q, k, v), fa),
            ("flash_prefill_ragged",
             lambda: fpr.flash_prefill_ragged(*args), fpr)):
        a, b = call(), call()
        torch.cuda.synchronize()
        if mod.last_launch["variant"] != "tc" or not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches differ "
                                 f"({mod.last_launch})")
        out[name] = True
    return out


DTC_PAGE_SIZES = (4, 16, 48, 128, 256)


def _expect_decode_tc(mod, chunk, n_chunks) -> None:
    want = {"variant": "tc", "chunk": chunk, "n_chunks": n_chunks}
    if mod.last_launch != want:
        raise AssertionError(f"{mod.__name__}: launch {mod.last_launch}, "
                             f"expected {want}")


def _check_dead_row(name, out) -> None:
    """A row with no live slot is 0, as the Pallas kernel writes it (the
    plain version averages every value there)."""
    import torch
    torch.cuda.synchronize()
    if bool(out.float().abs().any()):
        raise AssertionError(f"{name}: a row with no live slot is not 0")


def _check_decode_tc(gen, worst) -> int:
    """The bf16 split-KV variants at D in {64, 128}, g in {1, 2, 7}.
    flash_decode_paged: page sizes 4 to 256 (48: chunks of two pages;
    256: a chunk of one page walked in two stages), about 300 slots a
    row so that the last chunk is cut at M pages, seq lens 1, mid and
    capacity and a row with no live slot.  flash_decode: caches of 37
    (one ragged chunk), 577 and 1000 slots under linear and wrapped-ring
    masks, and an all-dead mask.  Each against its plain version within
    ``bf16_tol``; dead rows against 0."""
    import torch
    from repro_torch.kernels import decode_tc as dtc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_decode_paged as fdp
    dt, n = torch.bfloat16, 0
    for d in (64, 128):
        for g in (1, 2, 7):
            for ps in DTC_PAGE_SIZES:
                r, kvh = 4, 2
                m = -(-300 // ps)
                cap = m * ps
                q, kp, vp, bt, mask = _decode_inputs(
                    gen, r, g * kvh, kvh, d, ps, m,
                    [1, cap // 2, cap - 1, 0], dt)
                mask[3] = False
                out = fdp.flash_decode_paged(q, kp, vp, bt, mask)
                chunk = dtc.paged_chunk(ps)
                _expect_decode_tc(fdp, chunk, dtc.n_chunks(cap, chunk))
                ref = fdp.flash_decode_paged_plain(q, kp, vp, bt, mask)
                _compare("flash_decode_paged", out[:3], ref[:3], dt, worst,
                         ("tc", d, g, ps))
                _check_dead_row("flash_decode_paged", out[3])
                n += 1
            for cache_len in (37, 577, 1000):
                q, k, v = _contig_inputs(gen, 3, cache_len, 2 * g, 2, d, dt)
                for case, mask in _contig_masks(cache_len):
                    out = fd.flash_decode(q, k, v, mask)
                    _expect_decode_tc(fd, dtc.CHUNK,
                                      dtc.n_chunks(cache_len, dtc.CHUNK))
                    _compare("flash_decode", out,
                             fd.flash_decode_plain(q, k, v, mask), dt,
                             worst, ("tc", d, g, cache_len, case))
                    n += 1
                _check_dead_row("flash_decode", fd.flash_decode(
                    q, k, v, torch.zeros_like(mask)))
    return n


def _check_decode_tc_bits(gen) -> dict:
    """The invariance contract of the split-KV variants, bit for bit at
    the serving shapes (H = 28 over KV = 4, D = 128): two launches agree;
    a request's output is the same in another row with other siblings,
    with its pages renumbered and with a wider block table (entries on
    the scratch page 0, masked); a sequence's is the same in a smaller
    batch."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_decode_paged as fdp
    dt = torch.bfloat16
    r, h, kvh, d, ps, m = 8, 28, 4, 128, 16, 37
    seq = [544, 1, 300, 575, 17, 128, 129, 591]
    q, kp, vp, bt, mask = _decode_inputs(gen, r, h, kvh, d, ps, m, seq, dt)
    call = fdp.flash_decode_paged
    base = call(q, kp, vp, bt, mask)
    checks = {"two_launches": torch.equal(base, call(q, kp, vp, bt, mask))}
    # request 0 as row 5, among siblings with other queries and lengths
    q2, _, _, bt2, mask2 = _decode_inputs(gen, r, h, kvh, d, ps, m,
                                          seq[::-1], dt)
    q2[5], bt2[5], mask2[5] = q[0], bt[0], mask[0]
    checks["other_row"] = torch.equal(call(q2, kp, vp, bt2, mask2)[5],
                                      base[0])
    # the same values at other physical pages (page 0 stays the scratch)
    perm = torch.cat([torch.zeros(1, dtype=torch.long),
                      torch.randperm(kp.shape[0] - 1, generator=gen) + 1])
    perm = perm.cuda()
    kp3, vp3 = torch.empty_like(kp), torch.empty_like(vp)
    kp3[perm], vp3[perm] = kp, vp
    bt3 = perm[bt.long()].to(torch.int32)
    checks["renumbered_pages"] = torch.equal(call(q, kp3, vp3, bt3, mask),
                                             base)
    # a wider table: 11 more blocks on the scratch page, masked out
    bt4 = torch.cat([bt, torch.zeros((r, 11), dtype=torch.int32,
                                     device="cuda")], dim=1)
    mask4 = torch.cat([mask, torch.zeros((r, 11 * ps), dtype=torch.bool,
                                         device="cuda")], dim=1)
    checks["wider_table"] = torch.equal(call(q, kp, vp, bt4, mask4), base)
    # contiguous: two launches, and sequences 3 and 6 as a batch of two
    n = 577
    q, k, v = _contig_inputs(gen, 8, n, h, kvh, d, dt)
    mask = _contig_masks(n)[3][1]
    full = fd.flash_decode(q, k, v, mask)
    checks["contig_two_launches"] = torch.equal(
        full, fd.flash_decode(q, k, v, mask))
    idx = torch.tensor([3, 6], device="cuda")
    checks["contig_subset"] = torch.equal(
        fd.flash_decode(q[idx].contiguous(), k[idx].contiguous(),
                        v[idx].contiguous(), mask), full[idx])
    if not all(checks.values()) or fdp.last_launch["variant"] != "tc" \
            or fd.last_launch["variant"] != "tc":
        raise AssertionError(f"split-KV decode bits differ: {checks}")
    return checks


def _check_smem_models() -> int:
    """Each wrapper's Python shared-memory model (what the autotuner
    filters on and the wrapper checks) equals the number its kernel
    library computes for the launch."""
    from repro_torch.kernels import attention_tc as tc
    from repro_torch.kernels import block_sparse_matmul as bsmm
    from repro_torch.kernels import decode_tc as dtc
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
    for d in (64, 128):
        for chunk in (dtc.CHUNK, 256, 512):
            pairs.append((("fd_tc", d, chunk), dtc.smem_bytes(d, chunk),
                          fd._lib().flash_decode_tc_smem_bytes(d, chunk)))
        for ps in (4, 8, 16, 48, 64, 100, 128, 256, 512):
            pairs.append((("fdp_tc", d, ps), fdp.smem_bytes_tc(d, ps),
                          fdp._lib().flash_decode_paged_tc_smem_bytes(
                              d, dtc.paged_chunk(ps))))
    for bq in tc.TILES:
        for d in fa.HEAD_DIMS:
            for bkv in tc.TILES:
                pairs.append((("fa_tc", bq, bkv, d),
                              tc.smem_bytes(bq, bkv, d),
                              fa._lib().flash_attention_tc_smem_bytes(
                                  bq, bkv, d)))
            pairs.append((("fpr_tc", bq, d), fpr.smem_bytes_tc(bq, d),
                          fpr._lib().flash_prefill_ragged_tc_smem_bytes(
                              bq, d)))
    pairs += _qmm_plan_pairs()
    bad = [(case, py, c) for case, py, c in pairs if py != c]
    if bad:
        raise AssertionError(f"shared-memory models differ from the kernels' "
                             f"(case, python, library): {bad[:8]}")
    return len(pairs)


def _qmm_plan_pairs() -> list:
    """quant_matmul's tc plan in Python (``gemm_tc.qmm_plan``) and in the
    library (``quant_matmul_tc_plan``) at every tc shape of phases 3 and 6
    and at Qwen2-7B's projections for M from 1 to 4096."""
    import ctypes
    from repro_torch.kernels import gemm_tc
    from repro_torch.kernels import quant_matmul as qmm
    keys = ("swap", "block_a", "block_b", "splits", "k_per_split", "stages",
            "smem_bytes")
    shapes = {(m, k, n) for m, k, n in QMM_SHAPES if k % 16 == 0}
    shapes |= {(8, 152064, 64), (128, 3584, 152064)}
    for m in (1, 8, 9, 16, 33, 64, 65, 128, 512, 4096):
        for k, n in ((3584, 18944), (18944, 3584), (3584, 4608),
                     (3584, 3584), (3584, 152064), (152064, 3584)):
            shapes.add((m, k, n))
    out = []
    buf = (ctypes.c_longlong * len(keys))()
    for m, k, n in sorted(shapes):
        qmm._lib().quant_matmul_tc_plan(m, n, k, buf)
        plan = gemm_tc.qmm_plan(m, n, k)
        out.append((("qmm_plan", m, k, n), [int(plan[key]) for key in keys],
                    list(buf)))
    return out


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
    qmm_checks = _check_quant_matmul(gen)
    n_qmm = qmm_checks["cases"]
    ste = _check_ste(gen)
    worst["quant_matmul"] = {"bfloat16": 0.0, "float32": 0.0}
    worst["block_sparse_matmul"], worst["flash_attention"] = {}, {}
    n_cases += _check_block_sparse(gen, worst)
    n_cases += _check_flash_attention(gen, worst)
    n_smem = _check_smem_models()
    n_tc = _check_tc_variants(gen, worst)
    bit_equal = _check_tc_bit_equal(gen)
    n_dtc = _check_decode_tc(gen, worst)
    decode_bits = _check_decode_tc_bits(gen)
    emit({"phase": "kernels", "cases": n_cases + n_qmm + n_tc + n_dtc,
          "tc_cases": n_tc, "tc_bit_equal": bit_equal,
          "decode_tc_cases": n_dtc, "decode_tc_bits": decode_bits,
          "fp32_tol": FP32_TOL,
          "block_sparse_fp32_tol": "1e-5 * max|plain|",
          "bf16_tol": "2**-7 * max|plain| + 1e-6 (one bf16 ulp)",
          "quant_matmul": f"{n_qmm} cases exactly equal, int32 wrap "
                          f"included", "quant_matmul_variants":
          qmm_checks["variants"], "quant_matmul_bits": qmm_checks["bits"],
          "int8_ste": ste,
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
    tc_counts = _read_tc_counts()
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
    # bf16 activations and cache at D = 128: every admission dispatch's
    # and every decode step's attention goes to the tensor-core variant
    want_tc = {"flash_decode_paged": counts["flash_decode_paged"],
               "flash_prefill_ragged": counts["flash_prefill_ragged"],
               "flash_decode": 0, "quant_matmul": 0,
               "block_sparse_matmul": 0, "flash_attention": 0}
    if tc_counts != want_tc:
        raise AssertionError(f"tensor-core launches {tc_counts}, expected "
                             f"{want_tc}")
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
          "launches": counts, "launches_tc": tc_counts,
          "expected_launches": expected})
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
        tc_counts = _read_tc_counts()
        expected = {"flash_decode_paged": 0, "flash_prefill_ragged": 0,
                    "flash_decode": cfg.n_layers * (n_gen - 1),
                    "quant_matmul": n_mlp * cfg.n_layers * n_gen if int8
                    else 0, "block_sparse_matmul": 0, "flash_attention": 0}
        if counts != expected:
            raise AssertionError(f"generate {pname}: launch counts {counts} "
                                 f"!= {expected}")
        # bf16 q and cache at D = 128: every decode step's attention on
        # the tensor-core variant
        if not int8 and tc_counts["flash_decode"] != counts["flash_decode"]:
            raise AssertionError(f"generate {pname}: tensor-core launches "
                                 f"{tc_counts}, expected all "
                                 f"{counts['flash_decode']} flash_decode")
        # K = 3,584 and 18,944: every int8 product on the tensor-core
        # variant (prefill M = 4,096, decode M = 8 swapped)
        if int8 and tc_counts["quant_matmul"] != counts["quant_matmul"]:
            raise AssertionError(f"generate {pname}: tensor-core launches "
                                 f"{tc_counts}, expected all "
                                 f"{counts['quant_matmul']} quant_matmul")
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
              "launches": counts, "launches_tc": tc_counts,
              "sample": host[0, :8].tolist()})
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
    O-task, whose LM fine-tune (AdamW's fp32 moments beside the weights)
    does not fit all 28 layers on one card; phase 11 runs PRUNING on a
    2-layer cut."""
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
    problems = derive_problems(handle, device="cuda")
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
    # bf16 products with K a multiple of 16: both GEMMs on tensor cores
    tc_counts = _read_tc_counts()
    if any(tc_counts[name] != counts[name] for name in GEMM_TC):
        raise AssertionError(f"phase 8 tensor-core launches {tc_counts}, "
                             f"expected every GEMM launch of {counts}")
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
                          "stands in for the PRUNING O-task, whose LM "
                          "fine-tune does not fit 28 layers on one card "
                          "(phase 11 runs it on 2)",
               "sparsity": masked.metrics["sparsity"], "max_live": max_live,
               "problems": len(problems),
               "search_steps": meta.get("tune.result")["search_steps"],
               "launches": counts, "launches_tc": tc_counts,
               "expected_launches": expected, "wall_s": wall,
               "peak_mem_gb": peak, "tile_configs": tuned}
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


# ------------------------------------------------------- phases 9 and 10
# The SERVE O-task's flow (phase 9) and the durability paths (phase 10),
# Qwen2-7B at full width and depth in bf16 with seed-0 weights.
SERVEFLOW = dict(name="qwen2-7b-serveflow", n_requests=8, prompt_len=256,
                 max_new_tokens=16, prefix_share=0.25, seed=11)
SERVEFLOW_SLOTS = 4
PAGED = ("flash_decode_paged", "flash_prefill_ragged", "paged_segment")
TUNE_PER_TRIAL = 1 + 3                  # Tune's default warmup + iters
# 8 requests of 256 + 32 tokens over 4 slots.  A request is admitted with
# 17 pages (its prompt and one segment) and grows to 19; a pool of whole
# lifetimes never preempts (3 lifetimes admit 3 requests, which then grow
# within it), so the pool holds the 4 admissions and DURABLE_SPARE pages:
# growth preempts, and the victims' swap images spill beside the journal
DURABLE = dict(name="qwen2-7b-durable", n_requests=8, prompt_len=256,
               max_new_tokens=32, seed=12)
DURABLE_PLAN = dict(slots=4, page_size=16, segment_len=8)
DURABLE_SPARE = 2

FRESH_PROCESS = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.registry import get_config
from repro_torch.models.api import build_model
from repro_torch.serving import PagedServingEngine, ServingPlan
with open(sys.argv[2]) as f:
    plan = ServingPlan.from_dict(json.load(f))
cfg = get_config(sys.argv[4], smoke=sys.argv[5] == "1")
eng = PagedServingEngine.from_plan(build_model(cfg, device=sys.argv[3]),
                                   plan)
print(json.dumps({"cache": eng.pcfg.to_dict(), "plan": eng.plan.to_dict(),
                  "prefill_mode": eng.prefill_mode,
                  "cache_dtype": str(eng.cache_dtype)}))
"""


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _paged_problems(cfg, device) -> list:
    """The flash_decode_paged, flash_prefill_ragged and paged_segment
    problems of ``derive_problems`` over all its problems (at full width
    the matrix products rank first among the four largest).  An LM's
    stacked weights derive no problem, so a handle on the config alone
    gives the list the flow's MODEL-GEN artifact would."""
    import types
    from repro_torch.tasks.handle import DNNHandle
    from repro_torch.tasks.tune import derive_problems
    handle = DNNHandle(kind="lm", name=cfg.name, params={},
                       model=types.SimpleNamespace(cfg=cfg))
    return [p for p in derive_problems(handle, max_problems=64,
                                       device=device)
            if p["kernel"] in PAGED]


def _tune_launches(probes) -> dict:
    """What Tune launches for its probes: (warmup + iters) a measured
    candidate, SEGMENT_TOKENS decode launches a paged_segment call, none
    for a cache hit."""
    from repro_torch.kernels import autotune
    want = {name: 0 for name in KERNELS}
    for p in probes:
        if p.get("cached"):
            continue
        if p["kernel"] == "paged_segment":
            want["flash_decode_paged"] += TUNE_PER_TRIAL \
                * autotune.SEGMENT_TOKENS
        else:
            want[p["kernel"]] += TUNE_PER_TRIAL
    return want


def phase_serveflow(device="cuda", smoke=False):
    """MODEL-GEN → TUNE → SERVE (``serve_strategy``) at full width, with
    the autotune cache a fresh file that TUNE, the plan readbacks and the
    engine's prefill readback share.  TUNE first settles the page size
    (``flash_decode_paged``), so that the flow's TUNE stage tunes the
    prefill tile and the segment cadence against the page size the pool
    will use; then the flow.  Checks: TUNE's launches, the readbacks'
    provenance, the staged search's pruning and gate, the artifact's
    round trip (also in a fresh process) and every replay launch on the
    tensor-core variants.  Returns (launches of the flow, model, params)."""
    import os

    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategies import run, serve_strategy
    from repro_torch.kernels import autotune
    from repro_torch.serving import (PagedServingEngine, ServingPlan,
                                     TrafficProfile)
    cfg = get_config("qwen2_7b", smoke=smoke)
    OUT.mkdir(exist_ok=True)
    cache = OUT / "serveflow_autotune.json"
    artifact = OUT / "serveflow_plan.json"
    cache.unlink(missing_ok=True)
    artifact.unlink(missing_ok=True)
    old_env = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = str(cache)
    autotune.clear_memory_cache()
    try:
        fpd = next(p for p in _paged_problems(cfg, device)
                   if p["kernel"] == "flash_decode_paged")
        _zero_counts()
        t0 = time.perf_counter()
        pre = autotune.tune("flash_decode_paged",
                            {k: v for k, v in fpd.items() if k != "kernel"},
                            device=device)
        _sync(device)
        pre_s = time.perf_counter() - t0
        n_pre = _read_counts()["flash_decode_paged"]
        if n_pre != TUNE_PER_TRIAL * len(pre.trials) or pre.cached:
            raise AssertionError(f"phase 9 page-size tune: {n_pre} "
                                 f"launches for {len(pre.trials)} trials")
        problems = _paged_problems(cfg, device)
        ps = pre.config["page_size"]
        if sorted(p["kernel"] for p in problems) != sorted(PAGED) or any(
                p.get("page_size", ps) != ps for p in problems):
            raise AssertionError(f"phase 9 problems {problems}, page {ps}")
        prof = TrafficProfile(**SERVEFLOW)
        flow = serve_strategy(
            "qwen2-7b", model_params={"train_en": False, "smoke": smoke},
            tune_params={"problems": problems},
            serve_params={"profile": prof.to_dict(),
                          "slots": SERVEFLOW_SLOTS,
                          "artifact_path": str(artifact)},
            device=device)
        serve_task = flow.tasks[2]
        at_serve = {}
        serve_execute = serve_task.execute

        def execute(meta, inputs):     # the TUNE / SERVE boundary
            _sync(device)
            at_serve.update(launches=_read_counts(), tc=_read_tc_counts(),
                            t=time.perf_counter())
            return serve_execute(meta, inputs)

        serve_task.execute = execute
        _zero_counts()
        t0 = time.perf_counter()
        meta = run(flow)
        _sync(device)
        t_end = time.perf_counter()
        wall = t_end - t0
        counts, tc_counts = _read_counts(), _read_tc_counts()
        tune_counts = at_serve["launches"]
        want = _tune_launches(meta.trace("tune.probe"))
        if tune_counts != want:
            raise AssertionError(f"phase 9 TUNE launches {tune_counts} != "
                                 f"{want}")
        serve_counts = {k: counts[k] - tune_counts[k] for k in counts}
        serve_tc = {k: tc_counts[k] - at_serve["tc"][k] for k in tc_counts}
        paged = ("flash_decode_paged", "flash_prefill_ragged")
        if any(serve_counts[k] < 1 or serve_tc[k] != serve_counts[k]
               for k in paged) or any(serve_counts[k] for k in KERNELS
                                      if k not in paged):
            raise AssertionError(f"phase 9 replay launches {serve_counts}, "
                                 f"tensor-core {serve_tc}")
        if any(tc_counts[k] != counts[k] for k in paged):
            raise AssertionError(f"phase 9 tensor-core launches "
                                 f"{tc_counts} of {counts}")
        res = meta.get("serve.result")
        default = ServingPlan.resolve(
            cfg, slots=SERVEFLOW_SLOTS, max_prompt_len=prof.prompt_len,
            max_new_tokens=prof.max_new_tokens, device=device)
        prov = {k: default.provenance[k] for k in ("page_size",
                                                   "segment_len")}
        if any(v not in ("tuned", "relaxed") for v in prov.values()):
            raise AssertionError(f"phase 9 default plan provenance {prov}")
        if res["n_stage2"] * 2 > res["n_candidates"]:
            raise AssertionError(f"phase 9: stage 2 ran {res['n_stage2']} "
                                 f"of {res['n_candidates']}")
        if not res["objective"] >= res["default_objective"]:
            raise AssertionError(f"phase 9: winner {res['objective']} < "
                                 f"default {res['default_objective']}")
        with open(artifact) as f:
            plan = ServingPlan.from_dict(json.load(f))
        if plan != ServingPlan.from_dict(res["plan"]) or plan != \
                ServingPlan.from_dict(json.loads(json.dumps(plan.to_dict()))):
            raise AssertionError("phase 9: the artifact does not round-trip")
        served = meta.latest("dnn", lambda a: "+V" in a.name).payload
        eng = PagedServingEngine.from_plan(served.model, plan)
        if eng.pcfg != plan.cache or eng.plan != plan \
                or eng.prefill_mode != plan.prefill_mode:
            raise AssertionError("phase 9: from_plan is not the plan")
        src = str(Path(sys.modules["repro_torch"].__file__).parents[1])
        child = subprocess.run(
            [sys.executable, "-c", FRESH_PROCESS, src, str(artifact),
             str(device), "qwen2_7b", "1" if smoke else "0"],
            capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"phase 9 fresh process: {child.stderr}")
        fresh = json.loads(child.stdout.strip().splitlines()[-1])
        if fresh != {"cache": eng.pcfg.to_dict(), "plan": eng.plan.to_dict(),
                     "prefill_mode": eng.prefill_mode,
                     "cache_dtype": str(eng.cache_dtype)}:
            raise AssertionError(f"phase 9 fresh process built {fresh}")
        probes = meta.trace("serve.probe")
        for p in probes:
            emit({"phase": "serveflow_candidate",
                  **{k: p.get(k) for k in (
                      "step", "stage", "candidate", "page_size",
                      "segment_len",
                      "n_pages", "objective", "feasible", "tokens",
                      "wall_s", "decode_s", "preemptions", "n_segments",
                      "admission_p50_s")}})
        tune_done = meta.trace("tune.done")
        emit({"phase": "serveflow", "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "dtype": cfg.act_dtype, "profile": prof.to_dict(),
              "slots": SERVEFLOW_SLOTS, "wall_s": wall,
              "tune_s": at_serve["t"] - t0,
              "serve_s": t_end - at_serve["t"],
              "page_size_pretune": {"config": pre.config, "us": pre.us,
                                    "trials": len(pre.trials),
                                    "wall_s": pre_s,
                                    "trial_us": [[t.config, t.us]
                                                 for t in pre.trials]},
              "tune": [{k: d[k] for k in ("kernel", "config", "us",
                                          "cached")} for d in tune_done],
              "tune_launches": tune_counts,
              "serve_launches": serve_counts,
              "launches": counts, "launches_tc": tc_counts,
              "default_provenance": prov,
              "default_cache": default.cache.to_dict(),
              "objective": res["objective"],
              "default_objective": res["default_objective"],
              "n_candidates": res["n_candidates"],
              "n_stage2": res["n_stage2"], "plan": res["plan"],
              "fresh_process_equal": True})
    finally:
        if old_env is None:
            os.environ.pop(autotune.CACHE_ENV, None)
        else:
            os.environ[autotune.CACHE_ENV] = old_env
        autotune.clear_memory_cache()
    return counts, served.model, served.params


def _durable_model():
    """Phase 10's model when phase 9 did not build one: Qwen2-7B at full
    width and depth, bf16, seed-0 weights (MODEL-GEN's)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    model = build_model(get_config("qwen2_7b"))
    return model, model.init(seed=0)


def _check_row_invariance(model, params, device) -> dict:
    """The products of an admission prefill give a row the same bits
    beside 8 rows or 1,024 (``models/common.py::row_invariant_matmul``):
    layer 0's projections and lm_head through ``linear``, bf16.  Beside
    each, whether one plain ``torch.matmul`` call does too (reported, not
    required: cuBLAS picks its algorithm by the row count)."""
    import torch
    from repro_torch.models.common import linear
    ctx = model.ctx(decode=True)
    blk = params.blocks[0]
    gen = torch.Generator(device=device).manual_seed(7)
    out = {}
    for name, w in (("attn/wq", blk.attn.wq), ("attn/wk", blk.attn.wk),
                    ("mlp/w_up", blk.mlp.w_up), ("mlp/w_down", blk.mlp.w_down),
                    ("lm_head", params.lm_head)):
        x = torch.randn((1024, w.shape[0]), generator=gen,
                        device=device).to(model.cfg.adt)
        full = linear(ctx, name, x.view(4, 256, -1), w).reshape(1024, -1)
        wx = w.to(x.dtype)
        plain = torch.matmul(x, wx)
        plain_equal = {}
        for rows in (8, 264):
            part = linear(ctx, name, x[:rows].view(1, rows, -1), w)[0]
            if not torch.equal(part, full[:rows]):
                raise AssertionError(f"{name}: rows 0..{rows} change bits "
                                     f"beside 1,024 rows")
            plain_equal[rows] = bool(torch.equal(torch.matmul(x[:rows], wx),
                                                 plain[:rows]))
        out[name] = {"shape": list(w.shape),
                     "plain_matmul_rows_equal": plain_equal}
    return out


def _pools_drained(cluster) -> bool:
    for rep in cluster.replicas:
        if rep.fenced:
            continue
        s = rep.run.sched.rm.stats()
        if s["free_pages"] + s["pinned_pages"] \
                != rep.run.pcfg.allocatable_pages \
                or s["held_pages"] != s["pinned_pages"]:
            return False
    return True


def phase_durable(model, params, device="cuda") -> dict:
    """The durability paths at full width on one card: (a) a journaled
    burst, fault-free (in turns with the same burst unjournaled, for the
    journal's overhead), then crashed at a mid-burst boundary
    (``process_crash``) and finished by ``RestartRecovery`` from the
    plan JSON and the journal; (b) a 2-replica ``ServingCluster`` losing
    a replica (``replica_crash``); (c) that cluster journaled, crashed and
    resumed.  Every request's tokens must equal the unjournaled engine's,
    no swap image may outlive the run, and the surviving pools must be
    drained.  Returns the phase's launch counts."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.serving import (DurabilityPolicy, FaultPlan,
                                     PagedServingEngine, ProcessCrashed,
                                     RestartRecovery, ServingCluster,
                                     ServingPlan, TrafficProfile,
                                     replay_journal)
    from repro_torch.serving.cluster import DEAD
    cfg = model.cfg
    prof = TrafficProfile(**DURABLE)
    plan = ServingPlan.resolve(cfg, max_prompt_len=prof.prompt_len,
                               max_new_tokens=prof.max_new_tokens,
                               device=device, **DURABLE_PLAN)
    pc = plan.cache
    admit = pc.pages_for(pc.admission_tokens(prof.prompt_len,
                                             prof.max_new_tokens))
    plan = dataclasses.replace(plan, cache=dataclasses.replace(
        pc, n_pages=pc.max_slots * admit + DURABLE_SPARE + 1))
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_journal_"))

    def durable(name, n_replicas=1):
        d = root / name
        return dataclasses.replace(plan, n_replicas=n_replicas,
                                   durability=DurabilityPolicy(
                                       enabled=True, journal_dir=str(d))), d

    def requests():
        return prof.requests(cfg.vocab_size, page_size=plan.cache.page_size)

    def tokens(reqs):
        return {r.rid: list(r.tokens) for r in reqs if r.failure is None}

    def images(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("img-*"))

    def mismatch(reqs):
        """Per request that differs from the oracle: its tokens' length,
        the first differing position and its failure record."""
        out = {}
        for r in reqs:
            got, want = list(r.tokens), oracle.get(r.rid, [])
            if r.failure is not None or got != want:
                first = next((i for i, (a, b) in enumerate(zip(got, want))
                              if a != b), min(len(got), len(want)))
                out[str(r.rid)] = {
                    "len": len(got), "first_diff": first,
                    "failure": None if r.failure is None
                    else r.failure.record()}
        return out

    eng = PagedServingEngine.from_plan(model, plan)
    out = {"plan_cache": plan.cache.to_dict(),
           "row_invariance": _check_row_invariance(model, params, device)}
    try:
        _zero_counts()
        walls, oracle = {}, None
        # (a) unjournaled and journaled in turns: U, J, J, U
        for i, journaled in enumerate((False, True, True, False)):
            e = eng
            if journaled:
                jplan, d = durable(f"burst{i}")
                e = PagedServingEngine.from_plan(model, jplan)
            reqs = requests()
            t0 = time.perf_counter()
            st = e.run(reqs, params)
            _sync(device)
            walls.setdefault("journaled" if journaled else "plain",
                             []).append(time.perf_counter() - t0)
            got = tokens(reqs)
            if oracle is None:
                oracle, base = got, st
            if got != oracle or st["n_finished"] != prof.n_requests \
                    or st["preemptions"] < 1:
                raise AssertionError(f"phase 10 burst {i}: "
                                     f"{st['n_finished']} finished, "
                                     f"{st['preemptions']} preemptions, "
                                     f"tokens equal {got == oracle}")
            if journaled and (st["journal"]["n_spilled"] < 1 or images(d)):
                raise AssertionError(f"phase 10 journal {i}: "
                                     f"{st['journal']}, left {images(d)}")
        if len(oracle) != prof.n_requests or any(
                len(t) != prof.max_new_tokens for t in oracle.values()):
            raise AssertionError("phase 10: the burst did not finish")
        crash_at = base["n_segments"] // 2
        jplan, d = durable("crash")
        try:
            PagedServingEngine.from_plan(model, jplan).run(
                requests(), params,
                faults=FaultPlan.at(process_crash=crash_at))
            raise AssertionError("phase 10: process_crash did not fire")
        except ProcessCrashed:
            pass
        at_crash = {str(r.rid): r.status
                    for r in replay_journal(str(d)).requests.values()}
        left_at_crash = images(d)
        t0 = time.perf_counter()
        res = RestartRecovery(str(d)).resume(model, params)
        _sync(device)
        resume_s = time.perf_counter() - t0
        if tokens(res["requests"]) != oracle or images(d) \
                or "swapped" not in at_crash.values():
            raise AssertionError(f"phase 10 restart: differ "
                                 f"{mismatch(res['requests'])}, "
                                 f"images left {images(d)}, at the crash "
                                 f"{at_crash}")
        out["burst"] = {
            "profile": prof.to_dict(), "plain_wall_s": walls["plain"],
            "journaled_wall_s": walls["journaled"],
            "journal_overhead": sum(walls["journaled"])
            / sum(walls["plain"]) - 1.0,
            "preemptions": base["preemptions"],
            "n_segments": base["n_segments"], "crash_at": crash_at,
            "status_at_crash": at_crash, "images_at_crash": left_at_crash,
            "recovered": res["recovered"], "resume_s": resume_s,
            "tokens_equal": True}
        # (b) two replicas, one lost
        reqs = requests()
        cl = ServingCluster(eng, params, n_replicas=2,
                            faults=FaultPlan.at(replica_crash=1))
        t0 = time.perf_counter()
        st = cl.run(reqs)
        _sync(device)
        states = [v["state"] for v in st["replicas"].values()]
        if tokens(reqs) != oracle or st["n_dead_lettered"] \
                or states.count(DEAD) != 1 or not _pools_drained(cl):
            raise AssertionError(f"phase 10 cluster: {states}, dead "
                                 f"{st['n_dead_lettered']}, differ "
                                 f"{mismatch(reqs)}")
        out["cluster"] = {"wall_s": time.perf_counter() - t0,
                          "states": states, "rounds": st["rounds"],
                          "n_migrated": st["n_migrated"],
                          "n_restarted": st["n_restarted"],
                          "faults": st["faults"]["fired"],
                          "tokens_equal": True, "pools_drained": True}
        del cl
        # (c) the cluster journaled, crashed and resumed
        cplan, d = durable("cluster", n_replicas=2)
        ceng = PagedServingEngine.from_plan(model, cplan)
        crash_c = st["rounds"] // 2
        try:
            ServingCluster(ceng, params, n_replicas=2,
                           faults=FaultPlan.at(process_crash=crash_c)).run(
                requests())
            raise AssertionError("phase 10: cluster process_crash did not "
                                 "fire")
        except ProcessCrashed:
            pass
        at_crash = {str(r.rid): r.status
                    for r in replay_journal(str(d)).requests.values()}
        t0 = time.perf_counter()
        res = RestartRecovery(str(d)).resume(model, params)
        _sync(device)
        if tokens(res["requests"]) != oracle:
            raise AssertionError(f"phase 10 cluster restart: "
                                 f"{mismatch(res['requests'])}, at the "
                                 f"crash {at_crash}, recovered "
                                 f"{res['recovered']}, "
                                 f"{res['stats'].get('n_dead_lettered')} "
                                 f"dead-lettered")
        # a cluster's resume gives the pre-crash images to no replica's
        # writer, so they stay on disk (as in the JAX package): reported
        out["cluster_restart"] = {"crash_at": crash_c,
                                  "status_at_crash": at_crash,
                                  "recovered": res["recovered"],
                                  "images_left": images(d),
                                  "resume_s": time.perf_counter() - t0,
                                  "tokens_equal": True}
        counts, tc_counts = _read_counts(), _read_tc_counts()
        paged = ("flash_decode_paged", "flash_prefill_ragged")
        if any(counts[k] < 1 or tc_counts[k] != counts[k] for k in paged) \
                or any(counts[k] for k in KERNELS if k not in paged):
            raise AssertionError(f"phase 10 launches {counts}, tensor-core "
                                 f"{tc_counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "durable", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.act_dtype, **out,
          "launches": counts, "launches_tc": tc_counts})
    return counts


# ---------------------------------------------------------------- phase 11
# Qwen2-7B's O-tasks at full width, cut to 2 layers: a trained parameter
# costs 2 (bf16) + 2 (gradient) + 8 bytes (AdamW's two fp32 moments), so
# 28 layers (7.6 B parameters) need ~91 GB before activations; 2 layers
# (1.56 B parameters, the embedding and lm_head included) ~20 GB.
DESIGNFLOW_LM_LAYERS = 2
# the card against the CPU, 3 steps from one CPU-drawn init (phase 11 d)
CARD_CPU_STEPS = 3
JET_CARD_TOL = 1e-4        # jet_dnn under INT8: losses (rel) and weights
LM_CARD_LOSS_RTOL = 2e-3   # qwen2-smoke (bf16 products): losses
LM_CARD_NEAR, LM_CARD_SHARE = 1e-4, 0.95   # weights within, share of them


def _count_int8_linears(modules):
    """Wrap the ``linear`` that each of ``modules`` calls, counting every
    INT8 forward by the quant_matmul variant its K gives and by its M
    (rows).  Returns (counts, restore)."""
    from repro_torch.kernels import gemm_tc
    from repro_torch.quant.policy import INT8
    counts = {"tc": 0, "mma": 0, "m": {}}
    originals = [(mod, mod.linear) for mod in modules]

    def counted_linear(orig):
        def linear(ctx, name, x, w, b=None):
            if ctx.level_for(name) == INT8:
                counts[gemm_tc.qmm_variant(w.shape[0])] += 1
                m = str(x.numel() // x.shape[-1])
                counts["m"][m] = counts["m"].get(m, 0) + 1
            return orig(ctx, name, x, w, b)
        return linear

    for mod, orig in originals:
        mod.linear = counted_linear(orig)

    def restore():
        for mod, orig in originals:
            mod.linear = orig
    return counts, restore


def _check_int8_launches(part, counts, int8) -> dict:
    """quant_matmul launched once per INT8 ``linear`` forward, each on the
    variant its K gives."""
    from repro_torch.kernels import quant_matmul as qmm
    got = {"launches": qmm.launches, "launches_tc": qmm.launches_tc}
    want = {"launches": int8["tc"] + int8["mma"], "launches_tc": int8["tc"]}
    if got != want or counts["quant_matmul"] != got["launches"]:
        raise AssertionError(f"phase 11 ({part}): quant_matmul {got}, INT8 "
                             f"linear forwards {int8}")
    return {**got, "int8_linears_by_m": int8["m"]}


def _probe_trace(meta) -> dict:
    """Each O-task's probes: candidate, accuracy, feasible and the
    resource metrics recorded with it."""
    keys = ("rate", "scale", "assignment", "accuracy", "feasible",
            "effective_macs", "weight_bits", "sparsity")
    out = {}
    for task, event in (("S", "scaling.probe"), ("P", "pruning.probe"),
                        ("Q", "quantization.probe")):
        probes = [{k: p[k] for k in keys if k in p}
                  for p in meta.trace(event)]
        if probes:
            out[task] = probes
    return out


def _flow_summary(meta, order: str) -> dict:
    """The selected results and each task's wall seconds; effective MACs
    and weight bits against MODEL-GEN's."""
    gen = next(iter(meta.models("dnn"))).metrics
    last = meta.latest("dnn").metrics
    results = {}
    for ch, key in (("S", "scaling.result"), ("P", "pruning.result"),
                    ("Q", "quantization.result")):
        res = meta.get(key)
        if ch in order and res is not None:
            results[ch] = {k: res[k] for k in (
                "scale", "pruning_rate", "assignment", "accuracy",
                "base_accuracy", "search_steps", "effective_macs",
                "weight_bits") if k in res}
    return {"task_s": {e["task"]: round(e["seconds"], 3)
                       for e in meta.trace("task.done")},
            "model_gen_accuracy": gen["accuracy"], "results": results,
            "effective_macs": [gen["effective_macs"],
                               last["effective_macs"]],
            "weight_bits": [gen["weight_bits"], last["weight_bits"]],
            "effective_macs_ratio": last["effective_macs"]
            / gen["effective_macs"],
            "weight_bits_ratio": last["weight_bits"] / gen["weight_bits"]}


def _designflow_bench(model: str, order: str, *, int8_modules=(),
                      device="cuda", cfg=None):
    """``combined_strategy(model, order)`` at the JAX package's defaults
    (or the meta-model ``cfg``) on ``device``; launch counts read just
    after.  Returns (meta, line)."""
    import torch
    from repro_torch.core.metamodel import MetaModel
    from repro_torch.core.strategies import combined_strategy
    int8, restore = _count_int8_linears(int8_modules)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        meta = combined_strategy(model, order,
                                 model_params={"device": device}).execute(
                                     MetaModel(dict(cfg or {})))
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    line = {"model": model, "order": order, "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "probes": _probe_trace(meta), **_flow_summary(meta, order),
            "launches": counts, "launches_tc": _read_tc_counts()}
    if int8_modules:
        line["quant_matmul"] = _check_int8_launches(order, counts, int8)
    return meta, line


def _spq_resnet9(**kw) -> dict:
    """(a) Fig. 2(b) on ResNet9 at its published widths: SCALING →
    PRUNING → QUANTIZATION, MODEL-GEN 3,072 samples and 5 epochs."""
    from repro_torch.models import cnn
    meta, line = _designflow_bench("resnet9", "SPQ", int8_modules=(cnn,),
                                   **kw)
    if meta.get("quantization.result") is None or \
            line["weight_bits_ratio"] > 1.0:
        raise AssertionError(f"phase 11 (a): {line['results']}")
    return line


def _flow_state(meta) -> tuple:
    """The probe traces (timestamps and seconds dropped) and the final
    artifact's parameters and masks."""
    from repro_torch.sparsity.masks import flatten_params
    events = [{k: v for k, v in e.items() if k not in ("t", "seconds")}
              for e in meta.log if e["event"] != "task.start"]
    art = meta.latest("dnn").payload
    return events, flatten_params(art.params), dict(art.masks or {})


def _qp_jet_dnn(**kw) -> dict:
    """(b) QUANTIZATION → PRUNING on jet_dnn: PRUNING fine-tunes under the
    INT8 policy QUANTIZATION chose, so quant_matmul runs in training's
    forward.  Run twice with one seed: the traces and the final weights
    must be equal bit for bit."""
    import torch
    from repro_torch.models import cnn
    runs = []
    for _ in range(2):
        meta, line = _designflow_bench("jet_dnn", "QP", int8_modules=(cnn,),
                                       **kw)
        runs.append((line, _flow_state(meta)))
        del meta
    (line, (ev0, p0, m0)), (line1, (ev1, p1, m1)) = runs
    same = {"trace": ev0 == ev1,
            "params": list(p0) == list(p1) and all(
                torch.equal(p0[k], p1[k]) for k in p0),
            "masks": list(m0) == list(m1) and all(
                torch.equal(m0[k], m1[k]) for k in m0),
            "launches": line["quant_matmul"] == line1["quant_matmul"]}
    assignment = line["results"]["Q"]["assignment"]
    train_int8 = sum(n for m, n in line["quant_matmul"][
        "int8_linears_by_m"].items() if m == "128")
    if not all(same.values()) or "int8" not in assignment.values() \
            or not train_int8:
        raise AssertionError(f"phase 11 (b): same={same}, assignment "
                             f"{assignment}, INT8 training forwards "
                             f"{train_int8}")
    line.update(bit_identical_rerun=same, int8_training_forwards=train_int8,
                wall_s_second=line1["wall_s"], launches_second=line1[
                    "launches"])
    return line


def _qp_qwen2(**kw) -> dict:
    """(c) QUANTIZATION → PRUNING on Qwen2-7B at full width, cut to
    :data:`DESIGNFLOW_LM_LAYERS` layers, MODEL-GEN training 5 steps."""
    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.models import layers, transformer
    full = qwen2_7b.CONFIG
    qwen2_7b.CONFIG = full.replace(n_layers=DESIGNFLOW_LM_LAYERS)
    try:
        meta, line = _designflow_bench("qwen2-7b", "QP",
                                       int8_modules=(layers, transformer),
                                       **kw)
    finally:
        qwen2_7b.CONFIG = full
    qm = line["quant_matmul"]
    rows = set(qm["int8_linears_by_m"])
    if qm["launches_tc"] != qm["launches"] or not qm["launches"] \
            or not rows <= {"1024", "256"}:
        raise AssertionError(f"phase 11 (c): quant_matmul {qm}")
    handle = meta.latest("dnn").payload
    if handle.masks is None or any(p.requires_grad
                                   for p in handle.params.parameters()):
        raise AssertionError("phase 11 (c): the pruned LM carries no masks "
                             "or trains on")
    line.update(
        layers=DESIGNFLOW_LM_LAYERS, d_model=full.d_model, d_ff=full.d_ff,
        vocab=full.vocab_size, dtype=full.param_dtype,
        cut=f"{full.n_layers} -> {DESIGNFLOW_LM_LAYERS} layers: AdamW's two "
            f"fp32 moments make a trained parameter 12 bytes, 28 layers "
            f"~91 GB; 2 layers ~20 GB",
        int8_training_forwards=qm["int8_linears_by_m"].get("256", 0),
        int8_training_note="PRUNING's LM fine-tune runs under the model's "
                           "own policy (bf16), as in the JAX package; the "
                           "INT8 policy reaches evaluation (M = 1,024)")
    del meta, handle
    torch.cuda.empty_cache()
    return line


def _card_vs_cpu() -> dict:
    """(d) ``train_classifier`` (jet_dnn under the INT8 policy) and
    ``lm_finetune`` (qwen2-smoke, unstructured masks at 0.3) for
    :data:`CARD_CPU_STEPS` steps from one CPU-drawn init and the same
    batches, on the CPU (plain versions) and on the card."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic
    from repro_torch.models.api import build_model
    from repro_torch.models.cnn import init_jet_dnn, jet_dnn_apply
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.sparsity.masks import build_masks, prunable_paths
    from repro_torch.tasks.train_utils import lm_finetune, train_classifier
    out = {}
    params = init_jet_dnn(torch.Generator().manual_seed(0))
    data = synthetic.jet_dataset(CARD_CPU_STEPS * 128, seed=1)
    policy = PrecisionPolicy(default="int8")
    runs = [train_classifier(tree_map(lambda t: t.to(dev), params),
                             jet_dnn_apply, data, epochs=1, policy=policy,
                             seed=3) for dev in ("cpu", "cuda")]
    (pc, lc), (pg, lg) = runs
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    w_abs = max(float((a - b.cpu()).abs().max()) for a, b in
                zip(tree_leaves(pc), tree_leaves(pg)))
    out["jet_dnn_int8"] = {"steps": len(lc), "loss_max_rel": loss_rel,
                           "weight_max_abs": w_abs, "tol": JET_CARD_TOL}
    if not (len(lc) == CARD_CPU_STEPS and loss_rel <= JET_CARD_TOL
            and w_abs <= JET_CARD_TOL):
        raise AssertionError(f"phase 11 (d) jet_dnn: {out}")

    cfg = get_config("qwen2_7b", smoke=True)
    cpu_model = build_model(cfg, device="cpu")
    gpu_model = build_model(cfg, device="cuda")
    lm = cpu_model.init(0)
    lm_gpu = gpu_model.empty_params()
    lm_gpu.load_state_dict(lm.state_dict())
    masks = build_masks(lm, 0.3, "unstructured",
                        prunable_paths(lm, min_size=64))

    def batches(s):
        t = synthetic.lm_tokens(4 * 64 + 1, cfg.vocab_size, seed=100 + s)
        return {"tokens": t[:-1].reshape(4, 64),
                "labels": t[1:].reshape(4, 64)}

    tc, lc = lm_finetune(cpu_model, lm, batches, steps=CARD_CPU_STEPS,
                         masks=masks)
    tg, lg = lm_finetune(gpu_model, lm_gpu, batches, steps=CARD_CPU_STEPS,
                         masks={k: v.cuda() for k, v in masks.items()})
    sd_g = tg.state_dict()
    diffs = torch.cat([(v.float() - sd_g[k].float().cpu()).abs().reshape(-1)
                       for k, v in tc.state_dict().items()])
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    near = float((diffs <= LM_CARD_NEAR).float().mean())
    bound = 2 * 1e-3 * CARD_CPU_STEPS + 1e-6
    out["qwen2_smoke_masked"] = {
        "steps": len(lc), "loss_max_rel": loss_rel,
        "weight_max_abs": float(diffs.max()),
        "share_within": [LM_CARD_NEAR, near], "tol": {
            "loss_rel": LM_CARD_LOSS_RTOL, "share": LM_CARD_SHARE,
            "max": bound}}
    if not (loss_rel <= LM_CARD_LOSS_RTOL and near >= LM_CARD_SHARE
            and float(diffs.max()) <= bound):
        raise AssertionError(f"phase 11 (d) qwen2-smoke: {out}")
    return out


def phase_designflow(device="cuda", cfg=None) -> dict:
    """The paper's design flow with training on the card: (a) ResNet9
    SPQ, (b) jet_dnn QP twice, (c) Qwen2-7B QP on 2 layers, (d) the card
    against the CPU.  Every part's counts are set to 0 before it and read
    after; returns the sums of (a)-(c).  ``device`` and the meta-model
    ``cfg`` (smaller flows) serve a rehearsal on the CPU."""
    import torch
    total = {name: 0 for name in KERNELS}
    for part, fn in (("a", _spq_resnet9), ("b", _qp_jet_dnn),
                     ("c", _qp_qwen2)):
        line = fn(device=device, cfg=cfg)
        emit({"phase": "designflow", "part": part, **line})
        for counts in (line["launches"], line.get("launches_second", {})):
            for name, n in counts.items():
                total[name] += n
        torch.cuda.empty_cache()
    if device != "cuda":
        return total
    t0 = time.perf_counter()
    cmp = _card_vs_cpu()
    emit({"phase": "designflow", "part": "d", **cmp,
          "wall_s": time.perf_counter() - t0})
    return total


PREFILL_RANGE = "burst_prefill"


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
    admit = eng._admit_batch

    def traced_admit(*args, **kwargs):   # the admission dispatches' range
        with torch.profiler.record_function(PREFILL_RANGE):
            return admit(*args, **kwargs)

    eng._admit_batch = traced_admit
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = eng.run(reqs, lm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = st["n_segments"] * pcfg.segment_len
    summary = _profile_summary(prof, wall, "profile.txt")
    # device time of the kernels the admission dispatches launched
    prefill_us = sum(e.device_time_total for e in prof.key_averages()
                     if e.key == PREFILL_RANGE
                     and e.device_type == torch.autograd.DeviceType.CPU)
    emit({"phase": "profile", "requests": len(reqs), "new_tokens": 16,
          "wall_s": wall, "prefill_s": st["prefill_s"],
          "decode_s": st["decode_s"], "decode_steps": steps,
          "n_prefill_dispatches": st["n_prefill_dispatches"],
          "prefill_device_s": prefill_us / 1e6,
          "prefill_share_of_device_time":
              prefill_us / 1e6 / summary["device_busy_s"], **summary})
    del eng
    torch.cuda.empty_cache()
    _profile_generate(cfg, lm)


def _profile_summary(prof, wall: float, table: str) -> dict:
    """Device busy time and idle share over ``wall``, the top kernels
    and host ops; the full table goes to ``chiprun_out/<table>``."""
    import torch
    events = prof.key_averages()
    # device-side events only: a host op's device time repeats its
    # kernels' time (and a user range's device span is no kernel)
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key != PREFILL_RANGE]
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


# A spin on the card long enough (about 0.5 ms) for the host to prepare
# and enqueue the timed call behind it (a decode wrapper's call takes
# about 0.05 ms of host time, more on a busy host).
HOST_COVER_CYCLES = 1_000_000


def _time_ms(fn, reps: int, flush) -> float:
    """Median of CUDA-event times of single calls, with the 50 MB L2
    flushed before each (the serving path finds K/V cold) and the card
    kept busy while the host prepares the call (``torch.cuda._sleep``),
    so that a fast kernel's time is the card's and not the wrapper's
    launch overhead."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms_by_kernel(fn, flush, reps: int = 20,
                         match: str = "decode") -> dict:
    """Mean device time of each kernel of ``fn`` whose name holds
    ``match`` over ``reps`` calls, each after an L2 flush, from
    torch.profiler (the flush's own kernel left out): where a two-kernel
    call's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.count == reps and match in e.key}


def phase_timing(launches: dict) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode_paged as fdp
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
    launch = dict(fdp.last_launch)
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
    rows.append({**_row("flash_decode_paged",
                        "src/repro_torch/csrc/flash_decode_paged.cu",
                        "src/repro/kernels/flash_decode_paged.py:74",
                        launches, err, bf16_tol(ref),
                        lambda: fdp.flash_decode_paged(q, kp, vp, bt, mask),
                        lambda: fdp.flash_decode_paged_plain(q, kp, vp, bt,
                                                             mask),
                        lib, nbytes, flops, flush,
                        {"R": r, "H": h, "KV": kvh, "D": d, "page_size": ps,
                         "M": m, "seq_lens": seq[0], "dtype": "bfloat16"}),
                 **launch, "device_ms_by_kernel": _device_ms_by_kernel(
                     lambda: fdp.flash_decode_paged(q, kp, vp, bt, mask),
                     flush)})

    # prefill: the burst's fresh dispatch, 8 x 512-token prompts, then its
    # shared-prefix dispatch, 8 x 256-token suffixes after 256 shared
    # positions
    s = c["prompt_len"]
    row = _prefill_row(gen, launches, flush, sdpa_gqa, [0] * r, [s] * r, s)
    shared = _prefill_row(gen, launches, flush, sdpa_gqa,
                          [c["prefix_len"]] * r,
                          [s - c["prefix_len"]] * r, s - c["prefix_len"])
    row["shared_prefix"] = {key: shared[key] for key in SUB_ROW_KEYS}
    rows.append(row)
    rows.append(_flash_decode_row(gen, launches, flush, sdpa_gqa))
    rows.append(_quant_matmul_row(gen, launches, flush))
    rows.append(_block_sparse_row(launches, flush))
    rows.append(_flash_attention_row(launches, flush, sdpa_gqa))
    emit({"phase": "timing", "kernels": rows})
    return rows


SUB_ROW_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "variant", "tiles", "shapes")


def _prefill_row(gen, launches, flush, sdpa_gqa, offs, lens, s) -> dict:
    """flash_prefill_ragged at the phase-5 pool (R = 8, H = 28 over
    KV = 4, D = 128, page size 16, 37 pages a request) in bf16: suffixes
    of ``s`` positions at ``offs`` with ``lens`` live.  Bytes: q and out,
    the live K/V and the tables once; operations: 4 * H * D * the causal
    pairs.  Library: SDPA over K/V gathered to contiguous, with the
    layer's mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill_ragged as fpr
    from repro_torch.models import layers as L
    c = SERVE
    r, h, kvh, d = c["max_slots"], 28, 4, 128
    ps, m, item = c["page_size"], c["max_blocks"], 2
    args = _prefill_inputs(gen, r, s, h, kvh, d, ps, m, offs, lens,
                           torch.bfloat16)
    q, kp, vp, bt, off, ln = args
    out = fpr.flash_prefill_ragged(*args)
    tiles = {"block_q": fpr.last_launch["block_q"], "block_kv":
             fpr.TC_BLOCK_KV if fpr.last_launch["variant"] == "tc" else None}
    variant = fpr.last_launch["variant"]
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
    row = _row("flash_prefill_ragged",
               "src/repro_torch/csrc/flash_prefill_ragged.cu",
               "src/repro/kernels/flash_prefill_ragged.py:110",
               launches, err, bf16_tol(ref),
               lambda: fpr.flash_prefill_ragged(*args),
               lambda: fpr.flash_prefill_ragged_plain(*args),
               lib, nbytes, flops, flush,
               {"R": r, "S": s, "H": h, "KV": kvh, "D": d,
                "page_size": ps, "M": m, "offsets": offs[0],
                "lens": lens[0], "dtype": "bfloat16"})
    row.update(variant=variant, tiles=tiles)
    return row


def _block_sparse_row(launches, flush) -> dict:
    """Problem 3 of phase 8: x (128, 3584) bf16 @ a (3584, 152064) bf16
    weight under a 50 % block mask (``block_mask``), at block_m 32 to 256
    (the row's ``ms`` at the default 128), with the variant and M tile
    each ran.  Bytes: x, the live
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
    launch = dict(getattr(bsmm, "last_launch", {}))
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
    row["variant"] = launch.get("variant")
    row["tiles"] = {"block_m": launch.get("block_m")}
    # block_m requests and the M tile each ran (bf16: the tensor-core
    # tiles; 256 clamps to M = 128)
    row["ms_by_block_m"], row["tile_by_block_m"] = {}, {}
    for bm in (32, 64, 128, 256):
        row["ms_by_block_m"][bm] = _time_ms(
            lambda bm=bm: bsmm.block_sparse_matmul(x, wm, kidx, block_m=bm),
            20, flush)
        row["tile_by_block_m"][bm] = getattr(bsmm, "last_launch",
                                             {}).get("block_m")
    return row


def _flash_attention_row(launches, flush, sdpa_gqa) -> dict:
    """Problem 4 of phase 8: (1, 512) queries and keys, H = 28 over KV = 4,
    D = 128, fp32, causal, default tiles (the fp32 kernel); then the same
    shape and Qwen2-7B prefill scale (1, 4096) in bf16, causal (the
    tensor-core kernel at its default tiles).  Bytes: q, k, v and out
    once; operations: 4 * D * H * the causal pairs, over the fp32
    (67 TFLOP/s, CUDA cores) or bf16 (989) peak.  Library:
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for s, dtype, peak in ((512, torch.float32, H100_FP32_FLOPS),
                           (512, torch.bfloat16, H100_BF16_FLOPS),
                           (4096, torch.bfloat16, H100_BF16_FLOPS)):
        h, kvh, d = 28, 4, 128
        q = torch.randn((1, s, h, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((1, s, kvh, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((1, s, kvh, d), generator=g, device="cuda").to(dtype)
        out = fa.flash_attention(q, k, v)
        launch = dict(fa.last_launch)
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
        row = _row(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:91", launches, err, tol,
            lambda: fa.flash_attention(q, k, v),
            lambda: fa.flash_attention_plain(q, k, v), lib, nbytes, flops,
            flush, {"B": 1, "S": s, "H": h, "KV": kvh, "D": d,
                    "causal": True,
                    "dtype": str(dtype).removeprefix("torch.")},
            peak_ops=peak)
        row.update(variant=launch.pop("variant"), tiles=launch)
        rows.append(row)
    row, bf16_512, prefill = rows
    row["bf16_512"] = {key: bf16_512[key] for key in SUB_ROW_KEYS}
    row["prefill_4096"] = {key: prefill[key] for key in SUB_ROW_KEYS}
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
    launch = dict(fd.last_launch)
    ref = fd.flash_decode_plain(q, k, v, mask)
    err = float((out.float() - ref.float()).abs().max())
    live = pos + 1
    nbytes = 2 * b * live * kvh * d * item + 2 * q.numel() * item + n
    flops = 4 * b * h * d * live
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    am = mask[None, None, None, :]
    lib = (lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=am, enable_gqa=True)) if sdpa_gqa else None
    return {**_row("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
                   "src/repro/kernels/flash_decode.py:130", launches, err,
                   bf16_tol(ref), lambda: fd.flash_decode(q, k, v, mask),
                   lambda: fd.flash_decode_plain(q, k, v, mask), lib,
                   nbytes, flops, flush,
                   {"B": b, "H": h, "KV": kvh, "D": d, "L": n, "pos": pos,
                    "dtype": "bfloat16"}),
            **launch, "device_ms_by_kernel": _device_ms_by_kernel(
                lambda: fd.flash_decode(q, k, v, mask), flush)}


# Qwen2-7B's gate/up projection at decode (the row's own numbers) and at
# the phase-5 prefill, its down projection at decode and at prefill,
# TUNE's two quant_matmul problems (embed and lm_head at M = 128), and the
# MLP of an INT8 training forward (4 x 64 tokens, phase 11's LM batch):
# (label, M, K, N)
QMM_ROWS = (("gate_up_8", 8, 3584, 18944), ("prefill", 4096, 3584, 18944),
            ("down_8", 8, 18944, 3584), ("prefill_down", 4096, 18944, 3584),
            ("tune_embed", 128, 152064, 3584),
            ("tune_lm_head", 128, 3584, 152064),
            ("train_up_256", 256, 3584, 18944),
            ("train_down_256", 256, 18944, 3584))
QMM_SUB_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_note", "quantize_ms", "wrapper_ms", "max_abs_err",
                "shapes", "variant", "tiles", "swap", "splits",
                "device_ms_by_kernel")


def _quant_matmul_row(gen, launches, flush) -> dict:
    """The int8 product on operands already quantized, at each shape of
    :data:`QMM_ROWS`, with the variant, tiles and splits that ran, and the
    weight quantization that every call also pays (``quantize_ms``) and
    the whole wrapper (``wrapper_ms``) timed beside it.  Library:
    ``torch._int_mm`` on the same int8 operands (int32 out, no
    dequantization), which refuses M <= 16."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    row = None
    for label, m, k, n in QMM_ROWS:
        x = torch.randn((m, k), generator=gen).to(torch.bfloat16).cuda()
        w = (0.02 * torch.randn((k, n), generator=gen)).to(
            torch.bfloat16).cuda()
        ops = qmm.quantize_operands(x, w)
        xq, xs, wq, ws = ops
        out = qmm.int8_matmul(*ops)
        launch = dict(getattr(qmm, "last_launch", {}))
        ref = qmm.int8_matmul_plain(*ops)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        del out, ref
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
                         "operands": "int8, quantized", "shape": label},
                 peak_ops=H100_INT8_OPS)
        r["library_note"] = why or "torch._int_mm, int32 out"
        r["quantize_ms"] = _time_ms(lambda: qmm.quantize_operands(x, w), 5,
                                    flush)
        r["wrapper_ms"] = _time_ms(lambda: qmm.quant_matmul(x, w), 5, flush)
        r.update(variant=launch.get("variant"), tiles=launch.get("tiles"),
                 swap=launch.get("swap"), splits=launch.get("splits"))
        if m == 8:      # split K: the partial products and the combine
            r["device_ms_by_kernel"] = _device_ms_by_kernel(
                lambda: qmm.int8_matmul(*ops), flush, match="qmm")
        if row is None:
            row = r
        else:
            row[label] = {key: r[key] for key in QMM_SUB_KEYS if key in r}
        del x, w, ops, xq, xs, wq, ws, wt, lib
        torch.cuda.empty_cache()
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
    ap.add_argument("--phases", default="1,2,3,4,5,6,8,9,10,11",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch to drive (default: "
                         "this checkout's); another commit's src/ with "
                         "--phases 1,6 times its kernels with this "
                         "script's rows")
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
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # fp32 products and convolutions in full fp32 on the card, as the
    # plain versions they are compared with (cuDNN would use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    (OUT / "chip_smoke.jsonl").unlink(missing_ok=True)
    smi = phase_device(src)
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
    designflow_launches = phase_designflow() if 11 in phases else {}
    flow_launches, durable_launches = {}, {}
    if 9 in phases or 10 in phases:
        model = params = None
        if 9 in phases:
            flow_launches, model, params = phase_serveflow()
        if 10 in phases:
            if model is None:
                model, params = _durable_model()
            durable_launches = phase_durable(model, params)
        del model, params
        torch.cuda.empty_cache()
    # block_sparse_matmul and flash_attention run on phase 8's path only
    for name in ("block_sparse_matmul", "flash_attention"):
        launches[name] = tune_launches.get(name, 0)
    rows = phase_timing(launches) if 6 in phases else []
    for row in rows:
        row["tune_launches"] = tune_launches.get(row["name"], 0)
        row["serveflow_launches"] = flow_launches.get(row["name"], 0)
        row["durable_launches"] = durable_launches.get(row["name"], 0)
        row["designflow_launches"] = designflow_launches.get(row["name"], 0)
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
