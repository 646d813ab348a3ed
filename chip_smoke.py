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
               and the batch; flash_decode also at zamba2-2.7b's shared
               attention (B 8, H = KV = 32, D = 80, the fp32 CUDA-core
               variant in bf16 too) and quant_matmul at its MLP (M = 8
               and 4,096, exactly equal); flash_decode at whisper-small's
               decoder (B 8, H = KV = 12: g = 1, D = 64, 68 live slots of
               69; "tc", two launches and a subset of the batch bit for
               bit) and quant_matmul at its MLP (M = 8 and 12,000,
               exactly equal), and at starcoder2-3b's in phase 15's
               training forward (M = 1,024, exactly equal);
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
               projection (M = 8) and TUNE's two problems (M = 128);
               sub-rows at phase 12's shapes: the paged pair and
               flash_decode at granite's H = 16 over KV = 8, D = 64,
               quant_matmul at DeepSeek-V2's shared experts (M = 4 and
               1,024); sub-rows at phase 13's: flash_decode at zamba2's
               D = 80 and quant_matmul at its shared MLP; at phase 14's:
               flash_decode at whisper-small's g = 1 and quant_matmul at
               its MLP (M = 8 and 12,000); at phase 15's:
               quant_matmul at starcoder2-3b's training MLP (M = 1,024);
               the rows name the variant and tiles (decode: chunk and
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
               phase 6, whose rows report its launch counts;
12. families — the MoE family (MLA attention and the MoE FFN, plain
               PyTorch products as in the JAX package; fp32 products
               without TF32): (a) granite-moe-1b-a400m at full width and
               depth (24 layers, 32 experts top-8, fp32 weights from seed
               0, bf16 activations and cache) behind the paged engine on
               the phase-5 burst — launch counts, every paged launch on
               "tc" at D = 64, one MoE host read a layer a forward, two
               requests served again alone bit-identical — then
               contiguous ``generate`` (batch 8, 512-token prompts, 64 new,
               every flash_decode launch on "tc") and a torch.profiler
               breakdown of 4 of its decode steps; (b) DeepSeek-V2 at full
               width (MLA, 160 routed experts top-6, 2 shared) cut to 2 of
               60 layers, bf16, ``generate`` (batch 4, 256-token prompts,
               32 new) under the bf16 policy (no kernel runs) and the
               int8-mlp policy (quant_matmul for each shared-expert
               product, all on "tc"), and a profile of 4 decode steps
               under each; (c) the CPU against the card from
               one set of fp32 weights: granite on 2 layers through the
               paged engine and ``generate``, DeepSeek-V2 on 1 layer
               through ``generate`` under both policies.  Runs before
               phase 6, whose rows report its launch counts;
13. ssm_hybrid — the SSM and hybrid families through contiguous
               ``generate`` (the paged engine refuses both, in both
               packages), batch 8, 512-token prompts, 64 new tokens:
               (a) zamba2-2.7b at full width and depth (54 Mamba2 layers,
               the weight-shared attention+MLP block after every 6, bf16
               weights from seed 0) under the bf16 and the int8-mlp
               policy — flash_decode 9 launches a decode step, all on the
               fp32 CUDA-core variant at D = 80, quant_matmul 27 a
               forward under int8-mlp, all "tc" — with each request's
               recurrent state beside its K/V bytes and a profile of 4
               decode steps; (b) xlstm-125m at full width and depth (6
               mLSTM/sLSTM pairs, fp32 weights) under the bf16 policy, no
               kernel launched, and its profile; (c) for each, a prefill
               of 511 tokens plus one decode step against the 512-token
               prefill's last logits: in fp32 within one bf16 ulp of the
               largest, the served bf16 configuration reported beside;
               (d) the CPU against the card in fp32 (zamba2 on one
               segment of 6 layers, xlstm whole), greedy tokens equal on
               the decided rows.  Runs before phase 6, whose rows report
               its launch counts;
14. encdec   — the encoder-decoder family: (a) whisper-small whole (12 +
               12 layers, d_model 768, 12 heads of 64, d_ff 3,072, vocab
               51,865, 1,500 frames; fp32 weights from seed 0) through
               contiguous ``generate`` with stub frames (batch 8, a
               4-token prompt, 64 new tokens) under the bf16 and the
               int8-mlp policy — flash_decode 12 a decode step, all "tc"
               at g = 1, quant_matmul at every ``mlp/…`` product of the
               encoder, the prefill and each step under int8-mlp, all
               "tc" — with the encoder timed alone, a request's cross K/V
               bytes, peak memory and a profile of 4 decode steps split
               into self-attention, cross-attention and MLP; (b) a
               prefill of 3 tokens and one decode step against the
               4-token prefill's last logits (fp32 within one bf16 ulp of
               the largest, the served bf16 one reported); (c) the CPU
               against the card in fp32 at whisper-small's width cut to
               whisper-smoke's 2 + 2 layers, greedy tokens equal on the
               decided rows.  Runs before phase 6, whose rows report its
               launch counts;
15. train    — the single-device trainer on starcoder2-3b (30 layers,
               d_model 3,072, 24 heads over 2 KV, d_ff 12,288, vocab
               49,152, bf16 weights, remat "dots"), batch 8 x 128 tokens
               of ``lm_tokens``: (a) ``launch/train.main`` at full width
               cut to 2 layers, 8 steps with a checkpoint every 3 and a
               node failure injected at step 5, against the same run
               without it — one restart, 2 steps replayed, final losses
               within 1e-5, the final states compared bit for bit (and,
               if they differ, the ops that break determinism named) —
               then a resume after a stop (6 steps, then 10 over the same
               directory: 4 run) and a bf16 leaf restored bit for bit,
               with the checkpoint seconds and bytes; (b)
               ``make_train_step`` on all 30 layers under bf16 and
               int8-mlp, 1 warm-up and 3 timed steps each (step ms,
               tokens/s, the share of 989 TFLOP/s as ``mfu``, peak
               memory; quant_matmul launched 2 x 30 a step under
               int8-mlp, all "tc", none in the backward; the MLP weights
               move), and one step with remat "none" (its peak and step
               time: what the selective checkpoint costs); (c)
               (a)'s cut with gradient compression (finite losses,
               nonzero residuals); (d) one fp32 step at full width on 1
               layer, the CPU against the card.  Runs before phase 6,
               whose rows report its launch counts.

16. dist     — distribution: (a) ``launch/train.py --mesh 1x1`` on a
               real one-rank NCCL mesh (DTensors) against phase 15's
               unsharded trainer (in memory) — starcoder2-3b at full width cut
               to 2 layers, 3 steps of 8 x 128 under bf16 and int8-mlp,
               the final checkpoints and the losses bit for bit, both
               trainers' step ms, quant_matmul 2 x 2 x 3
               launches under int8-mlp, all "tc" — then 8 greedy decode
               steps of ``make_decode_step`` on the mesh (flash_decode
               16 launches) with tokens equal to ``generate``'s; (b) the
               dry run on the host of Qwen2-7B on the reference's 16 x 16
               mesh (a placeholder world of 256, H100 constants):
               ``dryrun_flow(..., "decode_32k", "H")``, three probes over
               ``cache_seq_axis`` with their rooflines and the rules'
               fallbacks (the reference's, string for string), the best
               config, and Lower → Compile → Roofline at train_4k; (c)
               rank 0 of (b)'s best decode_32k config executed on the card
               (28 layers, 8 requests, every cache slot live, collectives
               stubbed): the card's peak within 25 % of Compile's
               prediction, and the step's ms.  Runs before phase 6, whose
               rows report its launch counts.

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

Usage: ``python3 chip_smoke.py [--phases
1,2,3,4,5,6,8,9,10,11,12,13,14,15,16[,7]] [--src DIR]``; ``--phases 1,2,9,10``
builds the kernels and drives the SERVE and durability paths alone,
``--phases 1,2,3,11`` the design flow with training, ``--phases 1,2,12``
the MoE family, ``--phases 1,2,3,13`` the SSM and hybrid families,
``--phases 1,2,3,14`` the encoder-decoder family, ``--phases 1,2,3,15``
the trainer, ``--phases 1,2,16`` distribution.
``--src`` drives the ``repro_torch`` under another tree (e.g. the parent
commit unpacked beside this one) with this script's phases; with
``--phases 1,6`` that times both commits' kernels with the same rows in one
call.
"""

from __future__ import annotations

import argparse
import contextlib
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
# attention shapes (H, KV, D): Qwen2-7B's (phases 5 and 8),
# granite-moe-1b-a400m's (phase 12), zamba2-2.7b's shared block
# (phase 13: D = 80, the fp32 CUDA-core variant in bf16 too) and
# whisper-small's decoder (phase 14)
QWEN_ATTN = (28, 4, 128)
GRANITE_ATTN = (16, 8, 64)
ZAMBA_ATTN = (32, 32, 80)
# whisper-small's decoder self-attention (phase 14): MHA, g = 1, D = 64
WHISPER_ATTN = (12, 12, 64)
# phase 14's traffic: batch 8, 1,500 stub frames each, a 4-token decoder
# prompt (Whisper's start-of-transcript sequence), 64 new tokens
WHISPER = dict(batch=8, prompt_len=4, gen=64)
WHISPER_CACHE_LEN = WHISPER["prompt_len"] + WHISPER["gen"] + 1


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
# swapped (M <= 64) and not, with and without a split; then granite's
# tied lm_head under int8 (N = 49,155, odd), DeepSeek-V2's shared
# experts at decode (M = 4) and prefill (M = 1,024), zamba2-2.7b's
# shared MLP at decode (M = 8) and prefill (M = 4,096),
# whisper-small's MLP at decode (M = 8) and in the encoder (M = 8 x
# 1,500), and starcoder2-3b's MLP in phase 15's training forward (M = 8
# x 128)
QMM_SHAPES = ((8, 3584, 18944), (8, 18944, 3584), (4096, 3584, 18944),
              (4096, 18944, 3584), (3, 56, 40), (5, 100, 17),
              (130, 72, 200), (128, 152064, 3584), (3, 80, 40),
              (17, 2064, 1000), (64, 1024, 200), (65, 272, 136),
              (70, 4112, 300), (200, 512, 520), (512, 16, 64), (512, 32, 5),
              (512, 512, 10), (8, 1024, 49155), (512, 1024, 49155),
              (4, 5120, 3072), (1024, 5120, 3072), (4, 3072, 5120),
              (1024, 3072, 5120), (8, 2560, 10240), (8, 10240, 2560),
              (4096, 2560, 10240), (4096, 10240, 2560), (8, 768, 3072),
              (8, 3072, 768), (12000, 768, 3072), (12000, 3072, 768),
              (1024, 3072, 12288), (1024, 12288, 3072))
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
            if (m >= 4096 or k > 100_000) and dtype == torch.float32:
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


def _check_whisper_decode(gen, worst) -> dict:
    """flash_decode at whisper-small's decoder self-attention: R = 8,
    H = KV = 12 (g = 1: one live query row in each 16-row ``mma`` A
    tile), D = 64, the 69-slot cache of phase 14's ``generate`` with 68
    live slots.  bf16 on the tensor-core variant within ``bf16_tol`` of
    the plain version, and bit for bit: two launches agree, and
    sequences 3 and 6 alone give their bits in the batch of 8."""
    import torch
    from repro_torch.kernels import decode_tc as dtc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers as L
    n, pos = WHISPER_CACHE_LEN, WHISPER_CACHE_LEN - 2
    q, k, v = _contig_inputs(gen, 8, n, *WHISPER_ATTN, torch.bfloat16)
    mask = L.decode_attention_mask(
        L.kv_positions_for_cache(pos, n, 0, device="cuda"), pos, 0)
    full = fd.flash_decode(q, k, v, mask)
    _expect_decode_tc(fd, dtc.CHUNK, dtc.n_chunks(n, dtc.CHUNK))
    _compare("flash_decode", full, fd.flash_decode_plain(q, k, v, mask),
             torch.bfloat16, worst, ("whisper", *WHISPER_ATTN, n, pos))
    idx = torch.tensor([3, 6], device="cuda")
    checks = {"live_slots": int(mask.sum()),
              "two_launches": torch.equal(full,
                                          fd.flash_decode(q, k, v, mask)),
              "subset": torch.equal(
                  fd.flash_decode(q[idx].contiguous(), k[idx].contiguous(),
                                  v[idx].contiguous(), mask), full[idx])}
    if checks["live_slots"] != pos + 1 or not (checks["two_launches"]
                                                and checks["subset"]):
        raise AssertionError(f"flash_decode at g = 1: {checks}")
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
        # full width: R = 8, ps = 16, M = 37, at Qwen2-7B's H = 28, KV = 4,
        # D = 128 and granite-moe-1b-a400m's H = 16, KV = 8, D = 64
        for h, kvh, d in (QWEN_ATTN, GRANITE_ATTN):
            r, ps, m = 8, 16, 37
            cap = m * ps
            args = _decode_inputs(gen, r, h, kvh, d, ps, m,
                                  [0, 1, 17, 255, 300, 511, 576, cap - 1],
                                  dtype)
            _compare("flash_decode_paged", fdp.flash_decode_paged(*args),
                     fdp.flash_decode_paged_plain(*args), dtype, worst,
                     ("full", h, kvh, d))
            s = 77                                     # 3 tiles, last ragged
            args = _prefill_inputs(
                gen, r, s, h, kvh, d, ps, m,
                [0, 16, 256, 256, 100, 0, 500, 3],
                [77, 77, 40, 0, 77, 1, 77, 9], dtype)
            _compare("flash_prefill_ragged",
                     fpr.flash_prefill_ragged(*args),
                     fpr.flash_prefill_ragged_plain(*args), dtype, worst,
                     ("full", h, kvh, d))
            n_cases += 2
        # contiguous decode: g in {1, 2, 7} at D = 8 over cache lengths a
        # tile divides, none divides and 577 = 512 + 64 + 1, then the
        # full-width serving shape; linear and wrapped-ring masks
        shapes = [(3, h, kvh, 8, n) for h, kvh in ((4, 4), (4, 2), (7, 1))
                  for n in (16, 37, 577)] + [(8, *QWEN_ATTN, 577),
                                             (8, *GRANITE_ATTN, 577),
                                             (8, *ZAMBA_ATTN, 577),
                                             (8, *WHISPER_ATTN,
                                              WHISPER_CACHE_LEN)]
        for b, h, kvh, d, n in shapes:
            q, k, v = _contig_inputs(gen, b, n, h, kvh, d, dtype)
            for case, mask in _contig_masks(n):
                _compare("flash_decode", fd.flash_decode(q, k, v, mask),
                         fd.flash_decode_plain(q, k, v, mask), dtype, worst,
                         (b, h, kvh, d, n, case))
                n_cases += 1
                if d == ZAMBA_ATTN[2] and fd.last_launch["variant"] != "ffma":
                    raise AssertionError(f"flash_decode at D = {d}: "
                                         f"{fd.last_launch}, expected ffma")
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
    decode_bits["whisper"] = _check_whisper_decode(gen, worst)
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
    out = _paged_cpu_vs_gpu(cfg, (m_cpu, lm_cpu), (m_gpu, lm_gpu))
    emit({"phase": "cpu_vs_gpu", "layers": cfg.n_layers,
          "d_model": cfg.d_model, "equal_tokens": True, **out,
          "init_s": round(t_init, 3)})
    _contiguous_cpu_vs_gpu(cfg, lm_cpu, lm_gpu)
    del lm_gpu, m_gpu
    torch.cuda.empty_cache()


def _paged_cpu_vs_gpu(cfg, cpu, gpu) -> dict:
    """The paged engine on the CPU (plain versions) and on the card
    (kernels), fp32 cache, must emit equal tokens: 4 requests of 48
    tokens (2 sharing a 32-token prefix), 20 new each, through one
    preemption and one restore.  ``cpu`` and ``gpu`` are (model, params)
    with the same weights."""
    import numpy as np
    import torch
    from repro_torch.serving import PagedCacheConfig, PagedServingEngine
    # 48 + 20 + 1 tokens need a 5th page that the admission (48 + 4 + 1)
    # does not back, and 15 allocatable pages cannot grow all four:
    # one preemption and one restore
    pcfg = PagedCacheConfig(page_size=16, n_pages=16, max_slots=4,
                            max_blocks=5, segment_len=4)
    reqs = _requests(np.random.default_rng(0), 4, 48, 2, 32,
                     cfg.vocab_size, 20)
    tokens, stats, secs = {}, {}, {}
    for name, (model, lm) in (("cpu", cpu), ("gpu", gpu)):
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
            raise AssertionError(f"{cfg.name} paged {name}: "
                                 f"{stats[name]}")
    if tokens["cpu"] != tokens["gpu"]:
        raise AssertionError(f"{cfg.name}: CPU and GPU tokens differ: "
                             f"{tokens}")
    return {"tokens_per_request": [len(t) for t in tokens["gpu"].values()],
            "stats": stats, "run_s": secs}


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


def _serve_engine(arch: str = "qwen2_7b"):
    """``arch`` (Qwen2-7B by default) at full width and depth with bf16
    activations (random weights from seed 0, in the config's parameter
    dtype) behind the phase-5 engine (bf16 cache), warmed up on one short
    request."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import (PagedCacheConfig, PagedServingEngine,
                                     warmup)
    c = SERVE
    cfg = get_config(arch)
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
    import torch
    cfg, _, lm, eng, counts, _ = _burst("qwen2_7b", "serve")
    del eng
    torch.cuda.empty_cache()
    launches = {k: counts[k] for k in ("flash_decode_paged",
                                       "flash_prefill_ragged")}
    launches.update(phase_generate(cfg, lm))
    return launches


def _burst(arch: str, phase: str):
    """The phase-5 burst on ``arch`` at full width and depth (bf16): 16
    requests, launch counts equal to layers × dispatches and layers ×
    decode steps, every paged attention launch on its tensor-core variant.
    Returns (cfg, pcfg, params, engine, counts, requests)."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L
    c = SERVE
    cfg, pcfg, lm, eng, t_init = _serve_engine(arch)
    reqs = _requests(np.random.default_rng(1), c["n"], c["prompt_len"],
                     c["n_shared"], c["prefix_len"], cfg.vocab_size,
                     c["max_new"])
    torch.cuda.reset_peak_memory_stats()
    syncs0 = L.moe_host_syncs
    # the main path: counts set to 0 just before, read just after
    _zero_counts()
    t0 = time.perf_counter()
    st = eng.run(reqs, lm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    tc_counts = _read_tc_counts()
    syncs = L.moe_host_syncs - syncs0
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
            f"{arch} burst: bad requests {bad}, finished "
            f"{st['n_finished']}, dead-lettered {st['n_dead_lettered']}")
    if counts != expected or min(expected["flash_decode_paged"],
                                 expected["flash_prefill_ragged"]) < 1:
        raise AssertionError(f"{arch} launch counts {counts} != {expected}")
    # one MoE host read a layer a forward: a dispatch or a decode step
    want_syncs = (counts["flash_decode_paged"]
                  + counts["flash_prefill_ragged"]) if cfg.is_moe else 0
    if syncs != want_syncs:
        raise AssertionError(f"{arch}: {syncs} MoE host reads, expected "
                             f"{want_syncs}")
    # bf16 activations and cache at D = 64 or 128: every admission
    # dispatch's and every decode step's attention goes to the tensor-core
    # variant
    want_tc = {"flash_decode_paged": counts["flash_decode_paged"],
               "flash_prefill_ragged": counts["flash_prefill_ragged"],
               "flash_decode": 0, "quant_matmul": 0,
               "block_sparse_matmul": 0, "flash_attention": 0}
    if tc_counts != want_tc:
        raise AssertionError(f"{arch} tensor-core launches {tc_counts}, "
                             f"expected {want_tc}")
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": "bfloat16", "param_dtype": cfg.param_dtype, **c,
          "init_s": round(t_init, 3),
          "wall_s": wall, "prefill_s": st["prefill_s"],
          "decode_s": st["decode_s"], "tokens": n_tokens,
          "tokens_per_s": n_tokens / wall,
          "n_segments": st["n_segments"],
          "n_prefill_dispatches": st["n_prefill_dispatches"],
          "prefix_hits": st["prefix_hits"],
          "preemptions": st["preemptions"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "moe_host_syncs": syncs,
          "launches": counts, "launches_tc": tc_counts,
          "expected_launches": expected})
    return cfg, pcfg, lm, eng, counts, reqs


GENERATE = dict(batch=8, prompt_len=512, gen=64)


def _attn_layers(cfg) -> int:
    """GQA attention layers a forward runs over the contiguous cache (each
    a flash_decode launch a decode step): none under MLA and in xLSTM,
    zamba2's shared block once a segment."""
    if cfg.use_mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return cfg.n_layers


def _mlp_linears(cfg) -> int:
    """``linear`` calls named ``mlp/…`` in one forward: the dense MLP's,
    the MoE layers' shared experts (the routed experts call none) or
    zamba2's shared block's, once a segment; xLSTM's products are named
    ``mlstm/…`` and ``slstm/…``."""
    if cfg.family == "ssm":
        return 0
    if cfg.is_moe:
        return 3 * cfg.n_layers if cfg.n_shared_experts else 0
    return (3 if cfg.mlp == "glu" else 2) * _attn_layers(cfg)


def _state_bytes(cfg, batch: int, seq_len: int) -> dict:
    """A request's decode state in the contiguous cache (bf16 attention
    cache): the recurrent states' bytes (fp32) beside the attention K/V
    bytes at ``seq_len`` slots."""
    from repro_torch.models import transformer as T
    cache = T.init_lm_cache(cfg, batch, seq_len, device="meta")
    out = {"recurrent_state_bytes_per_request": 0,
           "kv_cache_bytes_per_request": 0}

    def walk(node, key):
        for name, t in node.items():
            if isinstance(t, dict):
                walk(t, "kv_cache_bytes_per_request" if name == "shared"
                     else key)
            elif name != "pos":
                out[key] += t.numel() * t.element_size() // batch

    walk(cache, "recurrent_state_bytes_per_request")
    return out


def phase_generate(cfg, lm, c=GENERATE, policies=("bf16", "int8-mlp"),
                   phase="generate", frames=None) -> dict:
    """Contiguous ``generate`` at full width in bf16 (by default batch 8,
    512-token prompts, 64 new tokens) under each of ``policies`` (bf16,
    int8-mlp), on the one parameter set (the policy lives on the model,
    not on the parameters).  Each run is a main path: counts set to 0
    just before it, read just after.  flash_decode launches a GQA layer
    a decode step (none under MLA, whose decode attention is plain
    PyTorch), quant_matmul each ``mlp/…`` product under int8-mlp.
    Under either policy every flash_decode launch takes the variant
    ``decode_tc.variant`` gives the model's head dim (the tensor cores at
    D = 64 and 128, zamba2's D = 80 the fp32 CUDA-core kernel).  For the
    SSM and hybrid families the run also reports a request's recurrent
    state beside its attention K/V.  An enc-dec model's prefill encodes
    ``frames`` (its encoder's ``mlp/…`` products, once a run, also
    quantized under int8-mlp); the run also reports the encoder timed
    alone after it (``encode_s``) and a request's cross K/V bytes.
    Returns the launches of flash_decode (bf16 run) and quant_matmul
    (int8-mlp run)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.kernels import decode_tc
    from repro_torch.launch.serve import (generate, make_serve_fns,
                                          serve_policy, timed_generate)
    from repro_torch.models import layers as L
    from repro_torch.models.api import build_model
    b, s, n_gen = c["batch"], c["prompt_len"], c["gen"]
    prompts = torch.from_numpy(lm_tokens(b * s, cfg.vocab_size, seed=1)
                               .reshape(b, s).astype(np.int32))
    cache_len = s + n_gen + 1
    n_attn = _attn_layers(cfg)
    decode_tc_variant = decode_tc.variant(torch.bfloat16, torch.bfloat16,
                                          cfg.hd)
    launches = {}
    for pname in policies:
        int8 = pname == "int8-mlp"
        model = build_model(cfg, serve_policy(int8))
        fns = make_serve_fns(model)
        generate(model, lm, prompts[:, :64], 4, 69, fns=fns,
                 frames=frames)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs0 = L.moe_host_syncs
        _zero_counts()
        toks, t = timed_generate(model, lm, prompts, n_gen, cache_len,
                                 fns=fns, frames=frames)
        counts = _read_counts()
        tc_counts = _read_tc_counts()
        syncs = L.moe_host_syncs - syncs0
        expected = {"flash_decode_paged": 0, "flash_prefill_ragged": 0,
                    "flash_decode": n_attn * (n_gen - 1),
                    "quant_matmul": _mlp_linears(cfg) * n_gen
                    + 2 * cfg.n_enc_layers if int8 else 0,
                    "block_sparse_matmul": 0, "flash_attention": 0}
        if counts != expected:
            raise AssertionError(f"generate {cfg.name} {pname}: launch "
                                 f"counts {counts} != {expected}")
        if syncs != (cfg.n_layers * n_gen if cfg.is_moe else 0):
            raise AssertionError(f"generate {cfg.name} {pname}: {syncs} "
                                 f"MoE host reads")
        # bf16 q and cache: every decode step's attention on the variant
        # the head dim gives (tensor cores at D = 64 or 128)
        want_tc = counts["flash_decode"] if decode_tc_variant == "tc" else 0
        if tc_counts["flash_decode"] != want_tc:
            raise AssertionError(f"generate {cfg.name} {pname}: tensor-core "
                                 f"launches {tc_counts}, expected "
                                 f"{want_tc} of {counts['flash_decode']} "
                                 f"flash_decode (D = {cfg.hd}: "
                                 f"{decode_tc_variant})")
        # K a multiple of 16 (Qwen2-7B 3,584 and 18,944; DeepSeek-V2's
        # shared experts 5,120 and 3,072): every int8 product on the
        # tensor-core variant (prefill unswapped, decode swapped)
        if int8 and tc_counts["quant_matmul"] != counts["quant_matmul"]:
            raise AssertionError(f"generate {cfg.name} {pname}: tensor-core "
                                 f"launches {tc_counts}, expected all "
                                 f"{counts['quant_matmul']} quant_matmul")
        host = toks.cpu()
        if host.shape != (b, n_gen) or not bool(
                ((host >= 0) & (host < cfg.vocab_size)).all()):
            raise AssertionError(f"generate {cfg.name} {pname}: bad tokens "
                                 f"{tuple(host.shape)}")
        decode_tokens = b * (n_gen - 1)
        extra = {}
        if cfg.use_mla:
            # the compressed cache against a K/V cache of the same heads
            per_slot = cfg.n_layers * b * cache_len * 2
            extra["mla_cache_bytes"] = per_slot * (cfg.kv_lora_rank
                                                   + cfg.rope_head_dim)
            extra["full_kv_cache_bytes"] = per_slot * cfg.n_heads * (
                cfg.nope_head_dim + cfg.rope_head_dim + cfg.v_head_dim)
        if cfg.family in ("ssm", "hybrid"):
            extra.update(_state_bytes(cfg, b, cache_len))
        if cfg.enc_dec:
            extra.update(_encoder_alone(cfg, model, lm, frames, cache_len))
        if counts["flash_decode"]:
            extra["flash_decode_variant"] = decode_tc_variant
        if not any(counts.values()):
            extra["note"] = ("no kernel of the port runs on this path: "
                             + ("the mLSTM and sLSTM mixers"
                                if cfg.family == "ssm" else
                                "MLA attention and the MoE FFN")
                             + " are plain PyTorch products, as they are "
                             "outside Pallas in the JAX package")
        emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
              "policy": pname, "dtype": "bfloat16",
              "param_dtype": cfg.param_dtype, **c,
              "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
              "decode_step_ms": 1e3 * t["decode_s"] / (n_gen - 1),
              "decode_tokens_per_s": decode_tokens / t["decode_s"],
              "prefill_tokens_per_s": b * s / t["prefill_s"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "moe_host_syncs": syncs, **extra,
              "launches": counts, "launches_tc": tc_counts,
              "sample": host[0, :8].tolist()})
        if int8:
            launches["quant_matmul"] = counts["quant_matmul"]
        else:
            launches["flash_decode"] = counts["flash_decode"]
        del fns, model
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- phase 12: MoE family
DEEPSEEK_LAYERS = 2                 # of 60: 60 layers are ~476 GB in bf16
DEEPSEEK_GENERATE = dict(batch=4, prompt_len=256, gen=32)
ALONE_RIDS = (0, 12)                # a prefix sharer of the first wave and
                                    # a fresh request of the second
# CPU against the card: a batch of candidate prompts runs on both sides,
# and the rows whose every greedy step keeps a top-2 logit gap of at least
# FAMILIES_GAP on the CPU must give equal tokens (at least two of them):
# under the bf16 and int8 policies a logit moves by ~0.01 between two
# fp32 summation orders
FAMILIES_CANDIDATES = 32
FAMILIES_GAP = 0.05


def phase_families() -> dict:
    """The MoE family on the card (MLA attention and the MoE FFN):
    (a) granite-moe-1b-a400m at full width and depth behind the paged
    engine (the phase-5 burst), two of its requests served again alone
    (bit-identical tokens), then contiguous ``generate``; (b) DeepSeek-V2
    at full width on 2 layers through ``generate`` under the bf16 and the
    int8-mlp policy; (a) and (b) each end in a torch.profiler breakdown of
    :data:`PROFILE_STEPS` decode steps (outside the counted runs); (c) the
    CPU against the
    card.  fp32 products stay
    fp32 (no TF32), as in the plain versions and the reference.  Returns
    the kernels' launches on these paths."""
    import torch
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 12: TF32 is on for fp32 products")
    launches = _families_granite()
    launches.update(_families_deepseek())
    _families_cpu_vs_gpu()
    return launches


def _families_granite() -> dict:
    """(a): the burst (launch counts, every paged launch on "tc" at D =
    64, one MoE host read a layer a forward), the row invariance of two
    requests, and bf16 ``generate`` (every flash_decode launch on
    "tc")."""
    import torch
    from repro_torch.serving import PagedServingEngine
    cfg, pcfg, lm, eng, counts, reqs = _burst("granite_moe_1b_a400m",
                                              "families_burst")
    alone = {}
    for rid in ALONE_RIDS:
        req = _copy_requests([reqs[rid]])
        PagedServingEngine(eng.model, pcfg).run(req, lm)
        alone[rid] = req[0].tokens == reqs[rid].tokens
    if not all(alone.values()):
        raise AssertionError(f"granite: requests served alone differ from "
                             f"the burst: {alone}")
    emit({"phase": "families_row_invariance", "arch": cfg.name,
          "rids": list(ALONE_RIDS), "bit_identical": True})
    del eng
    torch.cuda.empty_cache()
    launches = {k: counts[k] for k in ("flash_decode_paged",
                                       "flash_prefill_ragged")}
    launches.update(phase_generate(cfg, lm, policies=("bf16",),
                                   phase="families_generate"))
    _profile_generate(cfg, lm, policies=("bf16",),
                      phase="families_profile_granite", steps=PROFILE_STEPS)
    del lm
    torch.cuda.empty_cache()
    return launches


def _families_deepseek() -> dict:
    """(b): DeepSeek-V2 at full width (MLA, 160 routed experts top-6, 2
    shared), cut to :data:`DEEPSEEK_LAYERS` layers, bf16 weights from
    seed 0 on the card."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("deepseek_v2_236b").replace(n_layers=DEEPSEEK_LAYERS)
    t0 = time.perf_counter()
    lm = build_model(cfg).init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    emit({"phase": "families_init", "arch": cfg.name,
          "layers": cfg.n_layers, "reduced": "n_layers 60 -> 2",
          "params": n_params, "init_s": time.perf_counter() - t0})
    launches = phase_generate(cfg, lm, DEEPSEEK_GENERATE,
                              phase="families_generate")
    launches.pop("flash_decode")
    _profile_generate(cfg, lm, DEEPSEEK_GENERATE,
                      phase="families_profile_deepseek", steps=PROFILE_STEPS)
    del lm
    torch.cuda.empty_cache()
    return launches


def _families_cpu_vs_gpu() -> None:
    """(c): the port on the CPU (plain versions) and on the card (kernels)
    from one set of fp32 weights, drawn on the card and copied to the CPU:
    granite at full width on 2 layers through the paged engine (FP32
    policy, a preemption and a restore) and ``generate`` (bf16 policy);
    DeepSeek-V2 at full width on 1 layer (a ~20 GB host copy) through
    ``generate`` under the bf16 and the int8-mlp policy."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.quant.policy import PrecisionPolicy
    for arch, layers, policies in (
            ("granite_moe_1b_a400m", 2, ("bf16",)),
            ("deepseek_v2_236b", 1, ("bf16", "int8-mlp"))):
        cfg = get_config(arch).replace(n_layers=layers,
                                       param_dtype="float32",
                                       act_dtype="float32")
        policy = PrecisionPolicy(default="fp32")
        t0 = time.perf_counter()
        m_gpu = build_model(cfg, policy, device="cuda")
        lm_gpu = m_gpu.init(seed=0)
        m_cpu = build_model(cfg, policy, device="cpu")
        lm_cpu = m_cpu.empty_params()
        lm_cpu.load_state_dict(lm_gpu.state_dict())
        out = {"init_s": time.perf_counter() - t0}
        if not cfg.use_mla:
            out["paged"] = _paged_cpu_vs_gpu(cfg, (m_cpu, lm_cpu),
                                             (m_gpu, lm_gpu))
        out["generate"] = {p: _generate_cpu_vs_gpu(cfg, lm_cpu, lm_gpu, p)
                           for p in policies}
        emit({"phase": "families_cpu_vs_gpu", "arch": cfg.name,
              "layers": layers, "dtype": "float32", **out})
        del lm_gpu, m_gpu, lm_cpu, m_cpu
        torch.cuda.empty_cache()


def _generate_cpu_vs_gpu(cfg, lm_cpu, lm_gpu, pname: str,
                         prompt_len: int = 32, gen: int = 8,
                         candidates: int = FAMILIES_CANDIDATES,
                         frames=None) -> dict:
    """``generate`` (host loop, fp32 cache) of ``candidates`` prompts on
    both sides under ``pname`` (an enc-dec model's with ``frames``); each
    greedy step's top-2 logit gap is read on the way.  The rows whose
    every step keeps a gap of :data:`FAMILIES_GAP` on the CPU must agree
    (at least two rows)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import (ServeFns, generate,
                                          make_serve_fns, serve_policy)
    from repro_torch.models.api import build_model
    prompts = torch.from_numpy(np.random.default_rng(PHASE4_PROMPT_SEED)
                               .integers(0, cfg.vocab_size,
                                         (candidates, prompt_len))
                               .astype(np.int32))
    res, secs = {}, {}
    for side, lm, dev in (("cpu", lm_cpu, "cpu"), ("gpu", lm_gpu, "cuda")):
        model = build_model(cfg, serve_policy(pname == "int8-mlp"),
                            device=dev)
        gaps = []

        def gapped(fn):
            def call(*args):
                logits, cache = fn(*args)
                top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
                gaps.append((top[:, 0] - top[:, 1]).cpu())
                return logits, cache
            return call

        fns = ServeFns(prefill=gapped(model.prefill),
                       decode_scan=make_serve_fns(model).decode_scan,
                       decode_one=gapped(model.decode_step))
        t0 = time.perf_counter()
        toks = generate(model, lm, prompts, gen, prompt_len + gen + 1,
                        scan=False, fns=fns, cache_dtype=torch.float32,
                        frames=frames)
        secs[side] = time.perf_counter() - t0
        res[side] = (toks.cpu(), torch.stack(gaps, 1).min(dim=1).values)
    decided = res["cpu"][1] >= FAMILIES_GAP
    n_decided = int(decided.sum())
    if n_decided < 2 or not torch.equal(res["cpu"][0][decided],
                                        res["gpu"][0][decided]):
        raise AssertionError(
            f"{cfg.name} generate {pname}: {n_decided} rows with a top-2 "
            f"gap >= {FAMILIES_GAP}; CPU {res['cpu'][0][decided].tolist()} "
            f"GPU {res['gpu'][0][decided].tolist()}")
    return {"candidates": candidates, "decided_rows": n_decided,
            "equal_decided_rows": True,
            "equal_rows_all": int((res["cpu"][0] == res["gpu"][0])
                                  .all(dim=1).sum()),
            "min_gap_decided": float(res["cpu"][1][decided].min()),
            "sample": res["gpu"][0][decided][0].tolist(), "run_s": secs}


# ------------------------------------------- phase 13: SSM and hybrid
# CPU against the card: xlstm-125m's tied head reads a d_model-768
# embedding (logits of std ~0.55 over 50,304 columns: a greedy step keeps
# a 0.05 top-2 gap less often than at zamba2's width), so it runs more
# candidates
SSM_CPU_LAYERS = {"zamba2_2p7b": 6, "xlstm_125m": 12}
SSM_CPU_CANDIDATES = {"zamba2_2p7b": 32, "xlstm_125m": 96}
SSM_POLICIES = {"zamba2_2p7b": ("bf16", "int8-mlp"), "xlstm_125m": ("bf16",)}


def phase_ssm_hybrid() -> dict:
    """The SSM and hybrid families on the card, through contiguous
    ``generate`` (the paged engine refuses both, as the JAX package's
    does): (a) zamba2-2.7b at full width and depth (54 Mamba2 layers, the
    shared attention+MLP block after every 6; bf16 weights from seed 0)
    under the bf16 and the int8-mlp policy — flash_decode 9 a decode step,
    all on the fp32 CUDA-core variant at D = 80, quant_matmul 27 a
    forward under int8-mlp, all "tc" — and a profile of
    :data:`PROFILE_STEPS` decode steps; (b) xlstm-125m at full width and depth (6 mLSTM/sLSTM pairs, fp32
    weights) under the bf16 policy, no kernel launched, and its profile;
    (c) for each, a prefill of 511 tokens and one decode step against the
    512-token prefill's last logits (:func:`_handoff`); (d) the CPU
    against the card in fp32.  fp32 products stay fp32 (no TF32).
    Returns the kernels' launches on these paths."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 13: TF32 is on for fp32 products")
    t_phase = time.perf_counter()
    launches = {}
    for arch in ("zamba2_2p7b", "xlstm_125m"):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        lm = build_model(cfg).init(seed=0)
        torch.cuda.synchronize()
        emit({"phase": "ssm_hybrid_init", "arch": cfg.name,
              "layers": cfg.n_layers, "param_dtype": cfg.param_dtype,
              "params": sum(p.numel() for p in lm.parameters()),
              "init_s": time.perf_counter() - t0})
        got = phase_generate(cfg, lm, policies=SSM_POLICIES[arch],
                             phase="ssm_hybrid_generate")
        if arch == "zamba2_2p7b":
            launches.update(got)
        _profile_generate(cfg, lm, policies=("bf16",),
                          phase=f"ssm_hybrid_profile_{arch}",
                          steps=PROFILE_STEPS)
        _handoff(cfg, lm)
        del lm
        torch.cuda.empty_cache()
    for arch in ("zamba2_2p7b", "xlstm_125m"):
        _ssm_cpu_vs_gpu(arch)
    emit({"phase": "ssm_hybrid_done", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def _handoff(cfg, lm, s: int = GENERATE["prompt_len"], frames=None,
             phase: str = "ssm_hybrid_handoff") -> None:
    """Phase 13 (c), phase 14 (b): a prefill of ``s - 1`` tokens and one
    decode step against the ``s``-token prefill's last logits, on the
    same weights: the
    chunked SSD / mLSTM and the contiguous prefill attention against the
    recurrent steps and flash_decode (an enc-dec model's prefills also
    encode ``frames``).  Held within ``bf16_tol`` in fp32
    (activations, cache and products), where the two paths differ only
    in fp32 summation order.  The served configuration (bf16 activations,
    cache and products) is reported beside it: there the decode path
    rounds once more (Mamba2's decode casts its SSD output to bf16, the
    cache holds bf16 K/V where prefill attends the unrounded ones), and
    on zamba2-smoke the JAX package's own handoff misses ``bf16_tol`` by
    2x as the port's does."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.models.api import build_model
    from repro_torch.quant.policy import PrecisionPolicy
    b = GENERATE["batch"]
    toks = torch.from_numpy(lm_tokens(b * s, cfg.vocab_size, seed=2)
                            .reshape(b, s).astype(np.int32)).cuda()
    extra = {} if frames is None else {"frames": frames.cuda()}
    out = {}
    for label, act, level, cache_dtype in (
            ("fp32", "float32", "fp32", torch.float32),
            ("served", cfg.act_dtype, "bf16", torch.bfloat16)):
        model = build_model(cfg.replace(act_dtype=act),
                            PrecisionPolicy(default=level))
        full, _ = model.prefill(lm, {"tokens": toks, **extra},
                                model.init_cache(b, s, cache_dtype))
        _, cache = model.prefill(lm, {"tokens": toks[:, :-1], **extra},
                                 model.init_cache(b, s, cache_dtype))
        step, _ = model.decode_step(lm, cache, toks[:, -1:])
        ref = full[:, -1].float()
        err = float((step[:, -1].float() - ref).abs().max())
        out[label] = {"max_abs_err": err, "tol": bf16_tol(ref),
                      "max_abs_logit": float(ref.abs().max()),
                      "argmax_equal_rows": int((step[:, -1].argmax(-1)
                                                == ref.argmax(-1)).sum())}
        del model, full, cache, step
    err, tol = out["fp32"]["max_abs_err"], out["fp32"]["tol"]
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{cfg.name} handoff in fp32: prefill({s - 1}) "
                             f"+ one decode step vs prefill({s}): {err} > "
                             f"{tol}")
    emit({"phase": phase, "arch": cfg.name, "batch": b,
          "prompt_len": s, **out})


def _ssm_cpu_vs_gpu(arch: str) -> None:
    """(d): the port on the CPU (plain versions) and on the card (kernels)
    from one set of fp32 weights drawn on the card: zamba2 at full width
    cut to one segment (6 Mamba2 layers and the shared block), xlstm-125m
    whole, through ``generate`` (fp32 activations and cache) under each
    of its policies."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.quant.policy import PrecisionPolicy
    cfg = get_config(arch).replace(n_layers=SSM_CPU_LAYERS[arch],
                                   param_dtype="float32",
                                   act_dtype="float32")
    policy = PrecisionPolicy(default="fp32")
    t0 = time.perf_counter()
    lm_gpu = build_model(cfg, policy, device="cuda").init(seed=0)
    lm_cpu = build_model(cfg, policy, device="cpu").empty_params()
    lm_cpu.load_state_dict(lm_gpu.state_dict())
    out = {"init_s": time.perf_counter() - t0}
    out["generate"] = {
        p: _generate_cpu_vs_gpu(cfg, lm_cpu, lm_gpu, p,
                                candidates=SSM_CPU_CANDIDATES[arch])
        for p in SSM_POLICIES[arch]}
    emit({"phase": "ssm_hybrid_cpu_vs_gpu", "arch": cfg.name,
          "layers": cfg.n_layers, "dtype": "float32", **out})
    del lm_gpu, lm_cpu
    torch.cuda.empty_cache()


# ------------------------------------------- phase 14: encoder-decoder
# CPU against the card: whisper-small's width at whisper-smoke's depth
# (2 + 2 layers); its tied head reads a d_model-768 embedding of 51,865
# rows, so few greedy steps keep a 0.05 top-2 gap: 4 steps a candidate;
# candidates by policy (the CPU's int8 products, in float64, cost most)
WHISPER_CPU = dict(enc_layers=2, layers=2,
                   candidates={"bf16": 16, "int8-mlp": 8}, prompt_len=4,
                   gen=4)
WHISPER_POLICIES = ("bf16", "int8-mlp")
# decode steps of the profiles of phases 12-14: reading a profile back
# costs about 1 ms of host time a kernel launched (whisper-small ~1,400-
# 1,800 kernels a step, granite-moe ~6,500, zamba2-2.7b ~4,100), the
# steps themselves 25-110 ms
PROFILE_STEPS = 4


def phase_encdec() -> dict:
    """The encoder-decoder family on the card: (a) whisper-small whole
    (12 + 12 layers, d_model 768, 1,500 frames, fp32 weights from seed 0)
    through contiguous ``generate`` with frames (batch 8, a 4-token
    prompt, 64 new tokens) under the bf16 and the int8-mlp policy —
    flash_decode 12 a decode step, all "tc" at g = 1, quant_matmul at
    every ``mlp/…`` product of the encoder, the prefill and the steps
    under int8-mlp, all "tc" — with the encoder timed alone, a request's
    cross K/V bytes and a profile of 4 decode steps split into the
    self-attention, the cross-attention and the MLP; (b) a prefill of 3
    tokens and one decode step against the 4-token prefill's last
    logits; (c) the CPU against the card in fp32 at whisper-smoke's
    depth.  fp32 products stay fp32 (no TF32).  Returns the kernels'
    launches on these paths."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.whisper_serve import stub_frames
    from repro_torch.models.api import build_model
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 14: TF32 is on for fp32 products")
    t_phase = time.perf_counter()
    cfg = get_config("whisper_small")
    t0 = time.perf_counter()
    lm = build_model(cfg).init(seed=0)
    torch.cuda.synchronize()
    emit({"phase": "encdec_init", "arch": cfg.name,
          "enc_layers": cfg.n_enc_layers, "layers": cfg.n_layers,
          "param_dtype": cfg.param_dtype, "reduced": "nothing",
          "params": sum(p.numel() for p in lm.parameters()),
          "init_s": time.perf_counter() - t0})
    frames = stub_frames(WHISPER["batch"], cfg.n_frames, cfg.d_model)
    secs = {}
    t0 = time.perf_counter()
    launches = phase_generate(cfg, lm, WHISPER, WHISPER_POLICIES,
                              "encdec_generate", frames)
    secs["generate"] = time.perf_counter() - t0
    _profile_generate(cfg, lm, WHISPER, WHISPER_POLICIES, "encdec_profile",
                      frames, steps=PROFILE_STEPS)
    secs["profile"] = time.perf_counter() - t0 - sum(secs.values())
    _handoff(cfg, lm, WHISPER["prompt_len"], frames,
             phase="encdec_handoff")
    secs["handoff"] = time.perf_counter() - t0 - sum(secs.values())
    del lm
    torch.cuda.empty_cache()
    _encdec_cpu_vs_gpu()
    secs["cpu_vs_gpu"] = time.perf_counter() - t0 - sum(secs.values())
    emit({"phase": "encdec_done", "launches": launches,
          "seconds": time.perf_counter() - t_phase, "seconds_by_part": secs})
    return launches


def _encoder_alone(cfg, model, lm, frames, cache_len: int) -> dict:
    """The enc-dec extras of a ``generate`` run: the encoder alone over
    ``frames``, timed (outside the counted run), its output checked
    finite, and a request's cross K/V bytes in the bf16 cache."""
    import torch
    from repro_torch.models import transformer as T
    b = frames.shape[0]
    fr = frames.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = T.encdec_encode(model.ctx(), cfg, lm, fr)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    if not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"{cfg.name}: the encoder's output is not "
                             f"finite")
    cache = T.init_encdec_cache(None, cfg, None, b, cache_len,
                                device="meta")
    cross = sum(cache[name].numel() * cache[name].element_size()
                for name in ("cross_k", "cross_v")) // b
    return {"enc_layers": cfg.n_enc_layers, "frames": cfg.n_frames,
            "encode_s": encode_s, "cross_kv_bytes_per_request": cross}


def _encdec_cpu_vs_gpu() -> None:
    """(c): the port on the CPU (plain versions) and on the card (kernels)
    from one set of fp32 weights drawn on the card: whisper-small's width
    at whisper-smoke's depth (2 + 2 layers), fp32 activations and cache,
    through ``generate`` with stub frames under each policy."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.whisper_serve import stub_frames
    from repro_torch.models.api import build_model
    from repro_torch.quant.policy import PrecisionPolicy
    c = WHISPER_CPU
    cfg = get_config("whisper_small").replace(
        n_enc_layers=c["enc_layers"], n_layers=c["layers"],
        param_dtype="float32", act_dtype="float32")
    policy = PrecisionPolicy(default="fp32")
    t0 = time.perf_counter()
    lm_gpu = build_model(cfg, policy, device="cuda").init(seed=0)
    lm_cpu = build_model(cfg, policy, device="cpu").empty_params()
    lm_cpu.load_state_dict(lm_gpu.state_dict())
    n = c["candidates"]
    frames = stub_frames(max(n.values()), cfg.n_frames, cfg.d_model, seed=3)
    out = {"init_s": time.perf_counter() - t0}
    out["generate"] = {
        p: _generate_cpu_vs_gpu(cfg, lm_cpu, lm_gpu, p, c["prompt_len"],
                                c["gen"], n[p], frames[:n[p]])
        for p in WHISPER_POLICIES}
    emit({"phase": "encdec_cpu_vs_gpu", "arch": cfg.name,
          "enc_layers": cfg.n_enc_layers, "layers": cfg.n_layers,
          "dtype": "float32", **out})
    del lm_gpu, lm_cpu
    torch.cuda.empty_cache()


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
@contextlib.contextmanager
def _cut_config(module, **replace):
    """``module.CONFIG`` replaced (the registry reads it) for the block."""
    full = module.CONFIG
    module.CONFIG = full.replace(**replace)
    try:
        yield full
    finally:
        module.CONFIG = full


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
    with _cut_config(qwen2_7b, n_layers=DESIGNFLOW_LM_LAYERS) as full:
        meta, line = _designflow_bench("qwen2-7b", "QP",
                                       int8_modules=(layers, transformer),
                                       **kw)
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


# ------------------------------------------------------------- phase 15
TRAIN_ARCH = "starcoder2_3b"
# (a), (c): full width, 30 -> 2 layers (~343 M parameters; a checkpoint
# of bf16 parameters and fp32 moments ~3.4 GB instead of ~30 GB)
TRAIN_CUT_LAYERS = 2
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--batch", "8", "--seq-len", "128",
              "--ckpt-every", "3"]
TRAIN_STEPS, TRAIN_FAIL_AT = 8, 5
TRAIN_LOSS_TOL = 1e-5          # tests/test_runtime.py: final losses
TRAIN_TOKENS = 8 * 128         # (b): one step's batch
TRAIN_TIMED_STEPS = 3          # (b): after one warm-up step
# (d): one step at full width, 1 layer, fp32, batch 2 x 128, lr 1e-3:
# the loss within TRAIN_CARD_LOSS_RTOL, TRAIN_CARD_SHARE of the weights
# within TRAIN_CARD_NEAR, every one within 2·lr (Adam's first step moves
# a weight by about lr·sign(g); a gradient that is 0 in exact arithmetic,
# the K bias's, is noise on both sides)
TRAIN_CARD_LOSS_RTOL = 1e-5
TRAIN_CARD_NEAR, TRAIN_CARD_SHARE = 1e-5, 0.95
TRAIN_CARD_LR = 1e-3


@contextlib.contextmanager
def _timed_checkpoints(keep_step: int | None = None):
    """Seconds the loop spends in ``CheckpointManager.save`` (the wait
    for the previous write, then the host snapshot), in ``wait`` and in
    ``restore``; the snapshots' seconds (device-to-host copies); the
    background writes' seconds and bytes.  Every restore's bf16
    ``params/embed`` is held against its bits in the file (the
    reference's restore refuses bf16 leaves), and the host snapshot that
    step ``keep_step`` writes is kept (``stats["kept"]``)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import manager as M
    stats = {"save_s": 0.0, "wait_s": 0.0, "restore_s": 0.0,
             "snapshot_s": 0.0, "write_s": 0.0, "saves": 0, "restores": 0,
             "bytes": 0, "bf16_restores": 0, "bf16_restores_exact": 0}
    cls = M.CheckpointManager
    orig = {name: getattr(cls, name)
            for name in ("save", "wait", "restore", "_write")}
    host = M._host

    def timed_host(leaf):
        t0 = time.perf_counter()
        try:
            return host(leaf)
        finally:
            stats["snapshot_s"] += time.perf_counter() - t0

    def check_bf16(self, tree, meta):
        if tree is None or meta["leaves"]["params/embed"]["dtype"] != \
                "bfloat16":
            return
        path = Path(self.dir) / f"step_{meta['step']:08d}" / "arrays.npz"
        with np.load(path) as z:
            raw = z["params/embed"]
        emb = tree["params"]["embed"]
        stats["bf16_restores"] += 1
        stats["bf16_restores_exact"] += emb.dtype == torch.bfloat16 and \
            bool(np.array_equal(emb.view(torch.int16).numpy(), raw))

    def timed(name, key, count=None):
        def fn(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                out = orig[name](self, *a, **kw)
            finally:
                stats[key] += time.perf_counter() - t0
                if count:
                    stats[count] += 1
            if name == "restore":
                check_bf16(self, *out)
            if name == "_write":
                step, snapshot = a[0], a[1]
                path = Path(self.dir) / f"step_{step:08d}" / "arrays.npz"
                stats["bytes"] += path.stat().st_size \
                    if path.exists() else 0
                if step == keep_step:
                    stats["kept"] = snapshot
            return out
        return fn

    cls.save = timed("save", "save_s", "saves")
    cls.wait = timed("wait", "wait_s")
    cls.restore = timed("restore", "restore_s", "restores")
    cls._write = timed("_write", "write_s")
    M._host = timed_host
    try:
        yield stats
    finally:
        for name, fn in orig.items():
            setattr(cls, name, fn)
        M._host = host


def _launch_train(args: list, keep_step: int | None = None) -> dict:
    """``launch/train.main(args)``; its JSON report, with the wall time
    and the checkpoint timings, and the host snapshot of ``keep_step``'s
    checkpoint under ``"kept"``."""
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _timed_checkpoints(keep_step) as ck, \
            contextlib.redirect_stdout(buf):
        rc = train.main(args)
    out = buf.getvalue()
    report = json.loads(out[out.index("\n{") + 1:] if not out.startswith(
        "{") else out)
    if rc != 0:
        raise AssertionError(f"phase 15: launch.train {args} -> {rc}")
    kept = ck.pop("kept", None)
    report.update(wall_s=time.perf_counter() - t0,
                  checkpoint={**ck, "gb_written": ck["bytes"] / 1e9},
                  log=[line for line in out.splitlines()
                       if line.startswith(("failure", "straggler"))])
    report.pop("ckpt_dir")
    return report, kept


def _snapshots_equal(a: dict, b: dict) -> dict:
    """Two checkpoints' host snapshots (path -> numpy array, as written)
    bit for bit: the paths whose bytes differ."""
    import numpy as np
    if sorted(a) != sorted(b):
        return {"bit_equal": False, "differ": ["<paths>"], "n_differ": -1}
    differ = [k for k in sorted(a) if a[k].dtype != b[k].dtype
              or not np.array_equal(a[k].reshape(-1).view(np.uint8),
                                    b[k].reshape(-1).view(np.uint8))]
    return {"bit_equal": not differ, "differ": differ[:20],
            "n_differ": len(differ)}


# the aten ops of a backward whose CUDA kernels may add in any order
SCATTER_OPS = ("index_put", "scatter", "index_add", "embedding_dense_backward",
               "put_")


def _determinism_probe() -> dict:
    """Why two runs' states differ: one train step's gradients twice from
    one state, as they run and under ``torch.use_deterministic_algorithms
    (True)`` (its warnings name the ops it cannot make deterministic), and
    the scatter-type ops the backward ran (their CUDA kernels accumulate
    in launch order: the embedding's and the cross-entropy gather's
    backward)."""
    import warnings

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ShardedBatcher, TokenSource
    from repro_torch.models.api import build_model
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CUT_LAYERS)
    model = build_model(cfg)
    params = model.init(0)
    leaves = [p.requires_grad_(True) for p in params.parameters()]
    batch = ShardedBatcher(TokenSource(cfg.vocab_size, 8, 128), None,
                           prefetch=False).get(0)
    seen = set()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            if any(s in name for s in SCATTER_OPS):
                seen.add(name)
            return func(*args, **(kwargs or {}))

    def grads(record=False):
        loss, _ = model.loss(params, batch)
        with Ops() if record else contextlib.nullcontext():
            g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return g

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    out = {"default_bit_equal": same(grads(True), grads())}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out["deterministic_bit_equal"] = same(grads(), grads())
        finally:
            torch.use_deterministic_algorithms(False)
    out["backward_scatter_ops"] = sorted(seen)
    out["deterministic_warnings"] = sorted({str(w.message)[:160]
                                            for w in caught})
    del params, leaves
    torch.cuda.empty_cache()
    return out


def _train_fault_tolerance(root: Path) -> dict:
    """(a) and (c) on the 2-layer cut: a run with an injected node
    failure against one without, their final checkpoints bit for bit; a
    resume after a stop; the same run with gradient compression.  Every
    restore's bf16 leaf is held against its bits in the file."""
    import shutil

    from repro_torch.configs import starcoder2_3b
    out = {}
    last = TRAIN_STEPS - 1
    with _cut_config(starcoder2_3b, n_layers=TRAIN_CUT_LAYERS) as full:
        steps = ["--steps", str(TRAIN_STEPS)]
        fail, fail_final = _launch_train(TRAIN_ARGS + steps + [
            "--inject-failures", str(TRAIN_FAIL_AT),
            "--ckpt-dir", str(root / "fail")], keep_step=last)
        shutil.rmtree(root / "fail")
        clean, clean_final = _launch_train(TRAIN_ARGS + steps + [
            "--ckpt-dir", str(root / "clean")], keep_step=last)
        shutil.rmtree(root / "clean")
        # the failure at step 5 restores step 2's checkpoint: steps 3-4
        # run twice
        replayed = TRAIN_FAIL_AT - 3
        bits = _snapshots_equal(fail_final, clean_final)
        del fail_final, clean_final
        out["a"] = {
            "layers": TRAIN_CUT_LAYERS, "width": full.d_model,
            "cut": f"{full.n_layers} -> {TRAIN_CUT_LAYERS} layers",
            "with_failure": fail, "uninterrupted": clean,
            "final_loss_diff": abs(fail["final_loss"] - clean["final_loss"]),
            "final_states": bits}
        if not bits["bit_equal"]:
            out["a"]["determinism_probe"] = _determinism_probe()
        ck = fail["checkpoint"]
        if not (fail["restarts"] == 1 and clean["restarts"] == 0
                and fail["steps_run"] == TRAIN_STEPS + replayed
                and clean["steps_run"] == TRAIN_STEPS
                and out["a"]["final_loss_diff"] < TRAIN_LOSS_TOL
                and ck["bf16_restores"] == ck["bf16_restores_exact"] == 1):
            raise AssertionError(f"phase 15 (a): {out['a']}")
        # a resume after a stop: 6 steps, then 10 over the same directory
        first, _ = _launch_train(TRAIN_ARGS + [
            "--steps", "6", "--ckpt-dir", str(root / "resume")])
        second, _ = _launch_train(TRAIN_ARGS + [
            "--steps", "10", "--ckpt-dir", str(root / "resume")])
        shutil.rmtree(root / "resume")
        out["a"]["resume"] = {"first": first, "second": second}
        ck = second["checkpoint"]
        if not (first["steps_run"] == 6 and second["steps_run"] == 4
                and second["restarts"] == 0
                and ck["bf16_restores"] == ck["bf16_restores_exact"] == 1):
            raise AssertionError(f"phase 15 (a) resume: {first} {second}")
        # (c) the same config with int8 gradient compression: the final
        # snapshot's residuals
        comp, final = _launch_train(TRAIN_ARGS + [
            "--steps", "4", "--ckpt-every", "4", "--grad-compression",
            "--ckpt-dir", str(root / "comp")], keep_step=3)
        shutil.rmtree(root / "comp")
        res = [v for k, v in final.items() if k.startswith("residuals/")]
        nonzero = sum(int((r != 0).sum()) for r in res)
        out["c"] = {**comp, "residual_nonzero": nonzero,
                    "residual_leaves": len(res)}
        if not (comp["steps_run"] == 4 and nonzero > 0
                and math.isfinite(comp["final_loss"])):
            raise AssertionError(f"phase 15 (c): {out['c']}")
    return out


def _train_full_depth() -> tuple[dict, dict]:
    """(b) ``make_train_step`` on all 30 layers at full width, remat
    "dots" as configured, on one train state (seed 0): 1 warm-up and 3
    timed steps under bf16, one more under torch.profiler, then 1 + 3
    under int8-mlp (quant_matmul launched for each MLP product of each
    forward, saved by the remat, not launched again in the backward;
    the MLP weights must move), then one step with remat "none" for its
    peak memory.  Returns (the line, the int8-mlp run's launches)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ShardedBatcher, TokenSource
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import adamw, cosine_schedule
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_train_step)
    cfg = get_config(TRAIN_ARCH)
    batcher = ShardedBatcher(TokenSource(cfg.vocab_size, 8, 128), None,
                             prefetch=False)
    n_steps = 1 + TRAIN_TIMED_STEPS
    opt = adamw(cosine_schedule(3e-4, 10, 2 * n_steps + 2))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state = init_train_state(build_model(cfg), opt, 0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    out = {"layers": cfg.n_layers, "remat": cfg.remat, "params": n_params,
           "init_s": time.perf_counter() - t0,
           "state_gb": torch.cuda.memory_allocated() / 1e9}
    launches, step = {}, 0
    int8 = PrecisionPolicy(default="bf16").with_rule("*mlp*", "int8")
    for name, c, policy, steps in (
            ("bf16", cfg, None, n_steps), ("int8-mlp", cfg, int8, n_steps),
            ("bf16_remat_none", cfg.replace(remat="none"), None, 1)):
        train_step = make_train_step(build_model(c, policy=policy), opt)
        # the first and last blocks' MLP weights, on the host
        ends = [state["params"].blocks[i] for i in (0, -1)]
        mlp0 = {k: [getattr(b.mlp, k).detach().to("cpu", copy=True)
                    for b in ends] for k in ("w_up", "w_down")}
        batches = [batcher.get(step + s) for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times, losses = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step += steps
        counts, tc = _read_counts(), _read_tc_counts()
        run = {"steps": steps, "losses": losses,
               "step_ms": [t * 1e3 for t in times],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if steps > 1:
            ms = statistics.median(times[1:]) * 1e3
            run.update(step_ms_median=ms,
                       tokens_per_s=TRAIN_TOKENS / ms * 1e3,
                       mfu=6 * n_params * TRAIN_TOKENS / (ms / 1e3)
                       / H100_BF16_FLOPS)
        want = 2 * cfg.n_layers * steps if policy else 0
        run["launches"] = {k: v for k, v in counts.items() if v}
        moved = {k: min(float((getattr(b.mlp, k).detach().cpu().float()
                               - a.float()).abs().max())
                        for a, b in zip(v, ends))
                 for k, v in mlp0.items()}
        ok = counts["quant_matmul"] == want and tc["quant_matmul"] == want \
            and sum(counts.values()) == want \
            and all(math.isfinite(x) for x in losses) \
            and all(d > 0 for d in moved.values())
        run["mlp_min_max_delta"] = moved
        if policy:
            run.update(quant_matmul_expected=want,
                       variant=qmm.last_launch.get("variant"))
            launches = counts
        if name == "bf16":
            run["profile"] = _profile_train_step(train_step, state,
                                                 batcher.get(step))
            step += 1
        out[name] = run
        if not ok:
            raise AssertionError(f"phase 15 (b) {name}: {run}")
        del train_step, mlp0, ends, batches
    del state
    torch.cuda.empty_cache()
    return out, launches


def _profile_train_step(train_step, state, batch) -> dict:
    """torch.profiler over one more train step, device activity only
    (host ops would add ≈ 20 s of trace processing): the device's busy
    time and idle share, the launches and the top kernels (the table in
    ``chiprun_out/train_profile_bf16.txt``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"wall_s": wall,
           **_profile_summary(prof, wall, "train_profile_bf16.txt")}
    out["profile_s"] = time.perf_counter() - t1
    return out


def _train_card_vs_cpu() -> dict:
    """(d) One ``make_train_step`` at full width, 1 layer, fp32 (weights,
    activations and products), from one CPU-drawn init and one batch, on
    the CPU (plain versions) and on the card."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenSource
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_train_step)
    cfg = get_config(TRAIN_ARCH).replace(n_layers=1, param_dtype="float32",
                                         act_dtype="float32")
    policy = PrecisionPolicy(default="fp32")
    batch = TokenSource(cfg.vocab_size, 2, 128).batch_at(0)
    opt = adamw(TRAIN_CARD_LR)
    runs = {}
    cpu_model = build_model(cfg, policy=policy, device="cpu")
    state = init_train_state(cpu_model, opt, 0)
    init = {k: v.clone() for k, v in state["params"].state_dict().items()}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, policy=policy, device=dev)
        if dev == "cuda":
            params = model.empty_params()
            params.load_state_dict(init)
            state = {"params": params,
                     "opt": opt.init(params.param_tree(per_block=True))}
        step = make_train_step(model, opt)
        state, metrics = step(state, {
            k: torch.from_numpy(v).long().to(model.device)
            for k, v in batch.items()})
        runs[dev] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                     {k: v.detach().cpu() for k, v in
                      state["params"].state_dict().items()})
        del state, step
    (lc, gc, pc), (lg, gg, pg) = runs["cpu"], runs["cuda"]
    diffs = torch.cat([(pc[k] - pg[k]).abs().reshape(-1) for k in pc])
    near = float((diffs <= TRAIN_CARD_NEAR).float().mean())
    out = {"layers": 1, "dtype": "float32", "batch": [2, 128],
           "loss": [lc, lg], "loss_rel": abs(lc - lg) / abs(lc),
           "grad_norm": [gc, gg], "weight_max_abs": float(diffs.max()),
           "share_within": [TRAIN_CARD_NEAR, near],
           "tol": {"loss_rel": TRAIN_CARD_LOSS_RTOL,
                   "share": TRAIN_CARD_SHARE, "max": 2 * TRAIN_CARD_LR}}
    if not (out["loss_rel"] <= TRAIN_CARD_LOSS_RTOL
            and near >= TRAIN_CARD_SHARE
            and out["weight_max_abs"] <= 2 * TRAIN_CARD_LR + 1e-6):
        raise AssertionError(f"phase 15 (d): {out}")
    torch.cuda.empty_cache()
    return out


def phase_train() -> dict:
    """Phase 15, the single-device trainer on starcoder2-3b: (a) fault
    tolerance and (c) gradient compression through ``launch/train.main``
    on the 2-layer cut, in a temporary directory that the phase
    removes; (b) ``make_train_step`` at full depth, bf16 and int8-mlp;
    (d) the card against the CPU.  The counts are set to 0 before (b)'s
    int8-mlp run and read after it (the bf16 trainer launches no kernel,
    which (a), (b) and (c) check); returns those."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        _zero_counts()
        ft = _train_fault_tolerance(root)
        bf16_launches = {k: v for k, v in _read_counts().items() if v}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if bf16_launches:
        raise AssertionError(f"phase 15 (a, c): kernels launched under "
                             f"bf16: {bf16_launches}")
    emit({"phase": "train", "part": "a", **ft["a"],
          "wall_s": time.perf_counter() - t0})
    emit({"phase": "train", "part": "c", **ft["c"]})
    t1 = time.perf_counter()
    full, launches = _train_full_depth()
    emit({"phase": "train", "part": "b", "arch": TRAIN_ARCH, **full,
          "wall_s": time.perf_counter() - t1})
    t1 = time.perf_counter()
    cmp = _train_card_vs_cpu()
    emit({"phase": "train", "part": "d", **cmp,
          "wall_s": time.perf_counter() - t1})
    emit({"phase": "train_done", "launches": launches,
          "wall_s": time.perf_counter() - t0})
    return launches


# ------------------------------------------------------------- phase 16
DIST_STEPS = 3                 # (a): steps a run (checkpoints at -1, 2)
DIST_DECODE = dict(batch=8, prompt_len=64, steps=8)
# (a): 2 layers of the 1 x 1 sharded trainer must equal phase 15's
# unsharded one bit for bit: on one rank every local op is the unsharded
# op on the same tensors
DIST_ARCH = "qwen2-7b"
# (b): the rules' fallbacks of each decode_32k probe on 16 x 16, the
# reference's string for string (tests/test_torch_sharding.py::
# test_fallbacks_qwen2_on_16x16 holds them to the JAX package on the CPU)
DIST_FALLBACKS = {None: [], "model": [],
                  "data": ["kv_heads:dim4%16!=0->replicated"]}
DIST_PEAK_TOL = 0.25           # (c): measured peak against Compile's


def _one_rank_world():
    """A real one-rank NCCL default group (``launch/train.py``'s
    environment: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    import os
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl")


def _plain_train(int8: bool) -> tuple[list, dict]:
    """Phase 15's unsharded trainer as ``launch/train.main`` runs it
    (``train_loop``'s seed 0, ``TokenSource`` batches, AdamW on the
    cosine schedule), :data:`DIST_STEPS` steps in memory — no
    checkpoint is written — on the cut config: (losses, the host
    snapshot a checkpoint of the final state would write, each step's
    ms as ``train_loop`` times it: the step and its loss read back)."""
    from repro_torch.checkpoint.manager import _flatten, _host
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import state_to_jax
    from repro_torch.data.pipeline import ShardedBatcher, TokenSource
    from repro_torch.launch.serve import serve_policy
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import adamw, cosine_schedule
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_train_step)
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, serve_policy(True) if int8 else None,
                        device="cuda")
    opt = adamw(cosine_schedule(3e-4, 10, DIST_STEPS))
    state = init_train_state(model, opt, 0)
    step = make_train_step(model, opt)
    batcher = ShardedBatcher(TokenSource(cfg.vocab_size, 8, 128), None,
                             device="cuda")
    losses, step_ms = [], []
    for i in range(DIST_STEPS):
        batch = batcher.get(i)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, {k: _host(v)[0] for k, v in _flatten(
        state_to_jax(state)).items()}, step_ms


def _dist_train(root: Path) -> tuple[dict, dict]:
    """(a) ``launch/train.main --mesh 1x1`` on starcoder2-3b cut to 2
    layers, 3 steps under bf16 and int8-mlp (DTensors on the one-rank
    NCCL mesh), its final checkpoint's host snapshot against phase 15's
    unsharded trainer from the same seed (:func:`_plain_train`), bit
    for bit, and both trainers' step times (the first step is a
    warm-up).  Returns the report and the sharded runs' launches."""
    from repro_torch.configs import starcoder2_3b
    out, launches = {}, {}
    args = TRAIN_ARGS + ["--steps", str(DIST_STEPS)]
    with _cut_config(starcoder2_3b, n_layers=TRAIN_CUT_LAYERS):
        for pol in ("bf16", "int8-mlp"):
            int8 = pol == "int8-mlp"
            t0 = time.perf_counter()
            plain_losses, plain_kept, plain_ms = _plain_train(int8)
            plain_s = time.perf_counter() - t0
            _zero_counts()
            mesh, mesh_kept = _launch_train(
                args + (["--int8"] if int8 else []) + [
                    "--mesh", "1x1", "--ckpt-dir", str(root / pol)],
                keep_step=DIST_STEPS - 1)
            counts, tc = _read_counts(), _read_tc_counts()
            eq = _snapshots_equal(plain_kept, mesh_kept)
            losses = {"first_loss": (plain_losses[0], mesh["first_loss"]),
                      "final_loss": (plain_losses[-1], mesh["final_loss"])}
            if not eq["bit_equal"] or any(a != b for a, b in
                                          losses.values()):
                raise AssertionError(f"phase 16 (a) {pol}: the 1 x 1 mesh "
                                     f"differs from the unsharded trainer: "
                                     f"{eq}, losses {losses}")
            if mesh["mesh"] != [1, 1] or mesh["steps_run"] != DIST_STEPS:
                raise AssertionError(f"phase 16 (a): {mesh}")
            qmm = counts["quant_matmul"]
            others = {k: v for k, v in counts.items()
                      if v and k != "quant_matmul"}
            want = 2 * TRAIN_CUT_LAYERS * DIST_STEPS if int8 else 0
            if qmm != want or tc.get("quant_matmul", 0) != qmm or others:
                raise AssertionError(f"phase 16 (a) {pol}: launches "
                                     f"{counts}, tc {tc}, want {want}")
            if int8:
                launches["quant_matmul"] = qmm
            out[pol] = {"bit_equal": True, "losses": losses,
                        "quant_matmul": qmm, "quant_matmul_tc":
                        tc.get("quant_matmul", 0),
                        "mesh_step_ms": mesh["step_ms"],
                        "plain_step_ms": plain_ms,
                        "plain_s": plain_s, "mesh_wall_s": mesh["wall_s"]}
    return out, launches


def _dist_decode() -> tuple[dict, dict]:
    """(a) ``make_decode_step`` on the one-rank mesh: starcoder2-3b cut
    to 2 layers, bf16 weights from seed 0, a prefill and 8 greedy steps,
    against the unsharded ``generate`` from the same weights; the decode
    steps' flash_decode launches counted."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import (ShardingRules,
                                               batch_placements, distribute)
    from repro_torch.runtime import train_loop as TL
    c = DIST_DECODE
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CUT_LAYERS,
                                         param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt_len"]),
                            generator=gen)
    cache_len = c["prompt_len"] + c["steps"] + 1
    plain = build_model(cfg, device="cuda")
    ref = generate(plain, plain.init(0), prompts, c["steps"] + 1, cache_len,
                   scan=False).cpu()
    mesh = make_host_mesh(1, 1, "cuda")
    rules = ShardingRules.default(mesh)
    model = build_model(cfg, device="cuda", mesh=mesh)
    params = TL.shard_params(model.init(0), TL.state_shardings(
        model, rules, "sgd")["params"])
    cache = TL.place_cache(model.init_cache(c["batch"], cache_len),
                           TL.cache_shardings(model, rules, c["batch"],
                                              cache_len))
    bp = batch_placements(mesh)
    logits, cache = TL.make_prefill_step(model, cache_len)(
        params, {"tokens": distribute(prompts.cuda(), mesh, bp)}, cache)
    step = TL.make_decode_step(model)
    tok = logits.full_tensor()[:, -1].argmax(-1, keepdim=True).int()
    toks = [tok]
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        logits, cache = step(params, cache, distribute(tok, mesh, bp))
        tok = logits.full_tensor()[:, -1].argmax(-1, keepdim=True).int()
        toks.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = _read_counts(), _read_tc_counts()
    got = torch.cat(toks, 1).cpu()
    fd = counts["flash_decode"]
    if not torch.equal(got, ref.to(got.dtype)):
        raise AssertionError(f"phase 16 (a): mesh decode tokens differ from "
                             f"generate's in {int((got != ref).sum())}")
    if fd != c["steps"] * cfg.n_layers or any(
            v for k, v in counts.items() if k != "flash_decode"):
        raise AssertionError(f"phase 16 (a): decode launches {counts}")
    return ({"tokens_equal": True, "flash_decode": fd,
             "flash_decode_tc": tc.get("flash_decode", 0),
             "step_ms": wall / c["steps"] * 1e3, **c},
            {"flash_decode": fd})


def _dist_dryrun() -> dict:
    """(b) the dry run on the host, placeholder world of 256 ranks:
    ``dryrun_flow(qwen2-7b, decode_32k, "H")`` — three probes over
    ``cache_seq_axis`` — then Lower → Compile → Roofline at train_4k."""
    from repro_torch.core.strategies import dryrun_flow, run
    from repro_torch.launch.roofline import format_roofline
    t0 = time.perf_counter()
    meta = run(dryrun_flow(DIST_ARCH, "decode_32k", o_tasks="H",
                           task_params={"H": {"shape": "decode_32k"}}))
    res = meta.get("sharding_search.result")
    probes = []
    for t in res["trace"]:
        axis, r = t["config"]["cache_seq_axis"], t["roofline"]
        print(format_roofline(f"{DIST_ARCH} decode_32k cache_seq_axis="
                              f"{axis}", r), flush=True)
        if r["fallbacks"] != DIST_FALLBACKS[axis]:
            raise AssertionError(f"phase 16 (b): fallbacks {r['fallbacks']} "
                                 f"at cache_seq_axis={axis}")
        probes.append({"cache_seq_axis": axis, "bound_ms": r["bound_s"] * 1e3,
                       "dominant": r["dominant"], "fits": r["fits_hbm"],
                       "peak_gb": r["memory"]["peak_bytes"] / 1e9,
                       "fallbacks": r["fallbacks"],
                       "collective_counts": r["collective_counts"]})
    if not res["roofline"]["fits_hbm"]:
        raise AssertionError("phase 16 (b): no probe fits 80 GB")
    decode_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    tmeta = run(dryrun_flow(DIST_ARCH, "train_4k"))
    tr = tmeta.get("roofline.last")
    return {"probes": probes, "best": res["best"],
            "best_bound_ms": res["roofline"]["bound_s"] * 1e3,
            "decode_flow_s": decode_s,
            "train": {"bound_ms": tr["bound_s"] * 1e3,
                      "dominant": tr["dominant"],
                      "compute_ms": tr["compute_s"] * 1e3,
                      "memory_ms": tr["memory_s"] * 1e3,
                      "collective_ms": tr["collective_s"] * 1e3,
                      "peak_gb": tr["memory"]["peak_bytes"] / 1e9,
                      "fits": tr["fits_hbm"],
                      "collective_counts": tr["collective_counts"],
                      "flow_s": time.perf_counter() - t1}}


def _dist_execute(best: dict) -> dict:
    """(c) rank 0's program of (b)'s best decode_32k config on the card
    (28 layers, 8 requests, every cache slot live; the placeholder
    group's collectives stubbed): the card's peak against Compile's
    prediction, and the step's time."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import execute_cell, lower_cell
    kw = {k: v for k, v in best.items() if v is not None}
    shape = SHAPES["decode_32k"]
    lowered, _, _, _ = lower_cell(DIST_ARCH, shape, **kw)
    mem = lowered.compile().memory_analysis()
    predicted = mem.argument_size_in_bytes + mem.temp_size_in_bytes
    got = execute_cell(DIST_ARCH, shape, device="cuda", **kw)
    ratio = got["peak_bytes"] / predicted
    if abs(ratio - 1.0) > DIST_PEAK_TOL:
        raise AssertionError(f"phase 16 (c): peak {got['peak_bytes']} "
                             f"against {predicted} predicted")
    return {"config": kw, "predicted_peak_bytes": predicted,
            "predicted_arg_bytes": mem.argument_size_in_bytes,
            "measured_peak_bytes": got["peak_bytes"],
            "measured_arg_bytes": got["arg_bytes"], "ratio": ratio,
            "step_ms": got["ms"], "step_ms_all": got["ms_all"],
            "collectives": got["collectives"]}


def phase_dist() -> dict:
    """Phase 16, distribution: (a) the sharded trainer and decode on a
    real one-rank NCCL mesh against the unsharded ones; (b) the dry run
    of the reference's 16 x 16 production mesh on a placeholder group;
    (c) one rank of (b)'s best decode config executed on the card.  The
    counts are set to 0 just before each sharded run and read after it;
    returns the launches of (a)."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    _one_rank_world()
    try:
        train, launches = _dist_train(root)
        shutil.rmtree(root, ignore_errors=True)
        decode, dl = _dist_decode()
        launches.update(dl)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "dist", "part": "a", "arch": TRAIN_ARCH,
          "layers": TRAIN_CUT_LAYERS, "train": train, "decode": decode,
          "wall_s": time.perf_counter() - t0})
    t1 = time.perf_counter()
    try:
        dry = _dist_dryrun()
        emit({"phase": "dist", "part": "b", "arch": DIST_ARCH,
              "mesh": "16x16", **dry, "wall_s": time.perf_counter() - t1})
        t1 = time.perf_counter()
        ex = _dist_execute(dry["best"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit({"phase": "dist", "part": "c", "arch": DIST_ARCH, **ex,
          "wall_s": time.perf_counter() - t1})
    emit({"phase": "dist_done", "launches": launches,
          "wall_s": time.perf_counter() - t0})
    return launches


PREFILL_RANGE = "burst_prefill"
# the enc-dec decode profile's ranges over a decoder layer's parts
PART_RANGES = ("layer_self_attention", "layer_cross_attention",
               "layer_mlp")
USER_RANGES = (PREFILL_RANGE,) + PART_RANGES


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


def _profile_summary(prof, wall: float, table: str, events=None) -> dict:
    """Device busy time and idle share over ``wall``, the top kernels
    and host ops (from ``events``, ``prof.key_averages()`` when not
    given); the full table goes to ``chiprun_out/<table>``."""
    import torch
    if events is None:
        events = prof.key_averages()
    # device-side events only: a host op's device time repeats its
    # kernels' time (and a user range's device span is no kernel)
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in USER_RANGES]
    busy_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
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
            "cuda_launch_calls": launches,
            "top_device": [[e.key[:60], round(e.self_device_time_total / 1e3,
                                              3), e.count] for e in top_dev],
            "top_host": [[e.key[:60], round(e.self_cpu_time_total / 1e3, 3),
                          e.count] for e in top_cpu]}


@contextlib.contextmanager
def _part_ranges(on: bool):
    """With ``on``: for the block's duration, ``layers.attention`` and
    ``layers.mlp`` run inside the :data:`PART_RANGES` record_function
    ranges (cross-attention: a call with ``kv_override``), and are put
    back after.  The enc-dec decoder reaches both through the module."""
    from torch.profiler import record_function
    from repro_torch.models import layers as L
    if not on:
        yield
        return
    attention, mlp = L.attention, L.mlp

    def ranged_attention(*args, **kw):
        cross = kw.get("kv_override") is not None
        with record_function(PART_RANGES[1] if cross else PART_RANGES[0]):
            return attention(*args, **kw)

    def ranged_mlp(*args, **kw):
        with record_function(PART_RANGES[2]):
            return mlp(*args, **kw)

    L.attention, L.mlp = ranged_attention, ranged_mlp
    try:
        yield
    finally:
        L.attention, L.mlp = attention, mlp


def _profile_generate(cfg, lm, c=GENERATE, policies=("bf16", "int8-mlp"),
                      phase="profile_generate", frames=None,
                      steps: int = 16) -> None:
    """torch.profiler over ``steps`` contiguous decode steps of a ``generate``
    shape (the phase-5 one by default; after an unprofiled prefill, which
    encodes an enc-dec model's ``frames``), once per policy.  For an
    enc-dec model the profile also holds a range around each decoder
    layer's self-attention (its projections, the cache write and
    flash_decode), cross-attention (over the cached frames) and MLP, put
    there by :func:`_part_ranges` for this run only: each part's host and
    device milliseconds a step and its share of the step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.launch.serve import (generate, make_serve_fns,
                                          serve_policy)
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import greedy_argmax
    b, s = c["batch"], c["prompt_len"]
    prompts = torch.from_numpy(lm_tokens(b * s, cfg.vocab_size, seed=1)
                               .reshape(b, s).astype(np.int32)).cuda()
    extra = {} if frames is None else {"frames": frames.cuda()}
    for pname in policies:
        int8 = pname == "int8-mlp"
        model = build_model(cfg, serve_policy(int8))
        fns = make_serve_fns(model)
        generate(model, lm, prompts[:, :64], 4, 69, fns=fns,
                 frames=frames)                                  # warm-up
        cache = model.init_cache(b, s + steps + 1)
        logits, cache = fns.prefill(lm, {"tokens": prompts, **extra}, cache)
        tok = greedy_argmax(logits[:, -1:]).to(torch.int32)
        torch.cuda.synchronize()
        with _part_ranges(cfg.enc_dec), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fns.decode_scan(lm, cache, tok, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        summary = _profile_summary(prof, wall, f"{phase}_{pname}.txt",
                                   events)
        step_ms = 1e3 * wall / steps
        busy_ms = max(1e3 * summary["device_busy_s"] / steps, 1e-9)
        parts = {}
        for e in events:
            if e.key in PART_RANGES and \
                    e.device_type == torch.autograd.DeviceType.CPU:
                host_ms = e.cpu_time_total / 1e3 / steps
                dev_ms = e.device_time_total / 1e3 / steps
                parts[e.key] = {"calls_per_step": e.count / steps,
                                "host_ms": host_ms,
                                "host_share_of_step": host_ms / step_ms,
                                "device_ms": dev_ms,
                                "device_share_of_busy": dev_ms / busy_ms}
        flash_ms = sum(e.self_device_time_total for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "decode" in e.key) / 1e3 / steps
        if parts:
            summary["parts"] = parts
        emit({"phase": phase, "arch": cfg.name, "policy": pname,
              "batch": b, "prompt_len": s, "decode_steps": steps,
              "wall_s": wall, "decode_step_ms": step_ms,
              "device_events_per_step": summary["device_events"] / steps,
              "flash_decode_device_ms": flash_ms,
              "readback_s": time.perf_counter() - t0 - wall, **summary})
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


def phase_timing(launches: dict, families: dict, hybrid: dict,
                 encdec: dict, train: dict) -> list:
    """Kernel rows at the phase-5 shapes (``launches``: phases 5 and 8),
    with sub-rows at granite-moe-1b-a400m's burst and ``generate``
    shapes and DeepSeek-V2's shared experts (``families``: phase 12's
    launches), at zamba2-2.7b's shared block (``hybrid``: phase 13's
    launches): flash_decode at D = 80 and quant_matmul at its MLP, and
    at whisper-small (``encdec``: phase 14's launches): flash_decode at
    g = 1 over 68 live slots and quant_matmul at its MLP, and at
    starcoder2-3b's training forward (``train``: phase 15's launches):
    quant_matmul at its MLP."""
    import torch
    c = SERVE
    gen = torch.Generator().manual_seed(2)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    # scaled_dot_product_attention takes enable_gqa from torch 2.5 on
    sdpa_gqa = tuple(int(x) for x in
                     torch.__version__.split("+")[0].split(".")[:2]) >= (2, 5)
    rows = []
    row = _paged_decode_row(gen, launches, flush, sdpa_gqa, *QWEN_ATTN)
    sub = _paged_decode_row(gen, families, flush, sdpa_gqa, *GRANITE_ATTN)
    row["granite"] = {key: sub[key] for key in SUB_ROW_KEYS + ("launches",)}
    rows.append(row)

    # prefill: the burst's fresh dispatch, 8 x 512-token prompts, then its
    # shared-prefix dispatch, 8 x 256-token suffixes after 256 shared
    # positions; granite's fresh dispatch
    r, s = c["max_slots"], c["prompt_len"]
    row = _prefill_row(gen, launches, flush, sdpa_gqa, [0] * r, [s] * r, s)
    shared = _prefill_row(gen, launches, flush, sdpa_gqa,
                          [c["prefix_len"]] * r,
                          [s - c["prefix_len"]] * r, s - c["prefix_len"])
    row["shared_prefix"] = {key: shared[key] for key in SUB_ROW_KEYS}
    sub = _prefill_row(gen, families, flush, sdpa_gqa, [0] * r, [s] * r, s,
                       GRANITE_ATTN)
    row["granite"] = {key: sub[key] for key in SUB_ROW_KEYS + ("launches",)}
    rows.append(row)
    row = _flash_decode_row(gen, launches, flush, sdpa_gqa, QWEN_ATTN)
    sub = _flash_decode_row(gen, families, flush, sdpa_gqa, GRANITE_ATTN)
    row["granite"] = {key: sub[key] for key in SUB_ROW_KEYS + ("launches",)}
    sub = _flash_decode_row(gen, hybrid, flush, sdpa_gqa, ZAMBA_ATTN)
    row["zamba2"] = {key: sub[key] for key in SUB_ROW_KEYS + ("launches",)}
    sub = _flash_decode_row(gen, encdec, flush, sdpa_gqa, WHISPER_ATTN,
                            WHISPER, WHISPER_CACHE_LEN - 2)
    row["whisper"] = {key: sub[key] for key in SUB_ROW_KEYS + ("launches",)}
    rows.append(row)
    rows.append(_quant_matmul_row(gen, launches, flush, families, hybrid,
                                  encdec, train))
    rows.append(_block_sparse_row(launches, flush))
    rows.append(_flash_attention_row(launches, flush, sdpa_gqa))
    emit({"phase": "timing", "kernels": rows})
    return rows


def _paged_decode_row(gen, launches, flush, sdpa_gqa, h, kvh, d) -> dict:
    """flash_decode_paged at the phase-5 pool (R = 8, page size 16, 37
    pages a request) in bf16: 8 requests mid-generation (512-token prompt
    + 32 tokens).  Bytes: the live K/V, q and out, mask and tables once;
    operations: 4 * H * D * the live slots.  Library: SDPA over K/V
    gathered to contiguous, with the layer's mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode_paged as fdp
    c = SERVE
    r, ps, m = c["max_slots"], c["page_size"], c["max_blocks"]
    item = 2
    seq = [c["prompt_len"] + 32] * r
    q, kp, vp, bt, mask = _decode_inputs(gen, r, h, kvh, d, ps, m, seq,
                                         torch.bfloat16)
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
    row = _row("flash_decode_paged",
               "src/repro_torch/csrc/flash_decode_paged.cu",
               "src/repro/kernels/flash_decode_paged.py:74",
               launches, err, bf16_tol(ref),
               lambda: fdp.flash_decode_paged(q, kp, vp, bt, mask),
               lambda: fdp.flash_decode_paged_plain(q, kp, vp, bt, mask),
               lib, nbytes, flops, flush,
               {"R": r, "H": h, "KV": kvh, "D": d, "page_size": ps,
                "M": m, "seq_lens": seq[0], "dtype": "bfloat16"})
    row.update(launch, device_ms_by_kernel=_device_ms_by_kernel(
        lambda: fdp.flash_decode_paged(q, kp, vp, bt, mask), flush))
    row["tiles"] = {"chunk": launch.get("chunk"),
                    "n_chunks": launch.get("n_chunks")}
    return row


SUB_ROW_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "variant", "tiles", "shapes")


def _prefill_row(gen, launches, flush, sdpa_gqa, offs, lens, s,
                 attn=QWEN_ATTN) -> dict:
    """flash_prefill_ragged at the phase-5 pool (R = 8, page size 16, 37
    pages a request; ``attn`` = (H, KV, D), Qwen2-7B's by default) in
    bf16: suffixes of ``s`` positions at ``offs`` with ``lens`` live.
    Bytes: q and out, the live K/V and the tables once; operations: 4 * H
    * D * the causal pairs.  Library: SDPA over K/V gathered to
    contiguous, with the layer's mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill_ragged as fpr
    from repro_torch.models import layers as L
    c = SERVE
    r = c["max_slots"]
    h, kvh, d = attn
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


def _flash_decode_row(gen, launches, flush, sdpa_gqa, attn,
                      c=GENERATE, pos=None) -> dict:
    """Contiguous decode at a ``generate`` shape ``c`` (the phase-5 one
    by default): 8 sequences over the ``prompt_len + gen + 1``-slot
    cache at position ``pos`` (mid-generation, 32 tokens after the
    prompt, by default), ``attn`` = (H, KV, D)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers as L
    b = c["batch"]
    h, kvh, d = attn
    n = c["prompt_len"] + c["gen"] + 1
    pos = c["prompt_len"] + 32 if pos is None else pos
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
    row = _row("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
               "src/repro/kernels/flash_decode.py:130", launches, err,
               bf16_tol(ref), lambda: fd.flash_decode(q, k, v, mask),
               lambda: fd.flash_decode_plain(q, k, v, mask), lib,
               nbytes, flops, flush,
               {"B": b, "H": h, "KV": kvh, "D": d, "L": n, "pos": pos,
                "dtype": "bfloat16"})
    row.update(launch, device_ms_by_kernel=_device_ms_by_kernel(
        lambda: fd.flash_decode(q, k, v, mask), flush))
    row["tiles"] = {"chunk": launch.get("chunk"),
                    "n_chunks": launch.get("n_chunks")}
    return row


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
# DeepSeek-V2's shared experts (phase 12, int8-mlp): gate/up and down at
# decode (M = 4) and prefill (M = 1,024)
QMM_FAMILY_ROWS = (("dsv2_up_4", 4, 5120, 3072),
                   ("dsv2_up_1024", 1024, 5120, 3072),
                   ("dsv2_down_4", 4, 3072, 5120),
                   ("dsv2_down_1024", 1024, 3072, 5120))
# zamba2-2.7b's shared MLP (phase 13, int8-mlp): gate/up and down at
# decode (M = 8) and prefill (M = 4,096)
QMM_HYBRID_ROWS = (("zamba2_up_8", 8, 2560, 10240),
                   ("zamba2_up_4096", 4096, 2560, 10240),
                   ("zamba2_down_8", 8, 10240, 2560),
                   ("zamba2_down_4096", 4096, 10240, 2560))
# whisper-small's MLP (phase 14, int8-mlp): up and down at decode (M = 8)
# and in the encoder (M = 8 x 1,500 frames)
QMM_ENCDEC_ROWS = (("whisper_up_8", 8, 768, 3072),
                   ("whisper_up_12000", 12000, 768, 3072),
                   ("whisper_down_8", 8, 3072, 768),
                   ("whisper_down_12000", 12000, 3072, 768))
# starcoder2-3b's MLP in phase 15's int8-mlp training forward (8 x 128
# tokens): up and down
QMM_TRAIN_ROWS = (("starcoder2_up_1024", 1024, 3072, 12288),
                  ("starcoder2_down_1024", 1024, 12288, 3072))
QMM_SUB_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_note", "quantize_ms", "wrapper_ms", "max_abs_err",
                "shapes", "variant", "tiles", "swap", "splits",
                "device_ms_by_kernel", "launches")


def _quant_matmul_row(gen, launches, flush, families, hybrid,
                      encdec, train) -> dict:
    """The int8 product on operands already quantized, at each shape of
    :data:`QMM_ROWS`, :data:`QMM_FAMILY_ROWS` (their ``launches`` from
    phase 12's ``families``), :data:`QMM_HYBRID_ROWS` (phase 13's
    ``hybrid``), :data:`QMM_ENCDEC_ROWS` (phase 14's ``encdec``) and
    :data:`QMM_TRAIN_ROWS` (phase 15's ``train``),
    with the variant, tiles and splits that ran,
    and the weight quantization that every call also pays
    (``quantize_ms``) and the whole wrapper (``wrapper_ms``) timed beside
    it.  Library:
    ``torch._int_mm`` on the same int8 operands (int32 out, no
    dequantization), which refuses M <= 16."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    row = None
    for label, m, k, n in (QMM_ROWS + QMM_FAMILY_ROWS + QMM_HYBRID_ROWS
                           + QMM_ENCDEC_ROWS + QMM_TRAIN_ROWS):
        counts = {"dsv2": families, "zamba2": hybrid, "whisper": encdec,
                  "starcoder2": train}.get(label.split("_")[0], launches)
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
                 "src/repro/kernels/quant_matmul.py:55", counts, err, 0.0,
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
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run (default: all "
                         "but 7)")
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
    phase_s = {}        # each phase's wall seconds, for the done line

    def run(phase: int, fn, *args, default=None):
        if phase not in phases:
            return default
        t1 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_s[phase] = round(time.perf_counter() - t1, 1)

    smi = phase_device(src)
    run(2, phase_build)
    run(3, phase_kernels)
    run(4, phase_cpu_vs_gpu)
    launches = run(5, phase_serve, default={})
    tune_launches = run(8, phase_tune, default={})
    designflow_launches = run(11, phase_designflow, default={})
    families_launches = run(12, phase_families, default={})
    hybrid_launches = run(13, phase_ssm_hybrid, default={})
    encdec_launches = run(14, phase_encdec, default={})
    train_launches = run(15, phase_train, default={})
    dist_launches = run(16, phase_dist, default={})
    flow_launches, durable_launches = {}, {}
    if 9 in phases or 10 in phases:
        model = params = None
        if 9 in phases:
            flow_launches, model, params = run(9, phase_serveflow)
        if 10 in phases:
            if model is None:
                model, params = _durable_model()
            durable_launches = run(10, phase_durable, model, params)
        del model, params
        torch.cuda.empty_cache()
    # block_sparse_matmul and flash_attention run on phase 8's path only
    for name in ("block_sparse_matmul", "flash_attention"):
        launches[name] = tune_launches.get(name, 0)
    rows = run(6, phase_timing, launches, families_launches,
               hybrid_launches, encdec_launches, train_launches, default=[])
    for row in rows:
        row["tune_launches"] = tune_launches.get(row["name"], 0)
        row["serveflow_launches"] = flow_launches.get(row["name"], 0)
        row["durable_launches"] = durable_launches.get(row["name"], 0)
        row["designflow_launches"] = designflow_launches.get(row["name"], 0)
        row["families_launches"] = families_launches.get(row["name"], 0)
        row["ssm_hybrid_launches"] = hybrid_launches.get(row["name"], 0)
        row["encdec_launches"] = encdec_launches.get(row["name"], 0)
        row["train_launches"] = train_launches.get(row["name"], 0)
        row["dist_launches"] = dist_launches.get(row["name"], 0)
    run(7, phase_profile)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3),
          "phase_s": phase_s})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
