"""The bf16 tensor-core variants of flash_attention and flash_prefill_ragged
on the CPU: their arithmetic, which inputs take them, their shared memory
and the autotuner's candidates for them.

No CUDA kernel runs here.  ``tc_emulate`` repeats the tensor-core main
loop's arithmetic in PyTorch (``csrc/attention_tc.cuh``): bf16 Q, K and V,
fp32 scores with the scale applied after the product, 64-key tiles walked
in order with the online softmax, P rounded to bf16 per tile, an fp32
accumulator, one rounding of the output to bf16.  It is held against the
JAX package's references — ``ref.flash_attention_ref`` and the Pallas
``flash_prefill_ragged`` in interpret mode — on inputs drawn with numpy
from a seed, within the card's check (``chip_smoke.py``'s ``bf16_tol``:
2**-7 of the largest reference output, plus 1e-6).  That shows the
numeric design (P in bf16) passes the card's tolerance before any chip
run.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill_ragged import \
    flash_prefill_ragged as jax_prefill
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import attention_tc as tc
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_prefill_ragged as fpr

LOG2E = 1.4426950408889634
NEG_INF = -1e30
BUDGET = 232_448


def bf16_tol(ref: torch.Tensor) -> float:
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-6


def tc_emulate(q, k, v, visible, block_kv=64):
    """One head: q (Sq, D), k and v (Skv, D) in bf16, visible (Sq, Skv)
    bool.  Returns (Sq, D) bf16 as the tensor-core kernel computes it."""
    d = q.shape[-1]
    c = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    sq = q.shape[0]
    m = torch.full((sq,), NEG_INF)
    l = torch.zeros(sq)
    acc = torch.zeros((sq, d))
    for t0 in range(0, k.shape[0], block_kv):
        live = visible[:, t0:t0 + block_kv]
        s = torch.where(live, (qf @ kf[t0:t0 + block_kv].T) * c, NEG_INF)
        m_new = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp2(m - m_new)
        p = torch.where(live, torch.exp2(s - m_new[:, None]), 0.0)
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + \
            p.bfloat16().float() @ vf[t0:t0 + block_kv]
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[:, None]).bfloat16()


def _bf16(rng, shape):
    """bf16 values from a numpy seed, as a torch tensor and as the same
    values for JAX."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .bfloat16()
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


# --------------------------------------------- (a) the arithmetic vs JAX
@pytest.mark.parametrize("g", [1, 7])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (256, 256, True, 0), (256, 256, True, 100), (256, 256, False, 0),
    (130, 256, False, 48), (200, 200, True, 0)])
def test_flash_attention_tc_arithmetic_within_card_tolerance(g, sq, skv,
                                                             causal, window):
    rng = np.random.default_rng(10 * g + sq + window)
    kvh, d = 2, 128
    h = kvh * g
    q, jq = _bf16(rng, (2, sq, h, d))
    k, jk = _bf16(rng, (2, skv, kvh, d))
    v, jv = _bf16(rng, (2, skv, kvh, d))
    ref = torch.from_numpy(np.asarray(flash_attention_ref(
        jq, jk, jv, causal=causal, window=window)).astype(np.float32))
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    visible = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        visible &= qp >= kp
    if window:
        visible &= (qp - kp) < window
    assert bool(visible.any(dim=1).all())      # every row sees a key
    out = torch.empty((2, sq, h, d), dtype=torch.bfloat16)
    for b in range(2):
        for hh in range(h):
            out[b, :, hh] = tc_emulate(q[b, :, hh], k[b, :, hh // g],
                                       v[b, :, hh // g], visible)
    err = float((out.float() - ref).abs().max())
    assert err <= bf16_tol(ref), (err, bf16_tol(ref))


@pytest.mark.parametrize("g,ps", [(1, 16), (7, 8), (7, 64)])
def test_flash_prefill_ragged_tc_arithmetic_within_card_tolerance(g, ps):
    rng = np.random.default_rng(100 + g + ps)
    r, s, kvh, d = 3, 100, 1, 128
    h = kvh * g
    offs = np.asarray([0, 37, 5], np.int32)      # 37: not a page multiple
    lens = np.asarray([s, 63, 0], np.int32)      # 0: an idle slot
    blocks = -(-(int(offs.max()) + s) // ps)
    n_pages = r * blocks + 1
    q, jq = _bf16(rng, (r, s, h, d))
    kp, jkp = _bf16(rng, (n_pages, ps, kvh, d))
    vp, jvp = _bf16(rng, (n_pages, ps, kvh, d))
    bt = (rng.permutation(n_pages - 1) + 1).astype(np.int32)[:r * blocks] \
        .reshape(r, blocks)
    ref = torch.from_numpy(np.asarray(jax_prefill(
        jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(offs), jnp.asarray(lens),
        interpret=True)).astype(np.float32))
    n = blocks * ps
    kf = kp[torch.from_numpy(bt).long()].reshape(r, n, kvh, d)
    vf = vp[torch.from_numpy(bt).long()].reshape(r, n, kvh, d)
    qi = torch.arange(s)[:, None]
    kj = torch.arange(n)[None, :]
    out = torch.zeros((r, s, h, d), dtype=torch.bfloat16)
    for ri in range(r):
        visible = (kj <= int(offs[ri]) + qi) & (qi < int(lens[ri]))
        for hh in range(h):
            out[ri, :, hh] = tc_emulate(q[ri, :, hh], kf[ri, :, hh // g],
                                        vf[ri, :, hh // g], visible)
        out[ri, int(lens[ri]):] = 0             # rows past lens are 0
    assert not bool(out[2].float().abs().any())
    err = float((out.float() - ref).abs().max())
    assert err <= bf16_tol(ref), (err, bf16_tol(ref))


# ------------------------------------------------- (b) which inputs go where
@pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 64, 96, 128, 256])
def test_variant_rule(q_dt, kv_dt, d):
    want = "tc" if q_dt == kv_dt == torch.bfloat16 and d in (64, 128) \
        else "ffma"
    assert tc.variant(q_dt, kv_dt, d) == want
    names = (str(q_dt).removeprefix("torch."),
             str(kv_dt).removeprefix("torch."))
    assert tc.variant(*names, d) == want


def test_tc_tiles_map_requests_to_the_nearest_taken_tile():
    assert fa.effective_tiles(None, None, 4096, 4096, "tc") == (128, 128)
    assert fa.effective_tiles(32, 32, 4096, 4096, "tc") == (64, 64)
    assert fa.effective_tiles(256, 256, 4096, 4096, "tc") == (128, 128)
    assert fa.effective_tiles(128, 128, 40, 64, "tc") == (64, 64)
    # the fp32 kernel's clamping is unchanged
    assert fa.effective_tiles(256, 256, 100, 100) == (128, 128)
    assert fa.effective_tiles(32, 96, 512, 512) == (32, 96)
    args = (7, 128, 16)                          # g, D, page size
    assert fpr.effective_block_q(None, 512, "tc", *args) == fpr.TC_BQ
    assert fpr.effective_block_q(fpr.BQ, 512, "tc", *args) == 64
    assert fpr.effective_block_q(128, 512, "tc", *args) == 128
    assert fpr.effective_block_q(256, 512, "tc", *args) == 128
    assert fpr.effective_block_q(128, 50, "tc", *args) == 64
    # fp32: the default 32 fits at g = 7, D = 128; 64 halves back to 32
    assert fpr.effective_block_q(None, 512, "ffma", *args) == 32
    assert fpr.effective_block_q(64, 512, "ffma", *args) == 32
    assert fpr.effective_block_q(64, 512, "ffma", 1, 8, 4) == 64


# ---------------------------------------- (c) shared memory and candidates
def _plan(bq, bkv, d):
    """The bf16 Q tile, then as many stages of a K and a V tile (at most
    4) as fit in the budget beside it and 1,280 bytes of barriers and
    alignment slack."""
    q_tile, stage = 2 * bq * d, 2 * (2 * bkv * d)
    stages = min(4, (BUDGET - 1280 - q_tile) // stage)
    return stages, q_tile + stages * stage + 256 + 1024


@pytest.mark.parametrize("d", [64, 128])
def test_tc_shared_memory_model_and_budget(d):
    for bq in tc.TILES:
        for bkv in tc.TILES:
            stages, nbytes = _plan(bq, bkv, d)
            assert tc.stages(bq, bkv, d) == stages >= 3
            assert tc.smem_bytes(bq, bkv, d) == nbytes <= BUDGET
    for bq in tc.TILES:
        stages, nbytes = _plan(bq, fpr.TC_BLOCK_KV, d)
        assert stages == 4
        assert fpr.smem_bytes_tc(bq, d) == nbytes <= BUDGET


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_candidates_are_the_tc_tiles(d):
    prob = tat.flash_attention_problem((1, 4096, 28, d), (1, 4096, 4, d),
                                       "bfloat16")
    cands = tat.enumerate_candidates("flash_attention", prob)
    assert [c for c, _ in cands] == [
        {"block_q": 128, "block_kv": 128}, {"block_q": 128, "block_kv": 64},
        {"block_q": 64, "block_kv": 128}, {"block_q": 64, "block_kv": 64}]
    assert [s for _, s in cands] == [
        tc.smem_bytes(c["block_q"], c["block_kv"], d) for c, _ in cands]
    prob = tat.flash_prefill_ragged_problem(8, 512, 28, 4, d, 592, 16,
                                            "bfloat16")
    cands = tat.enumerate_candidates("flash_prefill_ragged", prob)
    # the kernel default (32) stands for the tile it runs, 64
    assert [c for c, _ in cands] == [{"block_q": 32}, {"block_q": 128}]
    assert [s for _, s in cands] == [fpr.smem_bytes_tc(64, d),
                                     fpr.smem_bytes_tc(128, d)]
    # a 32-token suffix bucket is covered by one 64-row tile
    prob = dict(prob, s=32)
    assert [c for c, _ in tat.enumerate_candidates(
        "flash_prefill_ragged", prob)] == [{"block_q": 32}]


def test_fp32_and_other_candidates_are_unchanged():
    prob = tat.flash_attention_problem((1, 512, 28, 128), (1, 512, 4, 128),
                                       "float32")
    every = tat.KERNELS["flash_attention"].candidates(prob)
    assert len(every) == 16
    assert every[0] == ({"block_q": 128, "block_kv": 128},
                        fa.smem_bytes(128, 128, 128, "float32"))
    prob = tat.flash_prefill_ragged_problem(8, 512, 28, 4, 128, 592, 16,
                                            "float32")
    assert [c["block_q"] for c, _ in tat.KERNELS[
        "flash_prefill_ragged"].candidates(prob)] == [32, 8, 16, 64, 128,
                                                      256]
    # bf16 at D = 8 takes the fp32 kernel's tiles: all clamp to s = 7
    prob = tat.flash_prefill_ragged_problem(4, 7, 7, 1, 8, 64, 8,
                                            "bfloat16")
    assert tat.KERNELS["flash_prefill_ragged"].candidates(prob) == [
        ({"block_q": 32}, fpr.smem_bytes(7, 7, 8, 8))]
