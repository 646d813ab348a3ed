"""The bf16 split-KV tensor-core variants of flash_decode_paged and
flash_decode on the CPU: their arithmetic, which inputs take them, their
chunk plan, shared memory and workspace, and the invariance of a
request's output bits.

No CUDA kernel runs here.  ``decode_tc_emulate`` repeats the kernels'
arithmetic in PyTorch (``csrc/decode_tc.cuh``): bf16 q, K and V; fp32
scores with the scale applied after the product; the chunks of the
Python plan (``kernels/decode_tc.py``), each cut into 32-slot sub-tiles
that four warps take in turn with the online softmax, sub-tiles without
a live slot skipped; P rounded to bf16 per sub-tile; the warps' partials
combined in warp order, then the chunks' in chunk order; one rounding of
the output to bf16.  It is held against the JAX package's Pallas
``flash_decode_paged`` and ``flash_decode`` in interpret mode, on inputs
drawn with numpy from a seed, within the card's check (``chip_smoke.py``'s
``bf16_tol``: 2**-7 of the largest reference output, plus 1e-6).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_decode
from repro.kernels.flash_decode_paged import \
    flash_decode_paged as jax_decode_paged
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import decode_tc as dtc
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_decode_paged as fdp
from repro_torch.models import layers as TL

LOG2E = 1.4426950408889634
NEG_INF = -1e30
BUDGET = 232_448


def bf16_tol(ref: torch.Tensor) -> float:
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-6


def _combine(parts, shape):
    """Partials (m, l, acc) in order, neutral ones (None) skipped:
    m* = max m_i; acc = sum acc_i 2^(m_i - m*), l likewise."""
    live = [p for p in parts if p is not None]
    if not live:
        return torch.full(shape[:1], NEG_INF), torch.zeros(shape[:1]), \
            torch.zeros(shape)
    ms = torch.stack([m for m, _, _ in live]).max(dim=0).values
    l, acc = torch.zeros(shape[:1]), torch.zeros(shape)
    for m, li, ai in live:
        f = torch.exp2(m - ms)
        acc = acc + ai * f[:, None]
        l = l + li * f
    return ms, l, acc


def decode_tc_emulate(q, k, v, live, chunk):
    """One (request, kv head): q (g, D), k and v (n, D) in logical slot
    order, all bf16; live (n,) bool.  Returns (g, D) bf16 as the split-KV
    tensor-core kernels compute it."""
    g, d = q.shape
    n = k.shape[0]
    c = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    qf = q.float()
    chunks = []
    for c0 in range(0, n, chunk):
        c_end = min(c0 + chunk, n)
        if not bool(live[c0:c_end].any()):
            chunks.append(None)              # the neutral partial
            continue
        n_sub = -(-(c_end - c0) // dtc.SUB)
        warps = []
        for w in range(dtc.WARPS):
            m = torch.full((g,), NEG_INF)
            l, acc = torch.zeros(g), torch.zeros((g, d))
            seen = False
            for t in range(w, n_sub, dtc.WARPS):
                s0 = c0 + dtc.SUB * t
                s1 = min(s0 + dtc.SUB, c_end)
                lv = live[s0:s1]
                if not bool(lv.any()):
                    continue                 # a dead sub-tile: skipped
                seen = True
                s = qf @ k[s0:s1].float().T
                mx = torch.where(lv, s, -torch.inf).max(dim=1).values
                m_new = torch.maximum(m, mx * c)
                corr = torch.exp2(m - m_new)
                p = torch.where(lv, torch.exp2(s * c - m_new[:, None]), 0.0)
                l = l * corr + p.sum(dim=1)
                acc = acc * corr[:, None] + \
                    p.bfloat16().float() @ v[s0:s1].float()
                m = m_new
            warps.append((m, l, acc) if seen else None)
        chunks.append(_combine(warps, (g, d)))
    _, l, acc = _combine(chunks, (g, d))
    return (acc / torch.clamp(l, min=1e-30)[:, None]).bfloat16()


def emulate_paged(q, k_pages, v_pages, block_tables, mask):
    """The paged variant over a batch: (R, 1, H, D) bf16."""
    r, _, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    g, n = h // kvh, block_tables.shape[1] * ps
    kf = k_pages[block_tables.long()].reshape(r, n, kvh, d)
    vf = v_pages[block_tables.long()].reshape(r, n, kvh, d)
    out = torch.empty_like(q)
    for ri in range(r):
        for kh in range(kvh):
            out[ri, 0, kh * g:(kh + 1) * g] = decode_tc_emulate(
                q[ri, 0, kh * g:(kh + 1) * g], kf[ri, :, kh], vf[ri, :, kh],
                mask[ri], dtc.paged_chunk(ps))
    return out


def emulate_contig(q, k, v, mask):
    """The contiguous variant over a batch: (B, 1, H, D) bf16."""
    b, _, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    out = torch.empty_like(q)
    for bi in range(b):
        for kh in range(kvh):
            out[bi, 0, kh * g:(kh + 1) * g] = decode_tc_emulate(
                q[bi, 0, kh * g:(kh + 1) * g], k[bi, :, kh], v[bi, :, kh],
                mask, dtc.CHUNK)
    return out


def _bf16(rng, shape):
    """bf16 values from a numpy seed, as a torch tensor and as the same
    values for JAX."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .bfloat16()
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _paged_problem(rng, g, kvh, d, ps, m, lens):
    r = len(lens)
    n_pages = r * m + 1
    q, jq = _bf16(rng, (r, 1, g * kvh, d))
    kp, jkp = _bf16(rng, (n_pages, ps, kvh, d))
    vp, jvp = _bf16(rng, (n_pages, ps, kvh, d))
    bt = (rng.permutation(n_pages - 1) + 1).astype(np.int32)[:r * m] \
        .reshape(r, m)
    mask = np.arange(m * ps)[None, :] < np.asarray(lens)[:, None]
    return (q, kp, vp, torch.from_numpy(bt), torch.from_numpy(mask)), \
        (jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(mask))


# --------------------------------------------- (a) the arithmetic vs JAX
PAGES = {4: 40, 16: 12, 48: 5, 128: 3}       # page size -> pages a row


@pytest.mark.parametrize("ps", sorted(PAGES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 7])
def test_paged_tc_arithmetic_within_card_tolerance(g, d, ps):
    """lens 0 (no live slot), 1, mid and capacity; 1 or 2 kv heads; the
    chunks of the page size, the last cut at M pages."""
    m = PAGES[ps]
    cap = m * ps
    rng = np.random.default_rng(1000 * g + 10 * d + ps)
    args, jargs = _paged_problem(rng, g, 2 if g < 7 else 1, d, ps, m,
                                 [0, 1, cap // 2 + 3, cap])
    ref = torch.from_numpy(np.asarray(
        jax_decode_paged(*jargs, interpret=True)).astype(np.float32))
    out = emulate_paged(*args)
    assert not bool(out[0].float().abs().any())   # no live slot: zeros
    err = float((out.float() - ref).abs().max())
    assert err <= bf16_tol(ref), (err, bf16_tol(ref))


def _contig_masks(n):
    """Linear-cache masks at position 0, mid-cache and full, and two
    wrapped sliding-window rings (live slots not a prefix)."""
    out = []
    for pos, window in ((0, 0), (n // 2, 0), (n - 1, 0),
                        (n + n // 3, n), (2 * n + 5, n // 2 + 1)):
        kv_pos = TL.kv_positions_for_cache(pos, n, window)
        out.append(TL.decode_attention_mask(kv_pos, pos, window))
    return out


@pytest.mark.parametrize("n", [37, 577])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 7])
def test_contig_tc_arithmetic_within_card_tolerance(g, d, n):
    rng = np.random.default_rng(7 * g + d + n)
    kvh = 2 if g < 7 else 1
    q, jq = _bf16(rng, (2, 1, g * kvh, d))
    k, jk = _bf16(rng, (2, n, kvh, d))
    v, jv = _bf16(rng, (2, n, kvh, d))
    masks = _contig_masks(n)
    assert not bool(masks[-1][:n // 4].all())     # the ring wrapped
    for mask in masks:
        ref = torch.from_numpy(np.asarray(jax_decode(
            jq, jk, jv, jnp.asarray(mask.numpy()),
            interpret=True)).astype(np.float32))
        out = emulate_contig(q, k, v, mask)
        err = float((out.float() - ref).abs().max())
        assert err <= bf16_tol(ref), (err, bf16_tol(ref))


# ------------------------------------------------- (b) which inputs go where
@pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 64, 96, 128, 256])
def test_variant_rule(q_dt, kv_dt, d):
    want = "tc" if q_dt == kv_dt == torch.bfloat16 and d in (64, 128) \
        else "ffma"
    assert dtc.variant(q_dt, kv_dt, d) == want
    names = (str(q_dt).removeprefix("torch."),
             str(kv_dt).removeprefix("torch."))
    assert dtc.variant(*names, d) == want


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(5)
    args, _ = _paged_problem(rng, 7, 1, 128, 16, 3, [0, 20, 47])
    counts = (fdp.launches, fdp.launches_tc, fd.launches, fd.launches_tc)
    out = fdp.flash_decode_paged(*args)
    assert torch.equal(out, fdp.flash_decode_paged_plain(*args))
    q, kp = args[0], args[1]
    k = kp[1:4].reshape(1, 48, 1, 128)
    out = fd.flash_decode(q[:1], k, k, args[4][0])
    assert torch.equal(out, fd.flash_decode_plain(q[:1], k, k, args[4][0]))
    assert (fdp.launches, fdp.launches_tc, fd.launches,
            fd.launches_tc) == counts


# ---------------------------------------------------- (c) the chunk plan
@pytest.mark.parametrize("ps", [1, 3, 4, 8, 16, 48, 64, 100, 128, 200,
                                256, 512])
def test_paged_chunk_is_whole_pages_of_the_page_size_alone(ps):
    chunk = dtc.paged_chunk(ps)
    assert chunk % ps == 0 and chunk >= ps
    if ps <= dtc.CHUNK:
        # the most whole pages within CHUNK slots
        assert chunk <= dtc.CHUNK < chunk + ps
    else:
        assert chunk == ps
    # the table width and the batch only change how many chunks there are
    for m in (1, 2, 7, 37, 100):
        n = dtc.n_chunks(m * ps, chunk)
        assert (n - 1) * chunk < m * ps <= n * chunk


def test_serving_shapes_give_five_chunks():
    # the phase-5 burst (page size 16, 37 pages) and generate (577 slots)
    assert dtc.paged_chunk(16) == 128
    assert dtc.n_chunks(37 * 16, dtc.paged_chunk(16)) == 5
    assert dtc.n_chunks(577, dtc.CHUNK) == 5


# ------------------------------------ (d) shared memory and the workspace
def _plan_bytes(d, chunk):
    """Four warps, each with one stage of a bf16 K and V sub-tile of 32
    rows padded to D + 8 (two stages when a warp walks more than one
    sub-tile)."""
    sub_tiles = -(-chunk // 32)
    stages = 2 if sub_tiles > 4 else 1
    return 4 * stages * 2 * 32 * (d + 8) * 2


@pytest.mark.parametrize("d", [64, 128])
def test_tc_shared_memory_model_and_budget(d):
    for ps in (4, 8, 16, 32, 48, 64, 100, 128, 256, 512):
        nbytes = _plan_bytes(d, dtc.paged_chunk(ps))
        assert fdp.smem_bytes_tc(d, ps) == nbytes <= BUDGET
        # a warp's partial (acc [16][D], m, l) fits in its first stage
        assert 16 * (d + 2) * 4 <= 2 * 32 * (d + 8) * 2
    assert dtc.smem_bytes(d, dtc.CHUNK) == _plan_bytes(d, 128)
    assert dtc.stages(dtc.CHUNK) == 1 and dtc.stages(256) == 2


def test_workspace_holds_acc_m_and_l_of_every_chunk():
    r, kv, n, g, d = 8, 4, 5, 7, 128
    shapes = dtc.workspace_shapes(r, kv, n, g, d)
    assert shapes == {"acc": (8, 4, 5, 7, 128), "m": (8, 4, 5, 7),
                      "l": (8, 4, 5, 7)}
    assert dtc.workspace_floats(r, kv, n, g, d) == 8 * 4 * 5 * 7 * 130


def test_autotune_times_the_variant_the_dtype_takes():
    bf = tat.flash_decode_problem((8, 1, 28, 128), (8, 577, 4, 128),
                                  "bfloat16")
    fp = dict(bf, dtype="float32")
    assert tat.enumerate_candidates("flash_decode", bf) == [
        ({}, dtc.smem_bytes(128, dtc.CHUNK))]
    assert tat.enumerate_candidates("flash_decode", fp) == [
        ({}, fd.smem_bytes(7, 128))]
    prob = tat.flash_decode_paged_problem(8, 28, 4, 128, 512, "bfloat16")
    assert all(s == fdp.smem_bytes_tc(128, c["page_size"])
               for c, s in tat.enumerate_candidates("flash_decode_paged",
                                                    prob))


# ----------------------------------------------- (e) the invariance contract
def test_paged_output_bits_independent_of_row_pages_and_table_width():
    rng = np.random.default_rng(11)
    g, kvh, d, ps, m = 7, 2, 64, 16, 12
    (q, kp, vp, bt, mask), _ = _paged_problem(rng, g, kvh, d, ps, m,
                                              [150, 3, 0, 191])
    base = emulate_paged(q, kp, vp, bt, mask)[0]
    # another row index, with other siblings around it
    sib, _ = _paged_problem(np.random.default_rng(12), g, kvh, d, ps, m,
                            [40, 191, 2, 100])
    q2, bt2, mask2 = sib[0].clone(), sib[3].clone(), sib[4].clone()
    q2[2], bt2[2], mask2[2] = q[0], bt[0], mask[0]
    kp2, vp2 = sib[1].clone(), sib[2].clone()
    used = bt[0].long()
    kp2[used], vp2[used] = kp[used], vp[used]     # its pages' values
    assert torch.equal(emulate_paged(q2, kp2, vp2, bt2, mask2)[2], base)
    # renumbered pages: the same values at other physical pages
    n_pages = kp.shape[0]
    perm = torch.from_numpy(rng.permutation(n_pages - 1) + 1)
    perm = torch.cat([torch.zeros(1, dtype=perm.dtype), perm])
    kp3, vp3 = torch.empty_like(kp), torch.empty_like(vp)
    kp3[perm], vp3[perm] = kp, vp
    bt3 = perm[bt.long()].to(torch.int32)
    assert torch.equal(emulate_paged(q, kp3, vp3, bt3, mask)[0], base)
    # a wider table: the extra entries on the scratch page 0, dead
    bt4 = torch.cat([bt, torch.zeros((4, 9), dtype=torch.int32)], dim=1)
    mask4 = torch.cat([mask, torch.zeros((4, 9 * ps), dtype=torch.bool)],
                      dim=1)
    assert torch.equal(emulate_paged(q, kp, vp, bt4, mask4)[0], base)


def test_contig_output_bits_independent_of_the_batch():
    rng = np.random.default_rng(13)
    q, _ = _bf16(rng, (3, 1, 14, 128))
    k, _ = _bf16(rng, (3, 577, 2, 128))
    v, _ = _bf16(rng, (3, 577, 2, 128))
    mask = _contig_masks(577)[3]
    full = emulate_contig(q, k, v, mask)
    assert torch.equal(emulate_contig(q[1:2], k[1:2], v[1:2], mask),
                       full[1:2])
    assert torch.equal(emulate_contig(q[[2, 0]], k[[2, 0]], v[[2, 0]],
                                      mask), full[[2, 0]])

