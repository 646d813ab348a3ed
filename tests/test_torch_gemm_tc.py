"""The tensor-core variants of quant_matmul (s8) and block_sparse_matmul
(bf16) on the CPU: their arithmetic, which inputs take them, their tiles,
stages and shared memory, quant_matmul's split-K plan and workspace, and
the autotuner's candidates.

No CUDA kernel runs here.  ``qmm_tc_emulate`` repeats the s8 kernel's
arithmetic (``csrc/gemm_tc.cuh``, ``csrc/quant_matmul.cu``) in numpy: the
operands swapped at M <= 64, tiles and k-blocks padded with zeros as TMA
fills them, int32 sums per split that wrap, the splits combined in split
order (wrapping), then ``((float)acc * xs) * ws`` in fp32.  It must be
bit-equal to the JAX package's Pallas ``quant_matmul`` in interpret mode
(on operands whose scales both packages round alike) and to the port's
plain version where the sums wrap.  ``bsmm_tc_emulate`` repeats the bf16
kernel's: fp32 sums per M tile and column block over the live k-blocks in
kindex order, one rounding to bf16; it is held against the Pallas
``block_sparse_matmul`` in interpret mode within the card's check
(``chip_smoke.py``'s ``bf16_tol``: 2**-7 of the largest reference output,
plus 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_sparse_matmul import \
    block_sparse_matmul as jax_bsmm
from repro.kernels.quant_matmul import quant_matmul as jax_qmm
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import block_sparse_matmul as bsmm
from repro_torch.kernels import gemm_tc
from repro_torch.kernels import quant_matmul as qmm

BUDGET = 232_448
QWEN = [(m, k, n) for m in (8, 128, 4096)
        for k, n in ((3584, 18944), (18944, 3584), (3584, 4608),
                     (152064, 3584), (3584, 152064))]


def bf16_tol(ref: np.ndarray) -> float:
    return 2.0 ** -7 * float(np.abs(ref).max()) + 1e-6


def _wrap32(a: np.ndarray) -> np.ndarray:
    """Exact integers (int64) reduced modulo 2**32 into int32's range."""
    return a.astype(np.int64).astype(np.uint32).view(np.int32)


def _pad(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols), a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def qmm_tc_emulate(xq, xs, wq, ws, splits=None) -> np.ndarray:
    """xq (M, K) int8, xs (M, 1), wq (N, K) int8, ws (1, N) fp32, as
    numpy; (M, N) fp32 as the tc kernel computes it."""
    m, k = xq.shape
    n = wq.shape[0]
    plan = gemm_tc.qmm_plan(m, n, k)
    splits = plan["splits"] if splits is None else splits
    a, b = (wq, xq) if plan["swap"] else (xq, wq)
    ba, bb = plan["block_a"], plan["block_b"]
    kp = -(-k // gemm_tc.BLOCK_K) * gemm_tc.BLOCK_K
    a = _pad(a, -(-a.shape[0] // ba) * ba, kp).astype(np.int64)
    b = _pad(b, -(-b.shape[0] // bb) * bb, kp).astype(np.int64)
    acc = np.zeros((m, n), np.int32)
    for k0, k1 in gemm_tc.split_ranges(k, splits):
        part = np.zeros((a.shape[0], b.shape[0]), np.int32)
        for i0 in range(0, a.shape[0], ba):          # CTAs of the split
            for j0 in range(0, b.shape[0], bb):
                tile = np.zeros((ba, bb), np.int32)
                for kb in range(k0, k1, gemm_tc.BLOCK_K):   # one stage
                    blk = slice(kb, kb + gemm_tc.BLOCK_K)
                    tile = _wrap32(tile + a[i0:i0 + ba, blk]
                                   @ b[j0:j0 + bb, blk].T)
                part[i0:i0 + ba, j0:j0 + bb] = tile
        c = part.T if plan["swap"] else part
        acc = _wrap32(acc.astype(np.int64) + c[:m, :n])   # split order
    return (acc.astype(np.float32) * xs.astype(np.float32)) \
        * ws.astype(np.float32)


def _np_ops(x: np.ndarray, w: np.ndarray):
    return [t.numpy() for t in qmm.quantize_operands(torch.from_numpy(x),
                                                     torch.from_numpy(w))]


def _scale_exact(rng, m, k, n):
    """Operands whose per-row and per-column absmax is 127 * 2**-7: the
    scales are 2**-7 under the port's ``/ 127`` and XLA's ``* fl(1/127)``
    alike (test_torch_quant.py), so both packages quantize them alike."""
    top = np.float32(127 * 2.0 ** -7)
    x = np.clip(rng.standard_normal((m, k)), -0.9, 0.9).astype(np.float32)
    x[np.arange(m), rng.integers(0, k, m)] = top
    w = np.clip(rng.standard_normal((k, n)), -0.9, 0.9).astype(np.float32)
    w[rng.integers(0, k, n), np.arange(n)] = -top
    return x, w


# ------------------------------------------------------------ quant_matmul
@pytest.mark.parametrize("k", [16, 17, 40, 56, 72, 80, 96, 100, 3584, 18944,
                               152064])
def test_qmm_variant_rule(k):
    assert gemm_tc.qmm_variant(k) == ("tc" if k % 16 == 0 else "mma")


@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (3, 80, 40), (8, 3584, 18944),
                                   (64, 1024, 200), (65, 272, 136),
                                   (4096, 3584, 18944), (4096, 18944, 3584),
                                   (128, 152064, 3584), (128, 3584, 152064)])
def test_qmm_tiles_stages_and_shared_memory(m, k, n):
    plan = gemm_tc.qmm_plan(m, n, k)
    assert plan["block_a"] == 128
    assert plan["swap"] == (m <= 64)
    if plan["swap"]:      # M on wgmma's N side: the smallest s8 N covering
        assert plan["block_b"] == min(t for t in gemm_tc.SWAP_N if t >= m)
    else:
        assert plan["block_b"] == 256
    stage = (plan["block_a"] + plan["block_b"]) * gemm_tc.BLOCK_K
    assert 2 <= plan["stages"] <= gemm_tc.MAX_STAGES
    assert plan["smem_bytes"] == plan["stages"] * stage + 256 + 1024
    assert plan["smem_bytes"] <= BUDGET
    assert qmm.smem_bytes(m, n, k) == plan["smem_bytes"]
    assert qmm.smem_bytes(m, n, k + 8) == qmm.MMA_SMEM_BYTES


def test_qmm_plans_at_the_main_path_shapes():
    """Decode swaps the operands; the down projection (28 tiles) and
    TUNE's embed product (14 tiles) split K, gate/up at M = 8 (148 tiles,
    a wave) does not."""
    got = {s: gemm_tc.qmm_plan(s[0], s[2], s[1]) for s in (
        (8, 3584, 18944), (8, 18944, 3584), (4096, 3584, 18944),
        (4096, 18944, 3584), (128, 152064, 3584), (128, 3584, 152064))}
    assert [(p["swap"], p["block_b"], p["splits"]) for p in got.values()] \
        == [(True, 8, 1), (True, 8, 5), (False, 256, 1), (False, 256, 1),
            (False, 256, 19), (False, 256, 1)]


@pytest.mark.parametrize("m,k,n", QWEN + [(8, 1024, 40), (3, 96, 17),
                                          (100, 2048, 120), (17, 2064, 1000),
                                          (70, 4112, 300), (2, 140000, 3)])
def test_qmm_split_plan_covers_k_with_no_empty_split(m, k, n):
    plan = gemm_tc.qmm_plan(m, n, k)
    ranges = gemm_tc.split_ranges(k, plan["splits"])
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(k1 > k0 for k0, k1 in ranges)                   # none empty
    assert all(k0 % gemm_tc.BLOCK_K == 0 for k0, _ in ranges)  # k32 steps
    assert all((k1 - k0) % 32 == 0 for k0, k1 in ranges[:-1])
    kb = -(-k // gemm_tc.BLOCK_K)
    assert plan["k_per_split"] * (plan["splits"] - 1) < kb \
        <= plan["k_per_split"] * plan["splits"]
    a_rows, b_rows = (n, m) if plan["swap"] else (m, n)
    tiles = -(-a_rows // plan["block_a"]) * -(-b_rows // plan["block_b"])
    # about two waves of 132 SMs (one when swapped) where K allows (short
    # of it only by the rounding that leaves no split empty), at least 4
    # k-blocks a split, one split where the tiles alone fill the waves
    per = plan["k_per_split"]
    target = gemm_tc.SMS * (gemm_tc.SWAP_WAVES if plan["swap"]
                            else gemm_tc.WAVES)
    if tiles >= target:
        assert plan["splits"] == 1
    elif kb // gemm_tc.MIN_SPLIT_KB >= -(-target // tiles):
        assert tiles * plan["splits"] > target * (1 - 1 / per)
        assert tiles * plan["splits"] >= 0.8 * target
    if plan["splits"] > 1:
        assert plan["k_per_split"] >= gemm_tc.MIN_SPLIT_KB
    shape = gemm_tc.qmm_workspace_shape(m, n, plan["splits"])
    assert shape == ((plan["splits"], m, n) if plan["splits"] > 1 else None)


@pytest.mark.parametrize("m,k,n", [(8, 1024, 40), (3, 96, 17),
                                   (100, 2048, 120), (64, 1536, 64),
                                   (128, 512, 256), (16, 512, 128)])
def test_qmm_tc_arithmetic_equals_pallas_kernel(m, k, n):
    """Swapped and not, split and not, ragged M, N and K: bit for bit
    against the Pallas kernel in interpret mode."""
    x, w = _scale_exact(np.random.default_rng(m * k + n), m, k, n)
    got = qmm_tc_emulate(*_np_ops(x, w))
    want = np.asarray(jax_qmm(jnp.asarray(x), jnp.asarray(w),
                              interpret=True))
    np.testing.assert_array_equal(got, want)


def test_qmm_tc_sums_wrap_as_the_plain_version():
    """Every product at +-127 over K = 140,000 (past 133,143): the int32
    sums wrap, split over 122 ranges as the plan has it or forced to 1 or
    7, bit for bit ``quant_matmul_plain``."""
    m, k, n = 2, 140_000, 3
    x = np.ones((m, k), np.float32)
    w = np.where(np.arange(k)[:, None] % 5 == 0, -1.0, 1.0).astype(
        np.float32) * np.array([1.0, -1.0, 1.0], np.float32)
    w[:, 2] = 1.0
    ops = _np_ops(x, w)
    want = qmm.quant_matmul_plain(torch.from_numpy(x),
                                  torch.from_numpy(w)).numpy()
    assert gemm_tc.qmm_plan(m, n, k)["splits"] == 122
    assert (want[:, 2] < 0).all()            # 127 * 127 * 140,000 wrapped
    for splits in (None, 1, 7):
        np.testing.assert_array_equal(qmm_tc_emulate(*ops, splits), want)


@pytest.mark.parametrize("m,k,n", [(8, 3072, 40), (100, 2048, 120)])
def test_qmm_any_split_count_gives_the_same_bits(m, k, n):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    ops = _np_ops(x, w)
    base = qmm_tc_emulate(*ops)
    for splits in (1, 2, 3, 5, 24):          # 24: trailing splits empty
        np.testing.assert_array_equal(qmm_tc_emulate(*ops, splits), base)
    np.testing.assert_array_equal(
        base, qmm.int8_matmul_plain(*map(torch.from_numpy, ops)).numpy())


# ----------------------------------------------------- block_sparse_matmul
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tc"),
                                        ("bfloat16", "tc"),
                                        (torch.float32, "ffma"),
                                        ("float32", "ffma")])
def test_bsmm_variant_rule(dtype, want):
    assert gemm_tc.bsmm_variant(dtype) == want


@pytest.mark.parametrize("bm,tile", [(8, 64), (32, 64), (64, 64), (95, 64),
                                     (96, 128), (128, 128), (191, 128),
                                     (192, 256), (256, 256)])
def test_bsmm_tile_and_shared_memory(bm, tile):
    assert gemm_tc.bsmm_tile(bm) == tile
    stage = 2 * (tile + 128) * 128           # x tile and w block, bf16
    stages = min(4, (BUDGET - 1280) // stage)
    assert stages >= 2
    assert bsmm.smem_bytes(bm, "bfloat16") == gemm_tc.bsmm_smem_bytes(bm) \
        == stages * stage + 1280 <= BUDGET
    # fp32 keeps the FFMA kernel's model
    assert bsmm.smem_bytes(bm, torch.float32) == \
        4 * (bsmm.tile_rows(bm) * (128 + 4) + 128 * 128)


def bsmm_tc_emulate(x, w, kindex, block_m) -> np.ndarray:
    """x (M, K), w (K, N) bf16-valued fp32 numpy; kindex (N / 128,
    max_live).  (M, N) fp32 holding the bf16 output of the tc kernel."""
    m, k = x.shape
    n = w.shape[1]
    t = gemm_tc.bsmm_tile(min(block_m, m))
    xp = _pad(x, -(-m // t) * t, k)          # TMA's zero rows past M
    out = np.zeros((xp.shape[0], n), np.float32)
    for i0 in range(0, xp.shape[0], t):
        for j, row in enumerate(kindex):
            acc = np.zeros((t, 128), np.float32)
            for kb in row:                   # index order, -1 skipped
                if 0 <= kb < k // 128:
                    acc += xp[i0:i0 + t, kb * 128:(kb + 1) * 128] \
                        @ w[kb * 128:(kb + 1) * 128, j * 128:(j + 1) * 128]
            out[i0:i0 + t, j * 128:(j + 1) * 128] = acc
    rounded = torch.from_numpy(out[:m]).to(torch.bfloat16).float()
    return rounded.numpy()


KINDEX = {"dead_and_dense": [[-1, -1, -1], [0, 1, 2]],
          "excluded_nonzero": [[0, 2], [1, -1]],
          "out_of_order": [[2, 0, -1], [1, 2, 0]]}


@pytest.mark.parametrize("case", sorted(KINDEX))
def test_bsmm_tc_arithmetic_within_card_tolerance(case):
    """Each tc tile (block_m 32 to 256 map to 64, 64, 128, 256) against
    the Pallas kernel in interpret mode; a dead column is exactly 0 and a
    block that kindex leaves out is never read."""
    rng = np.random.default_rng(len(case))
    x = torch.from_numpy(rng.standard_normal((256, 384)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((384, 256)).astype(
        np.float32)).to(torch.bfloat16)
    kidx = np.asarray(KINDEX[case], np.int32)
    want = np.asarray(jax_bsmm(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(kidx), interpret=True).astype(jnp.float32))
    xf, wf = x.float().numpy(), w.float().numpy()
    # w with every block that kindex leaves out zeroed
    live = np.zeros((3, 2), bool)
    for j, row in enumerate(kidx):
        live[row[row >= 0], j] = True
    w_live = wf * np.repeat(np.repeat(live, 128, 0), 128, 1)
    for bm in (32, 64, 128, 256):
        got = bsmm_tc_emulate(xf, wf, kidx, bm)
        assert np.abs(got - want).max() <= bf16_tol(want)
        np.testing.assert_array_equal(got, bsmm_tc_emulate(xf, w_live, kidx,
                                                           bm))
        dead = [j for j, row in enumerate(kidx) if (row < 0).all()]
        for j in dead:
            assert not got[:, j * 128:(j + 1) * 128].any()
    plain = bsmm.block_sparse_matmul_plain(x, w, torch.from_numpy(kidx))
    assert np.abs(plain.float().numpy() - want).max() <= bf16_tol(want)


# ---------------------------------------------------------------- wrappers
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = (qmm.launches, qmm.launches_tc, bsmm.launches,
              bsmm.launches_tc)
    x = torch.randn((8, 256), generator=torch.Generator().manual_seed(0))
    w = torch.randn((256, 128), generator=torch.Generator().manual_seed(1))
    assert torch.equal(qmm.quant_matmul(x, w), qmm.quant_matmul_plain(x, w))
    kidx = torch.tensor([[0, 1]], dtype=torch.int32)
    xb = x.to(torch.bfloat16)
    assert torch.equal(bsmm.block_sparse_matmul(xb, w.to(torch.bfloat16),
                                                kidx),
                       bsmm.block_sparse_matmul_plain(
                           xb, w.to(torch.bfloat16), kidx))
    assert (qmm.launches, qmm.launches_tc, bsmm.launches,
            bsmm.launches_tc) == before


# --------------------------------------------------------------- autotuner
@pytest.mark.parametrize("m,want", [(128, [128, 64]), (64, [128]),
                                    (512, [128, 64, 256])])
def test_bf16_block_sparse_candidates_are_the_tc_tiles(m, want):
    prob = tat.block_sparse_matmul_problem((m, 3584), (3584, 4096),
                                           "bfloat16", max_live=14)
    cands = tat.enumerate_candidates("block_sparse_matmul", prob)
    assert [c["block_m"] for c, _ in cands] == want
    for cfg, smem in cands:
        assert smem == gemm_tc.bsmm_smem_bytes(min(cfg["block_m"], m))


def test_fp32_block_sparse_candidates_are_unchanged():
    prob = tat.block_sparse_matmul_problem((128, 256), (256, 256), "float32",
                                           max_live=2)
    cands = tat.enumerate_candidates("block_sparse_matmul", prob)
    assert [c for c, _ in cands] == [{"block_m": 128}, {"block_m": 64},
                                     {"block_m": 32}]
    assert [s for _, s in cands] == [bsmm.smem_bytes(b, "float32")
                                     for b in (128, 64, 32)]


@pytest.mark.parametrize("m,k,n", [(128, 152064, 3584), (128, 3584, 152064),
                                   (8, 56, 40)])
def test_quant_matmul_candidate_carries_its_variants_shared_memory(m, k, n):
    prob = tat.quant_matmul_problem((m, k), (k, n), "bfloat16")
    assert tat.enumerate_candidates("quant_matmul", prob) == [
        ({}, qmm.smem_bytes(m, n, k))]
