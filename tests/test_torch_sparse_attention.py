"""The port's block_sparse_matmul and flash_attention on the CPU against
the JAX package: each wrapper's plain version (what a CPU tensor runs)
against the Pallas kernel in interpret mode and against the jnp oracle in
``repro.kernels.ref``; ``compact_block_index``, ``block_map`` and
``masked_matmul`` against theirs.

Inputs come from numpy seeds and go to both packages as numpy arrays.
Tolerances: fp32 outputs within 1e-5 of the largest output magnitude
(block-sparse: both sum 128-wide fp32 dots per block, in other orders) or
2e-5 absolute (attention: the online softmax against a full softmax, as
the port's other attention tests); bf16 outputs within one bf16 ulp of
the largest output magnitude (2**-7 of it), since both round one fp32
result to bf16 and may land on either side of a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_sparse_matmul import block_sparse_matmul as jax_bsmm
from repro.kernels.block_sparse_matmul import \
    compact_block_index as jax_compact
from repro.kernels.flash_attention import flash_attention as jax_fa
from repro.sparsity import masks as jmasks
from repro_torch.kernels import block_sparse_matmul as bsmm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.sparsity import masks as tmasks

FP32_REL = 1e-5
FA_FP32_TOL = 2e-5


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (fp32 -> bf16 rounds to nearest even on both sides)."""
    j = jnp.asarray(a, jnp.float32)
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype: str, fp32_tol: float | None = None) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":
        tol = 2.0 ** -7 * scale + 1e-6
    else:
        tol = fp32_tol if fp32_tol is not None else FP32_REL * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# ------------------------------------------------------ block-sparse matmul
# (N / 128, max_live) index lists for a (384, 256) weight (3 x 2 blocks):
# column 0 all dead and column 1 dense; then column 0 live on blocks 0 and
# 2 only — block 1 holds nonzero weights that must never be read — and
# column 1 on block 1, -1 padded.
KINDEX = {"dead_and_dense": [[-1, -1, -1], [0, 1, 2]],
          "excluded_nonzero": [[0, 2], [1, -1]]}


def _masked_dense(w: np.ndarray, kidx: np.ndarray) -> np.ndarray:
    out = np.zeros_like(w)
    for j, row in enumerate(kidx):
        for kb in row[row >= 0]:
            out[kb * 128:(kb + 1) * 128, j * 128:(j + 1) * 128] = \
                w[kb * 128:(kb + 1) * 128, j * 128:(j + 1) * 128]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_m", [32, 64, 128])
@pytest.mark.parametrize("case", sorted(KINDEX))
def test_block_sparse_matmul_plain_matches_pallas_and_ref(case, block_m,
                                                          dtype):
    rng = np.random.default_rng(block_m)
    x = rng.standard_normal((256, 384)).astype(np.float32)
    w = rng.standard_normal((384, 256)).astype(np.float32)   # no zero block
    kidx = np.asarray(KINDEX[case], np.int32)
    xj, xt = _both(x, dtype)
    wj, wt = _both(w, dtype)
    got = bsmm.block_sparse_matmul(xt, wt, torch.from_numpy(kidx),
                                   block_m=block_m)
    assert got.dtype == xt.dtype and got.shape == (256, 256)
    want = jax_bsmm(xj, wj, jnp.asarray(kidx), block_m=block_m,
                    interpret=True)
    _close(got, want, dtype)
    wm_j, wm_t = _both(_np(wj) * (_masked_dense(w, kidx) != 0), dtype)
    _close(got, jref.block_sparse_matmul_ref(xj, wm_j).astype(xj.dtype),
           dtype)
    _close(ref.block_sparse_matmul_ref(xt, wm_t), jref.block_sparse_matmul_ref(
        xj, wm_j), "float32")
    if case == "dead_and_dense":
        assert not got[:, :128].float().any()


def test_compact_block_index_block_map_and_masked_matmul_match_jax():
    rng = np.random.default_rng(7)
    occupancy = (rng.random((5, 9)) < 0.4).astype(np.int32)
    occupancy[:, 3] = 0                                   # a dead column
    np.testing.assert_array_equal(bsmm.compact_block_index(occupancy),
                                  jax_compact(occupancy))
    w = rng.standard_normal((384, 256)).astype(np.float32)
    x = rng.standard_normal((128, 384)).astype(np.float32)
    jmask = jmasks.block_mask(jnp.asarray(w), 0.5)
    tmask = tmasks.block_mask(torch.from_numpy(w), 0.5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    bmap = tmasks.block_map(tmask)
    assert bmap.dtype == np.int32
    np.testing.assert_array_equal(bmap, jmasks.block_map(jmask))
    got = ops.masked_matmul(torch.from_numpy(x), torch.from_numpy(w), tmask)
    want = jops.masked_matmul(jnp.asarray(x), jnp.asarray(w), jmask,
                              interpret=True)
    _close(got, want, "float32")


def test_new_wrappers_take_cuda_path_for_non_cpu_tensors():
    """The CPU path is chosen by the tensor's device alone: a non-CPU
    tensor (here ``meta``) goes to the kernel path, whose checks refuse
    it, never to the plain version."""
    x = torch.empty((128, 256), device="meta")
    kidx = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        bsmm.block_sparse_matmul(x, torch.empty((256, 128)), kidx)
    q = torch.empty((1, 64, 4, 64), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.empty((1, 64, 2, 64)),
                           torch.empty((1, 64, 2, 64)))


def test_shared_memory_model_tiles():
    """The launch's shared memory, as the autotuner filters it: the JAX
    default (128, 128) fits in fp32 at D = 128, (256, 128) does not."""
    assert fa.effective_tiles(None, None, 512, 512) == (128, 128)
    assert fa.effective_tiles(256, 256, 100, 100) == (128, 128)
    assert fa.effective_tiles(64, 32, 100, 100) == (64, 32)
    assert fa.smem_bytes(128, 128, 128, "float32") <= fa.SMEM_LIMIT
    assert fa.smem_bytes(256, 128, 128, torch.float32) > fa.SMEM_LIMIT
    for bm in (32, 64, 128, 256):
        for dt in ("float32", "bfloat16"):
            assert bsmm.smem_bytes(bm, dt) <= bsmm.SMEM_LIMIT
    assert bsmm.tile_rows(8) == 32 and bsmm.tile_rows(96) == 128


# --------------------------------------------------------- flash attention
def _qkv(g: int, s: int, dtype: str, seed: int, d: int = 16, b: int = 2):
    rng = np.random.default_rng(seed)
    kvh = 4 // g
    q = rng.standard_normal((b, s, 4, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return _both(q, dtype), _both(k, dtype), _both(v, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 100])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_attention_plain_matches_ref(g, s, causal, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(g, s, dtype, seed=s + g)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    _close(got, want, dtype, FA_FP32_TOL)
    _close(ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window),
           want, dtype, FA_FP32_TOL)


@pytest.mark.parametrize("tiles", [(32, 32), (64, 32)])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("s,causal,window", [(64, True, 0),
                                             (100, False, 16)])
def test_flash_attention_plain_matches_pallas_fp32(s, causal, window, g,
                                                   tiles):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(g, s, "float32", seed=3 * s + g)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window,
                             block_q=tiles[0], block_kv=tiles[1])
    want = jax_fa(qj, kj, vj, causal=causal, window=window, interpret=True,
                  block_q=tiles[0], block_kv=tiles[1])
    _close(got, want, "float32", FA_FP32_TOL)


@pytest.mark.parametrize("tiles", [(32, 32), (64, 32)])
def test_flash_attention_plain_matches_pallas_bf16(tiles):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 100, "bfloat16", seed=11)
    got = fa.flash_attention(qt, kt, vt, causal=True, window=16,
                             block_q=tiles[0], block_kv=tiles[1])
    want = jax_fa(qj, kj, vj, causal=True, window=16, interpret=True,
                  block_q=tiles[0], block_kv=tiles[1])
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")
