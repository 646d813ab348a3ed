"""The port's paged-attention kernel wrappers on the CPU (their plain
PyTorch versions) against the JAX package's Pallas kernels run in
interpret mode and against an independent gather-and-softmax oracle.

Inputs come from numpy seeds and go to both packages as numpy arrays.
Tolerance: fp32 throughout, max abs error <= 2e-5 (as tests/test_paged.py
holds the Pallas kernels to their oracles).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode_paged import flash_decode_paged as jax_decode
from repro.kernels.flash_prefill_ragged import \
    flash_prefill_ragged as jax_prefill
from repro.models import layers as JL
from repro_torch.kernels import flash_decode_paged as fdp
from repro_torch.kernels import flash_prefill_ragged as fpr
from repro_torch.models import layers as TL

TOL = 2e-5


def _pages(rng, slots, blocks, ps, kvh, d):
    """Random pools and a scrambled block table (page 0 stays scratch)."""
    n_pages = slots * blocks + 1
    kp = rng.standard_normal((n_pages, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, kvh, d)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1) + 1).astype(np.int32)
    return kp, vp, bt[:slots * blocks].reshape(slots, blocks)


def _gather_oracle(q, kp, vp, bt, mask):
    """Masked softmax over pages gathered through the block table, in
    numpy float64 — independent of both packages."""
    r, s, h, d = q.shape
    _, ps, kvh, _ = kp.shape
    n = bt.shape[1] * ps
    g = h // kvh
    kf = np.repeat(kp[bt].reshape(r, n, kvh, d), g, axis=2).astype(np.float64)
    vf = np.repeat(vp[bt].reshape(r, n, kvh, d), g, axis=2).astype(np.float64)
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kf) / math.sqrt(d)
    sc = np.where(mask[:, None], sc, -np.inf)
    m = np.max(sc, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    w = np.exp(sc - m)
    den = w.sum(-1, keepdims=True)
    w = np.where(den > 0, w / np.where(den > 0, den, 1.0), 0.0)
    return np.einsum("bhqk,bkhd->bqhd", w, vf)


def _decode_problem(seed, slots, h, kvh, d, ps, blocks, seq_lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((slots, 1, h, d)).astype(np.float32)
    kp, vp, bt = _pages(rng, slots, blocks, ps, kvh, d)
    sl = np.asarray(seq_lens, np.int32)
    mask = np.asarray(JL.paged_decode_attention_mask(
        JL.paged_kv_positions(jnp.asarray(sl), blocks * ps),
        jnp.asarray(sl)))
    return q, kp, vp, bt, sl, mask


def _torch_decode(q, kp, vp, bt, sl):
    """The port's path: the mask from the port's own helpers, then the
    wrapper (CPU tensors -> plain version)."""
    t = torch.from_numpy
    sl_t = t(sl)
    mask = TL.paged_decode_attention_mask(
        TL.paged_kv_positions(sl_t, bt.shape[1] * kp.shape[1]), sl_t)
    before = fdp.launches
    out = fdp.flash_decode_paged(t(q), t(kp), t(vp), t(bt), mask)
    assert fdp.launches == before        # CPU tensors never launch
    return out.numpy(), mask.numpy()


class TestDecode:
    @pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (7, 1)])
    @pytest.mark.parametrize("page_size", [4, 8, 16])
    def test_gqa_and_page_size_grid(self, h, kvh, page_size):
        slots, blocks, d = 3, 3, 8
        cap = blocks * page_size
        q, kp, vp, bt, sl, mask = _decode_problem(
            page_size * 10 + h, slots, h, kvh, d, page_size, blocks,
            [0, cap // 2, cap - 1])
        out, t_mask = _torch_decode(q, kp, vp, bt, sl)
        assert np.array_equal(t_mask, mask)
        ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(bt),
                                    jnp.asarray(mask), interpret=True))
        assert np.max(np.abs(out - ref)) <= TOL
        oracle = _gather_oracle(q, kp, vp, bt, mask[:, None, :])
        assert np.max(np.abs(out - oracle)) <= TOL

    @pytest.mark.parametrize("seq_lens", [[0, 1, 2, 3], [5, 17, 9, 31]])
    def test_ragged_lengths_scrambled_vs_identity(self, seq_lens):
        """Ragged rows through a scrambled table match the Pallas kernel
        and the oracle; the same logical K/V moved to an identity layout
        gives the same output (physical placement is invisible)."""
        slots, blocks, ps, h, kvh, d = 4, 4, 8, 4, 2, 8
        q, kp, vp, bt, sl, mask = _decode_problem(
            7, slots, h, kvh, d, ps, blocks, seq_lens)
        out, _ = _torch_decode(q, kp, vp, bt, sl)
        ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(bt),
                                    jnp.asarray(mask), interpret=True))
        assert np.max(np.abs(out - ref)) <= TOL
        oracle = _gather_oracle(q, kp, vp, bt, mask[:, None, :])
        assert np.max(np.abs(out - oracle)) <= TOL
        ident = 1 + np.arange(slots * blocks, dtype=np.int32).reshape(
            slots, blocks)
        kp_i, vp_i = kp.copy(), vp.copy()
        kp_i[ident.reshape(-1)] = kp[bt.reshape(-1)]
        vp_i[ident.reshape(-1)] = vp[bt.reshape(-1)]
        out_i, _ = _torch_decode(q, kp_i, vp_i, ident, sl)
        assert np.max(np.abs(out - out_i)) < 1e-6


def _prefill_problem(seed, slots, s, h, kvh, d, ps, blocks, offs, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((slots, s, h, d)).astype(np.float32)
    kp, vp, bt = _pages(rng, slots, blocks, ps, kvh, d)
    return (q, kp, vp, bt, np.asarray(offs, np.int32),
            np.asarray(lens, np.int32))


def _check_prefill(q, kp, vp, bt, off, ln, block_q=None):
    t = torch.from_numpy
    before = fpr.launches
    out = fpr.flash_prefill_ragged(t(q), t(kp), t(vp), t(bt), t(off),
                                   t(ln)).numpy()
    assert fpr.launches == before
    ref = np.asarray(jax_prefill(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(off), jnp.asarray(ln),
                                 interpret=True, block_q=block_q))
    assert np.max(np.abs(out - ref)) <= TOL
    s, n = q.shape[1], bt.shape[1] * kp.shape[1]
    mask = TL.ragged_prefill_attention_mask(t(off), t(ln), s, n).numpy()
    assert np.array_equal(mask, np.asarray(JL.ragged_prefill_attention_mask(
        jnp.asarray(off), jnp.asarray(ln), s, n)))
    oracle = _gather_oracle(q, kp, vp, bt, mask)
    assert np.max(np.abs(out - oracle)) <= TOL
    # rows at or past lens are exactly zero, idle slots included
    dead = np.arange(s)[None] >= ln[:, None]
    assert not np.any(out[dead])
    return out


class TestPrefill:
    @pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (7, 1)])
    @pytest.mark.parametrize("page_size", [4, 8, 16])
    def test_gqa_and_page_size_grid(self, h, kvh, page_size):
        slots, s, blocks, d = 3, 8, 4, 8
        offs = [0, page_size, 2 * page_size]     # suffix after a prefix
        lens = [8, 5, 0]                         # full / ragged / idle
        _check_prefill(*_prefill_problem(page_size + h, slots, s, h, kvh, d,
                                         page_size, blocks, offs, lens),
                       block_q=4)

    @pytest.mark.parametrize("block_q", [2, 32])
    def test_ragged_offsets_against_tiled_kernel(self, block_q):
        """S not a multiple of the Pallas tile; the plain version has no
        tile and matches every tiling."""
        slots, s, h, kvh, d, ps, blocks = 4, 7, 4, 2, 8, 8, 4
        _check_prefill(*_prefill_problem(3, slots, s, h, kvh, d, ps, blocks,
                                         [0, 3, 8, 24], [7, 4, 7, 1]),
                       block_q=block_q)

    def test_causal_frontier_single_source(self):
        slots, s, h, kvh, d, ps, blocks = 2, 4, 2, 1, 8, 4, 3
        offs, lens = [2, 5], [4, 3]
        _check_prefill(*_prefill_problem(5, slots, s, h, kvh, d, ps, blocks,
                                         offs, lens))
        mask = TL.ragged_prefill_attention_mask(
            torch.tensor(offs), torch.tensor(lens), s, blocks * ps)
        assert int(mask[0, 0].sum()) == offs[0] + 1
        assert int(mask[1, 2].sum()) == offs[1] + 3
        assert not bool(mask[1, 3].any())        # past lens: dead row


def _meta_call(name):
    """One call of wrapper ``name`` whose first tensor lies off the CPU (a
    meta tensor) while the rest are CPU tensors of valid shapes."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qmm
    q = torch.empty((1, 1, 2, 8), device="meta")
    kp = torch.empty((2, 4, 1, 8), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32)
    mask = torch.ones((1, 4), dtype=torch.bool)
    return {
        "flash_decode_paged": lambda: fdp.flash_decode_paged(q, kp, kp, bt,
                                                             mask),
        "flash_prefill_ragged": lambda: fpr.flash_prefill_ragged(
            q, kp, kp, bt, bt[0], bt[0]),
        "flash_decode": lambda: fd.flash_decode(
            q, torch.empty((1, 4, 1, 8)), torch.empty((1, 4, 1, 8)),
            mask[0]),
        "quant_matmul": lambda: qmm.quant_matmul(
            torch.empty((4, 8), device="meta"), torch.ones((8, 3))),
    }[name]


@pytest.mark.parametrize("name", ["flash_decode_paged",
                                  "flash_prefill_ragged", "flash_decode",
                                  "quant_matmul"])
def test_cuda_tensor_without_kernel_build_raises_not_falls_back(name):
    """The CPU path is chosen by the tensor's device alone: a wrapper
    handed a non-CPU tensor goes to the kernel path (here: a meta tensor,
    which fails its checks) instead of the plain version."""
    with pytest.raises(ValueError):
        _meta_call(name)()


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("pos", [0, 3, 11, 20])
def test_contiguous_mask_helpers_match_jax(pos, window):
    """The contiguous-cache position/mask helpers (linear and
    sliding-window ring) equal the JAX package's."""
    cache_len = 8 if window else 24
    t_pos = TL.kv_positions_for_cache(torch.tensor(pos), cache_len, window)
    j_pos = JL.kv_positions_for_cache(jnp.asarray(pos), cache_len, window)
    assert np.array_equal(t_pos.numpy(), np.asarray(j_pos))
    assert np.array_equal(
        TL.decode_attention_mask(t_pos, pos, window).numpy(),
        np.asarray(JL.decode_attention_mask(j_pos, pos, window)))
