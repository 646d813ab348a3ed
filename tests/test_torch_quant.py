"""The port's INT8/FP8 precision levels on the CPU against the JAX package:
``quantize_int8`` / ``fake_quant_int8`` / ``cast_level``, the quant_matmul
wrapper's plain version against the Pallas kernel (interpret mode) and the
jnp oracle, and the policy-dispatched ``linear``.

Inputs come from numpy seeds and go to both packages as numpy arrays.
Tolerance: none — int8 products are summed exactly and dequantized in one
fixed order, so outputs are compared with ``assert_array_equal``.  The one
exception is the jitted Pallas path on general inputs: XLA rewrites the
scale ``absmax / 127`` into ``absmax * fl(1/127)``, one ulp off in some
scales, so that comparison uses inputs whose scales are powers of two,
where both forms are exact.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.quant_matmul import quant_matmul as jax_qmm
from repro.models.common import Ctx as JaxCtx
from repro.models.common import linear as jax_linear
from repro.quant import policy as JP
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.models.common import Ctx, linear
from repro_torch.quant import policy as TP


def _bf16(a: np.ndarray) -> torch.Tensor:
    """fp32 numpy -> torch bf16 with the same (round-to-nearest-even)
    values JAX's ``astype(bfloat16)`` gives."""
    bits = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _operands(seed, m, k, n, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, n))).astype(np.float32)
    if dtype == "bfloat16":
        return (x, w), (_bf16(x), _bf16(w)), (jnp.asarray(x).astype(
            jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16))
    return (x, w), (torch.from_numpy(x), torch.from_numpy(w)), (
        jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(3, 56, 40), (8, 56, 24), (3, 96, 17),
                                   (8, 96, 128), (16, 512, 64)])
def test_quant_matmul_plain_equals_oracle(m, k, n, dtype):
    """Ragged and tileable shapes, bit for bit against
    ``ref.quant_matmul_ref``; CPU tensors never launch."""
    _, (xt, wt), (xj, wj) = _operands(m * k + n, m, k, n, dtype)
    before = qmm.launches
    got = qmm.quant_matmul(xt, wt)
    assert qmm.launches == before
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.quant_matmul_ref(xj, wj)))


@pytest.mark.parametrize("m,k,n", [(8, 96, 40), (32, 512, 128)])
def test_quant_matmul_plain_equals_pallas_kernel(m, k, n):
    """Against the Pallas kernel in interpret mode, on operands whose
    per-row and per-column absmax is 127 * 2**-7: the scales are then
    2**-7 under both ``/ 127`` and XLA's ``* fl(1/127)``, so the quantized
    operands agree and the outputs must be equal bit for bit."""
    rng = np.random.default_rng(m + k + n)
    top = np.float32(127 * 2.0 ** -7)
    x = np.clip(rng.standard_normal((m, k)), -0.9, 0.9).astype(np.float32)
    x[np.arange(m), rng.integers(0, k, m)] = top
    w = np.clip(rng.standard_normal((k, n)), -0.9, 0.9).astype(np.float32)
    w[rng.integers(0, k, n), np.arange(n)] = -top
    got = qmm.quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(jax_qmm(jnp.asarray(x), jnp.asarray(w),
                              interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_operands_layout_and_int32_bound():
    """The kernel's operand layout — wq (N, K), k contiguous — and the
    overflow bound the wrapper states: 127 * 127 * K < 2**31."""
    x = torch.randn((5, 24), generator=torch.Generator().manual_seed(0))
    w = torch.randn((24, 7), generator=torch.Generator().manual_seed(1))
    xq, xs, wq, ws = qmm.quantize_operands(x, w)
    assert (xq.shape, xs.shape, wq.shape, ws.shape) == \
        ((5, 24), (5, 1), (7, 24), (1, 7))
    assert wq.is_contiguous() and wq.dtype == torch.int8
    assert torch.equal(qmm.int8_matmul_plain(xq, xs, wq, ws),
                       qmm.quant_matmul_plain(x, w))
    assert 127 * 127 * (qmm.K_LIMIT - 1) < 2**31


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_equals_jax(axis, dtype):
    """Values, scales and the ±127 ends, including an all-zero slice
    (scale 1e-8 / 127) and exact ties of round-half-to-even."""
    rng = np.random.default_rng(3 + axis)
    w = rng.standard_normal((33, 20)).astype(np.float32)
    w[:, 4] = 0.0
    w[5] = 0.0
    w[7, :] = np.linspace(-2.5, 2.5, 20, dtype=np.float32)
    wt = _bf16(w) if dtype == "bfloat16" else torch.from_numpy(w)
    wj = jnp.asarray(w).astype(dtype)
    qt, st = TP.quantize_int8(wt, axis)
    qj, sj = JP.quantize_int8(wj, axis)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert int(qt.abs().amax()) == 127
    live = np.abs(w).max(axis=axis) > 0
    ends = np.abs(qt.numpy()).max(axis=axis)
    assert (ends[live] == 127).all()


def test_fake_quant_and_cast_level_equal_jax():
    rng = np.random.default_rng(5)
    w = (3.0 * rng.standard_normal((16, 12))).astype(np.float32)
    w[0, 0] = 470.0                     # past fp8's largest finite value
    w[1, 1] = -463.0                    # rounds to -448
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    np.testing.assert_array_equal(TP.fake_quant_int8(wt).numpy(),
                                  np.asarray(JP.fake_quant_int8(wj)))
    for level in TP.LEVELS:
        np.testing.assert_array_equal(TP.cast_level(wt, level).numpy(),
                                      np.asarray(JP.cast_level(wj, level)))
        assert TP.weight_bytes((16, 12), level) == \
            JP.weight_bytes((16, 12), level)
    assert TP.LEVEL_BYTES == JP.LEVEL_BYTES
    fp8 = TP.cast_level(wt, TP.FP8)
    assert bool(torch.isnan(fp8[0, 0])) and float(fp8[1, 1]) == -448.0


def test_fake_quant_gradient_is_straight_through():
    w = torch.randn((6, 4), generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    TP.fake_quant_int8(w).sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))


def test_fp8_storage_matches_ml_dtypes_out_of_range():
    """float8_e4m3fn has no infinity: the reference's conversion turns
    magnitudes that round past 448 into NaN, where torch's own cast
    saturates; the port's storage follows the reference."""
    x = np.asarray([447.0, 448.0, 463.9, 464.0, 464.1, 480.0, 1e4, -500.0,
                    np.inf, -np.inf, 0.0, 1e-9], np.float32)
    want = x.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    got = TP.to_fp8_e4m3fn(torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_equals_jax(level, dtype, bias):
    """``linear`` at the INT8 and FP8 levels over a (B, S, K) activation:
    equal arrays in fp32; in bf16 the FP8 level's bf16 product may round
    one bf16 ulp apart (fp32 sums in another order), INT8 stays equal."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 96)).astype(np.float32)
    w = (0.2 * rng.standard_normal((96, 40))).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32) if bias else None
    if dtype == "bfloat16":
        xt, wt = _bf16(x), _bf16(w)
        bt = None if b is None else _bf16(b)
    else:
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        bt = None if b is None else torch.from_numpy(b)
    conv = (lambda a: jnp.asarray(a).astype(dtype))
    want = np.asarray(jax_linear(
        JaxCtx(policy=JP.PrecisionPolicy(default=level)), "mlp/w_up",
        conv(x), conv(w), None if b is None else conv(b)
    ).astype(jnp.float32))
    got = linear(Ctx(policy=TP.PrecisionPolicy(default=level)), "mlp/w_up",
                 xt, wt, bt)
    assert got.dtype == xt.dtype and got.shape == (2, 4, 40)
    if level == "fp8" and dtype == "bfloat16":
        ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
        assert (np.abs(_np(got) - want) <= ulp).all()
    else:
        np.testing.assert_array_equal(_np(got), want)


def test_quant_matmul_refuses_non_cpu_tensors_it_cannot_launch():
    """A tensor off the CPU goes to the kernel path, whose checks refuse
    what the kernel does not take — never to the plain version."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        qmm.quant_matmul(x, torch.empty((8, 3), device="meta"))
    with pytest.raises(ValueError):
        qmm.quant_matmul(x, torch.empty((8, 3)))
