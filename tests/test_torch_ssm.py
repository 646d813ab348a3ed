"""The port's SSM (xLSTM) and hybrid (zamba2) families against the JAX
package on the CPU: each mixer (``_segsum``, ``_causal_conv``, Mamba2's
chunked SSD, mLSTM, sLSTM) and its prefill → decode handoff, the whole
model's logits, loss and decode caches, ``generate``'s greedy tokens, the
parameter tree the design flow reads and the families' refusals — on
``zamba2-smoke`` (4 Mamba2 layers, the shared block every 2, fp32
weights) and ``xlstm-smoke`` (one mLSTM/sLSTM pair, fp32 weights).

Inputs come from numpy seeds; parameters are the JAX package's init,
moved with ``params_from_jax``.  Tolerances, all with fp32 activations
(fp32 arithmetic in other orders: staged products where the reference
has five-operand einsums, ``F.softplus`` returning x above 20 where JAX
adds ``log1p(exp(-x))`` < 2e-9, ``F.logsigmoid``):
- ``_segsum`` within 1e-6 relative (XLA's cumsum adds in another
  order), ``_causal_conv`` within 1e-6; the conv's decode steps equal
  its prefill bit for bit;
- mixer outputs and recurrent states within 1e-5, but the sLSTM
  normaliser ``n`` (a sum that grows with the steps) and
  ``_mlstm_chunked`` on unit-variance inputs (its ``b_t - b_s`` decay
  differences and the division by its normaliser scale the cumsum's
  rounding) within 1e-5 of their magnitude;
- the chunked mLSTM within 1e-4 of the per-step recurrence (the JAX
  package's own bound, ``tests/test_ssm.py``);
- logits within 1e-4, the loss within 1e-5;
- greedy tokens equal under the bf16 and int8-mlp policies, on prompts
  whose every step keeps a top-2 gap of at least 0.05 (asserted on the
  port's side), as ``test_torch_decode.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch.serve import generate as jax_generate
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build
from repro.models.common import Ctx as JaxCtx
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.serving import PagedCacheConfig as JaxPCfg
from repro.serving.paged_cache import init_paged_cache as jax_paged_cache
from repro.sparsity import masks as jmasks
from repro_torch.configs.registry import all_configs, get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch.serve import generate, serve_policy
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model
from repro_torch.models.common import Ctx
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving import PagedCacheConfig, init_paged_cache
from repro_torch.sparsity import masks as tmasks

ARCHS = ["zamba2_2p7b", "xlstm_125m"]
TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, JAX params, port model, port params) at smoke
    size with fp32 activations under the FP32 policy."""
    return _pair(request.param, "fp32")


@pytest.fixture(scope="module")
def zamba():
    return _pair("zamba2_2p7b", "fp32")


@pytest.fixture(scope="module")
def xlstm():
    return _pair("xlstm_125m", "fp32")


def _pair(arch, level, int8_mlp=False, embed_scale=1.0):
    jcfg = jax_config(arch, smoke=True).replace(act_dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    jpol, tpol = JaxPolicy(default=level), PrecisionPolicy(default=level)
    if int8_mlp:
        jpol = jpol.with_rule("*mlp*", "int8")
        tpol = serve_policy(True)
    jm = jax_build(jcfg, policy=jpol)
    tm = build_model(tcfg, tpol, device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params["embed"] = params["embed"] * np.float32(embed_scale)
    lm = tm.empty_params()
    lm.load_state_dict(params_from_jax(params))
    return arch, jm, jax.tree.map(jnp.asarray, params), tm, lm


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _block(params, i=0):
    return jax.tree.map(lambda t: t[i], params["blocks"])


def _states_close(tstate: dict, jstate: dict) -> None:
    """Leaf by leaf within TOL; the sLSTM normaliser ``n`` relatively."""
    assert sorted(tstate) == sorted(jstate)
    for name, t in tstate.items():
        want = np.asarray(jstate[name])
        assert tuple(t.shape) == want.shape, name
        tol = TOL * max(1.0, float(np.abs(want).max())) if name == "n" \
            else TOL
        assert _err(t.numpy(), want) <= tol, name


# ---------------------------------------------------------------- pieces
@pytest.mark.parametrize("l", [1, 8, 32])
def test_segsum_equals_jax(l):
    a = -np.abs(_x(1, (2, 3, 2, l)))
    want = np.asarray(JS._segsum(jnp.asarray(a)))
    got = TS._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    above = ~np.tril(np.ones((l, l), bool))
    assert (got[..., above] == TS.NEG_INF).all()


@pytest.mark.parametrize("c", [12, 128, 160])
def test_causal_conv_equals_jax_and_decode_is_bit_equal(c):
    """Both branches against the JAX function; then the decode branch,
    one token at a time from a zero window, against prefill's output:
    the taps are summed in one order in fp32, so the sums are equal bit
    for bit.  At the smoke models' conv widths (xlstm-smoke's 128,
    zamba2-smoke's 160 channels) so is the output.  At 12 channels the
    CPU's SiLU may differ by an ulp: torch runs its vectorised exp over
    whole SIMD blocks and a scalar exp over a tensor's tail, and the two
    branches' tails hold other elements (the card computes every element
    alike)."""
    b, s, k = 2, 9, 4
    x = _x(2, (b, s, c))
    w, bias = _x(3, (k, c), 0.1), _x(4, (c,), 0.1)
    want, _ = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias))
    xt, wt, bt = (torch.from_numpy(t) for t in (x, w, bias))
    got, none = TS._causal_conv(xt, wt, bt)
    assert none is None and _err(got, want) <= 1e-6
    state = torch.zeros((b, k - 1, c))
    jstate = jnp.zeros((b, k - 1, c))
    steps = []
    for t in range(s):
        y, state = TS._causal_conv(xt[:, t:t + 1], wt, bt, state)
        jy, jstate = JS._causal_conv(jnp.asarray(x[:, t:t + 1]),
                                     jnp.asarray(w), jnp.asarray(bias),
                                     jstate)
        assert _err(y, jy) <= 1e-6 and _err(state, jstate) <= 0
        steps.append(y)
    dec = torch.cat(steps, dim=1)
    if c % 32:
        assert _err(dec, got) <= 1e-6
    else:
        assert torch.equal(dec, got)


@pytest.mark.parametrize("s", [17, 32, 48])
def test_ssd_chunked_equals_jax(zamba, s):
    """Chunk 32: one partial chunk, one whole chunk, a padded second
    chunk; the output and the final state."""
    _, jm, _, tm, _ = zamba
    cfg = tm.cfg
    d_in, nh, n, _ = TS.mamba2_dims(cfg)
    xc, bc, cc = (_x(5 + i, (2, s, w)) for i, w in enumerate((d_in, n, n)))
    dt = np.log1p(np.exp(_x(8, (2, s, nh))))
    a = -np.arange(1, nh + 1, dtype=np.float32)
    dsk = _x(9, (nh,))
    jy, jh = JS._ssd_chunked(jm.cfg, *(jnp.asarray(t) for t in
                                       (xc, bc, cc, dt, a, dsk)))
    ty, th = TS._ssd_chunked(cfg, *(torch.from_numpy(t) for t in
                                    (xc, bc, cc, dt, a, dsk)))
    assert ty.shape == (2, s, d_in) and th.shape == (2, nh, cfg.ssm_head_dim,
                                                     n)
    assert _err(ty, jy) <= TOL and _err(th, jh) <= TOL


@pytest.mark.parametrize("s", [17, 32, 48])
def test_mamba2_apply_equals_jax(zamba, s):
    """Uncached, then as a prefill that leaves the decode handoff: the
    same output, the conv state (the last 3 pre-conv inputs) and the SSD
    state equal to the JAX package's."""
    _, jm, jp, tm, lm = zamba
    x = _x(10, (2, s, tm.cfg.d_model), 0.5)
    jmix = _block(jp)["mixer"]
    want, _ = JS.mamba2_apply(JaxCtx(policy=jm.policy), jm.cfg, jmix,
                              jnp.asarray(x))
    got, none = TS.mamba2_apply(tm.ctx(), tm.cfg, lm.blocks[0].mixer,
                                torch.from_numpy(x))
    assert none is None and _err(got, want) <= TOL
    jst, _ = JS.init_mamba2_state(jm.cfg, 2)
    _, jst = JS.mamba2_apply(JaxCtx(policy=jm.policy), jm.cfg, jmix,
                             jnp.asarray(x), jst)
    tst = TS.init_mamba2_state(tm.cfg, 2)
    got2, tst2 = TS.mamba2_apply(tm.ctx(), tm.cfg, lm.blocks[0].mixer,
                                 torch.from_numpy(x), tst)
    assert tst2 is tst and torch.equal(got2, got)
    _states_close(tst, jst)


@pytest.mark.parametrize("seq,chunk", [(32, 8), (48, 16), (17, 8)])
def test_mlstm_chunked_equals_jax_and_recurrence(seq, chunk):
    cfg = get_config("xlstm_125m", smoke=True).replace(mlstm_chunk=chunk)
    jcfg = jax_config("xlstm_125m", smoke=True).replace(mlstm_chunk=chunk)
    b, h, dh = 2, 3, 16
    q, v = _x(11, (b, seq, h, dh)), _x(13, (b, seq, h, dh))
    k = _x(12, (b, seq, h, dh), 0.25)
    logi = _x(14, (b, seq, h))
    logf = np.array(jax.nn.log_sigmoid(_x(15, (b, seq, h)) + 2.0))
    jy, jcarry = JS._mlstm_chunked(jcfg, *(jnp.asarray(t) for t in
                                           (q, k, v, logi, logf)))
    args = [torch.from_numpy(t) for t in (q, k, v, logi, logf)]
    ty, tcarry = TS._mlstm_chunked(cfg, *args)
    assert _err(ty, jy) <= TOL * max(1.0, float(np.abs(jy).max()))
    for t, j in zip(tcarry, jcarry):
        assert _err(t, j) <= TOL * max(1.0, float(np.abs(j).max()))
    ref = TS.mlstm_recurrent_reference(cfg, *args)
    jref = JS.mlstm_recurrent_reference(jcfg, *(jnp.asarray(t) for t in
                                                (q, k, v, logi, logf)))
    assert _err(ref, jref) <= TOL
    assert _err(ty, ref) <= 1e-4


@pytest.mark.parametrize("s", [17, 40])
def test_mlstm_apply_equals_jax(xlstm, s):
    """Uncached, and as a prefill leaving the handoff state (chunk 32: S
    = 40 pads its second chunk)."""
    _, jm, jp, tm, lm = xlstm
    x = _x(16, (2, s, tm.cfg.d_model), 0.3)
    jmix = _block(jp)["mlstm"]
    want, _ = JS.mlstm_apply(JaxCtx(policy=jm.policy), jm.cfg, jmix,
                             jnp.asarray(x))
    got, _ = TS.mlstm_apply(tm.ctx(), tm.cfg, lm.blocks[0].mlstm,
                            torch.from_numpy(x))
    assert _err(got, want) <= TOL
    jst, _ = JS.init_mlstm_state(jm.cfg, 2)
    _, jst = JS.mlstm_apply(JaxCtx(policy=jm.policy), jm.cfg, jmix,
                            jnp.asarray(x), jst)
    tst = TS.init_mlstm_state(tm.cfg, 2)
    TS.mlstm_apply(tm.ctx(), tm.cfg, lm.blocks[0].mlstm,
                   torch.from_numpy(x), tst)
    _states_close(tst, jst)


def test_slstm_apply_equals_jax(xlstm):
    """Uncached; as a prefill with a state (the carry restarts at h = c =
    0, n = 1, m = 0 whatever the state holds); then decode steps that
    continue from it."""
    _, jm, jp, tm, lm = xlstm
    x = _x(17, (2, 12, tm.cfg.d_model), 0.3)
    jmix = _block(jp)["slstm"]
    jctx = JaxCtx(policy=jm.policy)
    want, _ = JS.slstm_apply(jctx, jm.cfg, jmix, jnp.asarray(x))
    got, _ = TS.slstm_apply(tm.ctx(), tm.cfg, lm.blocks[0].slstm,
                            torch.from_numpy(x))
    assert _err(got, want) <= TOL
    jst, _ = JS.init_slstm_state(jm.cfg, 2)
    jst = {k: v + 0.5 for k, v in jst.items()}
    tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    _, jst = JS.slstm_apply(jctx, jm.cfg, jmix, jnp.asarray(x), jst)
    got, _ = TS.slstm_apply(tm.ctx(), tm.cfg, lm.blocks[0].slstm,
                            torch.from_numpy(x), tst)
    assert _err(got, want) <= TOL
    _states_close(tst, jst)
    for t in range(3):
        xt = _x(18 + t, (2, 1, tm.cfg.d_model), 0.3)
        want, jst = JS.slstm_apply(JaxCtx(policy=jm.policy, decode=True),
                                   jm.cfg, jmix, jnp.asarray(xt), jst)
        got, _ = TS.slstm_apply(Ctx(policy=tm.policy, decode=True), tm.cfg,
                                lm.blocks[0].slstm, torch.from_numpy(xt),
                                tst)
        assert _err(got, want) <= TOL
        _states_close(tst, jst)


@pytest.mark.parametrize("start", ["zeros", "state"])
def test_slstm_scan_backward_equals_autograd(start):
    """``repro_torch::slstm_scan``'s backward (back through time by hand,
    the loop recomputed) against autograd through the plain loop, in
    float64 (within 1e-12 of the largest gradient): ∂wx and ∂r for
    upstream gradients on every output, from the training start carry
    and from a decode state; the op's forward is the loop's bit for
    bit."""
    gen = torch.Generator().manual_seed(5)
    b, s, h, dh = 2, 9, 3, 5
    f64 = dict(dtype=torch.float64)
    wx = torch.randn((b, s, 4, h, dh), generator=gen, **f64)
    r = torch.randn((4, h, dh, dh), generator=gen, **f64) / dh ** 0.5
    if start == "zeros":
        z = torch.zeros((b, h, dh), **f64)
        carry = (z, z, torch.ones_like(z), z)
    else:
        carry = tuple(torch.randn((b, h, dh), generator=gen, **f64)
                      for _ in range(4))
        carry = carry[:2] + (carry[2].abs() + 0.5, carry[3])
    wx.requires_grad_(True)
    r.requires_grad_(True)
    want_out = TS._slstm_loop(wx, r, *carry)
    ups = [torch.randn(t.shape, generator=gen, **f64) for t in want_out]
    want = torch.autograd.grad(want_out, (wx, r), ups)
    out = torch.ops.repro_torch.slstm_scan(wx, r, *carry)
    assert all(torch.equal(a, w) for a, w in zip(out, want_out))
    got = torch.autograd.grad(out, (wx, r), ups)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


MIXERS = {"mamba2": ("zamba2_2p7b", "mixer", "mamba2_apply",
                     "init_mamba2_state"),
          "mlstm": ("xlstm_125m", "mlstm", "mlstm_apply", "init_mlstm_state"),
          "slstm": ("xlstm_125m", "slstm", "slstm_apply", "init_slstm_state")}


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_prefill_then_decode_equals_whole_prefill(mixer, zamba,
                                                        xlstm):
    """prefill(S - 1) then one decode step gives the whole prefill's last
    row, in the port (within TOL) and as the JAX package's step does."""
    arch, attr, fn, init = MIXERS[mixer]
    _, jm, jp, tm, lm = zamba if arch == ARCHS[0] else xlstm
    s = 33
    x = _x(21, (2, s, tm.cfg.d_model), 0.5)
    mod = getattr(lm.blocks[0], attr)
    tfn, jfn = getattr(TS, fn), getattr(JS, fn)
    full, _ = tfn(tm.ctx(), tm.cfg, mod, torch.from_numpy(x))
    tst = getattr(TS, init)(tm.cfg, 2)
    tfn(tm.ctx(), tm.cfg, mod, torch.from_numpy(x[:, :-1]), tst)
    step, _ = tfn(Ctx(policy=tm.policy, decode=True), tm.cfg, mod,
                  torch.from_numpy(x[:, -1:]), tst)
    assert _err(step, full[:, -1:]) <= TOL
    jst = getattr(JS, init)(jm.cfg, 2)[0]
    jparams = _block(jp)[attr]
    _, jst = jfn(JaxCtx(policy=jm.policy), jm.cfg, jparams,
                 jnp.asarray(x[:, :-1]), jst)
    jstep, jst = jfn(JaxCtx(policy=jm.policy, decode=True), jm.cfg,
                     jparams, jnp.asarray(x[:, -1:]), jst)
    assert _err(step, jstep) <= TOL
    _states_close(tst, jst)


# ---------------------------------------------------------- whole model
def test_lm_logits_and_loss_equal_jax(pair):
    """Uncached logits and ``LMModel.loss`` (cross-entropy and z-loss),
    and its gradient through every block."""
    _, jm, jp, tm, lm = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = JT.lm_apply(jm.ctx(), jm.cfg, jp, jnp.asarray(toks))
    tl, none = TT.lm_apply(tm.ctx(), tm.cfg, lm, torch.from_numpy(toks))
    assert none is None and _err(tl, jl) <= 1e-4
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
    leaves = tree_leaves(lm.param_tree(per_block=True))
    for p in leaves:
        p.requires_grad_(True)
    try:
        tloss, _ = tm.loss(lm, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
        grads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    g_in = grads[[i for i, p in enumerate(leaves)
                  if p is lm.blocks[-1].get_parameter(
                      "mixer.in_proj" if tm.cfg.family == "hybrid"
                      else "mlstm.w_up")][0]]
    assert bool(torch.isfinite(g_in).all()) and float(g_in.abs().sum()) > 0


def _cache_close(got, want, path="") -> None:
    """Leaf by leaf: the same nesting, ``pos`` equal, states within
    TOL (the sLSTM ``n`` relatively)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _cache_close(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if path.endswith("pos"):
        got = np.asarray(got.numpy() if torch.is_tensor(got) else got)
        np.testing.assert_array_equal(got, want)
        return
    assert tuple(got.shape) == want.shape and str(got.dtype).split(".")[-1] \
        == str(want.dtype), path
    tol = TOL * max(1.0, float(np.abs(want).max())) \
        if path.endswith("slstm/n") else TOL
    assert _err(got.float().numpy(), want) <= tol, path


def test_prefill_then_decode_cache_equals_jax(pair):
    """A 40-token prefill into the model cache (fp32, 48 slots), then 4
    decode steps: logits and every cache leaf at each step; then the JAX
    cache moved over with ``cache_from_jax`` decodes to the JAX package's
    greedy token."""
    _, jm, jp, tm, lm = pair
    toks = np.random.default_rng(8).integers(
        0, jm.cfg.vocab_size, (2, 44)).astype(np.int32)
    jcache, _ = jm.init_cache(2, 48, jnp.float32)
    tcache = tm.init_cache(2, 48, torch.float32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :40])},
                            jcache)
    tl, tcache = tm.prefill(lm, {"tokens": torch.from_numpy(toks[:, :40])},
                            tcache)
    assert _err(tl, jl) <= 1e-4
    _cache_close(tcache, jcache)
    for step in range(40, 44):
        tok = toks[:, step:step + 1]
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(lm, tcache, torch.from_numpy(tok))
        assert _err(tl, jl) <= 1e-4
        _cache_close(tcache, jcache)
    moved = cache_from_jax(jax.tree.map(np.asarray, jcache))
    _cache_close(moved, jcache)
    tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    jl, _ = jm.decode_step(jp, jcache, jnp.asarray(tok))
    tl, _ = tm.decode_step(lm, moved, torch.from_numpy(tok))
    np.testing.assert_array_equal(torch.argmax(tl[:, -1], -1).numpy(),
                                  np.asarray(jnp.argmax(jl[:, -1], -1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_equals_jax(arch):
    """The nesting, shapes and dtypes of ``init_lm_cache`` under a bf16
    cache: only the shared attention's K/V take bf16, every recurrent
    state stays fp32."""
    tc = TT.init_lm_cache(get_config(arch, smoke=True), 3, 10)
    jc, _ = JT.init_lm_cache(jax_config(arch, smoke=True), 3, 10)
    _cache_close(tc, jc)


def _min_top2_gap(model, params, prompts, gen, cache_len) -> float:
    cache = model.init_cache(prompts.shape[0], cache_len)
    logits, cache = model.prefill(params, {"tokens":
                                           torch.from_numpy(prompts)}, cache)
    gaps = []
    for step in range(gen):
        top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        if step < gen - 1:
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            logits, cache = model.decode_step(params, cache, tok)
    return min(gaps)


@pytest.mark.parametrize("arch,int8,seed,embed_scale", [
    ("zamba2_2p7b", False, 0, 10.0),
    ("zamba2_2p7b", True, 0, 10.0),
    ("xlstm_125m", False, 5, 10.0),
])
def test_generate_tokens_equal_jax(arch, int8, seed, embed_scale):
    """``generate`` (device loop and host loop) against the JAX package's
    under the bf16 policy and the int8-mlp policy (zamba2's shared MLP
    takes the int8 product; xLSTM has no ``mlp`` product).  The smoke
    models' tied heads read the 0.02-scale embedding, whose logits lie
    too close for a greedy step to be decided: both sides' embedding is
    scaled by 10."""
    _, jm, jp, tm, lm = _pair(arch, "bf16", int8_mlp=int8,
                              embed_scale=embed_scale)
    prompts = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    gen = 8
    cache_len = 8 + gen + 1
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), gen,
                                   cache_len))
    assert _min_top2_gap(tm, lm, prompts, gen, cache_len) >= 0.05
    for scan in (True, False):
        got = generate(tm, lm, torch.from_numpy(prompts), gen, cache_len,
                       scan=scan)
        assert got.dtype == torch.int32 and got.shape == (2, gen)
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_mlp_rule_reaches_only_zamba2_shared_mlp():
    """Under the int8-mlp policy the ``*mlp*`` rule matches zamba2's
    shared ``mlp/w_*`` and none of xLSTM's ``mlstm/…``/``slstm/…``
    products."""
    pol = serve_policy(True)
    names = {"mlp/w_gate", "mlp/w_up", "mlp/w_down", "attn/wq",
             "ssm/in_proj", "ssm/out_proj", "mlstm/w_up", "mlstm/wq",
             "mlstm/w_if", "mlstm/w_down", "slstm/w_in", "slstm/w_ff_up",
             "slstm/w_ff_down", "lm_head"}
    assert {n for n in names if pol.level_for(n) == "int8"} == \
        {"mlp/w_gate", "mlp/w_up", "mlp/w_down"}


# ------------------------------------------------------------ structure
def test_param_tree_equals_jax(pair):
    """The design flow's view: ``flatten_params`` names and stacked
    shapes, and the per-block training tree in the JAX leaf order."""
    _, jm, jp, tm, lm = pair
    jflat = jmasks.flatten_params(jp)
    tflat = tmasks.flatten_params(lm)
    assert sorted(tflat) == sorted(jflat)
    assert {k: tuple(v.shape) for k, v in tflat.items()} == \
        {k: tuple(v.shape) for k, v in jflat.items()}
    got = tree_leaves(lm.param_tree(per_block=True))
    want = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        a = np.asarray(leaf)
        want += list(a) if path[0].key == "blocks" else [a]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), w)


def test_check_ported_refuses_only_enc_dec(monkeypatch):
    """``check_ported`` went with the enc-dec port; what the port still
    refuses on the contiguous path is the enc-dec family alone, at the
    serve CLI, as the JAX launcher does (it names the whisper entry
    point).  Every other registry config gets past that check to
    ``build_model``; and ``build_model`` gives each config its module
    class, whisper-small's :class:`EncDec`."""
    from repro_torch.launch import serve as tserve

    class Built(Exception):
        pass

    def stop(cfg, *args, **kw):
        raise Built(cfg.name)

    assert not hasattr(TT, "check_ported")
    monkeypatch.setattr(tserve, "build_model", stop)
    refused = set()
    for arch, cfg in all_configs(smoke=True).items():
        with pytest.raises((SystemExit, Built)) as err:
            tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
        if err.type is SystemExit:
            assert "repro_torch.launch.whisper_serve" in str(err.value)
            refused.add(arch)
        params = build_model(cfg, device="cpu").empty_params()
        assert isinstance(params, TT.EncDec if cfg.enc_dec else TT.LM), arch
    assert refused == {"whisper_small"}


@pytest.mark.parametrize("arch", ARCHS + ["whisper_small"])
def test_paged_cache_refuses_both_families(arch):
    """The paged cache refuses the SSM, hybrid and enc-dec families with
    the reference's message."""
    kw = dict(page_size=8, n_pages=5, max_slots=2, max_blocks=2)
    with pytest.raises(ValueError) as jerr:
        jax_paged_cache(jax_config(arch, smoke=True), JaxPCfg(**kw))
    with pytest.raises(ValueError) as terr:
        init_paged_cache(get_config(arch, smoke=True), PagedCacheConfig(**kw),
                         device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_full_size_configs_build():
    """Both configs at full size (shape-only, on the meta device) and
    through ``build_model``: zamba2-2.7b's 54 Mamba2 blocks and one
    shared block (≈ 2.3 B parameters, bf16), xlstm-125m's 6 pairs (fp32)."""
    z = TT.LM(get_config("zamba2_2p7b"), device="meta")
    assert len(z.blocks) == 54 and z.shared.attn.wq.shape == (2560, 2560)
    assert z.blocks[0].mixer.in_proj.shape == (2560, 2 * 5120 + 2 * 64 + 80)
    assert z.blocks[0].mixer.A_log.dtype == torch.float32
    assert z.blocks[0].mixer.out_proj.dtype == torch.bfloat16
    assert 2.2e9 < sum(p.numel() for p in z.parameters()) < 2.4e9
    x = TT.LM(get_config("xlstm_125m"), device="meta")
    assert len(x.blocks) == 6 and x.blocks[0].slstm.r.shape == (4, 4, 192,
                                                                192)
    assert 1.3e8 < sum(p.numel() for p in x.parameters()) < 1.5e8
    for arch in ARCHS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            assert build_model(cfg, device="cpu").cfg is cfg
