"""The port's contiguous-cache serving path on the CPU against the JAX
package: the flash_decode wrapper's plain version against the Pallas
kernel (interpret mode), the contiguous branches of ``attention``
(decode, ring buffer, prefill fill), greedy ``generate`` under the bf16
and int8-mlp policies, and the engine's serial admission.

Inputs come from numpy seeds; parameters and cache state move from the JAX
package with ``params_from_jax`` / ``cache_from_jax``.  Tolerances: fp32
attention outputs within 2e-5 (summation order); caches and greedy tokens
equal.  The ``generate`` cases run fp32 activations; under the bf16 policy
fp32 summation-order differences flip the rounding of a few bf16 operands,
which moves logits by the order of 0.01 between the frameworks — so their
prompts are chosen such that every greedy step's top-2 logit gap is at
least 0.05 (asserted on the port's side), and equal tokens are a real
check, not luck.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.launch.serve import generate as jax_generate
from repro.models import layers as JL
from repro.models.api import build_model as jax_build
from repro.models.common import Ctx as JaxCtx
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.serving import PagedCacheConfig as JaxPCfg
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.data.synthetic import lm_tokens
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch.serve import generate, serve_policy
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from repro_torch.models.common import Ctx
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving import (PagedCacheConfig, PagedServingEngine,
                                 Request)

TOL = 2e-5


# ------------------------------------------------------ flash_decode_plain
def _decode_problem(seed, b, cache_len, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, cache_len, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, cache_len, kvh, d)).astype(np.float32)
    return q, k, v


def _check_decode(q, k, v, mask):
    t = torch.from_numpy
    before = fd.launches
    out = fd.flash_decode(t(q), t(k), t(v), t(mask)).numpy()
    assert fd.launches == before             # CPU tensors never launch
    ref = np.asarray(jax_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(mask),
                                      interpret=True))
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= TOL


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (7, 1)])
@pytest.mark.parametrize("cache_len", [16, 37, 577])
def test_flash_decode_plain_linear_masks(h, kvh, cache_len):
    """g in {1, 2, 7}; cache lengths a tile divides, that none divides,
    and 577 = 512 + 64 + 1; masks from the port's helpers at position 0,
    mid-cache and a full cache, equal to the JAX package's masks."""
    q, k, v = _decode_problem(cache_len + h, 2, cache_len, h, kvh, 8)
    for pos in (0, cache_len // 2, cache_len - 1):
        mask = TL.decode_attention_mask(
            TL.kv_positions_for_cache(pos, cache_len, 0), pos, 0).numpy()
        assert np.array_equal(mask, np.asarray(JL.decode_attention_mask(
            JL.kv_positions_for_cache(jnp.asarray(pos), cache_len, 0),
            pos, 0)))
        _check_decode(q, k, v, mask)


@pytest.mark.parametrize("pos", [45, 70])
def test_flash_decode_plain_wrapped_ring(pos):
    """The danube-smoke ring (32 slots, window 32) after it wrapped: the
    live slots are not a prefix of the cache."""
    cache_len = window = 32
    q, k, v = _decode_problem(pos, 2, cache_len, 4, 2, 8)
    mask = TL.decode_attention_mask(
        TL.kv_positions_for_cache(pos, cache_len, window), pos,
        window).numpy()
    idx = pos % cache_len
    assert mask.all() and mask[idx] and mask[(idx + 1) % cache_len]
    short = TL.decode_attention_mask(
        TL.kv_positions_for_cache(pos, cache_len, 24), pos, 24).numpy()
    assert short.sum() == 24 and not short[(idx + 1) % cache_len]
    _check_decode(q, k, v, mask)
    _check_decode(q, k, v, short)


# ----------------------------------------------- contiguous attention layer
def _layer(arch):
    cfg = jax_config(arch, smoke=True).replace(act_dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    p, _ = JL.init_attention(jax.random.PRNGKey(0), cfg)
    att = TL.Attention(tcfg)
    att.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)))
    return cfg, tcfg, p, att


@pytest.mark.parametrize("arch,pos", [
    ("qwen2-7b", 0), ("qwen2-7b", 15),
    ("h2o-danube-3-4b", 0), ("h2o-danube-3-4b", 15),
    ("h2o-danube-3-4b", 45),                        # wrapped ring buffer
])
def test_attention_decode_matches_jax(arch, pos):
    """One decode token: output within 2e-5 of the JAX package's Pallas
    path; the cache equal outside the written slot, the written K/V row
    (fresh fp32 projections) within 2e-5, ``pos`` advanced by one."""
    cfg, tcfg, p, att = _layer(arch)
    cache_len = 16 if not cfg.sliding_window else min(16,
                                                       cfg.sliding_window)
    b = 2
    rng = np.random.default_rng(pos)
    kv_shape = (b, cache_len, cfg.n_kv_heads, cfg.hd)
    jcache = {"k": rng.standard_normal(kv_shape).astype(np.float32),
              "v": rng.standard_normal(kv_shape).astype(np.float32),
              "pos": np.asarray(pos, np.int32)}
    x = (0.3 * rng.standard_normal((b, 1, cfg.d_model))).astype(np.float32)
    y_ref, c_ref = JL.attention(
        JaxCtx(decode=True, use_kernels=True, interpret=True), cfg, p,
        jnp.asarray(x), jnp.asarray([pos]),
        jax.tree.map(jnp.asarray, jcache))
    tcache = cache_from_jax(jcache)
    assert tcache["pos"] == pos
    with torch.no_grad():
        y, c = TL.attention(Ctx(decode=True), tcfg, att, torch.from_numpy(x),
                            torch.tensor([pos]), tcache)
    assert np.max(np.abs(y.numpy() - np.asarray(y_ref))) <= TOL
    slot = pos % cache_len
    for leaf in ("k", "v"):
        got, want = c[leaf].numpy(), np.asarray(c_ref[leaf])
        assert np.max(np.abs(got[:, slot] - want[:, slot])) <= TOL
        assert np.abs(got[:, slot] - jcache[leaf][:, slot]).max() > 0.1
        got[:, slot] = want[:, slot]
        np.testing.assert_array_equal(got, want)
    assert c["pos"] == int(c_ref["pos"]) == pos + 1


def test_ring_prefill_overflow_then_decode():
    """A 40-token prompt into the 32-slot danube ring (40 % 32 != 0): the
    prefill rotates the retained tail so decode's position recovery reads
    the right slots.  Cache within 2e-5 of the JAX package's after the
    prefill, decode output within 2e-5 of it and of full-sequence
    attention."""
    cfg, tcfg, p, att = _layer("h2o-danube-3-4b")
    s, cache_len = 40, 32
    assert cfg.sliding_window == cache_len
    x = (0.3 * np.random.default_rng(1).standard_normal(
        (1, s + 1, cfg.d_model))).astype(np.float32)
    xt = torch.from_numpy(x)
    jc, _ = JL.init_attention_cache(cfg, 1, cache_len, dtype=jnp.float32)
    _, jc = JL.attention(JaxCtx(), cfg, p, jnp.asarray(x[:, :s]),
                         jnp.arange(s), jc)
    y_ref, _ = JL.attention(JaxCtx(decode=True), cfg, p,
                            jnp.asarray(x[:, s:]), jnp.asarray([s]), jc)
    tc = TL.init_attention_cache(tcfg, 1, 64, dtype=torch.float32)
    assert tc["k"].shape == (1, cache_len, cfg.n_kv_heads, cfg.hd)
    with torch.no_grad():
        y_full, _ = TL.attention(Ctx(), tcfg, att, xt, torch.arange(s + 1))
        _, tc = TL.attention(Ctx(), tcfg, att, xt[:, :s], torch.arange(s),
                             tc)
        for leaf in ("k", "v"):
            assert np.max(np.abs(tc[leaf].numpy()
                                 - np.asarray(jc[leaf]))) <= TOL
        assert tc["pos"] == int(jc["pos"]) == s
        y, _ = TL.attention(Ctx(decode=True), tcfg, att, xt[:, s:],
                            torch.tensor([s]), tc)
    assert np.max(np.abs(y.numpy() - np.asarray(y_ref))) <= TOL
    assert np.max(np.abs(y.numpy() - y_full[:, -1:].numpy())) <= TOL


def test_decode_of_several_tokens_uses_the_plain_path():
    """``s > 1`` tokens at ``pos`` attend under the first token's mask, as
    the JAX package's decode branch does (its kernel is single-token)."""
    cfg, tcfg, p, att = _layer("qwen2-7b")
    rng = np.random.default_rng(4)
    kv_shape = (2, 16, cfg.n_kv_heads, cfg.hd)
    jcache = {"k": rng.standard_normal(kv_shape).astype(np.float32),
              "v": rng.standard_normal(kv_shape).astype(np.float32),
              "pos": np.asarray(5, np.int32)}
    x = (0.3 * rng.standard_normal((2, 3, cfg.d_model))).astype(np.float32)
    y_ref, c_ref = JL.attention(JaxCtx(decode=True), cfg, p, jnp.asarray(x),
                                jnp.arange(5, 8),
                                jax.tree.map(jnp.asarray, jcache))
    with torch.no_grad():
        y, c = TL.attention(Ctx(decode=True), tcfg, att, torch.from_numpy(x),
                            torch.arange(5, 8), cache_from_jax(jcache))
    assert np.max(np.abs(y.numpy() - np.asarray(y_ref))) <= TOL
    assert np.max(np.abs(c["k"].numpy() - np.asarray(c_ref["k"]))) <= TOL
    np.testing.assert_array_equal(c["k"].numpy()[:, :5], jcache["k"][:, :5])
    assert c["pos"] == int(c_ref["pos"]) == 8


def test_lm_decode_from_converted_cache_fp32():
    """The JAX package's prefilled model cache, moved with
    ``cache_from_jax``, decodes in the port to the same logits (fp32
    policy, within 1e-4) and the same advanced per-layer ``pos``."""
    jm, jparams, tm, lm = _pair("qwen2-7b", JaxPolicy(default="fp32"),
                                PrecisionPolicy(default="fp32"))
    prompts = lm_tokens(2 * 8, jm.cfg.vocab_size, seed=5).reshape(2, 8)
    jcache, _ = jm.init_cache(2, 12, jnp.float32)
    _, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(prompts)},
                                    jcache)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert tcache["pos"].tolist() == [8, 8]
    tok = np.asarray([[3], [7]], np.int32)
    jl, jnew = jax.jit(jm.decode_step)(jparams, jcache, jnp.asarray(tok))
    tl, tnew = tm.decode_step(lm, tcache, torch.from_numpy(tok))
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= 1e-4
    assert tnew["pos"].tolist() == np.asarray(jnew["pos"]).tolist() == [9, 9]
    assert np.max(np.abs(tnew["k"].numpy() - np.asarray(jnew["k"]))) <= TOL


# ----------------------------------------------------------------- generate
def _pair(arch, jpolicy, tpolicy, **jkw):
    jcfg = jax_config(arch, smoke=True).replace(act_dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    jm = jax_build(jcfg, policy=jpolicy, **jkw)
    tm = build_model(tcfg, tpolicy, device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    lm = tm.empty_params()
    lm.load_state_dict(params_from_jax(params))
    return jm, jax.tree.map(jnp.asarray, params), tm, lm


def _min_top2_gap(model, params, prompts, gen, cache_len) -> float:
    """Smallest gap between the two largest logits over the greedy steps
    of ``generate``, on the port's side."""
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


@pytest.mark.parametrize("arch,prompt_len,seed,int8,jax_kernels", [
    ("qwen2-7b", 8, 1, False, False),
    ("h2o-danube-3-4b", 40, 8, False, False),      # ring overflow
    ("qwen2-7b", 8, 1, True, False),
    ("qwen2-7b", 8, 1, True, True),                # Pallas quant_matmul
])
def test_generate_tokens_equal_jax(arch, prompt_len, seed, int8,
                                   jax_kernels):
    """Greedy tokens of the port's ``generate`` (device loop and host
    loop) equal the JAX package's ``generate`` under the bf16 policy and
    under the int8-mlp policy of ``examples/serve_lm.py``."""
    jpol = JaxPolicy(default="bf16")
    if int8:
        jpol = jpol.with_rule("*mlp*", "int8")
    jm, jparams, tm, lm = _pair(arch, jpol, serve_policy(int8),
                                use_kernels=jax_kernels,
                                interpret=jax_kernels)
    prompts = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    gen = 8
    cache_len = prompt_len + gen + 1
    want = np.asarray(jax_generate(jm, jparams, jnp.asarray(prompts), gen,
                                   cache_len))
    assert _min_top2_gap(tm, lm, prompts, gen, cache_len) >= 0.05
    for scan in (True, False):
        got = generate(tm, lm, torch.from_numpy(prompts), gen, cache_len,
                       scan=scan)
        assert got.dtype == torch.int32 and got.shape == (2, gen)
        np.testing.assert_array_equal(got.numpy(), want)


def test_lm_tokens_equal_jax():
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn
    assert np.array_equal(lm_tokens(257, 1000, seed=3),
                          jsyn.lm_tokens(257, 1000, seed=3))
    for name in ("jet_dataset", "mnist_like", "svhn_like"):
        for a, b in zip(getattr(tsyn, name)(64, seed=2),
                        getattr(jsyn, name)(64, seed=2)):
            assert np.array_equal(a, b)
    x, y = tsyn.jet_dataset(50, seed=1)
    for a, b in zip(tsyn.train_test_split(x, y, seed=4),
                    jsyn.train_test_split(x, y, seed=4)):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))


# ------------------------------------------------------------ serial engine
def test_serial_engine_equals_jax_generate_and_batched():
    """``prefill_mode="serial"``: the port's tokens equal the JAX serial
    engine's, the port's ``generate`` per request and the port's batched
    engine; fp32 activations, policy and caches throughout."""
    jm, jparams, tm, lm = _pair("qwen2-7b", JaxPolicy(default="fp32"),
                                PrecisionPolicy(default="fp32"))
    n, prompt_len, gens = 3, 16, [9, 5, 9]
    prompts = lm_tokens(n * prompt_len, jm.cfg.vocab_size, seed=1).reshape(
        n, prompt_len)
    kw = dict(page_size=8, n_pages=9, max_slots=2, max_blocks=4,
              segment_len=4)
    res = {}
    for name in ("jax", "serial", "batched"):
        if name == "jax":
            eng = JaxEngine(jm, JaxPCfg(**kw), cache_dtype=jnp.float32,
                            prefill_mode="serial")
            mk, p = JaxRequest, jparams
        else:
            eng = PagedServingEngine(tm, PagedCacheConfig(**kw),
                                     cache_dtype=torch.float32,
                                     prefill_mode=name)
            mk, p = Request, lm
        reqs = [mk(rid=i, prompt=prompts[i].copy(), max_new_tokens=g)
                for i, g in enumerate(gens)]
        stats = eng.run(reqs, p)
        assert stats["n_finished"] == n
        res[name] = ({r.rid: list(r.tokens) for r in reqs},
                     stats["n_prefill_dispatches"])
    assert res["serial"] == res["jax"]
    assert res["serial"][1] == n
    assert res["batched"][0] == res["serial"][0]
    for i, g in enumerate(gens):
        toks = generate(tm, lm, torch.from_numpy(prompts[i:i + 1]), g,
                        prompt_len + g + 1, cache_dtype=torch.float32)
        assert toks[0].tolist() == res["serial"][0][i]


def test_serial_admission_fault_unwinds_and_retries():
    """An injected ``dispatch_admit`` fault on the serial path aborts the
    boundary's remaining admissions; every request still finishes with
    the fault-free tokens."""
    from repro_torch.serving import FaultPlan
    _, _, tm, lm = _pair("qwen2-7b", JaxPolicy(default="fp32"),
                         PrecisionPolicy(default="fp32"))
    prompts = lm_tokens(3 * 16, 256, seed=2).reshape(3, 16)
    pcfg = PagedCacheConfig(page_size=8, n_pages=13, max_slots=3,
                            max_blocks=4, segment_len=4)
    out = []
    for faults in (None, FaultPlan.at(dispatch_admit=1)):
        reqs = [Request(rid=i, prompt=prompts[i].copy(), max_new_tokens=6)
                for i in range(3)]
        stats = PagedServingEngine(tm, pcfg, cache_dtype=torch.float32,
                                   prefill_mode="serial").run(
                                       reqs, lm, faults=faults)
        assert stats["n_finished"] == 3 and stats["n_dead_lettered"] == 0
        out.append({r.rid: r.tokens for r in reqs})
    assert faults.total_fires == 1
    assert out[0] == out[1]


def test_serve_cli_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` with the JAX launcher's flags
    plus ``--int8`` and ``--device``; meshes other than 1x1 are refused."""
    import json
    from repro_torch.launch.serve import main
    assert main(["--arch", "qwen2_7b", "--smoke", "--device", "cpu",
                 "--int8", "--batch", "2", "--prompt-len", "8",
                 "--gen", "3", "--no-scan"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["policy"] == "int8-mlp" and out["generated"] == 3
    assert out["device"] == "cpu" and not out["scan"]
    with pytest.raises(SystemExit):
        main(["--arch", "qwen2_7b", "--smoke", "--device", "cpu",
              "--mesh", "2x1"])
