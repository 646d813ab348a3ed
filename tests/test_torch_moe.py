"""The port's MoE family against the JAX package on the CPU: the router,
the MoE FFN and its auxiliary loss, MLA attention (uncached, prefill then
decode, the compressed cache), whole-model logits and loss, the paged
engine's and ``generate``'s greedy tokens, and the parameter tree the
design flow reads — on ``granite-moe-smoke`` (GQA, 8 experts top-2, no
shared expert) and ``deepseek-v2-smoke`` (MLA, 8 experts top-2, one
shared expert).

Inputs come from numpy seeds; parameters are the JAX package's init,
moved with ``params_from_jax``.  Tolerances, all with fp32 activations:
- router gates within 1e-6 and expert indices equal;
- the MoE FFN (the JAX package multiplies every token through every
  expert and masks; the port routes each token to its top-k) within 1e-5,
  its auxiliary loss within 1e-6;
- MLA outputs and caches within 2e-5, logits within 1e-4 and the loss
  within 1e-5 (fp32 arithmetic in different orders);
- greedy tokens equal: the engine under the FP32 policy (differences far
  below the top-2 logit gaps), ``generate`` under the bf16 and int8-mlp
  policies with prompts whose every step keeps a top-2 gap of at least
  0.05 (asserted on the port's side), as ``test_torch_decode.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch.serve import generate as jax_generate
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build
from repro.models.common import Ctx as JaxCtx
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.serving import PagedCacheConfig as JaxPCfg
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.sparsity import masks as jmasks
from repro.tasks import quantization as jquant
from repro.tasks.handle import DNNHandle as JaxHandle
from repro_torch.configs.registry import get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch.serve import generate, serve_policy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model
from repro_torch.models.common import Ctx
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving import (PagedCacheConfig, PagedServingEngine,
                                 Request)
from repro_torch.sparsity import masks as tmasks
from repro_torch.tasks import quantization as tquant
from repro_torch.tasks.handle import DNNHandle

ARCHS = ["granite_moe_1b_a400m", "deepseek_v2_236b"]
MLA_TOL = 2e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, JAX params, port model, port params) at smoke
    size with fp32 activations under the FP32 policy."""
    return _pair(request.param, "fp32")


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


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _block(params, i=0):
    return jax.tree.map(lambda t: t[i], params["blocks"])


# ---------------------------------------------------------------- router
def test_router_equals_jax(pair):
    _, jm, jp, tm, lm = pair
    x = _x(1, (40, jm.cfg.d_model))
    router = _block(jp)["moe"]["router"]
    jg, je = JL._router(jm.cfg, router, jnp.asarray(x))
    tg, te = TL._router(tm.cfg, lm.blocks[0].moe.router, torch.from_numpy(x))
    assert np.max(np.abs(tg.numpy() - np.asarray(jg))) <= 1e-6
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_router_ties_take_the_lower_expert_first():
    """Equal probabilities (a zero router) pick experts 0..k-1 in order,
    as ``jax.lax.top_k`` does, with equal renormalised gates."""
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    jcfg = jax_config("granite_moe_1b_a400m", smoke=True)
    x = _x(2, (5, cfg.d_model))
    w = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    tg, te = TL._router(cfg, torch.from_numpy(w), torch.from_numpy(x))
    jg, je = JL._router(jcfg, jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te.tolist() == [list(range(cfg.top_k))] * 5
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# --------------------------------------------------------------- MoE FFN
def test_moe_ffn_and_aux_loss_equal_jax(pair):
    """With and without shared experts (deepseek-v2-smoke has one,
    granite-moe-smoke none), over a ragged token count."""
    arch, jm, jp, tm, lm = pair
    x = _x(3, (3, 7, jm.cfg.d_model))
    jblk = _block(jp)["moe"]
    want = JL.moe_ffn(JaxCtx(policy=jm.policy), jm.cfg, jblk, jnp.asarray(x))
    got = TL.moe_ffn(tm.ctx(), tm.cfg, lm.blocks[0].moe, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-5
    assert hasattr(lm.blocks[0].moe, "shared") == (arch != ARCHS[0])
    jaux = JL.moe_aux_loss(jm.cfg, jblk["router"], jnp.asarray(x))
    taux = TL.moe_aux_loss(tm.cfg, lm.blocks[0].moe.router,
                           torch.from_numpy(x))
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("row_block", [1, 4, 64])
def test_moe_row_blocks_give_the_unblocked_sum(pair, row_block):
    """The fixed row blocks of the card (zero-padded per expert) give the
    one-product-per-expert result; a one-token call (every expert with
    at most one row) too."""
    _, jm, _, tm, lm = pair
    p = lm.blocks[1].moe
    for shape in ((2, 9, jm.cfg.d_model), (1, 1, jm.cfg.d_model)):
        x = torch.from_numpy(_x(4, shape))
        ref = TL._moe_routed(tm.cfg, p, x, None)
        got = TL._moe_routed(tm.cfg, p, x, row_block)
        assert torch.allclose(got, ref, rtol=0, atol=1e-6)


def test_moe_one_host_read_a_layer(pair):
    _, jm, _, tm, lm = pair
    toks = torch.from_numpy(np.arange(12, dtype=np.int64).reshape(2, 6))
    before = TL.moe_host_syncs
    TT.lm_apply(tm.ctx(), tm.cfg, lm, toks)
    assert TL.moe_host_syncs - before == tm.cfg.n_layers


def test_moe_experts_policy_reaches_only_shared_experts(pair):
    """The routed experts ignore the policy in both packages (the dense
    reference never calls ``linear``): INT8 for ``moe/experts`` changes no
    bit.  int8 for ``mlp`` reaches the shared experts only (deepseek)."""
    arch, jm, jp, tm, lm = pair
    x = _x(5, (2, 5, jm.cfg.d_model))
    jblk = _block(jp)["moe"]
    outs = {}
    for name, rule in (("fp32", None), ("experts", "*moe/experts*"),
                       ("mlp", "*mlp*")):
        tpol = PrecisionPolicy(default="fp32")
        jpol = JaxPolicy(default="fp32")
        if rule:
            tpol, jpol = tpol.with_rule(rule, "int8"), jpol.with_rule(rule,
                                                                      "int8")
        outs[name] = (
            TL.moe_ffn(Ctx(policy=tpol), tm.cfg, lm.blocks[0].moe,
                       torch.from_numpy(x)).numpy(),
            np.asarray(JL.moe_ffn(JaxCtx(policy=jpol), jm.cfg, jblk,
                                  jnp.asarray(x))))
    for side in (0, 1):
        np.testing.assert_array_equal(outs["experts"][side],
                                      outs["fp32"][side])
        assert np.array_equal(outs["mlp"][side], outs["fp32"][side]) == \
            (arch == ARCHS[0])
    assert np.max(np.abs(outs["mlp"][0] - outs["mlp"][1])) <= 1e-5


# ------------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def mla_pair():
    return _pair("deepseek_v2_236b", "fp32")


def test_mla_uncached_equals_jax(mla_pair):
    _, jm, jp, tm, lm = mla_pair
    x = _x(6, (2, 11, jm.cfg.d_model))
    pos = np.arange(11)
    want, _ = JL.mla_attention(JaxCtx(policy=jm.policy), jm.cfg,
                               _block(jp)["attn"], jnp.asarray(x),
                               jnp.asarray(pos))
    got, cache = TL.mla_attention(tm.ctx(), tm.cfg, lm.blocks[0].attn,
                                  torch.from_numpy(x), torch.from_numpy(pos))
    assert cache is None
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= MLA_TOL


def test_mla_prefill_then_decode_equals_jax(mla_pair):
    """A 5-token prefill into a 9-slot compressed cache, a one-token
    decode, then a two-token decode (whose tokens see the cache up to the
    first one only, the reference's mask): outputs, ``ckv``, ``krope``
    and ``pos`` at every step; the last step also from a cache moved
    over with ``cache_from_jax``."""
    _, jm, jp, tm, lm = mla_pair
    cfg = tm.cfg
    jattn = _block(jp)["attn"]
    jcache, _ = JL.init_mla_cache(jm.cfg, 2, 9, jnp.float32)
    tcache = TL.init_mla_cache(cfg, 2, 9, torch.float32)
    steps = [(False, 0, 5), (True, 5, 1), (True, 6, 2)]
    for i, (decode, p0, s) in enumerate(steps):
        x = _x(10 + i, (2, s, cfg.d_model))
        pos = np.arange(p0, p0 + s)
        if i == 2:
            tcache = cache_from_jax(jax.tree.map(np.asarray, jcache))
        want, jcache = JL.mla_attention(
            JaxCtx(policy=jm.policy, decode=decode), jm.cfg, jattn,
            jnp.asarray(x), jnp.asarray(pos), jcache)
        got, tcache = TL.mla_attention(
            Ctx(policy=tm.policy, decode=decode), cfg, lm.blocks[0].attn,
            torch.from_numpy(x), torch.from_numpy(pos), tcache)
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= MLA_TOL
        assert tcache["pos"] == int(jcache["pos"]) == p0 + s
        for name in ("ckv", "krope"):
            assert np.max(np.abs(tcache[name].numpy()
                                 - np.asarray(jcache[name]))) <= MLA_TOL


def test_mla_cache_layout_equals_jax():
    cfg = get_config("deepseek_v2_236b", smoke=True)
    jcfg = jax_config("deepseek_v2_236b", smoke=True)
    tc = TT.init_lm_cache(cfg, 3, 10, torch.float32)
    jc, _ = JT.init_lm_cache(jcfg, 3, 10, jnp.float32)
    assert sorted(tc) == sorted(jc) == ["ckv", "krope", "pos"]
    for name in ("ckv", "krope"):
        assert tuple(tc[name].shape) == jc[name].shape
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    assert tc["pos"].device.type == "cpu"


# ---------------------------------------------------------- whole model
def test_lm_logits_and_cached_decode_equal_jax(pair):
    """Uncached logits; then a prefill into the model cache and two decode
    steps (logits, the advanced ``pos``)."""
    _, jm, jp, tm, lm = pair
    toks = np.random.default_rng(7).integers(
        0, jm.cfg.vocab_size, (2, 10)).astype(np.int32)
    jl, _ = JT.lm_apply(jm.ctx(), jm.cfg, jp, jnp.asarray(toks))
    tl, _ = TT.lm_apply(tm.ctx(), tm.cfg, lm, torch.from_numpy(toks))
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= 1e-4
    jcache, _ = jm.init_cache(2, 14, jnp.float32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = tm.prefill(lm, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 14, torch.float32))
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= 1e-4
    for step in range(2):
        tok = toks[:, step:step + 1]
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(lm, tcache, torch.from_numpy(tok))
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= 1e-4
        assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def test_loss_equals_jax(pair):
    """``LMModel.loss`` (cross-entropy and z-loss; no auxiliary loss in
    either package) and its gradient's existence through the MoE FFN."""
    _, jm, jp, tm, lm = pair
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 9)).astype(np.int32)
    labels = rng.integers(0, jm.cfg.vocab_size, (2, 9)).astype(np.int32)
    jloss, jaux = jm.loss(jp, {"tokens": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)})
    tree = lm.param_tree(per_block=True)
    leaves = tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    try:
        tloss, taux = tm.loss(lm, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
        grads = torch.autograd.grad(tloss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    assert abs(taux["nll"].item() - float(jaux["nll"])) <= 1e-5
    moe = lm.blocks[0].moe
    gw = dict(zip([id(p) for p in leaves], grads))[id(moe.w_gate)]
    assert gw.shape == moe.w_gate.shape and bool(torch.isfinite(gw).all())
    assert float(gw.abs().sum()) > 0


def test_param_tree_and_quantizable_groups_equal_jax(pair):
    """The design flow's view: ``flatten_params`` names and stacked
    shapes, the per-block training tree in the JAX leaf order, the router
    kept fp32, and QUANTIZATION's groups."""
    arch, jm, jp, tm, lm = pair
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
    full = TT.LM(get_config(arch), device="meta")
    assert full.blocks[0].moe.router.dtype == torch.float32
    th = DNNHandle(kind="lm", name=arch, params=lm, model=tm)
    jh = JaxHandle(kind="lm", name=arch, params=jp, model=jm)
    assert tquant.quantizable_groups(th) == jquant.quantizable_groups(jh)
    assert "moe/experts" in tquant.quantizable_groups(th)


def test_full_size_configs_build():
    """Both configs at full size (shape-only, on the meta device): the
    parameter counts of the two cells' cuts, and the bf16 router of none:
    the router is fp32 in DeepSeek-V2's bf16 model."""
    g = TT.LM(get_config("granite_moe_1b_a400m"), device="meta")
    n = sum(p.numel() for p in g.parameters())
    assert 1.3e9 < n < 1.4e9
    cfg = get_config("deepseek_v2_236b").replace(n_layers=1)
    d = TT.LM(cfg, device="meta")
    per_layer = sum(p.numel() for p in d.blocks[0].parameters())
    assert 3.9e9 < per_layer < 4.0e9
    assert d.blocks[0].moe.w_gate.dtype == torch.bfloat16
    assert d.blocks[0].moe.router.dtype == torch.float32
    assert d.blocks[0].moe.shared.w_gate.shape == (5120, 3072)
    for arch in ARCHS:
        assert build_model(get_config(arch), device="cpu").cfg.family == \
            "moe"


# ------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engine_pair():
    return _pair("granite_moe_1b_a400m", "fp32")


STAT_KEYS = ("n_finished", "n_dead_lettered", "n_segments",
             "n_prefill_dispatches", "preemptions", "restores",
             "prefix_hits", "prefix_tokens_matched")


@pytest.mark.parametrize("case", ["burst", "shared_prefix",
                                  "preempt_restore"])
def test_paged_engine_tokens_equal_jax(engine_pair, case):
    """granite-moe-smoke through both paged engines (FP32 policy, fp32
    cache): a burst, requests sharing a prompt (a full page shared and a
    tail forked copy-on-write), and an oversubscribed pool that preempts
    and restores."""
    _, jm, jp, tm, lm = engine_pair
    rng = np.random.default_rng(20)
    if case == "burst":
        kw = dict(page_size=8, n_pages=16, max_slots=3, max_blocks=4,
                  segment_len=4)
        prompts = [rng.integers(0, 256, 16) for _ in range(4)]
        gens = [3, 11, 7, 5]
    elif case == "shared_prefix":
        kw = dict(page_size=8, n_pages=32, max_slots=2, max_blocks=4,
                  segment_len=2)
        prompts = [rng.integers(0, 256, 13)] * 3
        gens = [14, 2, 5]
    else:
        kw = dict(page_size=8, n_pages=13, max_slots=4, max_blocks=4,
                  segment_len=4)
        prompts = [rng.integers(0, 256, 16) for _ in range(4)]
        gens = [12] * 4
    out = {}
    for side in ("jax", "torch"):
        if side == "jax":
            eng = JaxEngine(jm, JaxPCfg(**kw), cache_dtype=jnp.float32)
            mk, p = JaxRequest, jp
        else:
            eng = PagedServingEngine(tm, PagedCacheConfig(**kw),
                                     cache_dtype=torch.float32)
            mk, p = Request, lm
        reqs = [mk(rid=i, prompt=np.asarray(pr, np.int32).copy(),
                   max_new_tokens=g)
                for i, (pr, g) in enumerate(zip(prompts, gens))]
        st = eng.run(reqs, p)
        out[side] = ({r.rid: list(r.tokens) for r in reqs},
                     {k: st[k] for k in STAT_KEYS})
    assert out["torch"] == out["jax"]
    st = out["torch"][1]
    assert st["n_finished"] == len(prompts)
    if case == "shared_prefix":
        assert st["prefix_tokens_matched"] >= 8
    if case == "preempt_restore":
        assert st["preemptions"] >= 1 and st["restores"] >= 1


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
    ("granite_moe_1b_a400m", False, 0, 10.0),
    ("deepseek_v2_236b", False, 17, 1.0),
    ("deepseek_v2_236b", True, 17, 1.0),
])
def test_generate_tokens_equal_jax(arch, int8, seed, embed_scale):
    """``generate`` (device loop and host loop) against the JAX package's
    under the bf16 policy and the int8-mlp policy (DeepSeek-V2's shared
    experts take the int8 product; granite has no ``mlp`` product).
    granite-moe-smoke's tied head reads the 0.02-scale embedding, whose
    logits lie too close for any greedy step to be decided: both sides'
    embedding is scaled by 10."""
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
