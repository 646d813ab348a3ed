"""The port's ``lm_apply`` against the JAX package's on a paged cache:
a batched ragged admission prefill, a decode step, and a second admission
that shares the first request's prefix page — logits at every valid
position and the written K/V pages.

Same parameters on both sides (JAX init, moved with ``params_from_jax``,
QKV biases made non-zero, and every other all-0 or all-1 leaf — LayerNorm
biases and scales, MLP biases, RMSNorm and QK-norm scales — perturbed so
that a dropped bias or norm shows).  The configs: qwen2 and qwen1.5 (QKV
bias), starcoder2 (LayerNorm, a biased GELU MLP, QKV bias, a tied
embedding) and chameleon (QK-norm, family "vlm").  Tolerances:
- ``act_dtype="float32"`` and the FP32 policy on both sides: max abs
  error <= 1e-4 (fp32 arithmetic in different orders);
- the stock bf16 activations with the BF16 policy and a bf16 cache: the
  two frameworks round to bf16 at different places, so a logit may
  differ by a few bf16 ulps of the activations it is built from; held to
  max abs error <= 0.1 (logits here are O(1); a real porting bug — wrong
  RoPE pairing, mask or bias — moves them by O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch.serve import generate as jax_generate
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.serving.paged_cache import PagedCacheConfig as JaxPCfg
from repro.serving.paged_cache import init_paged_cache as jax_init_cache
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving.paged_cache import PagedCacheConfig
from repro_torch.serving.paged_cache import init_paged_cache

PS, BLOCKS, SLOTS = 8, 4, 4


def _models(arch, fp32, level=None, embed_scale=1.0):
    """Both packages' models at smoke size (fp32 activations and the FP32
    policy, or the stock bf16 activations and the BF16 policy; ``level``
    overrides the policy) and one converted parameter set, the embedding
    scaled by ``embed_scale``."""
    over = {"act_dtype": "float32"} if fp32 else {}
    jcfg = jax_config(arch, smoke=True).replace(**over)
    tcfg = get_config(arch, smoke=True).replace(**over)
    level = level or ("fp32" if fp32 else "bf16")
    jm = jax_build(jcfg, policy=JaxPolicy(default=level))
    tm = build_model(tcfg, policy=PrecisionPolicy(default=level),
                     device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params["embed"] = params["embed"] * np.float32(embed_scale)
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        if name in params["blocks"]["attn"]:
            b = params["blocks"]["attn"][name]
            params["blocks"]["attn"][name] = (
                0.5 * rng.standard_normal(b.shape)).astype(b.dtype)
    _perturb_constant_leaves(params, np.random.default_rng(3))
    lm = tm.empty_params()
    lm.load_state_dict(params_from_jax(params))
    return jcfg, tcfg, jm, tm, params, lm


def _perturb_constant_leaves(tree, rng):
    """In place: every leaf that is all 0 becomes 0.1 N(0, 1), every
    leaf that is all 1 becomes 1 + 0.1 N(0, 1)."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _perturb_constant_leaves(leaf, rng)
        elif not leaf.any() or (leaf == 1).all():
            base = 1.0 if leaf.any() else 0.0
            tree[key] = (base + 0.1 * rng.standard_normal(leaf.shape)
                         ).astype(leaf.dtype)


def _run_both(arch, fp32):
    jcfg, tcfg, jm, tm, params, lm = _models(arch, fp32)
    cdt = (jnp.float32, torch.float32) if fp32 else (jnp.bfloat16,
                                                      torch.bfloat16)
    kw = dict(page_size=PS, n_pages=SLOTS * BLOCKS + 1, max_slots=SLOTS,
              max_blocks=BLOCKS)
    jcache, _ = jax_init_cache(jcfg, JaxPCfg(**kw), cdt[0])
    tcache = init_paged_cache(tcfg, PagedCacheConfig(**kw), cdt[1],
                              device="cpu")
    jblocks = jcache["blocks"]
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    bt = np.zeros((SLOTS, BLOCKS), np.int32)
    bt[0] = [1, 2, 3, 4]
    bt[1] = [5, 6, 7, 0]
    bt[2] = [9, 10, 11, 12]                      # row 3 idle: scratch page
    steps = []
    # 1) ragged admission prefill, an idle row included
    lens = np.asarray([12, 9, 16, 0], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (SLOTS, 16)).astype(np.int32)
    steps.append(("prefill", toks, bt.copy(), np.zeros(SLOTS, np.int32),
                  lens))
    # 2) one decode step at each request's length
    steps.append(("decode", rng.integers(0, jcfg.vocab_size, (SLOTS, 1)
                                         ).astype(np.int32), bt.copy(),
                  lens.copy(), None))
    # 3) a new request in row 3 sharing row 0's first (full) page: its
    #    suffix starts at offset 8 and attends the page step 1 wrote
    bt3 = bt.copy()
    bt3[3] = [1, 13, 14, 0]
    toks3 = np.zeros((SLOTS, 8), np.int32)
    toks3[3, :6] = rng.integers(0, jcfg.vocab_size, 6)
    steps.append(("prefill", toks3, bt3, np.asarray([0, 0, 0, 8], np.int32),
                  np.asarray([0, 0, 0, 6], np.int32)))
    out = []
    for kind, tk, b, sl, pl in steps:
        jc = {"blocks": jblocks, "block_tables": jnp.asarray(b),
              "seq_lens": jnp.asarray(sl)}
        tc = {"blocks": tcache["blocks"], "block_tables": torch.from_numpy(b),
              "seq_lens": torch.from_numpy(sl)}
        if pl is not None:
            jc["prefill_lens"] = jnp.asarray(pl)
            tc["prefill_lens"] = torch.from_numpy(pl)
        jl, jnew = JT.lm_apply(jm.ctx(decode=True), jcfg, jparams,
                               jnp.asarray(tk), cache=jc)
        jblocks = jnew["blocks"]
        with torch.no_grad():
            tl, _ = T.lm_apply(tm.ctx(decode=True), tcfg, lm,
                               torch.from_numpy(tk), cache=tc)
        valid = (np.arange(tk.shape[1])[None] < pl[:, None]
                 if pl is not None else np.ones(tk.shape, bool))
        out.append((np.asarray(jl, np.float32)[valid],
                    tl.float().numpy()[valid]))
    pools = []
    for name in ("k_pages", "v_pages"):
        # page 0 is the scratch page: both sides park garbage there
        pools.append((np.asarray(jblocks[name].astype(jnp.float32))[:, 1:],
                      tcache["blocks"][name].float().numpy()[:, 1:]))
    return out, pools


ARCHS = ["qwen2_7b", "qwen1p5_110b", "starcoder2_3b", "chameleon_34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_logits_fp32(arch):
    steps, pools = _run_both(arch, fp32=True)
    for ref, got in steps + pools:
        assert ref.shape == got.shape and ref.size
        assert np.max(np.abs(ref - got)) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_logits_bf16(arch):
    steps, pools = _run_both(arch, fp32=False)
    for ref, got in steps:
        assert np.max(np.abs(ref - got)) <= 0.1
    for ref, got in pools:
        assert np.max(np.abs(ref - got)) <= 0.1


def test_uncached_forward_fp32():
    """The uncached branch (chunked MEA over the whole sequence)."""
    jcfg, tcfg, jm, tm, params, lm = _models("qwen2_7b", fp32=True)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 12)
                                             ).astype(np.int32)
    jl, _ = JT.lm_apply(jm.ctx(), jcfg, jax.tree.map(jnp.asarray, params),
                        jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = T.lm_apply(tm.ctx(), tcfg, lm, torch.from_numpy(toks))
    assert np.max(np.abs(np.asarray(jl) - tl.numpy())) <= 1e-4


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


@pytest.mark.parametrize("arch,seed", [("starcoder2_3b", 0),
                                       ("chameleon_34b", 13)])
def test_generate_tokens_equal_jax(arch, seed):
    """Greedy ``generate`` (device loop and host loop) against the JAX
    package's, fp32 activations under the BF16 policy, on the perturbed
    parameters.  The tied head of starcoder2-smoke reads the 0.02-scale
    embedding, whose logits lie too close for a greedy step to be
    decided, so both sides' embedding is scaled by 10; the prompts keep
    a top-2 gap of at least 0.05 at every step (asserted on the port's
    side), above the ~0.01 a bf16 operand's rounding moves a logit
    between the frameworks."""
    _, _, jm, tm, params, lm = _models(arch, True, "bf16", embed_scale=10.0)
    prompts = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    gen, cache_len = 8, 17
    want = np.asarray(jax_generate(jm, jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(prompts), gen, cache_len))
    assert _min_top2_gap(tm, lm, prompts, gen, cache_len) >= 0.05
    for scan in (True, False):
        got = generate(tm, lm, torch.from_numpy(prompts), gen, cache_len,
                       scan=scan)
        assert got.dtype == torch.int32 and got.shape == (2, gen)
        np.testing.assert_array_equal(got.numpy(), want)
