"""The port's PagedServingEngine on the CPU against the JAX package's
engine: the same requests must produce the same greedy tokens, exactly.

Both sides run qwen2-smoke with the same parameters (JAX init, QKV biases
made non-zero, moved with ``params_from_jax``), fp32 activations, the
FP32 policy and an fp32 cache, so the only differences are fp32
summation orders — far below the gaps between the top logits.  Four
runs: a burst, a shared-prefix burst with a copy-on-write tail fork, an
oversubscribed pool with preemption and restore, and seeded chaos, where
the same ``FaultPlan`` must also fire at the same opportunities in both
packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import PagedCacheConfig as JaxPCfg
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.resources import SwapState as JaxSwap
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.api import build_model
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving import (FaultPlan, PagedCacheConfig,
                                 PagedServingEngine, Request, SwapState)
from repro_torch.serving.engine import greedy_argmax


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config("qwen2_7b", smoke=True).replace(act_dtype="float32")
    tcfg = get_config("qwen2_7b", smoke=True).replace(act_dtype="float32")
    jm = jax_build(jcfg, policy=JaxPolicy(default="fp32"))
    tm = build_model(tcfg, policy=PrecisionPolicy(default="fp32"),
                     device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        b = params["blocks"]["attn"][name]
        params["blocks"]["attn"][name] = (
            0.5 * rng.standard_normal(b.shape)).astype(b.dtype)
    lm = tm.empty_params()
    lm.load_state_dict(params_from_jax(params))
    return jm, jax.tree.map(jnp.asarray, params), tm, lm


def _serve(pair, pcfg_kw, prompts, gens, fault_seed=None):
    """Run both engines on the same requests; returns per side
    ({rid: tokens}, stats, fault plan)."""
    jm, jparams, tm, lm = pair
    out = {}
    for side in ("jax", "torch"):
        if side == "jax":
            eng = JaxEngine(jm, JaxPCfg(**pcfg_kw), cache_dtype=jnp.float32)
            mk, fp, p = JaxRequest, JaxFaultPlan, jparams
        else:
            eng = PagedServingEngine(tm, PagedCacheConfig(**pcfg_kw),
                                     cache_dtype=torch.float32)
            mk, fp, p = Request, FaultPlan, lm
        plan = (None if fault_seed is None
                else fp.seeded(fault_seed, rate=0.3, max_fires=2))
        reqs = [mk(rid=i, prompt=np.asarray(pr, np.int32).copy(),
                   max_new_tokens=g)
                for i, (pr, g) in enumerate(zip(prompts, gens))]
        stats = eng.run(reqs, p, faults=plan)
        out[side] = ({r.rid: list(r.tokens) for r in reqs}, stats, plan)
    return out["jax"], out["torch"]


STAT_KEYS = ("n_finished", "n_dead_lettered", "n_segments",
             "n_prefill_dispatches", "n_restore_dispatches", "preemptions",
             "restores", "prefix_hits", "prefix_tokens_matched",
             "pages_allocated_total", "pages_shared_total")


def _same(j, t):
    assert t[0] == j[0]
    assert {k: t[1][k] for k in STAT_KEYS} == {k: j[1][k] for k in STAT_KEYS}


def _prompts(seed, n, length, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length) for _ in range(n)]


def test_burst(pair):
    j, t = _serve(pair, dict(page_size=8, n_pages=16, max_slots=3,
                             max_blocks=4, segment_len=4),
                  _prompts(1, 4, 16), [3, 11, 7, 5])
    _same(j, t)
    assert t[1]["n_finished"] == 4


def test_shared_prefix_burst_with_cow(pair):
    """Three requests with one 13-token prompt (a full page + a 5-token
    tail): the first two share the full page in one admission; the third
    is admitted mid-owner and forks the owner's tail copy-on-write."""
    prompt = _prompts(2, 1, 13)[0]
    j, t = _serve(pair, dict(page_size=8, n_pages=32, max_slots=2,
                             max_blocks=4, segment_len=2),
                  [prompt] * 3, [14, 2, 5])
    _same(j, t)
    assert t[1]["prefix_tokens_matched"] >= 8 + 12


def test_oversubscribed_preempt_restore(pair):
    j, t = _serve(pair, dict(page_size=8, n_pages=13, max_slots=4,
                             max_blocks=4, segment_len=4),
                  _prompts(23, 4, 16), [12] * 4)
    _same(j, t)
    assert t[1]["preemptions"] >= 1 and t[1]["restores"] >= 1


def test_seeded_chaos(pair):
    j, t = _serve(pair, dict(page_size=8, n_pages=7, max_slots=2,
                             max_blocks=4, segment_len=4),
                  _prompts(40, 3, 16), [8] * 3, fault_seed=0)
    _same(j, t)
    jplan, tplan = j[2], t[2]
    assert tplan.total_fires > 0
    assert tplan.log == jplan.log
    assert tplan.opportunities == jplan.opportunities


def test_swap_image_bytes_equal_jax_bf16():
    """A bf16 host swap image is byte-identical to the JAX package's for
    the same page contents, so its checksum is too."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**16, (2, 5, 4, 1, 8)).astype(np.uint16)
    bits &= 0x7F7F                   # finite values only
    pages = [2, 4, 1]
    swaps = {}
    jpool = jnp.asarray(bits.view(jnp.bfloat16))
    jeng = JaxEngine.__new__(JaxEngine)
    swaps["jax"] = JaxSwap(pages=list(pages), n_tokens=10, slot=0)
    jeng._swap_out({"blocks": {"k_pages": jpool, "v_pages": jpool}},
                   swaps["jax"])
    tpool = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    teng = PagedServingEngine.__new__(PagedServingEngine)
    teng.device = torch.device("cpu")
    swaps["torch"] = SwapState(pages=list(pages), n_tokens=10, slot=0)
    teng._swap_out({"blocks": {"k_pages": tpool, "v_pages": tpool}},
                   swaps["torch"])
    js, ts = swaps["jax"], swaps["torch"]
    assert ts.host_k.tobytes() == np.asarray(js.host_k).tobytes()
    assert ts.host_k.shape == js.host_k.shape
    assert ts.checksum == js.checksum


def test_greedy_argmax_first_maximal_index():
    x = np.array([[0.0, 3.0, 1.0, 3.0], [np.nan, 1.0, np.nan, 2.0],
                  [-1.0, -1.0, -1.0, -1.0]], np.float32)
    got = greedy_argmax(torch.from_numpy(x)).tolist()
    assert got == np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)).tolist()
    xb = torch.tensor([[1.0, 2.0, 2.0]], dtype=torch.bfloat16)
    assert greedy_argmax(xb).tolist() == [1]
