"""The SERVE path of the port on the CPU against the JAX package: the
``paged_segment`` runner, the autotuner readbacks (``ServingPlan.resolve``,
``preferred_page_size`` / ``preferred_segment_len``), the SERVE search
space (``candidate_grid``), ``TrafficProfile``, the ``Serve`` O-task and
``serve_strategy`` end to end.

Both packages read equivalent autotune caches (the same entries, backend
``"cpu"``) and run the qwen2-smoke config.  Tolerances: plans, grids,
provenance, request streams and ``serve.result`` equal as dicts (a stub
scorer makes the search deterministic, as the JAX package's own plan tests
do); greedy tokens equal exactly, from fp32 engines on one parameter set
(the JAX init, converted).
"""

import dataclasses
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.metamodel import MetaModel as JaxMeta
from repro.kernels import autotune as jat
from repro.models.api import build_model as jax_build
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving import paged_cache as jpc
from repro.serving.plan import ServingPlan as JaxPlan
from repro.serving.traffic import TrafficProfile as JaxProfile
from repro.tasks.model_gen import ModelGen as JaxModelGen
from repro.tasks.serve import Serve as JaxServe
from repro.tasks.serve import candidate_grid as jax_grid
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.metamodel import MetaModel
from repro_torch.core.strategies import O_TASKS, run, serve_strategy
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import flash_decode_paged as fdp
from repro_torch.models.api import build_model
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving import (PagedServingEngine, ServingPlan,
                                 TrafficProfile, paged_cache as tpc)
from repro_torch.tasks.model_gen import ModelGen
from repro_torch.tasks.serve import Serve, candidate_grid

SLOTS, PROMPT, NEW = 2, 16, 8
CAP = PROMPT + NEW + 1


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's default cache and an explicit one, in ``tmp_path``;
    returns (port path, JAX path) of the explicit pair."""
    monkeypatch.setenv(jat.CACHE_ENV, str(tmp_path / "jax_default.json"))
    monkeypatch.setenv(tat.CACHE_ENV, str(tmp_path / "port_default.json"))
    tat.clear_memory_cache()
    jat.clear_memory_cache()
    yield str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tat.clear_memory_cache()
    jat.clear_memory_cache()


def _cfgs():
    return jax_config("qwen2_7b", smoke=True), \
        get_config("qwen2_7b", smoke=True)


def _store_both(paths, kernel, problem, config):
    entry = {"config": config, "us": 1.0, "n_trials": 5, "iters": 3,
             "backend": "cpu", "t": 0.0}
    tat._store(paths[0], tat.cache_key(kernel, problem), entry)
    jat._store(paths[1], jat.cache_key(kernel, problem), entry)


def _fill(paths, contents, cfg):
    """``tuned``: entries at the resolve problem itself; ``relaxed``: at
    TUNE's proxy shape (8 slots, 512 tokens), as derive_problems keys
    them; ``cold``: none."""
    if contents == "cold":
        return
    slots, max_len = (SLOTS, CAP) if contents == "tuned" else (8, 512)
    adt = cfg.act_dtype
    fprob = tat.flash_decode_paged_problem(slots, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.hd, max_len,
                                           adt)
    _store_both(paths, "flash_decode_paged", fprob, {"page_size": 8})
    gprob = tat.paged_segment_problem(slots, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.hd, max_len, 8, adt)
    _store_both(paths, "paged_segment", gprob, {"segment_len": 4})


# ------------------------------------------------ the paged_segment runner
@pytest.mark.parametrize("segment_len", [2, 4, 8, 16, 32])
def test_paged_segment_runner_launches_and_reads_back(monkeypatch,
                                                      segment_len):
    """SEGMENT_TOKENS launches of flash_decode_paged a call, in segments
    of ``segment_len`` each read back once; the last output is the kernel
    on the last step's mask (the mask advanced one slot a step from half
    full, clamped at capacity)."""
    prob = tat.paged_segment_problem(3, 4, 2, 8, 40, 8, "float32")
    calls = []
    plain = fdp.flash_decode_paged

    def counting(q, kp, vp, bt, mask):
        calls.append(mask.clone())
        return plain(q, kp, vp, bt, mask)

    monkeypatch.setattr(fdp, "flash_decode_paged", counting)
    fn = tat.KERNELS["paged_segment"].make_runner(
        prob, {"segment_len": segment_len}, "cpu")
    outs = fn()
    assert len(calls) == tat.SEGMENT_TOKENS
    assert outs.device.type == "cpu"
    assert tuple(outs.shape) == (segment_len, 3)
    n_live = [int(m[0].sum()) for m in calls]
    assert n_live == [min(20 + 1 + i, 40) for i in range(len(calls))]
    q, kp, vp, bt, _ = tat._inputs("fpd", tat._pj(prob), "cpu", 8)
    want = fdp.flash_decode_paged_plain(q, kp, vp, bt, calls[-1])
    torch.testing.assert_close(outs[-1], want[:, 0, 0, 0], rtol=0, atol=0)
    assert len(fn()) == segment_len      # a second call starts over


def test_tune_paged_segment_counts_every_launch(caches, monkeypatch):
    """TUNE over the runner: launches = trials x (warmup + iters) x
    SEGMENT_TOKENS, the figure chip_smoke.py phase 9 checks on the card."""
    n = [0]
    plain = fdp.flash_decode_paged

    def counting(*a):
        n[0] += 1
        return plain(*a)

    monkeypatch.setattr(fdp, "flash_decode_paged", counting)
    prob = tat.paged_segment_problem(2, 4, 2, 8, 32, 8, "float32")
    res = tat.tune("paged_segment", prob, cache_path=caches[0],
                   device="cpu", iters=2, warmup=1)
    assert len(res.trials) == 5
    assert n[0] == 5 * (1 + 2) * tat.SEGMENT_TOKENS
    assert res.config in [t.config for t in res.trials]


# --------------------------------------------------------------- readbacks
@pytest.mark.parametrize("contents", ["cold", "tuned", "relaxed"])
@pytest.mark.parametrize("knobs", [
    {}, {"page_size": 16}, {"segment_len": 2}, {"page_size_cap": 4},
    {"pool_slots": 1, "prefill_bucket": 4, "retain_pages": 2}])
def test_resolve_equals_jax(caches, contents, knobs):
    jcfg, tcfg = _cfgs()
    _fill(caches, contents, tcfg)
    kw = dict(slots=SLOTS, max_prompt_len=PROMPT, max_new_tokens=NEW,
              **knobs)
    want = JaxPlan.resolve(jcfg, cache_path=caches[1], **kw)
    got = ServingPlan.resolve(tcfg, cache_path=caches[0], device="cpu",
                              **kw)
    assert got.to_dict() == want.to_dict()
    prov = got.provenance
    if not knobs:
        assert prov["page_size"] == prov["segment_len"] == \
            {"cold": "default"}.get(contents, contents)
    if "page_size_cap" in knobs and contents != "cold":
        assert prov["page_size"] == "capped"
    assert ServingPlan.from_dict(json.loads(json.dumps(
        got.to_dict()))) == got


def test_resolve_reads_only_its_backend(caches):
    """A cache entry timed on another backend is no evidence here: the
    readback falls back to the default, as it does in the JAX package."""
    _, tcfg = _cfgs()
    fprob = tat.flash_decode_paged_problem(SLOTS, tcfg.n_heads,
                                           tcfg.n_kv_heads, tcfg.hd, CAP,
                                           tcfg.act_dtype)
    tat._store(caches[0], tat.cache_key("flash_decode_paged", fprob),
               {"config": {"page_size": 64}, "us": 1.0, "n_trials": 5,
                "iters": 3, "backend": "cuda:NVIDIA H100 80GB HBM3"})
    plan = ServingPlan.resolve(tcfg, slots=SLOTS, max_prompt_len=PROMPT,
                               max_new_tokens=NEW, cache_path=caches[0],
                               device="cpu")
    assert plan.provenance["page_size"] == "default"
    assert plan.cache.page_size == tat.DEFAULT_PAGE_SIZE


@pytest.mark.parametrize("contents", ["cold", "tuned", "relaxed"])
def test_preferred_readbacks_equal_jax(caches, contents):
    jcfg, tcfg = _cfgs()
    defaults = (tat.default_cache_path(), jat.default_cache_path())
    _fill(defaults, contents, tcfg)
    for slots, max_len in ((SLOTS, CAP), (4, 300)):
        assert tpc.preferred_page_size(tcfg, slots, max_len,
                                       device="cpu") == \
            jpc.preferred_page_size(jcfg, slots, max_len)
        assert tpc.preferred_segment_len(tcfg, slots, max_len,
                                         device="cpu") == \
            jpc.preferred_segment_len(jcfg, slots, max_len)


def test_prefill_block_q_readback_memo(caches, monkeypatch):
    """The prefill's tuned block_q is read from the default cache once per
    dispatch shape; a store drops the memo, so a later TUNE win shows."""
    prob = tat.flash_prefill_ragged_problem(2, 8, 4, 2, 8, 32, 8,
                                            torch.float32)
    reads = []
    real = tat.tile_readback

    def spy(*a, **k):
        reads.append(a)
        return real(*a, **k)

    monkeypatch.setattr(tat, "tile_readback", spy)
    assert tat.memo_tile_readback("flash_prefill_ragged", prob,
                                  device="cpu") == \
        ({"block_q": 32}, "default")
    tat.memo_tile_readback("flash_prefill_ragged", prob, device="cpu")
    assert len(reads) == 1
    tat._store(tat.default_cache_path(),
               tat.cache_key("flash_prefill_ragged", prob),
               {"config": {"block_q": 16}, "us": 1.0, "n_trials": 4,
                "iters": 3, "backend": "cpu"})
    assert tat.memo_tile_readback("flash_prefill_ragged", prob,
                                  device="cpu") == ({"block_q": 16},
                                                    "tuned")
    assert len(reads) == 2


@pytest.mark.parametrize("shape", [(1, 7, 24), (3, 256, 24), (2, 300, 24),
                                   (5, 24)])
def test_blocked_matmul_is_the_product(shape):
    """The card's multi-token product in fixed 256-row blocks (the last
    padded) is ``x @ w`` in the shape of ``x @ w``; a row's result is the
    same beside one row or hundreds (on the CPU here, fp32, 1e-5)."""
    from repro_torch.models.common import blocked_matmul
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    got = blocked_matmul(x, w)
    assert got.shape == (*shape[:-1], 40)
    torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)
    flat = x.reshape(-1, 24)
    alone = blocked_matmul(flat[:1][None], w)[0, 0]
    assert torch.equal(alone, got.reshape(-1, 40)[0])


# ---------------------------------------------------------- search space
@pytest.mark.parametrize("knobs", [
    {}, {"page_size": 4}, {"segment_len": 2}, {"prefill_bucket": 1},
    {"pool_slots": 1, "page_size": 64, "segment_len": 32}])
def test_candidate_grid_equals_jax(caches, knobs):
    jcfg, tcfg = _cfgs()
    kw = dict(slots=SLOTS, max_prompt_len=PROMPT, max_new_tokens=NEW,
              **knobs)
    jplan = JaxPlan.resolve(jcfg, cache_path=caches[1], **kw)
    tplan = ServingPlan.resolve(tcfg, cache_path=caches[0], device="cpu",
                                **kw)
    want = [p.to_dict() for p in jax_grid(jplan)]
    got = [p.to_dict() for p in candidate_grid(tplan)]
    assert got == want
    assert got[0] == tplan.to_dict()


@pytest.mark.parametrize("prof", [
    dict(name="burst", n_requests=5, prompt_len=24, prefix_share=0.5,
         seed=9),
    dict(name="poisson", n_requests=7, arrival_rate=3.0, prompt_len=20,
         max_new_tokens=6, prefix_share=0.25,
         tenant_mix=(("a", 1.0), ("b", 2.0)), seed=3),
    dict(name="tiny", n_requests=1, prompt_len=2, prefix_share=0.9)])
@pytest.mark.parametrize("page_size", [1, 8])
def test_traffic_requests_equal_jax(prof, page_size):
    jp, tp = JaxProfile(**prof), TrafficProfile(**prof)
    assert tp.to_dict() == jp.to_dict()
    assert TrafficProfile.from_dict({**jp.to_dict(), "future": 1}) == tp
    assert tp.scaled(0.5).to_dict() == jp.scaled(0.5).to_dict()
    for a, b in ((tp, jp), (tp.scaled(0.5), jp.scaled(0.5))):
        got = a.requests(512, page_size=page_size)
        want = b.requests(512, page_size=page_size)
        assert [(r.rid, r.arrival, r.tenant, r.max_new_tokens)
                for r in got] == [(r.rid, r.arrival, r.tenant,
                                   r.max_new_tokens) for r in want]
        for r, w in zip(got, want):
            assert r.prompt.dtype == np.int32
            np.testing.assert_array_equal(r.prompt, np.asarray(w.prompt))


# ------------------------------------------------------------ SERVE task
def stub_scorer(plan, stage):
    """The JAX package's deterministic host-side fitness: a CRC of the
    effective cache config."""
    key = json.dumps(plan.cache.to_dict(), sort_keys=True)
    score = float(zlib.crc32(f"{key}@{stage}".encode()) % 10_000)
    return True, score, {"stub": True}


@pytest.fixture(scope="module")
def smoke_artifacts():
    jm = JaxMeta()
    (jname,) = JaxModelGen(model="qwen2-7b", smoke=True,
                           train_en=False).run(jm, [])
    tm = MetaModel()
    (tname,) = ModelGen(model="qwen2-7b", smoke=True, train_en=False,
                        device="cpu").run(tm, [])
    return (jm, jname), (tm, tname)


@pytest.mark.parametrize("contents", ["cold", "relaxed"])
def test_serve_stub_scorer_result_equals_jax(smoke_artifacts, caches,
                                             tmp_path, contents):
    (jm0, jname), (tm0, tname) = smoke_artifacts
    _, tcfg = _cfgs()
    _fill(caches, contents, tcfg)
    out = {}
    for side, meta0, name, task in (
            ("jax", jm0, jname, JaxServe), ("torch", tm0, tname, Serve)):
        for rep in range(2):
            meta = type(meta0)()
            meta.put(meta0.model(name))
            path = caches[1] if side == "jax" else caches[0]
            art = str(tmp_path / f"{side}{rep}.json")
            (o,) = task(scorer=stub_scorer, slots=SLOTS, cache_path=path,
                        artifact_path=art).run(meta, [name])
            res = meta.get("serve.result")
            with open(art) as f:
                assert json.load(f) == res["plan"]
            assert meta.model(o).payload.meta["serving_plan"] \
                == res["plan"]
            probes = [{k: v for k, v in p.items() if k != "t"}
                      for p in meta.trace("serve.")]
            if rep:
                assert (res, probes) == out[side]      # deterministic
            out[side] = (res, probes)
    assert out["torch"] == out["jax"]
    res = out["torch"][0]
    assert res["n_stage2"] * 2 <= res["n_candidates"]
    assert res["objective"] >= res["default_objective"]
    want = {"cold": "default", "relaxed": "relaxed"}[contents]
    assert res["plan"]["provenance"]["page_size"] in (want, "searched")


def test_serve_strategy_registers_o_task():
    assert O_TASKS["V"] is Serve
    flow = serve_strategy("qwen2-7b", device="cpu",
                          model_params={"smoke": True})
    mg, tune, serve = flow.tasks
    assert mg.params["device"] == "cpu" and tune.params["device"] == "cpu"
    assert mg.params["smoke"] is True and isinstance(serve, Serve)


# ----------------------------------------------------- end to end on CPU
@pytest.fixture(scope="module")
def fp32_pair():
    """The JAX smoke LM and the port's, fp32, on the JAX init."""
    jcfg = jax_config("qwen2_7b", smoke=True).replace(act_dtype="float32")
    tcfg = get_config("qwen2_7b", smoke=True).replace(act_dtype="float32")
    jm = jax_build(jcfg, policy=JaxPolicy(default="fp32"))
    tm = build_model(tcfg, policy=PrecisionPolicy(default="fp32"),
                     device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    lm = tm.empty_params()
    lm.load_state_dict(params_from_jax(params))
    return jm, jax.tree.map(jnp.asarray, params), tm, lm


def test_serve_strategy_end_to_end_tokens_equal_jax(caches, tmp_path,
                                                    fp32_pair):
    """MODEL-GEN → TUNE → SERVE on the CPU with the real replay scorer:
    the gates of the JAX package's serve-flow bench hold, and engines
    built from the emitted plan (cache in fp32) give the JAX engine's
    greedy tokens on the profile's requests."""
    prof = TrafficProfile(name="cpu-serveflow", n_requests=4,
                          prompt_len=16, max_new_tokens=8,
                          prefix_share=0.25, seed=11)
    art = str(tmp_path / "plan.json")
    meta = run(serve_strategy(
        "qwen2-7b", model_params={"smoke": True, "train_en": False},
        tune_params={"max_problems": 3, "max_trials": 4, "iters": 1},
        serve_params={"profile": prof.to_dict(), "slots": SLOTS,
                      "artifact_path": art}, device="cpu"))
    res = meta.get("serve.result")
    assert res["n_stage2"] * 2 <= res["n_candidates"]
    assert res["objective"] >= res["default_objective"] > 0
    with open(art) as f:
        plan = ServingPlan.from_dict(json.load(f))
    assert plan == ServingPlan.from_dict(res["plan"])
    served = meta.model(next(m.name for m in meta.models()
                             if "+V" in m.name))
    eng = PagedServingEngine.from_plan(served.payload.model, plan)
    assert eng.pcfg == plan.cache and eng.plan == plan
    stage2 = [p for p in meta.trace("serve.probe") if p["stage"] == 2]
    assert all(p["feasible"] and p["tokens"] == 4 * 8 for p in stage2)

    jm, jparams, tm, lm = fp32_pair
    plan32 = dataclasses.replace(plan, cache_dtype="float32")
    jplan = JaxPlan.from_dict(plan32.to_dict())
    tokens = {}
    for side, eng, p, prof_ in (
            ("jax", JaxEngine.from_plan(jm, jplan), jparams,
             JaxProfile(**prof.to_dict())),
            ("torch", PagedServingEngine.from_plan(tm, plan32), lm, prof)):
        reqs = prof_.requests(tm.cfg.vocab_size,
                              page_size=plan.cache.page_size)
        st = eng.run(reqs, p)
        assert st["n_finished"] == 4
        tokens[side] = {r.rid: list(r.tokens) for r in reqs}
    assert tokens["torch"] == tokens["jax"]
