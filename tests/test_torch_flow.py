"""The port's design flow on the CPU against the JAX package: the
autotuner's cache (format, key, path, backend), its candidate order and
shared-memory filter, the cache read path (``cached_config_info``,
``tile_readback``), ``derive_problems`` on identical handles, the
MODEL-GEN → TUNE flow, and the bench models behind ``DNNHandle``.

Inputs come from numpy seeds or from the JAX package's own parameters,
converted (``convert.py``).  Tolerances: accuracy and resource metrics
exactly equal; bench logits within 1e-4 (fp32; the convolutions run
``F.conv2d`` against ``lax.conv`` in another summation order — on a card
a comparison would also need ``torch.backends.cudnn.allow_tf32 = False``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metamodel import MetaModel as JaxMeta
from repro.kernels import autotune as jat
from repro.sparsity import masks as jmasks
from repro.tasks.handle import DNNHandle as JaxHandle
from repro.tasks.model_gen import ModelGen as JaxModelGen
from repro.tasks.tune import derive_problems as jax_derive
from repro_torch.convert import bench_params_from_jax, params_from_jax
from repro_torch.core.flow import DesignFlow
from repro_torch.core.metamodel import MetaModel
from repro_torch.core.strategies import combined_strategy, run
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import block_sparse_matmul as bsmm
from repro_torch.sparsity import masks as tmasks
from repro_torch.tasks.handle import DNNHandle
from repro_torch.tasks.model_gen import ModelGen
from repro_torch.tasks.tune import Tune, derive_problems

FA_PROBLEM = dict(q_shape=(1, 512, 28, 128), kv_shape=(1, 512, 4, 128),
                  dtype="float32")


@pytest.fixture
def cache_path(tmp_path, monkeypatch):
    # neither package's default cache may leak into its readbacks
    monkeypatch.setenv(jat.CACHE_ENV, str(tmp_path / "jax_default.json"))
    monkeypatch.setenv(tat.CACHE_ENV, str(tmp_path / "port_default.json"))
    tat.clear_memory_cache()
    jat.clear_memory_cache()
    yield str(tmp_path / "autotune.json")
    tat.clear_memory_cache()
    jat.clear_memory_cache()


def fake_timer(schedule):
    """Timer returning scripted µs per call (no kernel runs)."""
    calls = []

    def timer(fn, *, warmup, iters):
        calls.append(fn)
        return schedule(len(calls))

    timer.calls = calls
    return timer


# ---------------------------------------------------------------- cache
def test_cache_round_trip_format_and_key_equal_jax(cache_path):
    prob = tat.flash_attention_problem(**FA_PROBLEM)
    assert prob == jat.flash_attention_problem(**FA_PROBLEM)
    assert tat.cache_key("flash_attention", prob) == \
        jat.cache_key("flash_attention", prob)
    timer = fake_timer(lambda n: 100.0 + n)
    res = tat.tune("flash_attention", prob, cache_path=cache_path,
                   device="cpu", timer=timer, max_trials=4)
    assert not res.cached and len(timer.calls) == 4
    assert res.config == {"block_q": 128, "block_kv": 128} == \
        tat.KERNELS["flash_attention"].default_config
    with open(cache_path) as f:
        data = json.load(f)
    assert data["version"] == jat.CACHE_VERSION == tat.CACHE_VERSION
    (key, entry), = data["entries"].items()
    assert key == jat.cache_key("flash_attention", prob)
    assert entry["backend"] == "cpu" and entry["n_trials"] == 4
    assert entry["smem_budget"] == 232_448
    assert entry["smem_bytes"] == res.trials[0].smem_bytes
    assert set(entry) >= {"config", "us", "n_trials", "iters", "t"}
    tat.clear_memory_cache()                 # next read comes from disk
    res2 = tat.tune("flash_attention", prob, cache_path=cache_path,
                    device="cpu", timer=timer, max_trials=4)
    assert res2.cached and res2.config == res.config
    assert len(timer.calls) == 4


def test_default_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(jat.CACHE_ENV, raising=False)
    monkeypatch.delenv(tat.CACHE_ENV, raising=False)
    assert tat.CACHE_ENV != jat.CACHE_ENV
    assert tat.default_cache_path() != jat.default_cache_path()
    monkeypatch.setenv(jat.CACHE_ENV, str(tmp_path / "jax.json"))
    assert tat.default_cache_path() != str(tmp_path / "jax.json")
    monkeypatch.setenv(tat.CACHE_ENV, str(tmp_path / "port.json"))
    assert tat.default_cache_path() == str(tmp_path / "port.json")


def test_backend_mismatch_is_a_miss(cache_path):
    prob = tat.block_sparse_matmul_problem((128, 256), (256, 384),
                                           torch.bfloat16, max_live=2)
    key = tat.cache_key("block_sparse_matmul", prob)
    tat._store(cache_path, key, {
        "config": {"block_m": 32}, "us": 1.0, "n_trials": 99, "iters": 99,
        "smem_bytes": 0, "smem_budget": 1,
        "backend": "cuda:NVIDIA H100 80GB HBM3", "t": 0.0})
    assert tat.cached_config_info("block_sparse_matmul", prob,
                                  cache_path=cache_path, device="cpu") == \
        ({"block_m": 128}, "default")
    timer = fake_timer(lambda n: 10.0 * n)
    res = tat.tune("block_sparse_matmul", prob, cache_path=cache_path,
                   device="cpu", timer=timer)
    # every candidate timed anew: the bf16 kernel's tiles 128 and 64 (256
    # clamps onto 128 at M = 128)
    assert not res.cached and len(timer.calls) == 2


def test_candidates_default_first_and_cap_keeps_default():
    prob = tat.flash_attention_problem(**FA_PROBLEM)
    cands = tat.enumerate_candidates("flash_attention", prob)
    assert cands[0][0] == {"block_q": 128, "block_kv": 128}
    capped = tat.enumerate_candidates("flash_attention", prob, max_trials=1)
    assert capped == cands[:1]
    for kernel, prob in (
            ("block_sparse_matmul", tat.block_sparse_matmul_problem(
                (128, 3584), (3584, 152064), "bfloat16", max_live=14)),
            ("flash_prefill_ragged", tat.flash_prefill_ragged_problem(
                8, 32, 28, 4, 128, 512, 16, "bfloat16")),
            ("flash_decode_paged", tat.flash_decode_paged_problem(
                8, 28, 4, 128, 512, "bfloat16"))):
        default = tat.KERNELS[kernel].default_config
        assert tat.enumerate_candidates(kernel, prob)[0][0] == default
        assert tat.enumerate_candidates(kernel, prob,
                                        max_trials=1)[0][0] == default
    # block_sparse_matmul at M = 128: 256 clamps onto 128 and is dropped
    bs = tat.enumerate_candidates("block_sparse_matmul", tat.
                                  block_sparse_matmul_problem(
                                      (128, 256), (256, 256), "float32",
                                      max_live=2))
    assert [c for c, _ in bs] == [{"block_m": 128}, {"block_m": 64},
                                  {"block_m": 32}]
    # kernels with no launch parameter: one candidate, their fixed launch
    for kernel, prob in (
            ("quant_matmul", tat.quant_matmul_problem((128, 3584),
                                                      (3584, 152064),
                                                      "bfloat16")),
            ("flash_decode", tat.flash_decode_problem(
                (8, 1, 28, 128), (8, 512, 4, 128), "bfloat16"))):
        assert [c for c, _ in tat.enumerate_candidates(kernel, prob)] == [{}]


def test_no_candidate_over_the_shared_memory_budget_is_timed(cache_path):
    prob = tat.flash_attention_problem(**FA_PROBLEM)
    every = tat.KERNELS["flash_attention"].candidates(prob)
    kept = tat.enumerate_candidates("flash_attention", prob)
    assert len(every) == 16 and len(kept) == 13
    assert all(s <= 232_448 for _, s in kept)
    assert {"block_q": 256, "block_kv": 128} not in [c for c, _ in kept]
    timed = []

    def timer(fn, *, warmup, iters):
        timed.append(fn)
        return 5.0

    res = tat.tune("flash_attention", prob, cache_path=cache_path,
                   device="cpu", timer=timer, max_trials=None,
                   smem_budget=100_000)
    assert len(res.trials) == len(timed) >= 1
    assert all(t.smem_bytes <= 100_000 for t in res.trials)
    assert all(t.smem_budget == 100_000 for t in res.trials)


@pytest.mark.parametrize("kernel,problem,query", [
    ("flash_decode_paged", (8, 28, 4, 128, 512, "bfloat16"),
     (4, 28, 4, 128, 600, "bfloat16")),
    ("flash_prefill_ragged", (8, 32, 28, 4, 128, 512, 16, "bfloat16"),
     (2, 16, 28, 4, 128, 700, 16, "bfloat16")),
    ("flash_attention", None, None),
    ("block_sparse_matmul", None, None),
])
def test_read_path_equals_jax_over_identical_entries(cache_path, tmp_path,
                                                     kernel, problem, query):
    maker = {"flash_decode_paged": "flash_decode_paged_problem",
             "flash_prefill_ragged": "flash_prefill_ragged_problem"}
    if kernel == "flash_attention":
        prob = tat.flash_attention_problem(**FA_PROBLEM)
        other = tat.flash_attention_problem((1, 256, 28, 128),
                                            (1, 256, 4, 128), "float32")
        cfg = {"block_q": 64, "block_kv": 128}
    elif kernel == "block_sparse_matmul":
        prob = tat.block_sparse_matmul_problem((128, 256), (256, 256),
                                               "bfloat16", max_live=2)
        other = dict(prob, m=64)
        cfg = {"block_m": 32}
    else:
        prob = getattr(tat, maker[kernel])(*problem)
        other = getattr(tat, maker[kernel])(*query)
        assert prob == getattr(jat, maker[kernel])(*problem)
        cfg = {"page_size": 32} if kernel == "flash_decode_paged" \
            else {"block_q": 16}
    entry = {"config": cfg, "us": 1.0, "n_trials": 3, "iters": 3,
             "backend": "cpu", "t": 0.0}
    jax_path = str(tmp_path / "jax.json")
    tat._store(cache_path, tat.cache_key(kernel, prob), entry)
    jat._store(jax_path, jat.cache_key(kernel, prob), entry)
    for p in (prob, other):
        want = jat.tile_readback(kernel, p, cache_path=jax_path)
        assert tat.tile_readback(kernel, p, cache_path=cache_path,
                                 device="cpu") == want
        for relax in ((), tuple(sorted(set(prob) - {"dtype"}))[:2]):
            assert tat.cached_config_info(
                kernel, p, cache_path=cache_path, relax=relax,
                device="cpu") == jat.cached_config_info(
                kernel, p, cache_path=jax_path, relax=relax)
    provenance = {tat.tile_readback(kernel, p, cache_path=cache_path,
                                    device="cpu")[1] for p in (prob, other)}
    assert "tuned" in provenance
    if kernel in tat.TILE_RELAX:
        assert "relaxed" in provenance


def test_tuned_dispatchers_run_plain_on_cpu(cache_path):
    """tuned_* tune on the tensors' device (CPU: plain versions, real
    timing) and return what the wrapper returns at the tuned config."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    kidx = torch.tensor([[0, 1], [1, -1]], dtype=torch.int32)
    out = tat.tuned_block_sparse_matmul(x, w, kidx, cache_path=cache_path,
                                        iters=1, warmup=0)
    torch.testing.assert_close(out, bsmm.block_sparse_matmul(x, w, kidx),
                               rtol=0, atol=0)
    q = torch.randn((1, 64, 4, 64), generator=torch.Generator().manual_seed(0))
    k = torch.randn((1, 64, 2, 64), generator=torch.Generator().manual_seed(1))
    got = tat.tuned_flash_attention(q, k, k, cache_path=cache_path, iters=1,
                                    warmup=0)
    from repro_torch.kernels import flash_attention as fa
    torch.testing.assert_close(got, fa.flash_attention(q, k, k), rtol=0,
                               atol=0)
    with open(cache_path) as f:
        entries = json.load(f)["entries"]
    assert {k.split("|")[0] for k in entries} == {"block_sparse_matmul",
                                                  "flash_attention"}
    assert all(e["backend"] == "cpu" for e in entries.values())


def test_entry_points_raise_without_cuda(monkeypatch, cache_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = tat.block_sparse_matmul_problem((128, 256), (256, 256),
                                           "float32", max_live=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tat.tune("block_sparse_matmul", prob, cache_path=cache_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelGen(model="jet_dnn", train_en=False).run(MetaModel(), [])
    # the paged_segment runner runs on the CPU (plain versions), as every
    # runner does; only tuning on a missing card raises
    prob = tat.paged_segment_problem(2, 4, 2, 8, 32, 8, "float32")
    outs = tat.KERNELS["paged_segment"].make_runner(
        prob, {"segment_len": 8}, "cpu")()
    assert tuple(outs.shape) == (8, 2) and outs.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        tat.tune("paged_segment", prob, cache_path=cache_path)


# ------------------------------------------------------- derive_problems
class _Cfg:
    n_heads, n_kv_heads, d_model, head_dim = 4, 2, 128, 0

    @property
    def hd(self):
        return 32


class _Model:
    cfg = _Cfg()


def test_derive_problems_toy_lm_and_masked_weight_equal_jax(cache_path):
    jh = JaxHandle(kind="lm", name="toy", params={"w": jnp.zeros((128, 128))},
                   model=_Model())
    th = DNNHandle(kind="lm", name="toy",
                   params={"w": torch.zeros((128, 128))}, model=_Model())
    assert derive_problems(th, max_problems=4, device="cpu") == \
        jax_derive(jh, max_problems=4)
    w = np.random.default_rng(0).standard_normal((256, 384)).astype(
        np.float32)
    jmask = jmasks.block_mask(jnp.asarray(w), 0.5)
    tmask = tmasks.block_mask(torch.from_numpy(w), 0.5)
    jh = JaxHandle(kind="bench", name="m", params={"w": jnp.asarray(w)},
                   masks={"w": jmask})
    th = DNNHandle(kind="bench", name="m", params={"w": torch.from_numpy(w)},
                   masks={"w": tmask})
    got = derive_problems(th, device="cpu")
    assert got == jax_derive(jh)
    assert [p["kernel"] for p in got] == ["quant_matmul",
                                          "block_sparse_matmul"]


@pytest.fixture(scope="module")
def qwen_smoke():
    """JAX and port MODEL-GEN handles of qwen2-smoke, the port's carrying
    the JAX parameters."""
    jm = JaxMeta()
    jname = JaxModelGen(model="qwen2-7b", smoke=True,
                        train_en=False).run(jm, [])[0]
    jh = jm.model(jname).payload
    tm = MetaModel()
    tname = ModelGen(model="qwen2-7b", smoke=True, train_en=False,
                     device="cpu").run(tm, [])[0]
    th = tm.model(tname).payload
    th.params.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           jh.params)))
    return jh, th


def test_lm_handle_path_view_matches_jax_pytree(qwen_smoke):
    jh, th = qwen_smoke
    jflat = jmasks.flatten_params(jh.params)
    tflat = tmasks.flatten_params(th.params)
    assert list(tflat) == list(jflat)
    for path, leaf in tflat.items():
        assert tuple(leaf.shape) == tuple(jflat[path].shape), path
        assert tat.dtype_name(leaf.dtype) == jflat[path].dtype.name, path
    assert tmasks.prunable_paths(th.params) == \
        jmasks.prunable_paths(jh.params) == ["lm_head"]
    assert th.resource_metrics() == jh.resource_metrics()


def test_stacked_vectors_prune_like_jax(cache_path):
    """At 20 layers qwen2-smoke's stacked q bias (20, 56) reaches
    prunable size, as Qwen2-7B's (28, 3584) does: a 2-D leaf of the JAX
    pytree, so both packages block-mask it, and the masked LM masks each
    layer's bias with its row."""
    from repro.configs.registry import get_config as jax_config
    from repro.models.api import build_model as jax_build
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    jp = jax_build(jax_config("qwen2-7b", smoke=True).replace(
        n_layers=20)).init(jax.random.PRNGKey(0))
    lm = build_model(get_config("qwen2-7b", smoke=True).replace(n_layers=20),
                     device="cpu").empty_params()
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    assert tmasks.prunable_paths(lm) == jmasks.prunable_paths(jp) == \
        ["blocks/attn/bq", "lm_head"]
    jm, tm = jmasks.build_masks(jp, 0.5, "block"), \
        tmasks.build_masks(lm, 0.5, "block")
    for p in jm:
        np.testing.assert_array_equal(tm[p].numpy(), np.asarray(jm[p]))
    eff = tmasks.apply_masks(lm, tm)
    jeff = jmasks.apply_masks(jp, jm)
    np.testing.assert_array_equal(eff.blocks[3].attn.bq.detach().numpy(),
                                  np.asarray(jeff["blocks"]["attn"]["bq"][3]))
    assert eff.blocks[3].attn.wq is lm.blocks[3].attn.wq


def test_derive_problems_qwen_smoke_equal_jax(qwen_smoke, cache_path):
    jh, th = qwen_smoke
    assert derive_problems(th, max_problems=10, device="cpu") == \
        jax_derive(jh, max_problems=10)
    jm = jmasks.build_masks(jh.params, 0.5, "block")
    tm = tmasks.build_masks(th.params, 0.5, "block")
    assert sorted(tm) == sorted(jm) == ["lm_head"]
    np.testing.assert_array_equal(tm["lm_head"].numpy(),
                                  np.asarray(jm["lm_head"]))
    jc, tc = jh.child(masks=jm), th.child(masks=tm)
    assert derive_problems(tc, max_problems=10, device="cpu") == \
        jax_derive(jc, max_problems=10)
    assert tc.summary_metrics() == jc.summary_metrics()
    # the masked copy shares every parameter but the masked one
    eff = tc.effective_params()
    assert eff.embed is th.params.embed
    assert eff.blocks[0].attn.wq is th.params.blocks[0].attn.wq
    torch.testing.assert_close(eff.lm_head,
                               th.params.lm_head * tm["lm_head"])


def test_tune_derives_jax_problems_from_the_default_cache(qwen_smoke,
                                                         cache_path,
                                                         monkeypatch):
    """The page size behind the prefill and segment problems comes from
    each package's default cache, not from the cache ``Tune`` tunes into:
    with both default caches warm (page size 64 won) and Tune's own cache
    holding another winner (32), the port's Tune derives the JAX
    package's problems."""
    jh, th = qwen_smoke
    pprob = next(p for p in jax_derive(jh, max_problems=10)
                 if p["kernel"] == "flash_decode_paged")
    key = tat.cache_key("flash_decode_paged",
                        {k: v for k, v in pprob.items() if k != "kernel"})

    def entry(page_size):
        return {"config": {"page_size": page_size}, "us": 1.0,
                "n_trials": 5, "iters": 3, "backend": "cpu", "t": 0.0}

    jat._store(jat.default_cache_path(), key, entry(64))
    tat._store(tat.default_cache_path(), key, entry(64))
    tat._store(cache_path, key, entry(32))
    want = jax_derive(jh, max_problems=10)
    assert sorted(p["kernel"] for p in want if "page_size" in p) == \
        ["flash_prefill_ragged", "paged_segment"]
    assert all(p["page_size"] == 64 for p in want if "page_size" in p)
    assert derive_problems(th, max_problems=10, device="cpu") == want
    asked = []

    def fake_tune(kernel, spec, **kw):
        assert kw["cache_path"] == cache_path
        asked.append({"kernel": kernel, **spec})
        return tat.TuneResult(kernel, tat.cache_key(kernel, spec), {}, 1.0,
                              cached=True)

    monkeypatch.setattr(tat, "tune", fake_tune)
    meta = MetaModel()
    meta.add_model("q", "dnn", th)
    Tune(max_problems=10, device="cpu", cache_path=cache_path).run(
        meta, ["q#1"])
    assert asked == want


# ------------------------------------------------------------------ flow
def _tune_flow(cache_path, name):
    flow = DesignFlow(name)
    flow.chain(ModelGen(model="jet_dnn", train_en=False, device="cpu"),
               Tune(max_trials=2, iters=1, max_problems=1, device="cpu",
                    cache_path=cache_path))
    return flow.execute(MetaModel())


def test_model_gen_tune_flow_and_cached_second_run(cache_path):
    meta = _tune_flow(cache_path, "tune-test")
    probes = meta.trace("tune.probe")
    # quant_matmul takes no launch parameter: one candidate, one probe
    assert len(probes) == 1 and probes[0]["kernel"] == "quant_matmul"
    assert all(p["us"] > 0 and p["smem_bytes"] > 0 for p in probes)
    art = meta.latest("dnn")
    assert art.name.endswith("+T#2")
    configs = art.payload.meta["tile_configs"]
    assert configs and meta.get("tune.result")["configs"] == configs
    assert art.metrics["tune.search_steps"] == 1
    meta2 = _tune_flow(cache_path, "tune-test-2")
    probes2 = meta2.trace("tune.probe")
    assert len(probes2) == 1 and probes2[0].get("cached")


def test_tune_task_times_every_block_sparse_candidate(cache_path):
    """Tune over a handle with a block-masked weight on the CPU: one
    probe per candidate of each derived problem, then all cached."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (256, 384)).astype(np.float32))
    handle = DNNHandle(kind="bench", name="m", params={"w": w},
                       masks={"w": tmasks.block_mask(w, 0.5)})
    for cached in (False, True):
        meta = MetaModel()
        meta.add_model("m", "dnn", handle)
        Tune(device="cpu", iters=1, cache_path=cache_path).run(meta, ["m#1"])
        probes = meta.trace("tune.probe")
        kernels = [p["kernel"] for p in probes]
        if cached:
            assert kernels == ["quant_matmul", "block_sparse_matmul"]
            assert all(p["cached"] for p in probes)
        else:
            assert kernels == ["quant_matmul"] + ["block_sparse_matmul"] * 3
            assert [p["config"] for p in probes[1:]] == [
                {"block_m": 128}, {"block_m": 64}, {"block_m": 32}]


def test_combined_strategy_and_untrained_model_gen():
    meta = run(combined_strategy("jet_dnn", "T", task_params={"T": {
        "device": "cpu", "max_problems": 0}},
        model_params={"device": "cpu"}), {"ModelGen.train_en": False})
    assert meta.get("tune.result") == {"configs": {}, "search_steps": 0}
    assert meta.trace("model_gen.train") == []
    # MODEL-GEN trains by default; SHARDING-SEARCH ("H") chains like
    # the other O-tasks
    trained = MetaModel({"ModelGen.train_samples": 256,
                         "ModelGen.train_epochs": 1})
    ModelGen(model="jet_dnn", device="cpu").run(trained, [])
    assert len(trained.trace("model_gen.train")) == 1
    assert [t.name for t in combined_strategy("jet_dnn", "SPH").tasks] == [
        "ModelGen", "Scaling", "Pruning", "ShardingSearch"]


# ---------------------------------------------------- bench models / handle
@pytest.mark.parametrize("granularity", [None, "block", "unstructured"])
@pytest.mark.parametrize("name,scale", [("jet_dnn", 1.0), ("vgg7", 0.25),
                                        ("resnet9", 0.25)])
def test_bench_models_evaluate_and_resources_equal_jax(name, scale,
                                                       granularity):
    jm = JaxMeta()
    jname = JaxModelGen(model=name, train_en=False, scale=scale,
                        train_samples=256).run(jm, [])[0]
    jh = jm.model(jname).payload
    tm = MetaModel()
    tname = ModelGen(model=name, train_en=False, scale=scale,
                     train_samples=256, device="cpu").run(tm, [])[0]
    th = tm.model(tname).payload.child(params=bench_params_from_jax(
        jax.tree.map(np.asarray, jh.params)))
    if granularity is not None:
        jmask = jmasks.build_masks(jh.params, 0.5, granularity)
        tmask = tmasks.build_masks(th.params, 0.5, granularity)
        assert sorted(tmask) == sorted(jmask) and tmask
        for p in tmask:
            np.testing.assert_array_equal(tmask[p].numpy(),
                                          np.asarray(jmask[p]))
        jh, th = jh.child(masks=jmask), th.child(masks=tmask)
    # the first evaluate batch: the shapes JAX has compiled already
    x = jh.test_data[0][:512]
    np.testing.assert_array_equal(th.test_data[0], jh.test_data[0])
    got = th.logits(torch.from_numpy(x)).numpy()
    want = np.asarray(jh.logits(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert th.evaluate() == jh.evaluate()
    assert th.resource_metrics() == jh.resource_metrics()
    assert th.summary_metrics() == jh.summary_metrics()
