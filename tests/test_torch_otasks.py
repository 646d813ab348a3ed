"""The paper's design flow with training on the CPU against the JAX
package: PRUNING, SCALING and QUANTIZATION alone and combined ("PQ", and
"SPQ", ROADMAP's gate), at the sizes of ``tests/test_tasks.py``, and the
LM PRUNING of its ``TestLMOtasks`` on qwen2-smoke.

Both packages start from one init: the port's bench inits and
``LMModel.init`` are patched to draw the JAX package's for the same seed
(and SCALING's re-inits, seeded ``seed + int(scale * 1e4)``, alike), then
converted (``convert.py``).  Each JAX flow runs once (module fixtures).

What must be equal: every probe's candidate (rate, scale or assignment)
and feasible flag, ``search_steps``, the selected rate / scale /
assignment, and the resource metrics (effective MACs, weight bits,
sparsity).  Accuracies: within 2 test samples (1 % of jet_dnn's 204, 2 of
the LM's 1,024 tokens).  The two packages' fp32 products round apart by
an ulp, Adam carries that to ~6e-6 in the weights after MODEL-GEN's 12
steps, and a magnitude mask whose threshold falls between two weights
that close picks the other one: PRUNING's probe at rate 0.25 then scores
one test sample apart (ROADMAP Queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core import strategies as jstrat
from repro.core.flow import DesignFlow as JaxFlow
from repro.core.metamodel import MetaModel as JaxMeta
from repro.models import api as japi
from repro.models import cnn as jcnn
from repro.sparsity import masks as jmasks
from repro.tasks import quantization as jquant
from repro.tasks.model_gen import ModelGen as JaxModelGen
from repro.tasks.pruning import Pruning as JaxPruning
from repro_torch.convert import bench_params_from_jax, params_from_jax
from repro_torch.core import strategies as tstrat
from repro_torch.core.flow import DesignFlow
from repro_torch.core.metamodel import MetaModel
from repro_torch.models import api as tapi
from repro_torch.models.cnn import BENCH_MODELS
from repro_torch.optim.optimizers import tree_map
from repro_torch.sparsity import masks as tmasks
from repro_torch.tasks import quantization as tquant
from repro_torch.tasks.model_gen import ModelGen
from repro_torch.tasks.pruning import Pruning

CPU = {"device": "cpu"}
GEN = {"ModelGen.train_samples": 1024, "ModelGen.train_epochs": 2}
PQ = {"ModelGen.train_samples": 768, "ModelGen.train_epochs": 2,
      "Pruning.train_epochs": 1, "Pruning.pruning_rate_thresh": 0.2}
SPQ = {**PQ, "Scaling.max_trials_num": 2}
RESOURCES = ("total_macs", "effective_macs", "macs_fraction", "weight_bits",
             "weight_mbytes", "scale", "masked_params", "zeros", "sparsity")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_inits():
    """The port draws the JAX package's inits: bench models by the
    generator's seed, LMs by the seed and the (replaced) config."""
    with pytest.MonkeyPatch.context() as mp:
        for name, (jinit, _, _) in jcnn.BENCH_MODELS.items():
            _, apply_fn, info = BENCH_MODELS[name]

            def init(gen, scale=1.0, _j=jinit):
                key = jax.random.PRNGKey(gen.initial_seed())
                return tree_map(lambda t: t.to(gen.device),
                                bench_params_from_jax(_np(_j(key,
                                                             scale=scale))))
            mp.setitem(BENCH_MODELS, name, (init, apply_fn, info))

        def lm_init(self, seed=0):
            jcfg = JaxArchConfig(**dataclasses.asdict(self.cfg))
            jp = japi.build_model(jcfg).init(jax.random.PRNGKey(seed))
            lm = self.empty_params()
            lm.load_state_dict(params_from_jax(_np(jp)))
            return lm

        mp.setattr(tapi.LMModel, "init", lm_init)
        yield


def _run_both(jflow, tflow, cfg):
    return jflow.execute(JaxMeta(dict(cfg))), tflow.execute(MetaModel(
        dict(cfg)))


def _n_test(meta) -> int:
    handle = next(iter(meta.models("dnn"))).payload
    data = handle.test_data
    return data["labels"].size if handle.kind == "lm" else len(data[0])


def _same_probes(jm, tm, event: str, key: str) -> int:
    """Equal probe candidates and feasible flags, accuracies within two
    test samples, equal resource metrics; returns the probe count."""
    jp, tp = jm.trace(event), tm.trace(event)
    assert len(tp) == len(jp) > 0
    tol = 2 / _n_test(jm) + 1e-12
    for a, b in zip(jp, tp):
        assert b[key] == a[key]
        assert b.get("feasible") == a.get("feasible")
        assert abs(b["accuracy"] - a["accuracy"]) <= tol, (a, b)
        for r in RESOURCES:
            if r in a:
                assert b[r] == a[r], (r, a, b)
    return len(tp)


def _same_result(jm, tm, key: str, *exact: str) -> None:
    ja, ta = jm.get(key), tm.get(key)
    assert sorted(ta) == sorted(ja)
    for k in ("search_steps", *exact, *RESOURCES):
        if k in ja:
            assert ta[k] == ja[k], k
    tol = 2 / _n_test(jm) + 1e-12
    for k in ("accuracy", "base_accuracy"):
        assert abs(ta[k] - ja[k]) <= tol, k
    assert [a.name for a in tm.models("dnn")] == \
        [a.name for a in jm.models("dnn")]


# ----------------------------------------------------------------- flows
@pytest.fixture(scope="module")
def pruned(jax_inits):
    return _run_both(
        jstrat.pruning_strategy("jet_dnn", train_epochs=1,
                                pruning_rate_thresh=0.1),
        tstrat.pruning_strategy("jet_dnn", train_epochs=1,
                                pruning_rate_thresh=0.1, **CPU), GEN)


def test_pruning_strategy_equals_jax(pruned):
    jm, tm = pruned
    strip = lambda ev: [{k: v for k, v in e.items()  # noqa: E731
                         if k not in ("t", "final_loss")} for e in ev]
    assert strip(tm.trace("model_gen")) == strip(jm.trace("model_gen"))
    np.testing.assert_allclose(tm.trace("model_gen.train")[0]["final_loss"],
                               jm.trace("model_gen.train")[0]["final_loss"],
                               rtol=1e-5)
    assert [e["chosen"] for e in tm.trace("pruning.granularity")] == \
        [e["chosen"] for e in jm.trace("pruning.granularity")] == \
        ["unstructured"]
    assert _same_probes(jm, tm, "pruning.probe", "rate") >= 3
    _same_result(jm, tm, "pruning.result", "pruning_rate")
    res = tm.get("pruning.result")
    assert res["pruning_rate"] > 0.2 and res["macs_fraction"] < 0.8
    assert res["base_accuracy"] - res["accuracy"] <= 0.02 + 1e-9
    assert len(tm.lineage(tm.latest("dnn").name)) == 2


def test_pruned_artifact_masks_and_macs_fraction(pruned):
    jm, tm = pruned
    ja, ta = jm.latest("dnn").payload, tm.latest("dnn").payload
    assert sorted(ta.masks) == sorted(ja.masks)
    frac = tmasks.effective_macs_fraction(ta.masks, ta.params)
    assert frac == jmasks.effective_macs_fraction(ja.masks, ja.params)
    assert frac == pytest.approx(tm.get("pruning.result")["macs_fraction"])
    for p, m in ta.masks.items():
        w = tmasks.flatten_params(ta.params)[p]
        assert torch.count_nonzero(w[m == 0]) == 0


@pytest.fixture(scope="module")
def quantized(jax_inits):
    return _run_both(
        jstrat.quantization_strategy("jet_dnn", tolerate_acc_loss=0.02),
        tstrat.quantization_strategy("jet_dnn", tolerate_acc_loss=0.02,
                                     **CPU), GEN)


def test_quantization_strategy_equals_jax(quantized):
    jm, tm = quantized
    assert _same_probes(jm, tm, "quantization.probe", "assignment") >= 4
    assert [p["weight_bits"] for p in tm.trace("quantization.probe")] == \
        [p["weight_bits"] for p in jm.trace("quantization.probe")]
    _same_result(jm, tm, "quantization.result", "assignment")
    res = tm.get("quantization.result")
    gen = next(iter(tm.models("dnn"))).metrics
    assert res["weight_bits"] <= gen["weight_bits"] / 2
    handle = tm.latest("dnn").payload
    jhandle = jm.latest("dnn").payload
    assert handle.policy.as_dict() == {"default": jhandle.policy.default,
                                       "rules": jhandle.policy.rules,
                                       "exempt": jhandle.policy.exempt}
    assert tquant.quantizable_groups(handle) == \
        jquant.quantizable_groups(jhandle) == ["fc0", "fc1", "fc2", "fc3"]


@pytest.fixture(scope="module")
def scaled(jax_inits):
    kw = dict(tolerate_acc_loss=0.2, max_trials_num=2, train_epochs=3)
    return _run_both(jstrat.scaling_strategy("jet_dnn", **kw),
                     tstrat.scaling_strategy("jet_dnn", **kw, **CPU), GEN)


def test_scaling_strategy_equals_jax(scaled):
    jm, tm = scaled
    assert _same_probes(jm, tm, "scaling.probe", "scale") >= 1
    _same_result(jm, tm, "scaling.result", "scale")
    assert tm.get("scaling.result")["scale"] < 1.0
    ja, ta = jm.latest("dnn").payload, tm.latest("dnn").payload
    assert ta.scale == ja.scale and ta.masks is None
    assert {k: tuple(v.shape) for k, v in
            tmasks.flatten_params(ta.params).items()} == \
        {k: tuple(v.shape) for k, v in
         jmasks.flatten_params(ja.params).items()}


@pytest.fixture(scope="module")
def pq(jax_inits):
    return _run_both(jstrat.combined_strategy("jet_dnn", "PQ"),
                     tstrat.combined_strategy("jet_dnn", "PQ",
                                              model_params=CPU), PQ)


def test_pq_combined_equals_jax(pq):
    jm, tm = pq
    _same_probes(jm, tm, "pruning.probe", "rate")
    _same_probes(jm, tm, "quantization.probe", "assignment")
    _same_result(jm, tm, "pruning.result", "pruning_rate")
    _same_result(jm, tm, "quantization.result", "assignment")
    q, p = tm.get("quantization.result"), tm.get("pruning.result")
    assert q["weight_bits"] < p["weight_bits"]


@pytest.fixture(scope="module")
def spq(jax_inits):
    return _run_both(jstrat.combined_strategy("jet_dnn", "SPQ"),
                     tstrat.combined_strategy("jet_dnn", "SPQ",
                                              model_params=CPU), SPQ)


@pytest.mark.parametrize("task,event,key", [
    ("scaling", "scaling.probe", "scale"),
    ("pruning", "pruning.probe", "rate"),
    ("quantization", "quantization.probe", "assignment")])
def test_spq_gate_equals_jax(spq, task, event, key):
    """ROADMAP Queue 1 item 3's gate: Fig. 2(b)'s SCALING → PRUNING →
    QUANTIZATION picks the reference's search steps."""
    jm, tm = spq
    _same_probes(jm, tm, event, key)
    exact = {"scaling": "scale", "pruning": "pruning_rate",
             "quantization": "assignment"}[task]
    _same_result(jm, tm, f"{task}.result", exact)
    assert len(tm.lineage(tm.latest("dnn").name)) == 4


@pytest.fixture(scope="module")
def lm_pruned(jax_inits):
    def flow(gen, prune, **kw):
        f = (JaxFlow if gen is JaxModelGen else DesignFlow)("lm-prune")
        f.chain(gen(model="qwen2_7b", smoke=True, train_en=False, **kw),
                prune(train_epochs=1, pruning_rate_thresh=0.25,
                      tolerate_acc_loss=0.5))
        return f

    return _run_both(flow(JaxModelGen, JaxPruning),
                     flow(ModelGen, Pruning, **CPU), {})


def test_lm_pruning_equals_jax(lm_pruned):
    """TestLMOtasks' LM PRUNING on qwen2-smoke: block masks on lm_head and
    the stacked q bias, fine-tuned 4 steps a probe on seeds 100 + s."""
    jm, tm = lm_pruned
    assert [e["chosen"] for e in tm.trace("pruning.granularity")] == \
        [e["chosen"] for e in jm.trace("pruning.granularity")]
    assert _same_probes(jm, tm, "pruning.probe", "rate") >= 2
    _same_result(jm, tm, "pruning.result", "pruning_rate")
    assert tm.get("pruning.result")["search_steps"] >= 2
    ta, ja = tm.latest("dnn").payload, jm.latest("dnn").payload
    assert sorted(ta.masks) == sorted(ja.masks)
    for p in ta.masks:
        np.testing.assert_array_equal(ta.masks[p].numpy(),
                                      np.asarray(ja.masks[p]))
    assert not any(p.requires_grad for p in ta.params.parameters())


# ------------------------------------------------------------ strategies
def test_combined_strategy_orders_and_refusals():
    names = lambda f: [t.name for t in f.tasks]  # noqa: E731
    assert names(tstrat.combined_strategy("jet_dnn", "SP")) == \
        names(jstrat.combined_strategy("jet_dnn", "SP")) == \
        ["ModelGen", "Scaling", "Pruning"]
    assert names(tstrat.combined_strategy("jet_dnn", "QPSTV")) == \
        ["ModelGen", "Quantization", "Pruning", "Scaling", "Tune", "Serve"]
    assert sorted(tstrat.O_TASKS) == ["H", "P", "Q", "S", "T", "V"]
    # SHARDING-SEARCH and the dry-run flow are ported: the same chains
    assert names(tstrat.combined_strategy("jet_dnn", "PH")) == \
        names(jstrat.combined_strategy("jet_dnn", "PH"))
    assert names(tstrat.dryrun_flow("qwen2-7b")) == \
        names(jstrat.dryrun_flow("qwen2-7b")) == \
        ["ModelGen", "Lower", "Compile", "Roofline"]
    assert names(tstrat.dryrun_flow("qwen2-7b", o_tasks="H")) == \
        names(jstrat.dryrun_flow("qwen2-7b", o_tasks="H"))
