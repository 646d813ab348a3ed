"""The port's dry run (Lower → Compile → Roofline) and SHARDING-SEARCH.

- ``_cell_model_flops`` equals the JAX package's for every (arch, shape);
- the roofline arithmetic with the H100's constants and its report;
- ``lower_cell`` and the dry-run flow on a placeholder world of 256
  ranks (a subprocess: the ``"fake"`` process group is the process's
  default group): one rank's FLOPs times the chips cover the unsharded
  program's, collectives are counted where something is sharded, the
  memory estimate is the arguments' bytes plus the trace's peak;
- SHARDING-SEARCH's greedy descent and its ``require_fit`` penalty with a
  stubbed probe (its decisions rest on another cost model than the
  reference's, so they are not compared).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCH_IDS
from repro.launch import dryrun as jdry
from repro_torch.configs.base import SHAPES
from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as R
from repro_torch.tasks.handle import DNNHandle
from repro_torch.tasks.sharding_search import ShardingSearch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_model_flops_equals_jax(arch):
    for name in SHAPES:
        assert tdry._cell_model_flops(arch, SHAPES[name]) == \
            jdry._cell_model_flops(arch, JSHAPES[name])


def _compiled(flops, byts, coll, arg=10e9, temp=5e9):
    stats = R.CollectiveStats({"all-gather": coll}, {"all-gather": 3})
    return tdry.Compiled(flops=flops, bytes=byts, collectives=stats,
                         comm_counts={"all_gather_into_tensor": 3},
                         memory=tdry.MemoryAnalysis(arg, 0, temp), seconds=0)


class _Mesh:
    def size(self):
        return 256


def test_roofline_terms_and_report():
    """Each term is its count over the H100's rate; the bound is the
    largest; MODEL/HLO and the MFU bound as the reference defines them;
    the HBM check against 80 GB."""
    assert R.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                    "link_bw": 450e9, "hbm_bytes": 80e9}
    r = R.roofline(_compiled(989e12, 6.7e12, 45e9), _Mesh(),
                   model_flops=989e12 * 128)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(2.0)
    assert r["collective_s"] == pytest.approx(0.1)
    assert r["dominant"] == "memory_s" and r["bound_s"] == r["memory_s"]
    assert r["useful_flops_fraction"] == pytest.approx(0.5)
    assert r["mfu_bound"] == pytest.approx(0.25)
    assert r["memory"]["peak_bytes"] == 15e9 and r["fits_hbm"]
    assert r["collective_counts"] == {"all-gather": 3}
    assert not R.roofline(_compiled(1, 1, 1, arg=79e9, temp=2e9),
                          _Mesh())["fits_hbm"]
    text = R.format_roofline("cell", r)
    assert "chips=256" in text and "dominant: memory_s" in text
    assert "fits80GB=True" in text and "2000.000 ms" in text
    assert r["raw_flops"] == 989e12 and not r["scan_corrected"]


SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch.configs.base import SMOKE_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategies import dryrun_flow, run
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.roofline import DryRunCounter
    from repro_torch.models.api import build_model
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_train_step)
    from repro_torch.optim.optimizers import adamw
    smoke = get_config("qwen2_7b", smoke=True)
    ov = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
          if f.name != "name"}
    out = {}
    for shape in ("train_4k", "decode_32k"):
        sh = SMOKE_SHAPES[shape]
        lowered, mesh, model, aux = D.lower_cell("qwen2_7b", sh,
                                                 cfg_overrides=ov)
        c = lowered.compile()
        out[shape] = {"flops": c.flops, "chips": mesh.size(),
                      "coll": c.collectives.total_bytes,
                      "counts": c.comm_counts, "arg": c.memory.argument_size_in_bytes,
                      "temp": c.memory.temp_size_in_bytes,
                      "fallbacks": aux["fallbacks"]}
    # the unsharded train step's FLOPs on the same (meta) inputs
    sh = SMOKE_SHAPES["train_4k"]
    m = build_model(smoke, device="meta")
    st = {"params": type(m.abstract_params())(smoke, "meta")}
    from repro_torch.optim.optimizers import tree_map
    tree = st["params"].param_tree(per_block=True)
    f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                         device="meta"), tree)
    st["opt"] = {"step": 0, "m": f32, "v": tree_map(torch.empty_like, f32)}
    batch = {k: torch.zeros(v.shape, dtype=torch.long, device="meta")
             for k, v in m.input_specs(sh).items()}
    cnt = DryRunCounter()
    with cnt:
        make_train_step(m, adamw(3e-4))(st, batch)
    out["unsharded_flops"] = cnt.flops
    meta = run(dryrun_flow("qwen2-7b", "decode_32k", o_tasks="H",
                           task_params={"H": {"shape": "decode_32k",
                                              "verbose": False}}))
    arts = list(meta.models())
    art = meta.latest()
    out["flow"] = {"levels": [a.level for a in arts],
                   "best": meta.get("sharding_search.result")["best"],
                   "probes": len(meta.get("sharding_search.result")["trace"]),
                   "metrics": {k: art.metrics[k] for k in
                               ("arg_bytes", "temp_bytes",
                                "peak_bytes_per_chip")},
                   "bound_s": art.metrics["roofline"]["bound_s"]}
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def placeholder():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [t for t in r.stdout.splitlines() if t.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def test_lower_cell_on_a_placeholder_world(placeholder):
    """qwen2-smoke on the 16 x 16 production mesh: rank 0's FLOPs times
    256 chips cover the unsharded step's (replicated work counts once a
    chip), the sharded parameters and the batch bring collectives, and
    the arguments are one rank's shards."""
    tr = placeholder["train_4k"]
    assert tr["chips"] == 256
    assert tr["flops"] * tr["chips"] >= placeholder["unsharded_flops"] > 0
    assert tr["coll"] > 0 and sum(tr["counts"].values()) > 0
    assert tr["arg"] > 0 and tr["temp"] > 0
    dec = placeholder["decode_32k"]
    assert dec["coll"] > 0 and dec["flops"] > 0


def test_dryrun_flow_lower_compile_roofline(placeholder):
    """ModelGen (meta) → SHARDING-SEARCH over the decode knob → Lower →
    Compile → Roofline at qwen2-7b's full width: three probes, levels in
    order, the compiled artifact's peak = arguments + temporaries."""
    f = placeholder["flow"]
    assert f["levels"][0] == "dnn" and f["levels"][-2:] == ["lowered",
                                                            "compiled"]
    assert f["probes"] == 3
    m = f["metrics"]
    assert m["peak_bytes_per_chip"] == m["arg_bytes"] + m["temp_bytes"]
    assert m["peak_bytes_per_chip"] < R.HW["hbm_bytes"]
    assert f["bound_s"] > 0


def _handle():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    model = build_model(get_config("qwen2_7b", smoke=True), device="meta")
    return DNNHandle(kind="lm", name="qwen2_7b", params=None, model=model)


@pytest.mark.parametrize("require_fit", [True, False])
def test_sharding_search_descent_and_fit_penalty(monkeypatch, require_fit):
    """Greedy coordinate descent over the train knobs with a stubbed
    probe: each knob tried against the incumbent, the lowest score kept;
    a config that does not fit 80 GB is penalised only under
    ``require_fit``."""
    seen = []

    def fake(self, arch, shape, multi_pod, cfg_kw):
        seen.append(dict(cfg_kw))
        bound = {None: 3.0, "dots": 2.0, "full": 2.5, "none": 1.0}[
            cfg_kw["remat"]] / cfg_kw["microbatches"]
        fits = cfg_kw["remat"] != "none"
        peak = 40e9 if fits else 160e9
        return {"bound_s": bound, "dominant": "compute_s",
                "fits_hbm": fits, "memory": {"peak_bytes": peak}}

    monkeypatch.setattr(ShardingSearch, "measure", fake)
    meta = MetaModel()
    src = meta.add_model("qwen2_7b", LEVEL_DNN, _handle())
    task = ShardingSearch(shape="train_4k", require_fit=require_fit,
                          verbose=False)
    [out] = task.execute(meta, [src])
    best = meta.get("sharding_search.result")["best"]
    # 1 base + 3 remat + 2 microbatches + 1 fsdp candidates
    assert len(seen) == 7
    if require_fit:      # "none" (1.0) does not fit: 10 x (2 - 1) added
        assert best == {"remat": "dots", "microbatches": 4,
                        "cache_seq_axis": None, "fsdp": None}
    else:
        assert best["remat"] == "none" and best["microbatches"] == 4
    assert meta.model(out).metrics["n_probes"] == 7
    assert meta.model(out).payload.meta["sharding_config"] == best
