"""The port's boundary spans (``serving/observe.py::Observability.span``)
and the admission planning counts, on the CPU: spans nest with parent and
self time, the tracer-off path is the shared no-op (no clock read, no
allocation), one engine boundary records its phases in order with request
ids, the engine's ``prefill_s`` / ``decode_s`` are its spans' durations,
and the deficit-round-robin planner counts one plan and one round per page
of credit a lone queue head waits for."""

import gc
import json
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.api import build_model
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving import (ObservabilityPolicy, PagedCacheConfig,
                                 PagedServingEngine, Request)
from repro_torch.serving import observe as O
from repro_torch.serving.engine import EngineRun
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

def _traced():
    return O.Observability.from_policy(
        ObservabilityPolicy(enabled=True, trace=True))


def test_spans_nest_with_parent_and_self_time(tmp_path):
    obs = _traced().for_replica("r0")
    with obs.span("serve.step", boundary=7):
        with obs.span("serve.plan", rounds=3) as plan:
            time.sleep(0.002)
        with obs.span("serve.segment") as seg:
            with obs.span("serve.read") as read:
                time.sleep(0.002)
    spans = obs.tracer.spans
    assert [s.name for s in spans] == ["serve.step", "serve.plan",
                                       "serve.segment", "serve.read"]
    assert [s.parent for s in spans] == [-1, 0, 0, 2]
    assert all(s.boundary == 7 and s.replica == "r0" for s in spans)
    assert plan.detail == {"rounds": 3} and plan.seconds >= 0.002
    step = spans[0]
    assert step.start <= plan.start <= plan.end <= seg.start
    assert seg.start <= read.start <= read.end <= seg.end <= step.end
    own = obs.tracer.self_seconds()
    assert own[0] == pytest.approx(
        step.seconds - plan.seconds - seg.seconds, abs=1e-12)
    assert own[2] == pytest.approx(seg.seconds - read.seconds, abs=1e-12)
    assert own[3] == read.seconds
    assert obs.tracer.open == []
    # written only on export, beside trace.jsonl
    paths = obs.export(str(tmp_path))
    lines = [json.loads(x) for x in open(paths["spans"])]
    assert [x["name"] for x in lines] == [s.name for s in spans]
    assert lines[1]["detail"] == {"rounds": 3}
    assert lines[3]["parent"] == 2


def test_span_closes_on_an_exception():
    obs = _traced()
    with pytest.raises(RuntimeError):
        with obs.span("serve.step", boundary=1):
            with obs.span("serve.admit"):
                raise RuntimeError("dispatch failed")
    assert obs.tracer.open == []
    assert all(s.end >= s.start > 0 for s in obs.tracer.spans)


def test_spans_reach_the_profiler_as_ranges():
    from torch.profiler import ProfilerActivity, profile
    obs = _traced()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("serve.step", boundary=1):
            with obs.span("serve.plan"):
                torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "serve.step" in names and "serve.plan" in names


def test_tracer_off_is_the_shared_no_op(monkeypatch):
    obs = O.Observability.disabled()
    watch = O.Stopwatch()
    assert obs.span("serve.plan") is O.NULL_SPAN
    assert obs.span("serve.admit", watch) is watch
    reads = []
    real = time.perf_counter
    monkeypatch.setattr(O.time, "perf_counter",
                        lambda: reads.append(1) or real())
    span = obs.span
    for _ in range(64):                      # warm any caches
        with span("serve.grow") as sp:
            sp.set()
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(10_000):
        with span("serve.grow") as sp:
            sp.set()
    grown = sys.getallocatedblocks() - before
    # one block a call would read 10,000; the interpreter's own
    # bookkeeping moves a few
    assert grown <= 8, f"tracer-off span allocated {grown} blocks"
    assert reads == []
    # a timed site keeps exactly one pair of clock reads
    with obs.span("serve.segment", watch) as w:
        pass
    assert len(reads) == 2 and w.seconds == watch.end - watch.start >= 0


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2_7b", smoke=True).replace(act_dtype="float32")
    m = build_model(cfg, policy=PrecisionPolicy(default="fp32"),
                    device="cpu")
    return m, m.init(0)


def _run(model, pcfg, prompts, gens, obs):
    m, params = model
    eng = PagedServingEngine(m, PagedCacheConfig(**pcfg),
                             cache_dtype=torch.float32)
    er = EngineRun(eng, params, obs=obs)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        er.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                          max_new_tokens=g))
    return er


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length) for _ in range(n)]


def test_one_boundary_records_its_phases_in_order(model):
    obs = _traced()
    er = _run(model, dict(page_size=4, n_pages=32, max_slots=2,
                          max_blocks=8, segment_len=4),
              _prompts(1, 2, 7), [6, 6], obs)
    assert er.step() == "ran"
    spans = obs.tracer.spans
    names = [s.name for s in spans]
    assert names == ["serve.step", "serve.recover", "serve.grow",
                     "serve.plan", "serve.admit", "serve.dispatch",
                     "serve.read", "serve.segment", "serve.read",
                     "serve.commit"]
    by = {n: spans[names.index(n)] for n in names}
    assert [spans[s.parent].name for s in spans[1:]] == [
        "serve.step"] * 4 + ["serve.admit", "serve.dispatch",
                             "serve.step", "serve.segment", "serve.step"]
    assert all(s.boundary == 1 for s in spans)
    plan = by["serve.plan"].detail
    assert plan["admitted"] == [0, 1] and plan["plans"] >= 2
    assert plan["rounds"] >= 1
    d = by["serve.dispatch"].detail
    assert d == {"rids": [0, 1], "rows": 2, "s_pad": 8, "shared": 0,
                 "suffix": 14}
    assert by["serve.grow"].detail == {"preempted": [], "pages": 0}
    reg = obs.registry
    assert reg.counter("serving_admission_plans_total", "",
                       ("replica",)).total() == plan["plans"]
    assert reg.counter("serving_admission_rounds_total", "",
                       ("replica",)).total() == plan["rounds"]


def test_prefill_and_decode_seconds_are_their_spans(model):
    """Through preemptions and restores: the engine's two timers are the
    sums of the ``serve.admit`` and ``serve.segment`` durations, and the
    restores and preemptions carry their request ids."""
    obs = _traced()
    er = _run(model, dict(page_size=8, n_pages=13, max_slots=4,
                          max_blocks=4, segment_len=4),
              _prompts(23, 4, 16), [12] * 4, obs)
    while er.has_work:
        er.step()
    spans = obs.tracer.spans
    assert er.n_segments == sum(s.name == "serve.segment" for s in spans)
    assert er.prefill_s == sum(s.seconds for s in spans
                               if s.name == "serve.admit") > 0
    assert er.decode_s == sum(s.seconds for s in spans
                              if s.name == "serve.segment") > 0
    hist = obs.registry.histogram("serving_admission_batch_seconds", "",
                                  ("replica",))
    assert hist.sum(("",)) == pytest.approx(er.prefill_s, rel=1e-12)
    restores = [s for s in spans if s.name == "serve.restore"]
    preempted = [r for s in spans if s.name == "serve.grow"
                 for r in s.detail["preempted"]]
    assert restores and preempted
    assert {s.detail["rid"] for s in restores} <= set(preempted)
    assert all(spans[s.parent].name == "serve.admit" for s in restores)
    assert er.result()["n_finished"] == 4


def test_tracer_off_run_records_nothing_and_keeps_its_timers(model):
    obs = O.Observability.disabled()
    er = _run(model, dict(page_size=4, n_pages=32, max_slots=2,
                          max_blocks=8, segment_len=4),
              _prompts(1, 2, 7), [6, 6], obs)
    assert er.step() == "ran"
    assert obs.tracer is None
    assert er.prefill_s == er._w_admit.seconds > 0
    assert er.decode_s == er._w_segment.seconds > 0


@pytest.mark.parametrize("prompt_len", [5, 23, 60])
def test_lone_head_waits_one_round_and_one_plan_per_page(prompt_len):
    """Quantum 1: a lone fresh head costing N pages is re-planned at every
    round until its credit reaches N, then admitted in round N."""
    pcfg = PagedCacheConfig(page_size=4, n_pages=40, max_slots=2,
                            max_blocks=20, segment_len=4)
    obs = _traced()
    sched = ContinuousBatchingScheduler(pcfg, obs=obs)
    assert sched.rm.quantum == 1.0
    req = Request(rid="head", prompt=np.arange(prompt_len, dtype=np.int32),
                  max_new_tokens=4)
    sched.submit(req)
    n = sched.rm.admission_pages(req)
    assert sched.try_admit() == [req]
    plan = obs.tracer.spans[-1]
    assert plan.name == "serve.plan"
    assert plan.detail["plans"] == plan.detail["rounds"] == n
    assert plan.detail["admitted"] == ["head"]
    assert plan.detail["blocked"] == ({"deficit": n - 1} if n > 1 else {})
    reg = obs.registry
    assert reg.counter("serving_admission_plans_total", "",
                       ("replica",)).total() == n
    assert reg.counter("serving_admission_rounds_total", "",
                       ("replica",)).total() == n
