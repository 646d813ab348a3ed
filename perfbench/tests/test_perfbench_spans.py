"""The engine's program spans in the benchmark: ``harness/spans.py`` on
hand-made profiler events (idle by innermost ``serve.*`` span, kernels
inside decode segments, the parts summing to ``trace.reduce``'s idle
time), the span readers on records without spans, and a smoke-size run of
``perfbench/engine_trace.py`` on the CPU with the tracer armed."""

import types

import pytest
from torch.autograd import DeviceType

import perfbench_smoke as S
from perfbench import engine_trace as ET
from perfbench.harness import model as M
from perfbench.harness import spans as SP
from perfbench.harness import trace as TR
from perfbench.harness.spec import metric_reader
from perfbench.harness.window import RunRecord

READERS = ["admit_plan_ms", "admit_plans_per_admission",
           "device_idle_plan_frac", "device_idle_launch_frac",
           "decode_kernels_per_step"]


def _ev(name, a, b, dev=False, note=False):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: a, end_ns=lambda: b,
        device_type=lambda: DeviceType.CUDA if dev else DeviceType.CPU,
        is_user_annotation=lambda: note)


# a traced window 0..100 ns: a boundary (10..90) planning (12..30), then a
# segment (40..80) whose read is 70..80; kernels at 35..45 (under the
# step), 50..55 and 60..68 (inside the segment) and a copy at 72..78
EVENTS = [
    _ev("bench.trace", 0, 100, note=True),
    _ev("bench.step", 10, 90, note=True),
    _ev("serve.step", 10, 90, note=True),
    _ev("serve.plan", 12, 30, note=True),
    _ev("serve.segment", 40, 80, note=True),
    _ev("serve.read", 70, 80, note=True),
    _ev("serve.segment", 40, 80, dev=True, note=True),   # the device copy
    _ev("ampere_gemm", 35, 45, dev=True),
    _ev("paged_decode", 50, 55, dev=True),
    _ev("elementwise", 60, 68, dev=True),
    _ev("Memcpy DtoH (Device -> Pinned)", 72, 78, dev=True),
]


def test_idle_goes_to_the_innermost_program_span():
    out = SP.reduce(EVENTS)
    ns = {k: round(v * 1e9) for k, v in out["idle_by_span"].items()}
    # 0..10 and 90..100 outside every program span; 10..12, 30..35 and
    # 80..90 in the step's own time; 12..30 planning; 45..50, 55..60 and
    # 68..70 launching the segment; 70..72 and 78..80 in its read
    assert ns == {"outside": 20, "serve.step": 17, "serve.plan": 18,
                  "serve.segment": 12, "serve.read": 4}
    assert out["segments"] == 1 and out["segment_kernels"] == 2


def test_idle_by_span_sums_to_the_window_idle_time():
    whole = TR.reduce(EVENTS)
    out = SP.reduce(EVENTS)
    assert sum(out["idle_by_span"].values()) == pytest.approx(
        whole["window_s"] - whole["busy_s"], abs=1e-15)


def test_idle_outside_when_no_program_span_is_open():
    events = [_ev("bench.trace", 0, 50, note=True),
              _ev("bench.step", 0, 50, note=True),
              _ev("gemm", 20, 30, dev=True)]
    out = SP.reduce(events)
    assert out["idle_by_span"] == {"outside": pytest.approx(40e-9)}
    assert out["segments"] == 0


def test_spans_past_the_window_and_unclosed_children_are_clipped():
    # a step that began before the window and a child whose stamp ends a
    # nanosecond after its parent's
    events = [_ev("bench.trace", 100, 200, note=True),
              _ev("serve.step", 50, 150, note=True),
              _ev("serve.admit", 120, 151, note=True),
              _ev("serve.step", 160, 260, note=True)]
    out = SP.reduce(events)
    ns = {k: round(v * 1e9) for k, v in out["idle_by_span"].items()}
    assert ns == {"serve.step": 20 + 40, "serve.admit": 30, "outside": 10}


def test_clock_offsets_pair_spans_by_name():
    recorded = [{"name": "serve.step", "start": 1.0e-8},
                {"name": "serve.plan", "start": 1.2e-8},
                {"name": "serve.segment", "start": 4.0e-8},
                {"name": "serve.read", "start": 7.0e-8}]
    off = SP.clock_offsets(EVENTS, recorded)
    assert off["n"] == 4 and off["median_s"] == pytest.approx(0, abs=1e-12)
    with pytest.raises(RuntimeError):
        SP.clock_offsets(EVENTS, recorded[:3])


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_without_spans(name):
    read = metric_reader(name)
    rec = RunRecord(config={}, segment_len=8, w0=0.0, w1=1.0, sent=[],
                    boundaries=[])
    assert read(rec) is None
    # a device trace reduced by trace.reduce alone
    rec.trace = {"window_s": 1.0, "busy_s": 0.5, "kernel_s": {},
                 "device_ops": [], "idle_gaps": []}
    assert read(rec) is None


def test_readers_read_spans_and_the_reduction():
    rec = RunRecord(config={}, segment_len=8, w0=0.0, w1=1.0, sent=[],
                    boundaries=[])
    rec.spans = [
        {"name": "serve.plan", "start": 0.1, "end": 0.13,
         "detail": {"plans": 40, "rounds": 40, "admitted": [1, 2]}},
        {"name": "serve.plan", "start": 0.5, "end": 0.51,
         "detail": {"plans": 2, "rounds": 1, "admitted": []}},
        {"name": "serve.segment", "start": 0.6, "end": 0.7, "detail": {}}]
    rec.trace = {"window_s": 2.0, "busy_s": 0.5,
                 "idle_by_span": {"serve.plan": 0.4, "serve.dispatch": 0.1,
                                  "serve.segment": 0.3, "serve.read": 0.05},
                 "segments": 3, "segment_kernels": 2400}
    got = {n: metric_reader(n)(rec) for n in READERS}
    assert got == pytest.approx({
        "admit_plan_ms": 40.0 / 2, "admit_plans_per_admission": 42 / 2,
        "device_idle_plan_frac": 0.2, "device_idle_launch_frac": 0.2,
        "decode_kernels_per_step": 100.0})


def test_armed_smoke_run_reads_the_host_spans():
    cell = S.smoke_cell("qwen2-7b.docqa-closed")
    weights = M.make_weights(cell.config, 20240601, "cpu")
    model, params = M.port_model(cell.config, weights, "cpu")
    out = ET.serve(cell, 20240601, 1.5, True, True, model, params,
                   ET.time.perf_counter(), device="cpu", log=lambda m: None)
    m = out["metrics"]
    assert m["admit_plan_ms"] > 0 and m["admit_plans_per_admission"] >= 1
    # no device trace on the CPU: the device readers stay silent
    assert not {"device_idle_plan_frac", "device_idle_launch_frac",
                "decode_kernels_per_step", "device_idle_frac"} & set(m)
    assert "serve.plan" in out["host_self_s"]
    assert out["clock_offset"]["n"] > 0
    rounds, plans, admitted = map(sum, zip(*out["plan_spans"]))
    assert rounds >= 1 and plans >= admitted >= 1
    off = ET.serve(cell, 20240601, 0.5, False, False, model, params,
                   ET.time.perf_counter(), device="cpu", log=lambda m: None)
    assert "admit_plan_ms" not in off["metrics"]
    assert off["end_to_end"]["tokens_per_s"] > 0
