"""Serve one cell with the serving engine's own tracer armed: the program
spans inside ``EngineRun.step`` (``serve.step``, ``serve.plan``,
``serve.admit``, ``serve.dispatch``, ``serve.segment``, ``serve.read``,
``serve.commit``, ...) and the admission planning counts, read over the
window by the span readers of ``perfbench/metrics``.

    python3 perfbench/engine_trace.py --workload <cell> --seeds 101,102 \\
        --seconds 51
    python3 perfbench/engine_trace.py --workload <cell> --seeds 101,102 \\
        --seconds 51 --cost

Without ``--cost``: one run a seed, set up as the benchmark's own runs
are and profiled over the window's first seconds like its ``--trace 1``
run, with the tracer armed.  It prints the span metrics, the card's idle
time by innermost program span (``harness/spans.py``) beside
``trace.reduce``'s idle gaps, the host's own time by span, and the offset
between the tracer's stamps and the trace's copies of the same spans.
With ``--cost``: two untraced windows a seed, tracer off and on in turns,
and the end-to-end rate of each.  No comparison decides ``correct`` here
(the tracer changes no served token).  One process serves every run, so
the kernels build once; one JSON line a run on standard output.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the span readers, and the benchmark's readers of the same intervals
READ = ("admit_plan_ms", "admit_plans_per_admission",
        "device_idle_plan_frac", "device_idle_launch_frac",
        "decode_kernels_per_step", "device_idle_frac", "prefill_ms_per_ktok",
        "decode_step_ms", "prefix_hit_frac")


def serve(cell, seed: int, seconds: float, armed: bool, traced: bool,
          model, params, t_start: float, device="cuda", log=print) -> dict:
    """One window of ``cell`` on ``model``: set-up as ``run_cell``'s, the
    tracer armed or not, the window's first ``TRACE_S`` profiled when
    ``traced``.  Returns the run's line."""
    import torch
    from perfbench.harness import spans as SP
    from perfbench.harness import trace as TR
    from perfbench.harness.cell import TRACE_S, pool
    from perfbench.harness.serve import ServedLoop
    from perfbench.harness.spec import metric_reader
    from perfbench.harness.traffic import Stream
    from perfbench.harness.window import RunRecord, end_to_end
    from repro_torch.serving import (ObservabilityPolicy, PagedServingEngine,
                                     Request)
    from repro_torch.serving.engine import EngineRun
    from repro_torch.serving.observe import Observability

    clock = time.perf_counter
    c, mix = cell.config, cell.traffic
    serving = c["serving"]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stream = Stream(mix, seed, int(c["vocab_size"]),
                    int(serving["page_size"]))
    pcfg = pool(serving, stream)
    engine = PagedServingEngine(model, pcfg, cache_dtype=getattr(
        torch, serving["cache_dtype"]))
    obs = Observability.from_policy(
        ObservabilityPolicy(enabled=armed, trace=armed))
    er = EngineRun(engine, params, clock=clock, obs=obs)
    loop = ServedLoop(er, stream, mix, clock, Request)
    loop.start()
    loop.run_until(n_done=int(mix["warmup_requests"]))
    sync()

    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                          if cuda else [])
        prof = profile(activities=acts)
        # started before the window: a process's first start takes
        # seconds (1.75 s on a CPU host), which would eat a short window
        prof.start()
    w0 = clock()
    setup_s = w0 - t_start
    n_before = len(loop.boundaries)
    trace_sum, traced_b, offsets = None, [], None
    if traced:
        n0 = len(obs.tracer.spans) if armed else 0
        with record_function("bench.trace"), TR.engine_spans(engine):
            loop.span = record_function
            loop.run_until(t_end=w0 + min(TRACE_S, seconds))
            loop.span = contextlib.nullcontext
            sync()
        n1 = len(obs.tracer.spans) if armed else 0
        prof.stop()
        traced_b = loop.boundaries[n_before:]
    loop.run_until(t_end=w0 + seconds)
    sync()
    w1 = clock()
    if traced:
        # read once the window has closed: reading the events takes
        # seconds.  A CPU run has no device trace, but its host spans
        # pair up with the tracer's all the same
        events = prof.profiler.kineto_results.events()
        if cuda:
            trace_sum = TR.reduce(events)
            if armed:
                trace_sum.update(SP.reduce(events))
        if armed:
            offsets = SP.clock_offsets(
                events, [s.record() for s in obs.tracer.spans[n0:n1]])
        del events, prof
    rec = RunRecord(config=c, segment_len=pcfg.segment_len, w0=w0, w1=w1,
                    sent=loop.sent, boundaries=loop.boundaries[n_before:],
                    traced=traced_b, trace=trace_sum)
    out = {"workload": cell.name, "seed": seed, "armed": armed,
           "traced": traced, "boundaries": len(rec.boundaries),
           "end_to_end": end_to_end(rec, setup_s)}
    if armed:
        tr = obs.tracer
        inside = [i for i, s in enumerate(tr.spans)
                  if w0 <= s.start and s.end <= w1]
        rec.spans = [tr.spans[i].record() for i in inside]
        own = tr.self_seconds()
        host: dict[str, float] = {}
        for i in inside:
            host[tr.spans[i].name] = host.get(tr.spans[i].name, 0.0) + own[i]
        out["host_self_s"] = dict(sorted(host.items()))
        plans = [s["detail"] for s in rec.spans if s["name"] == "serve.plan"]
        out["plan_spans"] = [[d["rounds"], d["plans"], len(d["admitted"])]
                             for d in plans]
    out["metrics"] = {}
    for name in READ:
        v = metric_reader(name)(rec)
        if v is not None:
            out["metrics"][name] = v
    if trace_sum is not None:
        out["device"] = {"busy_s": trace_sum["busy_s"],
                         "window_s": trace_sum["window_s"]}
        out["breakdown"] = {k: trace_sum[k] for k in
                            ("idle_by_span", "idle_gaps", "device_ops",
                             "segments", "segment_kernels")
                            if k in trace_sum}
    if offsets is not None:
        out["clock_offset"] = offsets
    log(f"{cell.name} seed {seed} armed {armed} traced {traced}: "
        f"{len(rec.boundaries)} boundaries in {rec.span_s:.3f} s")
    del loop, er, engine, rec
    gc.collect()            # the engine and the loop's wrapper hold a cycle
    if cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from perfbench.harness import model as M
    from perfbench.harness.spec import find_cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = find_cell(args.workload, root=ROOT)
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter() if i else T_START
        weights = M.make_weights(cell.config, seed, "cuda")
        model, params = M.port_model(cell.config, weights, "cuda")
        modes = ([(False, False), (True, False)] if args.cost
                 else [(True, True)])
        if i % 2:
            modes.reverse()
        for armed, traced in modes:
            out = serve(cell, seed, args.seconds, armed, traced, model,
                        params, t0, log=lambda m: print(m, file=sys.stderr))
            out["card"] = torch.cuda.get_device_name(0)
            line = json.dumps(out)
            print(line, flush=True)
            if sink is not None:
                sink.write(line + "\n")
                sink.flush()
            t0 = time.perf_counter()
        del weights, model, params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
