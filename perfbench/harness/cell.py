"""One run of one cell: set-up, the measured window, the traced part,
the metrics and the comparison that decides ``correct``.

``run_cell`` is the whole run below the look for a chip, so the tests
drive it on the CPU at smoke sizes, with faults planted under it.
"""

from __future__ import annotations

import contextlib
import gc
import time

from perfbench.harness import correct as C
from perfbench.harness import model as M
from perfbench.harness import trace as TR
from perfbench.harness.serve import ServedLoop, percentile
from perfbench.harness.spec import Cell, metric_reader
from perfbench.harness.traffic import Stream
from perfbench.harness.window import (RunRecord, attempted_failed,
                                      end_to_end, ttfts_s)

# how long the traced part of a --trace 1 window lasts at most; it ends
# at the first boundary after this
TRACE_S = 3.0


def _ms(s):
    return None if s is None else round(s * 1e3, 3)


def pool(serving: dict, stream: Stream):
    """The paged pool as a deployment reserves it: every slot can hold its
    whole lifetime at the longest prompt and answer, plus the retention
    pages the mix names, plus the scratch page."""
    from repro_torch.serving import PagedCacheConfig
    ps = int(serving["page_size"])
    blocks = -(-(stream.max_prompt_tokens + stream.max_answer_tokens + 1)
               // ps)
    slots = int(serving["max_slots"])
    return PagedCacheConfig(
        page_size=ps, n_pages=slots * blocks + stream.retain_pages + 1,
        max_slots=slots, max_blocks=blocks,
        segment_len=int(serving["segment_len"]),
        prefill_bucket=int(serving["prefill_bucket"]),
        enable_prefix_sharing=True, retain_pages=stream.retain_pages)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             plant=None, control: bool = False, log=print) -> dict:
    """Run ``cell`` and return the result line's object (its ``checks``
    last).  ``plant(engine)``, when given, breaks the engine under the
    timed path (the tests' faults).  ``control`` adds the control's
    reading (``perfbench/control.py``; never in a benchmark run)."""
    import torch
    from repro_torch.serving import PagedServingEngine
    from repro_torch.serving.engine import EngineRun
    from repro_torch.serving.scheduler import Request

    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    c, mix = cell.config, cell.traffic
    serving = c["serving"]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---------------------------------------------------------- set-up
    stream = Stream(mix, seed, int(c["vocab_size"]),
                    int(serving["page_size"]))
    weights = M.make_weights(c, seed, device)
    model, params = M.port_model(c, weights, device)
    pcfg = pool(serving, stream)
    engine = PagedServingEngine(model, pcfg,
                                cache_dtype=getattr(torch,
                                                    serving["cache_dtype"]))
    if plant is not None:
        plant(engine)
    er = EngineRun(engine, params, clock=clock)
    loop = ServedLoop(er, stream, mix, clock, Request)
    loop.start()
    loop.run_until(n_done=int(mix["warmup_requests"]))
    sync()

    # ---------------------------------------------------------- window
    w0 = clock()
    setup_s = w0 - t_start
    n_before = len(loop.boundaries)
    trace_sum, traced = None, []
    if trace:
        from repro_torch.kernels import flash_decode_paged as FDP
        from repro_torch.kernels import flash_prefill_ragged as FPR
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                          if cuda else [])
        launches0 = (FPR.launches, FDP.launches)
        prof = profile(activities=acts)
        prof.start()
        with record_function("bench.trace"), TR.engine_spans(engine):
            loop.span = record_function
            loop.run_until(t_end=w0 + min(TRACE_S, seconds))
            loop.span = contextlib.nullcontext
            sync()
        prof.stop()
        traced = loop.boundaries[n_before:]
        launched = {"flash_prefill_ragged": FPR.launches - launches0[0],
                    "flash_decode_paged": FDP.launches - launches0[1]}
    loop.run_until(t_end=w0 + seconds)
    sync()
    w1 = clock()
    window = loop.boundaries[n_before:]
    # the comparison's sample is of requests sent by the close; where too
    # few of them have finished, those in flight finish, untimed
    want = int(c["correct"]["sample_tokens"])
    loop.drain(want, w1)
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace and cuda:
        # reduced once the window has closed: reading the events takes
        # seconds
        trace_sum = TR.reduce(prof.profiler.kineto_results.events())
        silent = [k for k, n in launched.items()
                  if n and not trace_sum["kernel_s"][k] > 0]
        if silent:
            raise RuntimeError(f"{silent} launched ({launched}) but the "
                               f"trace shows no device time for them")
    if trace:
        del prof

    rec = RunRecord(config=c, segment_len=pcfg.segment_len, w0=w0, w1=w1,
                    sent=loop.sent, boundaries=window,
                    traced=traced, trace=trace_sum)
    attempted, failed = attempted_failed(rec)
    e2e = end_to_end(rec, setup_s)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end
                   if e2e.get(m["name"]) is not None}
    ttft = ttfts_s(rec)
    ttft_n = len(ttft)
    late = [s.t_send - s.t_due for s in rec.sent if rec.inside(s.t_due)]
    log(f"window {rec.span_s:.3f} s, {len(rec.boundaries)} boundaries, "
        f"{attempted} requests due, {ttft_n} first tokens "
        f"(p90 samples beyond: {ttft_n - int(0.9 * ttft_n)}; ms at p50, "
        f"p90, p95: {[_ms(percentile(ttft, q)) for q in (50, 90, 95)]}), "
        f"{sum(s.done for s in rec.sent if rec.inside(s.req.t_done))} "
        f"finished; generator late by at most "
        f"{max(late, default=0.0) * 1e3:.3f} ms")

    # ------------------------------------------ free the program's state
    finished = [s for s in rec.sent if s.done and not s.failed
                and s.t_send <= w1 and s.req.t_done >= w0]
    del loop, er, engine, params, model, rec
    gc.collect()            # the engine and the loop's wrapper hold a cycle
    if cuda:
        torch.cuda.empty_cache()

    # ----------------------------------------------------- correctness
    picked = C.sample(finished, seed, want)
    ctrl = None
    if control:
        cmodel, cparams = M.port_model(c, weights, device, level="fp8")

        def ctrl(toks, pos):
            logits, _ = cmodel.prefill(cparams, {"tokens": toks[None]})
            return logits[0, pos].float()
    r = C.readings(c, weights, [s.req for s in picked], device, ctrl)
    limits = c["correct"]["limits"]
    checks = {name: {"value": r[name], "limit": float(lim)}
              for name, lim in limits.items()}
    ok = all(r[name] <= float(lim) for name, lim in limits.items())
    checks.update({"wrong_requests": {"value": r["wrong"], "limit": 0},
                   "failed_requests": {"value": failed, "limit": 0},
                   "compared_tokens": {"value": r["tokens"], "limit": 1}})
    ok = ok and r["wrong"] == 0 and failed == 0 and r["tokens"] >= 1
    log("readings: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    out = {"correct": bool(ok), "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if trace_sum is not None:
        out["device"]["busy_s"] = trace_sum["busy_s"]
        out["device"]["window_s"] = trace_sum["window_s"]
        out["breakdown"] = {"device_ops": trace_sum["device_ops"],
                            "idle_gaps": trace_sum["idle_gaps"]}
    if control:
        out["readings"] = r
    out["checks"] = checks
    return out

