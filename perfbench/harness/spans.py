"""The serving engine's own boundary spans in a traced run.

With its tracer armed (``ObservabilityPolicy(enabled=True, trace=True)``)
the port opens a ``torch.profiler.record_function`` range for each of its
spans (``serve.step``, ``serve.plan``, ``serve.admit``, ``serve.dispatch``,
``serve.segment``, ``serve.read``, ...; ``serving/engine.py``), so the
profiler's events carry them on the device trace's clock.  :func:`reduce`
reads the same raw events as ``trace.reduce``, over the same traced window:

- the device's idle time under each innermost open program span, idle
  outside every program span under :data:`OUTSIDE` (the parts sum to the
  window's idle time, ``window_s - busy_s`` of ``trace.reduce``);
- the device kernels that start inside ``serve.segment`` spans, and the
  number of those spans.

:func:`clock_offsets` pairs the kineto copies of the spans with the
tracer's in-memory ``time.perf_counter`` stamps of the same spans.
"""

from __future__ import annotations

import bisect
import statistics

from perfbench.harness.trace import merge

PREFIX = "serve."
OUTSIDE = "outside"
SEGMENT = "serve.segment"
# device operations of the trace that are copies or fills, not kernels
NOT_KERNELS = ("Memcpy", "Memset")


def split(events, window_span: str = "bench.trace"):
    """(window (start, end), device operations [(start, end, name)],
    program spans [(start, end, name)]) of the raw profiler events, in
    ns; device operations as ``trace.reduce`` counts them."""
    from torch.autograd import DeviceType
    dev, spans, window = [], [], None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith(PREFIX):
            spans.append((e.start_ns(), e.end_ns(), name))
        elif name == window_span:
            window = (e.start_ns(), e.end_ns())
    if window is None:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    return window, dev, sorted(spans, key=lambda s: (s[0], -s[1]))


def innermost(spans, w0: int, w1: int) -> list:
    """[(start, end, name)] covering [w0, w1] in order, each piece named
    by the innermost of the nested ``spans`` open over it (sorted by
    start, outer first at equal starts), :data:`OUTSIDE` where none is."""
    out, stack, t = [], [], w0

    def emit(b, name):
        nonlocal t
        b = min(max(b, w0), w1)
        if b > t:
            out.append((t, b, name))
            t = b

    for s0, s1, name in spans:
        while stack and stack[-1][0] <= s0:
            emit(*stack.pop())
        emit(s0, stack[-1][1] if stack else OUTSIDE)
        if stack:
            s1 = min(s1, stack[-1][0])     # a child closes inside its parent
        stack.append((s1, name))
    while stack:
        emit(*stack.pop())
    emit(w1, OUTSIDE)
    return out


def idle_by_span(busy, pieces, w0: int, w1: int) -> dict[str, int]:
    """ns of [w0, w1] outside the merged ``busy`` intervals, by the name of
    the ``pieces`` (:func:`innermost`) they fall in."""
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, min(a, w1)))
        t = max(t, b)
    out: dict[str, int] = {}
    i = 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                out[name] = out.get(name, 0) + ov
            j += 1
    return out


def reduce(events, window_span: str = "bench.trace") -> dict:
    """Program spans over the traced window, in seconds: ``idle_by_span``
    (device idle by innermost open ``serve.*`` span), ``segments`` (the
    ``serve.segment`` spans inside the window) and ``segment_kernels``
    (device kernels starting inside them)."""
    (w0, w1), dev, spans = split(events, window_span)
    busy = merge((max(a, w0), min(b, w1)) for a, b, _ in dev
                 if b > w0 and a < w1)
    idle = idle_by_span(busy, innermost(spans, w0, w1), w0, w1)
    segs = [(a, b) for a, b, n in spans
            if n == SEGMENT and w0 <= a and b <= w1]
    starts = sorted(a for a, _, n in dev if not n.startswith(NOT_KERNELS))
    kernels = sum(bisect.bisect_left(starts, b)
                  - bisect.bisect_left(starts, a) for a, b in segs)
    return {"idle_by_span": {k: v / 1e9 for k, v in sorted(idle.items())},
            "segments": len(segs), "segment_kernels": kernels}


def clock_offsets(events, recorded: list) -> dict:
    """The kineto copy's start minus the tracer's stamp, in seconds, of
    each program span the profiler saw, paired in order with
    ``recorded`` (the tracer's span records opened while it ran).  Raises
    where the two lists disagree on the spans' names."""
    _, _, kin = split(events)
    mem = sorted(recorded, key=lambda r: r["start"])
    if [n for _, _, n in kin] != [r["name"] for r in mem]:
        raise RuntimeError(f"{len(kin)} kineto spans and {len(mem)} "
                           f"recorded spans do not pair up by name")
    # whole ns first: the trace's stamps are too large for a float's 53 bits
    off = [(a - round(r["start"] * 1e9)) / 1e9
           for (a, _, _), r in zip(kin, mem)]
    if len(off) < 2:
        return {"n": len(off), "median_s": off[0] if off else None}
    q1, q2, q3 = statistics.quantiles(off, n=4)
    # a drift of one clock against the other shows as a slope over time
    slope = statistics.linear_regression([r["start"] for r in mem],
                                         off).slope
    return {"n": len(off), "median_s": q2, "iqr_s": q3 - q1,
            "range_s": max(off) - min(off), "drift_s_per_s": slope}
