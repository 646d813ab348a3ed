"""The traced run: ``torch.profiler`` over the first boundaries of the
window, reduced to device busy time, time by device operation and the
idle gaps labelled by what the host was doing.

The benchmark's own spans (``torch.profiler.record_function``) mark the
host's work: ``bench.loop`` (the benchmark's sending and stamping),
``bench.step`` (``EngineRun.step``), inside it ``bench.admit`` (the
admission dispatches) and ``bench.segment`` (launching a decode
segment).  An idle gap takes the innermost span open at its middle.
"""

from __future__ import annotations

import contextlib

SPAN_PREFIX = "bench."

# device operations of the two paged attention kernels, by the names the
# trace gives their CUDA functions
KERNELS = {"flash_prefill_ragged": ("ragged_prefill",),
           "flash_decode_paged": ("paged_decode", "decode_combine")}


@contextlib.contextmanager
def engine_spans(engine):
    """Wrap the engine's admission and segment entry points in spans on
    this instance, for the traced interval only."""
    from torch.profiler import record_function
    admit, segment = engine._admit_batched, engine._segment

    def traced_admit(*a, **k):
        with record_function("bench.admit"):
            return admit(*a, **k)

    def traced_segment(*a, **k):
        with record_function("bench.segment"):
            return segment(*a, **k)

    engine._admit_batched, engine._segment = traced_admit, traced_segment
    try:
        yield
    finally:
        del engine._admit_batched, engine._segment


def _short(name: str) -> str:
    return name.replace("void ", "").strip()[:80]


def merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(events, window_span: str = "bench.trace") -> dict:
    """Reduce the profiler's raw events (``prof.profiler.kineto_results
    .events()``: no event tree is built, which would take minutes for a
    few seconds of decode) to seconds: the traced window, device busy
    time, device time by operation name and by kernel of
    :data:`KERNELS`, and the ten longest idle gaps with their host
    labels.  The device's copies of the host spans (user annotations)
    are not device work."""
    from torch.autograd import DeviceType
    dev, spans, window = [], [], None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith(SPAN_PREFIX):
            if name == window_span:
                window = (e.start_ns(), e.end_ns())
            else:
                spans.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    if not dev:
        raise RuntimeError("the trace holds no device operation: the "
                           "profiler did not trace the card")
    w0, w1 = window
    by_name: dict[str, float] = {}
    for a, b, name in dev:
        key = _short(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    busy = merge((max(a, w0), min(b, w1)) for a, b, _ in dev
                 if b > w0 and a < w1)
    busy_ns = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    spans.sort(key=lambda s: s[1] - s[0])        # innermost first
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        label = next((n for s0, s1, n in spans if s0 <= mid < s1),
                     "bench.outside")
        labelled.append([label, (b - a) / 1e9])
    kernels = {k: sum(b - a for a, b, n in dev if any(p in n for p in pats))
               / 1e9 for k, pats in KERNELS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernel_s": kernels,
            "device_ops": [[n, ns / 1e9] for n, ns in top],
            "idle_gaps": labelled}
