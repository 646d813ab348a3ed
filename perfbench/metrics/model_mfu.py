"""The model FLOPs the window's served work needs (admissions and decode
steps, ``perfbench/harness/work.py``) over the window's seconds times the
H100's published bf16 peak, in percent."""

from perfbench.harness import work as W


def read(rec):
    flops = sum(W.boundary_flops(rec.config, b) for b in rec.boundaries)
    return 100.0 * flops / (rec.span_s * W.PEAK["bf16_flops"]) \
        if flops else None
