"""Device kernels that start inside the traced decode segments (the
engine's ``serve.segment`` spans, ``harness/spans.py``) per decode step:
the launches a step of ``PagedServingEngine._segment`` costs the host."""


def read(rec):
    t = rec.trace or {}
    steps = t.get("segments", 0) * rec.segment_len
    return t["segment_kernels"] / steps if steps else None
