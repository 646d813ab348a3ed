"""Share of the traced part of the window in which no operation ran on
the card while admission planning (``serve.plan``) was the innermost open
program span (``harness/spans.py``: the device trace's copies of the
engine's spans)."""


def read(rec):
    idle = (rec.trace or {}).get("idle_by_span")
    if idle is None or not rec.trace["window_s"]:
        return None
    return idle.get("serve.plan", 0.0) / rec.trace["window_s"]
