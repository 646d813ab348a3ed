"""Share of the traced part of the window in which no operation ran on
the card (from the profiler's device trace)."""


def read(rec):
    if rec.trace is None or not rec.trace["window_s"]:
        return None
    return 1.0 - rec.trace["busy_s"] / rec.trace["window_s"]
