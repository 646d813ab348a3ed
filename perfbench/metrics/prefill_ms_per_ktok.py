"""Host time of the window's admissions (``EngineRun`` ``prefill_s``:
the boundary's admission dispatches, ended by their device-to-host read)
per thousand prompt tokens prefilled (``serving/engine.py``)."""


def read(rec):
    secs = sum(b.prefill_s for b in rec.boundaries)
    tokens = sum(n for b in rec.boundaries for _, n in b.prefills)
    return secs * 1e3 / (tokens / 1e3) if tokens else None
