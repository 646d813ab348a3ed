"""Host time of the window's admission planning (the engine's
``serve.plan`` spans: ``ContinuousBatchingScheduler.try_admit``, its
deficit rounds and ``plan_admission`` calls) per request those spans
admitted, in the scheduler and paged cache.  Reads the run's program
spans (``rec.spans``), which only a run with the engine's tracer armed
has."""


def read(rec):
    plans = [s for s in getattr(rec, "spans", None) or ()
             if s["name"] == "serve.plan"]
    admitted = sum(len(s["detail"]["admitted"]) for s in plans)
    secs = sum(s["end"] - s["start"] for s in plans)
    return secs * 1e3 / admitted if admitted else None
