"""Share of the prompt tokens of the window's admissions that the prefix
cache served (the scheduler's ``Request.shared_tokens``), in the
scheduler and paged cache (``serving/scheduler.py``,
``serving/paged_cache.py::PrefixCache``)."""


def read(rec):
    adm = rec.admitted()
    total = sum(s.req.prompt_len for s in adm)
    return sum(s.shared for s in adm) / total if total else None
