"""Admission plans computed (``ResourceManager.plan_admission`` calls,
each a whole-prompt prefix-trie lookup) per request admitted over the
window, from the ``plans`` and ``admitted`` of the engine's ``serve.plan``
spans (``rec.spans``; a run with the engine's tracer armed)."""


def read(rec):
    plans = [s["detail"] for s in getattr(rec, "spans", None) or ()
             if s["name"] == "serve.plan"]
    admitted = sum(len(d["admitted"]) for d in plans)
    return sum(d["plans"] for d in plans) / admitted if admitted else None
