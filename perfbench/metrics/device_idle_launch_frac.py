"""Share of the traced part of the window in which no operation ran on
the card while the host was launching work: an admission dispatch
(``serve.dispatch``) or a decode segment (``serve.segment``) the innermost
open program span, outside their host reads (``serve.read``)."""


def read(rec):
    idle = (rec.trace or {}).get("idle_by_span")
    if idle is None or not rec.trace["window_s"]:
        return None
    return (idle.get("serve.dispatch", 0.0) + idle.get("serve.segment", 0.0)
            ) / rec.trace["window_s"]
