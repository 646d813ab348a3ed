"""Window arithmetic: the end-to-end metrics over all the work and all
the time of the measured window, and the record the per-layer metric
readers read.

The window runs from the start of its first boundary (``w0``) to the end
of its last (``w1``); every boundary in it lies wholly inside.  A rate is
the work done inside the window over ``w1 - w0``; a tail is over every
request whose event fell inside it.
"""

from __future__ import annotations

import dataclasses



@dataclasses.dataclass
class RunRecord:
    """What a run hands the metric readers."""
    config: dict
    segment_len: int
    w0: float
    w1: float
    sent: list                  # every Sent of the run (set-up included)
    boundaries: list            # the window's boundaries
    traced: list = dataclasses.field(default_factory=list)
    trace: dict | None = None   # perfbench.harness.trace.reduce's summary

    @property
    def span_s(self) -> float:
        return self.w1 - self.w0

    def inside(self, t) -> bool:
        return t is not None and self.w0 <= t <= self.w1

    def admitted(self) -> list:
        """Requests whose admission (prefill) fell inside the window."""
        return [s for s in self.sent if self.inside(s.t_admit)]


def tokens_in_window(rec: RunRecord) -> tuple[int, int]:
    """(prompt tokens prefilled, output tokens emitted) inside the window;
    prompt tokens served from the prefix cache are not prefilled."""
    prompt = sum(s.req.prompt_len - s.shared for s in rec.admitted())
    out = sum(1 for s in rec.sent for t in s.token_times if rec.inside(t))
    return prompt, out


def ttfts_s(rec: RunRecord) -> list[float]:
    """First token minus due time (open loop) or send time (closed loop,
    where they are one) of every request whose first token came inside
    the window."""
    return [s.t_first - s.t_due for s in rec.sent if rec.inside(s.t_first)]


def tpots_s(rec: RunRecord) -> list[float]:
    """(last token - first token) / (n - 1) of every request that
    completed inside the window with two tokens or more."""
    out = []
    for s in rec.sent:
        tt = s.token_times
        if s.done and len(tt) > 1 and rec.inside(tt[-1]):
            out.append((tt[-1] - tt[0]) / (len(tt) - 1))
    return out


def attempted_failed(rec: RunRecord) -> tuple[int, int]:
    """Requests due inside the window, and those of them the system
    failed (dead-lettered)."""
    due = [s for s in rec.sent if rec.inside(s.t_due)]
    return len(due), sum(1 for s in due if s.failed)


def answered(rec: RunRecord) -> int:
    """Requests that completed inside the window."""
    return sum(1 for s in rec.sent
               if s.done and not s.failed and rec.inside(s.req.t_done))


def end_to_end(rec: RunRecord, setup_s: float) -> dict[str, float]:
    prompt, out = tokens_in_window(rec)
    return {"tokens_per_s": (prompt + out) / rec.span_s,
            "requests_per_s": answered(rec) / rec.span_s,
            "setup_s": setup_s}
