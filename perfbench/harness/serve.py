"""The served loop: the port's ``EngineRun`` driven by a traffic stream,
with the benchmark's own stamps.

``EngineRun.step`` serves one segment boundary (admissions, then one
decode segment).  Around it the loop sends requests (closed loop: a
client's next request as soon as its last one completes; open loop:
every request whose due time has come) and stamps, on the benchmark's
clock, each request's send and due time, its first token (the engine's
admission stamp, taken on this same clock) and every later token (the
boundary at which the host received it).  Each boundary leaves a
:class:`Boundary` record of the work it did, which the window arithmetic
and the metric readers reduce.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Sent:
    """One request as the benchmark saw it."""
    req: object            # the port's Request
    t_due: float           # open loop: scheduled arrival; closed: = t_send
    t_send: float
    client: int = -1
    token_times: list = dataclasses.field(default_factory=list)
    t_admit: float | None = None
    shared: int = 0

    @property
    def t_first(self):
        return self.token_times[0] if self.token_times else None

    @property
    def done(self) -> bool:
        return self.req.t_done is not None

    @property
    def failed(self) -> bool:
        return self.req.failure is not None


@dataclasses.dataclass
class Boundary:
    """The work of one ``EngineRun.step``, between ``t0`` and ``t1``."""
    t0: float
    t1: float
    prefills: list         # (shared tokens, suffix tokens) per admission
    dispatches: list       # per admission dispatch: [(shared, suffix), ...]
    decode_rows: list      # (keys at the segment's first step, tokens) a row
    prefill_s: float
    decode_s: float
    n_segments: int
    n_prefill_dispatches: int
    moe_host_syncs: int


class ServedLoop:
    """Drive ``er`` (an ``EngineRun`` built on ``clock``) with ``stream``."""

    def __init__(self, er, stream, mix: dict, clock, request_cls):
        self.er, self.stream, self.mix = er, stream, mix
        self.clock = clock
        self.Request = request_cls
        self.closed = mix["loop"] == "closed"
        self.next_index = 0
        self.sent: list[Sent] = []
        self.live: list[Sent] = []
        self.boundaries: list[Boundary] = []
        self.next_due: float | None = None
        self.sending = True     # False: serve what is in flight, send none
        self._dispatch_log: list | None = None
        # a span factory around the loop's own work and the engine's step
        # (``torch.profiler.record_function`` in the traced part)
        self.span = contextlib.nullcontext
        self._wrap_dispatch()

    def _wrap_dispatch(self) -> None:
        """Record each admission dispatch's rows (host values only, no
        device read) by wrapping the engine's dispatch on this instance."""
        eng = self.er.engine
        inner = eng._dispatch_admissions

        def dispatch(cache, bt, reqs, s_pad, params):
            if self._dispatch_log is not None:
                self._dispatch_log.append(
                    [(int(r.shared_tokens),
                      int(r.prompt_len - r.shared_tokens)) for r in reqs])
            return inner(cache, bt, reqs, s_pad, params)

        eng._dispatch_admissions = dispatch

    # ------------------------------------------------------------ sending
    def _send(self, t_due: float, client: int = -1) -> Sent:
        it = self.stream.item(self.next_index)
        self.next_index += 1
        req = self.Request(rid=it.index, prompt=it.prompt,
                           max_new_tokens=it.max_new_tokens)
        now = self.clock()
        s = Sent(req=req, t_due=t_due, t_send=now, client=client)
        self.er.submit(req)
        self.sent.append(s)
        self.live.append(s)
        return s

    def start(self) -> None:
        now = self.clock()
        if self.closed:
            for c in range(int(self.mix["clients"])):
                self._send(now, c)
        else:
            self.next_due = now + self.stream.item(0).gap_s

    def _send_due(self) -> None:
        if self.closed or not self.sending:
            return
        now = self.clock()
        while self.next_due <= now:
            due = self.next_due
            self._send(due)
            self.next_due = due + self.stream.item(self.next_index).gap_s

    # ------------------------------------------------------------ one step
    def boundary(self) -> Boundary:
        """Send what is due, serve one boundary, stamp what came back."""
        from repro_torch.models import layers as L
        er = self.er
        with self.span("bench.loop"):
            self._send_due()
            before = {id(s): len(s.req.tokens) for s in self.live}
            c0 = (er.prefill_s, er.decode_s, er.n_segments,
                  er.n_prefill_dispatches, L.moe_host_syncs)
            self._dispatch_log = []
        t0 = self.clock()
        with self.span("bench.step"):
            status = er.step()
        t1 = self.clock()
        with self.span("bench.loop"):
            return self._after_step(status, t0, t1, before, c0)

    def _after_step(self, status, t0, t1, before, c0) -> Boundary:
        """Stamp what the step returned, send the closed loop's next
        requests, and record the boundary."""
        from repro_torch.models import layers as L
        er = self.er
        dispatches, self._dispatch_log = self._dispatch_log, None
        prefills, rows = [], []
        live, self.live = self.live, []
        for s in live:
            req = s.req
            n0, n = before[id(s)], len(req.tokens)
            if n0 == 0 and n > 0:                  # admitted this boundary
                s.t_admit = req.t_admitted
                s.shared = int(req.shared_tokens)
                s.token_times.append(req.t_first)
                prefills.append((s.shared, req.prompt_len - s.shared))
                n0 = 1
            if n > n0:
                # the segment fed tokens n0-1 .. n-2 at positions
                # prompt_len + n0 - 1 ...: its first step attends
                # prompt_len + n0 keys
                rows.append((req.prompt_len + n0, n - n0))
                s.token_times.extend([t1] * (n - n0))
            if s.done or s.failed:
                if self.closed and self.sending:
                    self._send(self.clock(), s.client)   # joins self.live
            else:
                self.live.append(s)
        if status == "idle":
            if er.has_work:
                er.note_stall()
            elif not self.closed and self.next_due is not None:
                wait = self.next_due - self.clock()
                if wait > 0:
                    time.sleep(wait)
        b = Boundary(
            t0=t0, t1=t1, prefills=prefills,
            dispatches=dispatches, decode_rows=rows,
            prefill_s=er.prefill_s - c0[0], decode_s=er.decode_s - c0[1],
            n_segments=er.n_segments - c0[2],
            n_prefill_dispatches=er.n_prefill_dispatches - c0[3],
            moe_host_syncs=L.moe_host_syncs - c0[4])
        self.boundaries.append(b)
        return b

    def drain(self, want_tokens: int, t_close: float) -> None:
        """Send nothing more and serve what is in flight until the requests
        sent by ``t_close`` that have finished hold ``want_tokens`` served
        tokens (or none is left in flight)."""
        self.sending = False
        while self.live and sum(
                len(s.req.tokens) for s in self.sent
                if s.done and not s.failed and s.t_send <= t_close) \
                < want_tokens:
            self.boundary()

    def run_until(self, t_end: float | None = None,
                  n_done: int | None = None) -> None:
        """Serve boundaries until the clock passes ``t_end`` or ``n_done``
        requests have completed."""
        while True:
            if t_end is not None and self.clock() >= t_end:
                return
            if n_done is not None and sum(s.done for s in self.sent) \
                    >= n_done:
                return
            self.boundary()


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (linear interpolation, numpy's default) of
    ``values``; None when there are none."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, float), q))
