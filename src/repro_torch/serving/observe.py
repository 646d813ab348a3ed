"""Serving observability: metrics registry, request tracing, exporters.

Telemetry substrate for the serving stack — the one
measurement path shared by benches, the SERVE replay scorer, and the
per-module ``stats()`` views:

- **MetricsRegistry** — typed counters, gauges, and fixed-exponential-
  bucket histograms with positional label sets (replica, tenant, site).
  Handles are idempotent by name (two modules asking for the same
  counter share one series table, which is how the scheduler's
  dead-letter increments and the ResourceManager's ``dead_letters``
  property stay one number).  ``snapshot()``/``delta()`` give JSON-safe
  reads; ``to_prometheus()`` renders the text exposition format.
- **Tracer** — a flat, append-only event log forming per-request span
  trees over the engine's boundary protocol
  (SUBMIT → ADMIT → SEGMENT* → {PREEMPT/STALL/QUARANTINE/RETRY/
  MIGRATE}* → COMPLETE | DEAD_LETTER).  Every event carries the
  boundary index and the injectable-clock timestamp; ``sequence()``
  drops the timestamps, so traces from seeded ``FaultPlan`` runs are
  bit-reproducible modulo wall-clock.  Beside the events it keeps the
  engine's nested host **spans** (``serve.step`` and its phases, see
  ``Observability.span``), each also opened as a
  ``torch.profiler.record_function`` range so a running profiler's
  device trace carries it on its own clock.
- **Observability** — the facade the engine/cluster/scheduler thread
  through.  Counters are *always* live (they back the ``stats()`` thin
  views even when telemetry is off); histograms, gauges, the tracer,
  and file exports only exist when the policy enables them — a
  disabled probe costs one attribute lookup against ``NULL_METRIC`` or
  one ``is not None`` test, and allocates nothing.  Only an armed
  tracer imports anything (``torch.profiler``, for its spans' ranges).

``ObservabilityPolicy`` (the plan knob group) lives in
``serving/plan.py`` beside the other policy dataclasses; this module
only duck-types it (``enabled`` / ``histogram_buckets`` / ``trace`` /
``export_dir``) so the plan never has to import machinery.
"""

from __future__ import annotations

import bisect
import json
import os
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_METRIC",
    "NULL_SPAN", "Observability", "Span", "SpanEvent", "Stopwatch",
    "Tracer", "exponential_buckets", "render_summary",
]


def exponential_buckets(start: float = 1e-4, factor: float = 2.0,
                        count: int = 18) -> tuple:
    """Upper bucket bounds ``start * factor**k`` for k in [0, count).

    The default grid spans 100 us .. ~13 s — the serving latency range
    from a single decode-token dispatch to a heavily backed-off retry.
    A final implicit +Inf bucket catches everything above.
    """
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError(
            f"buckets need start>0, factor>1, count>=1; got "
            f"({start}, {factor}, {count})")
    return tuple(start * factor ** k for k in range(count))


DEFAULT_BUCKETS = exponential_buckets()


class _NullMetric:
    """Shared do-nothing handle: the disabled-mode probe target.

    Every mutating/reading method exists so call sites never branch —
    a disabled probe is one attribute lookup plus a no-op call, and
    allocates nothing (pinned by tests/test_observe.py).
    """

    __slots__ = ()

    def inc(self, v=1.0, labels=()):
        pass

    def dec(self, v=1.0, labels=()):
        pass

    def set(self, v, labels=()):
        pass

    def observe(self, v, labels=()):
        pass

    def value(self, labels=()):
        return 0.0

    def total(self, **match):
        return 0.0


NULL_METRIC = _NullMetric()


class _Metric:
    __slots__ = ("name", "help", "labels", "series")
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        # label-value tuple (positional, matching self.labels) -> state
        self.series: dict = {}

    def _match_indices(self, match: dict) -> dict:
        try:
            return {self.labels.index(k): v for k, v in match.items()}
        except ValueError:
            raise ValueError(
                f"{self.name} has labels {self.labels}, not "
                f"{tuple(match)}") from None

    def value(self, labels: tuple = ()):
        return self.series.get(labels, 0.0)

    def total(self, **match) -> float:
        """Sum over series whose named labels equal the given values."""
        if not match:
            return float(sum(self.series.values()))
        idx = self._match_indices(match)
        return float(sum(
            v for key, v in self.series.items()
            if all(key[i] == want for i, want in idx.items())))


class Counter(_Metric):
    """Monotonic counter; one float per label-value tuple."""

    __slots__ = ()
    kind = "counter"

    def inc(self, v: float = 1.0, labels: tuple = ()):
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.series[labels] = self.series.get(labels, 0.0) + v


class Gauge(_Metric):
    """Set/inc/dec instantaneous value per label-value tuple."""

    __slots__ = ()
    kind = "gauge"

    def set(self, v: float, labels: tuple = ()):
        self.series[labels] = float(v)

    def inc(self, v: float = 1.0, labels: tuple = ()):
        self.series[labels] = self.series.get(labels, 0.0) + v

    def dec(self, v: float = 1.0, labels: tuple = ()):
        self.inc(-v, labels)


class Histogram(_Metric):
    """Fixed-exponential-bucket histogram.

    Per label-value tuple: ``[counts, sum, count]`` where ``counts``
    has ``len(buckets) + 1`` slots — one per finite upper bound plus
    the +Inf catch-all.  Bucket ``i`` counts observations ``v`` with
    ``buckets[i-1] < v <= buckets[i]`` (Prometheus ``le`` semantics).
    """

    __slots__ = ("buckets",)
    kind = "histogram"

    def __init__(self, name, help="", labels=(),
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        buckets = tuple(float(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"histogram {name} buckets must be non-empty and "
                f"strictly increasing: {buckets}")
        self.buckets = buckets

    def observe(self, v: float, labels: tuple = ()):
        s = self.series.get(labels)
        if s is None:
            s = self.series[labels] = \
                [[0] * (len(self.buckets) + 1), 0.0, 0]
        s[0][bisect.bisect_left(self.buckets, v)] += 1
        s[1] += v
        s[2] += 1

    def count(self, labels: tuple = ()) -> int:
        s = self.series.get(labels)
        return s[2] if s is not None else 0

    def sum(self, labels: tuple = ()) -> float:
        s = self.series.get(labels)
        return s[1] if s is not None else 0.0

    def _merged_counts(self, labels):
        if labels is not None:
            s = self.series.get(labels)
            return list(s[0]) if s is not None else None
        merged = None
        for s in self.series.values():
            if merged is None:
                merged = list(s[0])
            else:
                merged = [a + b for a, b in zip(merged, s[0])]
        return merged

    def percentile(self, q: float, labels: tuple | None = None) -> float:
        """Bucket-interpolated q-th percentile (labels=None merges all
        series).  Values past the top finite bound clamp to it."""
        counts = self._merged_counts(labels)
        if not counts or not sum(counts):
            return 0.0
        rank = (q / 100.0) * sum(counts)
        cum, lo = 0.0, 0.0
        for i, ub in enumerate(self.buckets):
            c = counts[i]
            if c and cum + c >= rank:
                return lo + max(rank - cum, 0.0) / c * (ub - lo)
            cum += c
            lo = ub
        return self.buckets[-1]

    # value() on a histogram is its count: keeps total(**match) usable
    def value(self, labels: tuple = ()):
        return self.count(labels)

    def total(self, **match) -> float:
        if not match:
            return float(sum(s[2] for s in self.series.values()))
        idx = self._match_indices(match)
        return float(sum(
            s[2] for key, s in self.series.items()
            if all(key[i] == want for i, want in idx.items())))


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(names: tuple, values: tuple, extra: tuple = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class MetricsRegistry:
    """Name-keyed metric store; handles are idempotent per name."""

    def __init__(self, histogram_buckets: tuple = ()):
        self._metrics: dict = {}
        self.histogram_buckets = \
            tuple(histogram_buckets) or DEFAULT_BUCKETS

    def _get(self, cls, name, help, labels, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labels != tuple(labels):
                raise ValueError(
                    f"metric {name} already registered as {m.kind}"
                    f"{m.labels}; asked for {cls.kind}{tuple(labels)}")
            return m
        m = self._metrics[name] = cls(name, help, tuple(labels), **kw)
        return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets: tuple | None = None) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         buckets=tuple(buckets) if buckets
                         else self.histogram_buckets)

    def metrics(self) -> list:
        return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-safe point-in-time read of every series."""
        out = {}
        for m in self.metrics():
            entry = {"kind": m.kind, "help": m.help,
                     "labels": list(m.labels)}
            if m.kind == "histogram":
                entry["buckets"] = list(m.buckets)
                entry["series"] = [
                    {"labels": list(k), "counts": list(s[0]),
                     "sum": s[1], "count": s[2]}
                    for k, s in sorted(m.series.items())]
            else:
                entry["series"] = [{"labels": list(k), "value": v}
                                   for k, v in sorted(m.series.items())]
            out[m.name] = entry
        return out

    def delta(self, prev: dict) -> dict:
        """Snapshot minus a previous ``snapshot()`` (counters and
        histograms subtract; gauges report their current value)."""
        cur = self.snapshot()
        for name, entry in cur.items():
            if entry["kind"] == "gauge" or name not in prev:
                continue
            old = {tuple(s["labels"]): s
                   for s in prev[name]["series"]}
            for s in entry["series"]:
                o = old.get(tuple(s["labels"]))
                if o is None:
                    continue
                if entry["kind"] == "histogram":
                    s["counts"] = [a - b for a, b in
                                   zip(s["counts"], o["counts"])]
                    s["sum"] -= o["sum"]
                    s["count"] -= o["count"]
                else:
                    s["value"] -= o["value"]
        return cur

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, deterministically
        ordered (metrics by name, series by label values)."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key in sorted(m.series):
                if m.kind == "histogram":
                    counts, total, n = m.series[key]
                    cum = 0
                    for ub, c in zip(m.buckets, counts):
                        cum += c
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_label_str(m.labels, key, (('le', _fmt(ub)),))}"
                            f" {cum}")
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_label_str(m.labels, key, (('le', '+Inf'),))}"
                        f" {n}")
                    lines.append(f"{m.name}_sum"
                                 f"{_label_str(m.labels, key)}"
                                 f" {_fmt(total)}")
                    lines.append(f"{m.name}_count"
                                 f"{_label_str(m.labels, key)} {n}")
                else:
                    lines.append(f"{m.name}"
                                 f"{_label_str(m.labels, key)}"
                                 f" {_fmt(m.series[key])}")
        return "\n".join(lines) + ("\n" if lines else "")


def render_summary(registry: MetricsRegistry) -> dict:
    """Compact JSON-safe table for bench rows and ``result()``:
    counter/gauge totals plus p50/p95/mean per histogram."""
    counters, gauges, latency = {}, {}, {}
    for m in registry.metrics():
        if m.kind == "counter":
            if m.series:
                counters[m.name] = m.total()
        elif m.kind == "gauge":
            if m.series:
                gauges[m.name] = m.total()
        else:
            n = m.total()
            if n:
                latency[m.name] = {
                    "count": int(n),
                    "mean": sum(s[1] for s in m.series.values()) / n,
                    "p50": m.percentile(50),
                    "p95": m.percentile(95),
                }
    return {"counters": counters, "gauges": gauges,
            "histograms": latency}


# ------------------------------------------------------------- tracing
class SpanEvent:
    """One request-lifecycle event: ``kind`` at ``boundary``/``t``.

    ``detail`` holds only deterministic payload (sites, reasons, page
    counts — never wall-clock durations), so ``Tracer.sequence()``
    is bit-reproducible for seeded fault plans.
    """

    __slots__ = ("rid", "kind", "boundary", "t", "detail")

    def __init__(self, rid, kind: str, boundary: int, t: float,
                 detail: dict):
        self.rid = rid
        self.kind = kind
        self.boundary = boundary
        self.t = t
        self.detail = detail

    def record(self) -> dict:
        return {"rid": self.rid, "kind": self.kind,
                "boundary": self.boundary, "t": self.t,
                "detail": self.detail}

    def __repr__(self):
        return (f"SpanEvent(rid={self.rid}, kind={self.kind!r}, "
                f"boundary={self.boundary}, t={self.t:.6f}, "
                f"detail={self.detail})")


class _NullSpan:
    """Shared do-nothing span: what ``Observability.span`` returns with
    the tracer off.  Entering, leaving and ``set`` allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **detail):
        pass


NULL_SPAN = _NullSpan()


class Stopwatch:
    """A reusable interval timer on ``time.perf_counter``: one clock read
    on entry, one on exit.  A timed span site hands one in, and gets it
    back in place of the span when the tracer is off."""

    __slots__ = ("start", "end")

    def __init__(self):
        self.start = self.end = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        return False

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Span:
    """One nested host interval of the engine's work.

    ``start``/``end`` are ``time.perf_counter`` seconds, ``parent`` the
    index in ``Tracer.spans`` of the span open around it (-1 at the top),
    ``boundary`` the engine boundary (inherited from the parent unless
    given), ``replica`` the owning run's label, and ``detail`` the call
    site's payload (request ids, page and token counts).  While open it
    also holds a ``torch.profiler.record_function`` range of the same
    name, entered before the start stamp and left after the end stamp.
    """

    __slots__ = ("name", "start", "end", "parent", "boundary", "replica",
                 "detail", "_tracer", "_range")

    def __init__(self, tracer, name: str, boundary, replica: str,
                 detail: dict):
        self._tracer = tracer
        self.name = name
        self.boundary = boundary
        self.replica = replica
        self.detail = detail
        self.parent = -1
        self.start = self.end = 0.0
        self._range = None

    def __enter__(self):
        tr = self._tracer
        if tr.open:
            self.parent = tr.open[-1]
            if self.boundary is None:
                self.boundary = tr.spans[self.parent].boundary
        elif self.boundary is None:
            self.boundary = -1
        tr.open.append(len(tr.spans))
        tr.spans.append(self)
        self._range = tr.record_function(self.name)
        self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        self._range.__exit__(None, None, None)
        self._range = None
        self._tracer.open.pop()
        return False

    def set(self, **detail):
        self.detail.update(detail)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def record(self) -> dict:
        return {"name": self.name, "start": self.start, "end": self.end,
                "parent": self.parent, "boundary": self.boundary,
                "replica": self.replica, "detail": self.detail}


# event kind -> lifecycle phase it opens (span_tree delimiter set)
_PHASE_OF = {
    "SUBMIT": "queued", "ADMIT": "running", "PREEMPT": "swapped",
    "STALL": "stalled", "QUARANTINE": "quarantined", "RETRY": "queued",
    "MIGRATE": "migrating", "COMPLETE": "done", "DEAD_LETTER": "dead",
}


class Tracer:
    """Append-only event log; per-request views are derived reads.
    ``spans`` holds the host spans in the order they opened; ``open``
    the indices of those still open, innermost last."""

    def __init__(self):
        from torch.profiler import record_function
        self.events: list = []
        self.spans: list = []
        self.open: list = []
        self.record_function = record_function

    def event(self, rid, kind: str, boundary: int, t: float, **detail):
        self.events.append(SpanEvent(rid, kind, boundary, t, detail))

    def trace(self, rid) -> list:
        return [e for e in self.events if e.rid == rid]

    def rids(self) -> list:
        seen: dict = {}
        for e in self.events:
            if e.rid is not None:
                seen.setdefault(e.rid, None)
        return list(seen)

    def sequence(self) -> list:
        """The deterministic view: every event minus timestamps.  Two
        seeded chaos runs must produce equal sequences."""
        return [(e.rid, e.kind, e.boundary,
                 tuple(sorted(e.detail.items())))
                for e in self.events]

    def span_tree(self, rid) -> list:
        """Group one request's events into lifecycle spans.  Each
        phase-opening kind (SUBMIT/ADMIT/PREEMPT/...) closes the
        previous span; non-delimiter kinds (SEGMENT, ADMIT_FAIL,
        SWAP_FAULT, ...) attach to the current one."""
        spans: list = []
        cur = None
        for e in self.trace(rid):
            phase = _PHASE_OF.get(e.kind)
            if phase is not None:
                if cur is not None:
                    cur["t_end"] = e.t
                    cur["boundary_end"] = e.boundary
                cur = {"phase": phase, "t_start": e.t,
                       "t_end": None, "boundary_start": e.boundary,
                       "boundary_end": None, "events": []}
                spans.append(cur)
            if cur is not None:
                cur["events"].append(e.kind)
        return spans

    def self_seconds(self) -> list:
        """Each span's duration less its children's, in ``spans`` order."""
        out = [s.seconds for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.seconds
        return out

    def to_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e.record(), sort_keys=True,
                                   separators=(",", ":")) + "\n")
        return path

    def spans_to_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s.record(), sort_keys=True,
                                   separators=(",", ":")) + "\n")
        return path


# -------------------------------------------------------------- facade
class Observability:
    """What the serving modules actually hold.

    Counters stay live regardless of the policy — they are the storage
    behind the ``stats()`` thin views.  Histograms and gauges come
    back as ``NULL_METRIC`` and ``tracer`` is ``None`` when disabled,
    so the hot path pays one attribute lookup (or one ``is not None``
    test) per probe and never allocates.

    ``for_replica`` binds a replica name while *sharing* the registry
    and tracer — a cluster's N replicas feed one store, and each
    replica's views filter on its own label value.
    """

    def __init__(self, policy=None, replica: str = ""):
        self.policy = policy
        self.enabled = bool(policy is not None
                            and getattr(policy, "enabled", False))
        buckets = tuple(getattr(policy, "histogram_buckets", ()) or ()) \
            if policy is not None else ()
        self.registry = MetricsRegistry(histogram_buckets=buckets)
        self.tracer = Tracer() if self.enabled and \
            getattr(policy, "trace", True) else None
        self.replica = replica

    @classmethod
    def disabled(cls) -> "Observability":
        """A fresh all-off instance (never a singleton: independent
        engines/tests must not share one counter store)."""
        return cls()

    @classmethod
    def from_policy(cls, policy) -> "Observability":
        return cls(policy=policy)

    def for_replica(self, name: str) -> "Observability":
        clone = object.__new__(Observability)
        clone.policy = self.policy
        clone.enabled = self.enabled
        clone.registry = self.registry       # shared
        clone.tracer = self.tracer           # shared
        clone.replica = name
        return clone

    # counters are always real: they back the stats() thin views
    def counter(self, name, help="", labels=()) -> Counter:
        return self.registry.counter(name, help, labels)

    # gauges/histograms only exist when telemetry is on
    def gauge(self, name, help="", labels=()):
        return self.registry.gauge(name, help, labels) \
            if self.enabled else NULL_METRIC

    def histogram(self, name, help="", labels=(), buckets=None):
        return self.registry.histogram(name, help, labels,
                                       buckets=buckets) \
            if self.enabled else NULL_METRIC

    # spans only exist when the tracer is on
    def span(self, name: str, watch: Stopwatch | None = None,
             boundary: int | None = None, **detail):
        """A context manager around one phase of the engine's work.

        Tracer on: a :class:`Span` recorded in the tracer, nested under
        the span open around it.  Tracer off: ``watch`` when one is given
        (a timed site keeps its one pair of clock reads), else the shared
        :data:`NULL_SPAN`.  Either way ``with obs.span(...) as sp`` gives
        an object whose ``seconds`` is the interval when it was timed.
        Call sites build detail (request-id lists and the like) only when
        ``tracer is not None``, and add it with ``sp.set(...)``."""
        tr = self.tracer
        if tr is None:
            return NULL_SPAN if watch is None else watch
        return Span(tr, name, boundary, self.replica, detail)

    def summary(self) -> dict:
        return render_summary(self.registry)

    def export(self, out_dir: str) -> dict:
        """Write ``metrics.prom`` (+ ``trace.jsonl`` and ``spans.jsonl``
        when tracing) to ``out_dir``; returns the written paths."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {"metrics": os.path.join(out_dir, "metrics.prom")}
        with open(paths["metrics"], "w") as f:
            f.write(self.registry.to_prometheus())
        if self.tracer is not None:
            paths["trace"] = self.tracer.to_jsonl(
                os.path.join(out_dir, "trace.jsonl"))
            paths["spans"] = self.tracer.spans_to_jsonl(
                os.path.join(out_dir, "spans.jsonl"))
        return paths
