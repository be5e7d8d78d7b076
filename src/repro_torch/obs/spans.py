"""Span tracing for host-side serving phases (port of
``repro.obs.spans``, with span ids and profiler ranges added).

A :class:`SpanTracer` records *complete* spans (``ph == "X"``: name,
category, start, duration, args) and *instant* events (``ph == "i"``:
fault trips, quarantine edges) from the host half of the serving path —
the fleet server's ticks and the engine's steps, planner, scan dispatch,
admission, paging, checkpoint write/resume.  Every record carries its own
``id`` and the ``parent`` id of the span open around it (None at the
top); a ``request`` arg is inherited by the spans opened inside.  While
``torch.profiler`` records, each span is also a profiler range (a
``RecordFunction``, as ``torch.profiler.record_function`` opens) named
``alert.<name>``, so the phases sit in the profiler's trace on its own
clock.  Two export formats:

* ``write_jsonl(path)`` — one JSON object per line, the stable
  machine-readable schema that :func:`validate_jsonl` checks;
* ``write_chrome_trace(path)`` — the Chrome ``traceEvents`` JSON that
  ``chrome://tracing`` and Perfetto open directly.

The tracer is a pure observer: it reads the clock around phases the
serving path already executes, keeps a bounded in-memory buffer
(overflow is *counted*, never silent: new records dropped, or in an
evicting tracer the oldest forgotten), and touches no controller state.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager, nullcontext

import torch

# Default bound on buffered events; past it new events are dropped and
# counted in `dropped`, or, in an evicting tracer, the oldest quarter is
# forgotten and counted in `evicted` (both exported in both writers'
# metadata).
SPAN_BUFFER_CAP = 262144

# Required keys of one JSONL record, in write order, and the version of
# that schema.
JSONL_SCHEMA = ("name", "cat", "ph", "ts_us", "dur_us", "id", "parent",
                "args")
JSONL_VERSION = 2

# Prefix of the profiler range each span opens while torch's profiler
# records.
RANGE_PREFIX = "alert."

_NULL = nullcontext()


def profiler_recording() -> bool:
    """Whether torch's profiler records on this thread now."""
    return torch._C._autograd._profiler_enabled()


def no_span(name: str, cat: str = "host", **args):
    """Stands in for :meth:`SpanTracer.span` where nothing records: a
    context that does nothing and yields None."""
    return _NULL


class SpanTracer:
    """Bounded in-memory recorder of phase spans and instant events."""

    def __init__(self, clock=time.perf_counter,
                 capacity: int = SPAN_BUFFER_CAP, evict: bool = False):
        self._clock = clock
        # The Unix time of ``ts_us == 0``, for overlaying by hand; the
        # ``alert.*`` profiler ranges are what aligns spans exactly.
        self.t0_unix_ns = time.time_ns()
        self._t0 = clock()
        self.capacity = int(capacity)
        self.events: list[dict] = []
        self.dropped = 0
        # A tracer that lives as long as its process keeps its newest
        # records: a record's parent ends after it, so forgetting the
        # oldest leaves no kept record without its parent.
        self.evict = bool(evict)
        self.evicted = 0
        self.last_s = 0.0  # seconds of the span that ended last
        self._next_id = 0
        self._open: list[tuple[int, str | None]] = []  # (id, request)

    def _enter(self, args: dict) -> tuple[int, int | None]:
        """A new record's id and its parent's; ``args`` inherits the
        parent's ``request``."""
        sid, self._next_id = self._next_id, self._next_id + 1
        if not self._open:
            return sid, None
        parent, request = self._open[-1]
        if request is not None:
            args.setdefault("request", request)
        return sid, parent

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _record(self, rec: dict) -> None:
        if len(self.events) >= self.capacity:
            if not self.evict:
                self.dropped += 1
                return
            n = max(1, self.capacity // 4)
            del self.events[:n]
            self.evicted += n
        self.events.append(rec)

    @contextmanager
    def span(self, name: str, cat: str = "host", **args):
        """Time the enclosed block as a complete span (``ph == "X"``),
        the child of the span open around it.  Yields ``args``, to which
        the block may add what it learns (kept when the span ends)."""
        sid, parent = self._enter(args)
        self._open.append((sid, args.get("request")))
        # The C++ range costs the host a tenth of what
        # ``torch.profiler.record_function`` does under the profiler, time
        # that falls between the card's graphs.
        rng = torch._C._profiler._RecordFunctionFast(RANGE_PREFIX + name) \
            if profiler_recording() else _NULL
        with rng:
            ts = self._now_us()
            try:
                yield args
            finally:
                dur = self._now_us() - ts
                self.last_s = dur * 1e-6
                self._open.pop()
                self._record({"name": name, "cat": cat, "ph": "X",
                              "ts_us": ts, "dur_us": dur, "id": sid,
                              "parent": parent, "args": args})

    def event(self, name: str, cat: str = "host", **args) -> None:
        """Record an instant event (``ph == "i"``, zero duration) inside
        the span open around it."""
        sid, parent = self._enter(args)
        self._record({"name": name, "cat": cat, "ph": "i",
                      "ts_us": self._now_us(), "dur_us": 0.0, "id": sid,
                      "parent": parent, "args": args})

    def __len__(self) -> int:
        return len(self.events)

    def phase_totals(self) -> dict[str, dict]:
        """Aggregate complete spans by name → count/total/max seconds."""
        return _totals(self.events)

    def tree_totals(self, root: str, last: int) -> dict[str, dict] | None:
        """:meth:`phase_totals` over the last ``last`` spans named
        ``root`` and every record under them; None where fewer are
        kept whole (after an eviction the oldest kept one may have lost
        records of its tree, which all precede it)."""
        roots = [e for e in self.events
                 if e["ph"] == "X" and e["name"] == root]
        roots = roots[1 if self.evicted else 0:][-last:]
        if last < 1 or len(roots) < last:
            return None
        kids: dict = {}
        for e in self.events:
            kids.setdefault(e["parent"], []).append(e)
        out, todo = [], list(roots)
        while todo:
            e = todo.pop()
            out.append(e)
            todo += kids.get(e["id"], [])
        return _totals(out)

    def write_jsonl(self, path: str) -> None:
        """Write one event per line; first line is a ``_meta`` header
        carrying the schema version, the dropped- and evicted-event
        counts and the Unix time of ``ts_us == 0`` in ns."""
        with open(path, "w") as f:
            f.write(json.dumps({"_meta": {"schema": list(JSONL_SCHEMA),
                                          "version": JSONL_VERSION,
                                          "dropped": self.dropped,
                                          "evicted": self.evicted,
                                          "t0_unix_ns": self.t0_unix_ns}}))
            f.write("\n")
            for e in self.events:
                f.write(json.dumps({k: e[k] for k in JSONL_SCHEMA}))
                f.write("\n")

    def write_chrome_trace(self, path: str) -> None:
        """Write the Chrome/Perfetto ``traceEvents`` JSON; each record's
        ``id`` and ``parent`` go into its args."""
        events = []
        for e in self.events:
            rec = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
                   "ts": e["ts_us"], "pid": 0, "tid": 0,
                   "args": dict(e["args"], id=e["id"],
                                parent=e["parent"])}
            if e["ph"] == "X":
                rec["dur"] = e["dur_us"]
            else:
                rec["s"] = "t"  # instant scope: thread
            events.append(rec)
        doc = {"traceEvents": events,
               "displayTimeUnit": "ms",
               "otherData": {"dropped": self.dropped,
                             "evicted": self.evicted,
                             "t0_unix_ns": self.t0_unix_ns}}
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")


def _totals(events) -> dict[str, dict]:
    """The complete spans of ``events`` by name → count/total/max
    seconds."""
    out: dict[str, dict] = {}
    for e in events:
        if e["ph"] != "X":
            continue
        row = out.setdefault(e["name"],
                             {"count": 0, "total_s": 0.0, "max_s": 0.0})
        dur_s = e["dur_us"] * 1e-6
        row["count"] += 1
        row["total_s"] += dur_s
        row["max_s"] = max(row["max_s"], dur_s)
    return out


def validate_jsonl(path: str) -> int:
    """Validate a :meth:`SpanTracer.write_jsonl` file against
    :data:`JSONL_SCHEMA`; returns the number of event records.

    Raises ``ValueError`` on a malformed header or version, missing keys,
    a bad ``ph`` code, negative timestamps/durations, a repeated ``id``,
    or a ``parent`` that names no record of the file (unless the header
    counts dropped events, which may have been parents) — this is the
    schema check CI runs over every trace the tests emit.
    """
    n = 0
    ids, parents = set(), []
    with open(path) as f:
        header = json.loads(f.readline())
        meta = header.get("_meta")
        if meta is None or meta.get("schema") != list(JSONL_SCHEMA) \
                or meta.get("version") != JSONL_VERSION:
            raise ValueError(f"{path}: missing/mismatched _meta header")
        for lineno, line in enumerate(f, start=2):
            rec = json.loads(line)
            missing = [k for k in JSONL_SCHEMA if k not in rec]
            if missing:
                raise ValueError(f"{path}:{lineno}: missing {missing}")
            if rec["ph"] not in ("X", "i"):
                raise ValueError(f"{path}:{lineno}: bad ph {rec['ph']!r}")
            if rec["ts_us"] < 0 or rec["dur_us"] < 0:
                raise ValueError(f"{path}:{lineno}: negative time")
            if not isinstance(rec["args"], dict):
                raise ValueError(f"{path}:{lineno}: args not a dict")
            if not isinstance(rec["id"], int) or rec["id"] in ids:
                raise ValueError(f"{path}:{lineno}: bad or repeated id")
            ids.add(rec["id"])
            if rec["parent"] is not None:
                parents.append((lineno, rec["parent"]))
            n += 1
    if not meta.get("dropped"):
        for lineno, parent in parents:
            if parent not in ids:
                raise ValueError(f"{path}:{lineno}: dangling parent "
                                 f"{parent!r}")
    return n
