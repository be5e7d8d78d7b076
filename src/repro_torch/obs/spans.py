"""Span tracing for host-side serving phases (port of
``repro.obs.spans``).

A :class:`SpanTracer` records *complete* spans (``ph == "X"``: name,
category, start, duration, args) and *instant* events (``ph == "i"``:
fault trips, quarantine edges) from the host half of the serving path —
planner, scan dispatch, admission, paging, checkpoint write/resume.  Two
export formats:

* ``write_jsonl(path)`` — one JSON object per line, the stable
  machine-readable schema that :func:`validate_jsonl` checks;
* ``write_chrome_trace(path)`` — the Chrome ``traceEvents`` JSON that
  ``chrome://tracing`` and Perfetto open directly.

The tracer is a pure observer: it reads the clock around phases the
serving path already executes, keeps a bounded in-memory buffer
(overflow is *counted*, never silent), and touches no controller state.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

# Default bound on buffered events; past it new events are dropped and
# counted in `dropped` (exported in both writers' metadata).
SPAN_BUFFER_CAP = 262144

# Required keys of one JSONL record, in write order.
JSONL_SCHEMA = ("name", "cat", "ph", "ts_us", "dur_us", "args")


class SpanTracer:
    """Bounded in-memory recorder of phase spans and instant events."""

    def __init__(self, clock=time.perf_counter, capacity: int = SPAN_BUFFER_CAP):
        self._clock = clock
        self._t0 = clock()
        self.capacity = int(capacity)
        self.events: list[dict] = []
        self.dropped = 0

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _record(self, rec: dict) -> None:
        if len(self.events) < self.capacity:
            self.events.append(rec)
        else:
            self.dropped += 1

    @contextmanager
    def span(self, name: str, cat: str = "host", **args):
        """Time the enclosed block as a complete span (``ph == "X"``)."""
        ts = self._now_us()
        try:
            yield
        finally:
            self._record({"name": name, "cat": cat, "ph": "X",
                          "ts_us": ts, "dur_us": self._now_us() - ts,
                          "args": args})

    def event(self, name: str, cat: str = "host", **args) -> None:
        """Record an instant event (``ph == "i"``, zero duration)."""
        self._record({"name": name, "cat": cat, "ph": "i",
                      "ts_us": self._now_us(), "dur_us": 0.0,
                      "args": args})

    def __len__(self) -> int:
        return len(self.events)

    def phase_totals(self) -> dict[str, dict]:
        """Aggregate complete spans by name → count/total/max seconds."""
        out: dict[str, dict] = {}
        for e in self.events:
            if e["ph"] != "X":
                continue
            row = out.setdefault(e["name"],
                                 {"count": 0, "total_s": 0.0, "max_s": 0.0})
            dur_s = e["dur_us"] * 1e-6
            row["count"] += 1
            row["total_s"] += dur_s
            row["max_s"] = max(row["max_s"], dur_s)
        return out

    def write_jsonl(self, path: str) -> None:
        """Write one event per line; first line is a ``_meta`` header
        carrying the schema version and the dropped-event count."""
        with open(path, "w") as f:
            f.write(json.dumps({"_meta": {"schema": list(JSONL_SCHEMA),
                                          "version": 1,
                                          "dropped": self.dropped}}))
            f.write("\n")
            for e in self.events:
                f.write(json.dumps({k: e[k] for k in JSONL_SCHEMA}))
                f.write("\n")

    def write_chrome_trace(self, path: str) -> None:
        """Write the Chrome/Perfetto ``traceEvents`` JSON."""
        events = []
        for e in self.events:
            rec = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
                   "ts": e["ts_us"], "pid": 0, "tid": 0,
                   "args": e["args"]}
            if e["ph"] == "X":
                rec["dur"] = e["dur_us"]
            else:
                rec["s"] = "t"  # instant scope: thread
            events.append(rec)
        doc = {"traceEvents": events,
               "displayTimeUnit": "ms",
               "otherData": {"dropped": self.dropped}}
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")


def validate_jsonl(path: str) -> int:
    """Validate a :meth:`SpanTracer.write_jsonl` file against
    :data:`JSONL_SCHEMA`; returns the number of event records.

    Raises ``ValueError`` on a malformed header, missing keys, a bad
    ``ph`` code, or negative timestamps/durations — this is the schema
    check CI runs over every trace the tests emit.
    """
    n = 0
    with open(path) as f:
        header = json.loads(f.readline())
        meta = header.get("_meta")
        if meta is None or meta.get("schema") != list(JSONL_SCHEMA):
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
            n += 1
    return n
