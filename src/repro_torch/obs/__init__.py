"""Observability: the flight recorder for the serving path (port of
``repro.obs``).

A :class:`~repro_torch.obs.metrics.MetricsRegistry` of counters, gauges,
histograms and phase timers, a :class:`~repro_torch.obs.spans.SpanTracer`
for host-side phases with JSONL and Chrome-trace export, and a
:class:`~repro_torch.obs.ring.TelemetryRing` of per-round aggregates fed
from the megatick's round body.  :class:`FlightRecorder` bundles the
three; a gateway, the fleet server and the serving engine take it as
their ``obs=`` keyword.  Where none is attached, the fleet server and the
engine record their spans into :data:`PROCESS_RECORDER` while
``torch.profiler`` records (:func:`span_recorder`), so a caller that
profiles gets them unasked.

Contract, a **pure observer**: attaching a recorder leaves every pick,
bank state and golden trace bitwise identical, and a disabled recorder
resolves to the bare path (``tests/test_torch_obs.py``).  All of it is
host Python and numpy except :func:`~repro_torch.obs.ring.round_aggregates`.
"""

from __future__ import annotations

import os

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, PhaseTimer)
from repro_torch.obs.ring import RING_FIELDS, TelemetryRing
from repro_torch.obs.spans import (SpanTracer, no_span, profiler_recording,
                                   validate_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "PhaseTimer",
    "TelemetryRing", "RING_FIELDS", "SpanTracer", "validate_jsonl",
    "FlightRecorder", "PROCESS_RECORDER", "no_span", "resolve_obs",
    "span_recorder",
]


class FlightRecorder:
    """The ``obs=`` bundle: metrics + spans + ring, with an off switch.

    ``FlightRecorder(enabled=False)`` is the asserted ~zero-cost mode:
    components check ``obs.enabled`` once at attach time and skip all
    instrumentation, so a disabled recorder behaves like ``obs=None``.
    """

    def __init__(self, enabled: bool = True, *,
                 ring_capacity: int | None = None):
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry()
        self.spans = SpanTracer()
        self.ring = TelemetryRing(ring_capacity) if ring_capacity \
            else TelemetryRing()

    def save(self, out_dir: str) -> dict[str, str]:
        """Write the whole recording under ``out_dir`` and return the
        paths: ``metrics.json``, ``spans.jsonl``, ``trace.json``
        (Chrome/Perfetto), ``ring.json``."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "metrics": os.path.join(out_dir, "metrics.json"),
            "spans": os.path.join(out_dir, "spans.jsonl"),
            "trace": os.path.join(out_dir, "trace.json"),
            "ring": os.path.join(out_dir, "ring.json"),
        }
        self.metrics.save(paths["metrics"])
        self.spans.write_jsonl(paths["spans"])
        self.spans.write_chrome_trace(paths["trace"])
        self.ring.save(paths["ring"])
        return paths


#: Where the fleet server and the engine record while torch's profiler
#: records and no recorder is attached to them.  It lives as long as the
#: process, so past its capacity it forgets its oldest spans.
PROCESS_RECORDER = FlightRecorder()
PROCESS_RECORDER.spans = SpanTracer(evict=True)


def resolve_obs(obs):
    """An attached and enabled flight recorder, else None: ``obs=None``
    and ``FlightRecorder(enabled=False)`` both take the bare path, so
    every instrumentation site is one pointer check."""
    return obs if (obs is not None and getattr(obs, "enabled", False)) \
        else None


def span_recorder(ob):
    """Where a span site records: ``ob`` (a resolved recorder or None),
    else :data:`PROCESS_RECORDER` while torch's profiler records, else
    None."""
    if ob is not None:
        return ob
    return PROCESS_RECORDER if profiler_recording() else None
