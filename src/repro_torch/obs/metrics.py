"""Metrics registry: counters, gauges, histograms, phase timers (port of
``repro.obs.metrics``).

The registry is the numeric half of the flight recorder
(:class:`repro_torch.obs.FlightRecorder`): named, optionally labeled
instruments that the serving path increments as it works — SLO-miss and
shed counts, queue depths, page-in/out totals, quarantine events, Kalman
innovation magnitudes, compile counts, planner/scan phase times.  Every
instrument is get-or-create by ``(name, labels)``, so independent
components (two gateways in a load sweep, a batcher inside a planner)
share totals when they share a registry — the Prometheus convention.

Pure-observer contract: instruments only *read*
values the serving path already computed; nothing in this module feeds
back into selection, delivery, or feedback, so attaching a registry is
bitwise-neutral by construction and the tests assert it end to end.
All state is plain Python/NumPy on host — recording never touches a
device buffer and never forces a sync the caller didn't already pay.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

import numpy as np

# Histograms keep at most this many raw observations (count/sum/min/max
# stay exact past the cap; percentiles then come from the retained
# prefix and the snapshot records how many were dropped — no silent
# truncation).
HISTOGRAM_SAMPLE_CAP = 65536


class Counter:
    """Monotonically increasing total (events, requests, pages)."""

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (>= 0) to the running total."""
        self.value += n

    def snapshot(self) -> dict:
        """Serializable state: ``{"value": total}``."""
        return {"value": float(self.value)}


class Gauge:
    """Last-write-wins instantaneous value (rates, ratios, sizes)."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        """Overwrite the gauge with the current reading."""
        self.value = float(v)

    def snapshot(self) -> dict:
        """Serializable state: ``{"value": last}``."""
        return {"value": float(self.value)}


class Histogram:
    """Distribution sketch: exact count/sum/min/max plus a bounded raw
    sample (first :data:`HISTOGRAM_SAMPLE_CAP` observations) for
    percentiles."""

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._sample: list[float] = []
        self.dropped = 0

    def observe(self, v: float) -> None:
        """Record one observation."""
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._sample) < HISTOGRAM_SAMPLE_CAP:
            self._sample.append(v)
        else:
            self.dropped += 1

    def observe_many(self, values) -> None:
        """Record a batch of observations (any array-like)."""
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        self.count += int(arr.size)
        self.total += float(arr.sum())
        self.min = min(self.min, float(arr.min()))
        self.max = max(self.max, float(arr.max()))
        room = HISTOGRAM_SAMPLE_CAP - len(self._sample)
        if room > 0:
            self._sample.extend(float(x) for x in arr[:room])
        self.dropped += max(int(arr.size) - room, 0)

    @property
    def mean(self) -> float:
        """Mean of all observations (0.0 when empty)."""
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Percentile over the retained sample (0.0 when empty)."""
        return float(np.percentile(np.asarray(self._sample), q)) \
            if self._sample else 0.0

    def snapshot(self) -> dict:
        """Serializable summary (count/sum/min/max/mean/p50/p99 plus the
        dropped-observation count — never a silent cap)."""
        return {
            "count": int(self.count),
            "sum": float(self.total),
            "min": float(self.min) if self.count else 0.0,
            "max": float(self.max) if self.count else 0.0,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "dropped_observations": int(self.dropped),
        }


class PhaseTimer:
    """Accumulating wall-time phase timer.

    Unlike the ad-hoc ``last_plan_s``-style attributes it replaces, a
    timer keeps the FULL accounting across repeated runs on the same
    component: ``total_s`` and ``count`` accumulate, ``last_s`` holds the
    most recent observation (the read-through alias the old attributes
    map onto), and ``min_s``/``max_s`` bound the distribution.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.count = 0
        self.total_s = 0.0
        self.last_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    def observe(self, seconds: float) -> None:
        """Record one phase duration."""
        seconds = float(seconds)
        self.count += 1
        self.total_s += seconds
        self.last_s = seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    @contextmanager
    def time(self):
        """Context manager timing its body with the timer's clock."""
        t0 = self._clock()
        try:
            yield self
        finally:
            self.observe(self._clock() - t0)

    def snapshot(self) -> dict:
        """Serializable summary (count/total/last/min/max/mean)."""
        return {
            "count": int(self.count),
            "total_s": float(self.total_s),
            "last_s": float(self.last_s),
            "min_s": float(self.min_s) if self.count else 0.0,
            "max_s": float(self.max_s),
            "mean_s": self.total_s / self.count if self.count else 0.0,
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "timer": PhaseTimer}


class MetricsRegistry:
    """Named, labeled instrument store shared across components.

    Instruments are get-or-create by ``(name, sorted(labels))``; asking
    for an existing name with a different *kind* is an error (a catalog
    must stay consistent).  ``snapshot()`` flattens everything into a
    JSON-ready list; ``save()``/``load_snapshot()`` round-trip it to
    disk for ``repro_torch.obs.report``.
    """

    def __init__(self):
        self._metrics: dict[tuple, object] = {}

    def _get(self, kind: str, name: str, labels: dict):
        key = (name, tuple(sorted(labels.items())))
        inst = self._metrics.get(key)
        if inst is None:
            inst = _KINDS[kind]()
            inst._kind = kind
            self._metrics[key] = inst
        elif inst._kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {inst._kind}, "
                f"requested as {kind}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create the counter ``name`` with ``labels``."""
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        """Get-or-create the gauge ``name`` with ``labels``."""
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        """Get-or-create the histogram ``name`` with ``labels``."""
        return self._get("histogram", name, labels)

    def timer(self, name: str, **labels) -> PhaseTimer:
        """Get-or-create the phase timer ``name`` with ``labels``."""
        return self._get("timer", name, labels)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> list[dict]:
        """All instruments as JSON-ready records, sorted by (name,
        labels) so snapshots diff cleanly."""
        out = []
        for (name, labels), inst in sorted(self._metrics.items()):
            out.append({"name": name, "type": inst._kind,
                        "labels": dict(labels), **inst.snapshot()})
        return out

    def save(self, path: str) -> None:
        """Write :meth:`snapshot` as pretty-printed JSON."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
            f.write("\n")

    @staticmethod
    def load_snapshot(path: str) -> list[dict]:
        """Read a :meth:`save`-written snapshot back."""
        with open(path) as f:
            return json.load(f)
