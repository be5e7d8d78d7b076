"""Seeded fault injection and Kalman-bank detection for the serving path
(port of ``repro.traffic.faults``).

ALERT's estimation layer exists to absorb environmental volatility
(co-runners, DVFS drift, resource loss).  This module makes that claim an
injectable, replayable scenario matrix:

* :class:`FaultSchedule`: a pure, seeded description of what goes wrong
  and when, from four event classes:

  - :class:`LaneStraggler`: one lane's co-runner drift, its slow-down
    ramping from 1 to ``1 + magnitude``;
  - :class:`DeviceLoss`: correlated loss of a device's contiguous lane
    group (optionally revived);
  - :class:`DVFSDrift`: thermal throttling, a global slow-down ramp;
  - :class:`Brownout`: intermittent power, periodic global slow-down
    windows.

  The schedule is query-only: ``slow_at(now)`` and ``dead_at(now)`` are
  pure float64 host functions of time, the reference's arithmetic op for
  op, so both packages see bit-identical perturbations.  The per-event
  magnitude jitter is pre-drawn at construction from an explicitly
  threaded ``numpy.random.Generator`` (int or Generator seeds).

* :class:`KalmanLaneDetector`: detection through ALERT's own Eq. 7
  posterior, not an oracle flag.  Each round it reads the slow-down
  bank's per-lane ``(mu, sigma)`` (host copies) and applies
  :class:`~repro_torch.runtime.straggler.StragglerMonitor`'s thresholds:
  a fleet-median-normalised ratio, an innovation-significance floor and a
  persistence count.  Lane stragglers trip it; global drift (DVFS,
  brownout) moves the median too and does not.

The response (quarantine on device loss, checkpointed resume) lives in
the gateway (:mod:`repro_torch.traffic.gateway`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.runtime.elastic import dead_lane_mask

#: Fault classes of the chaos scenario matrix.
FAULT_KINDS = ("straggler_drift", "device_loss", "dvfs_drift", "brownout")


@dataclasses.dataclass(frozen=True)
class LaneStraggler:
    """One lane's co-runner drift: its slow-down multiplier ramps
    linearly from 1 at ``start`` to ``1 + magnitude`` at
    ``start + ramp_s`` and plateaus there."""

    lane: int
    start: float
    magnitude: float = 1.0
    ramp_s: float = 1.0


@dataclasses.dataclass(frozen=True)
class DeviceLoss:
    """Correlated loss of the lanes in ``lanes`` at time ``at`` — a
    device's contiguous lane shard dying mid-sweep.  ``restore_at``
    (optional) revives the lanes (power cycle); ``None`` is permanent.
    Loss takes effect at the next round boundary — the schedule's query
    granularity."""

    at: float
    lanes: tuple[int, ...]
    restore_at: float | None = None


@dataclasses.dataclass(frozen=True)
class DVFSDrift:
    """Thermal/DVFS throttling: every lane's slow-down ramps at
    ``rate_per_s`` starting at ``start``, capped at ``cap``."""

    start: float
    rate_per_s: float
    cap: float = 2.0


@dataclasses.dataclass(frozen=True)
class Brownout:
    """Intermittent power (Zygarde's setting): from ``start`` until
    ``until``, the first ``duty`` fraction of every ``period`` is a
    brownout window during which every lane runs ``slowdown`` x
    slower."""

    start: float
    period: float
    duty: float = 0.5
    slowdown: float = 1.5
    until: float = math.inf


class FaultSchedule:
    """A seeded, replayable fault scenario over ``n_lanes`` lanes.

    ``events`` mixes the four event classes freely.  ``jitter_cv``
    draws one log-normal magnitude multiplier per event at construction
    (``seed``: int or ``numpy.random.Generator``) — the only randomness,
    so two schedules built with the same seed are identical and both
    gateways replay the same perturbation bit for bit.

    The queries are pure float64 functions of ``now``:

    * :meth:`slow_at` — the ``[n_lanes]`` latency multiplier applied on
      top of the environment's true scale (``xi * lambda``);
    * :meth:`dead_at` — the ``[n_lanes]`` lane-death mask.
    """

    def __init__(self, n_lanes: int,
                 events: Sequence = (), *,
                 seed: int | np.random.Generator = 0,
                 jitter_cv: float = 0.0):
        self.n_lanes = int(n_lanes)
        self.events = tuple(events)
        rng = seed if isinstance(seed, np.random.Generator) \
            else np.random.default_rng(seed)
        # One pre-drawn multiplier per event, always drawn (scale-0
        # normal is exactly 0.0, so jitter_cv=0 gives exactly 1.0 and
        # the Generator stream advances identically either way).
        self._jitter = np.exp(rng.normal(
            0.0, float(jitter_cv), size=len(self.events)))
        for ev in self.events:
            if isinstance(ev, (LaneStraggler,)) and not \
                    (0 <= ev.lane < self.n_lanes):
                raise ValueError(f"straggler lane {ev.lane} outside "
                                 f"[0, {self.n_lanes})")
            if isinstance(ev, DeviceLoss):
                bad = [ln for ln in ev.lanes
                       if not 0 <= ln < self.n_lanes]
                if bad:
                    raise ValueError(f"device-loss lanes {bad} outside "
                                     f"[0, {self.n_lanes})")

    def slow_at(self, now: float) -> np.ndarray:
        """Per-lane slow-down multiplier at time ``now`` (``[n_lanes]``
        f64, all ones when nothing is active) — deterministic, so the
        host gateways of both packages compute identical bits."""
        f = np.ones(self.n_lanes)
        for ev, j in zip(self.events, self._jitter):
            if isinstance(ev, LaneStraggler):
                if now >= ev.start:
                    ramp = 1.0 if ev.ramp_s <= 0 else \
                        min((now - ev.start) / ev.ramp_s, 1.0)
                    f[ev.lane] = f[ev.lane] * \
                        (1.0 + ev.magnitude * j * ramp)
            elif isinstance(ev, DVFSDrift):
                if now >= ev.start:
                    f = f * min(1.0 + ev.rate_per_s * j
                                * (now - ev.start), ev.cap)
            elif isinstance(ev, Brownout):
                if ev.start <= now < ev.until:
                    phase = (now - ev.start) % ev.period
                    if phase < ev.duty * ev.period:
                        f = f * (ev.slowdown * j)
        return f

    def dead_at(self, now: float) -> np.ndarray:
        """Lane-death mask at time ``now`` (``[n_lanes]`` bool): lanes
        inside a :class:`DeviceLoss` window are dead."""
        dead = np.zeros(self.n_lanes, dtype=bool)
        for ev in self.events:
            if isinstance(ev, DeviceLoss):
                end = math.inf if ev.restore_at is None else \
                    ev.restore_at
                if ev.at <= now < end:
                    dead[list(ev.lanes)] = True
        return dead

    @property
    def has_faults(self) -> bool:
        """Whether the schedule carries any events at all."""
        return bool(self.events)


def scenario(kind: str, n_lanes: int, *, start: float,
             horizon: float, seed: int | np.random.Generator = 0,
             magnitude: float = 1.5, jitter_cv: float = 0.0,
             n_devices: int = 4) -> FaultSchedule:
    """Build one canonical chaos-matrix scenario (``kind`` from
    :data:`FAULT_KINDS`) over ``[start, horizon)``:

    * ``straggler_drift`` — the last quarter of the lanes (at least one)
      ramp to ``1 + magnitude`` x over a fifth of the remaining horizon;
    * ``device_loss`` — the last of ``n_devices`` contiguous lane groups
      dies at ``start`` (:func:`~repro_torch.runtime.elastic.dead_lane_mask`);
    * ``dvfs_drift`` — a global thermal ramp reaching ``1 + magnitude``
      at the horizon;
    * ``brownout`` — periodic global windows (half duty, five periods
      across the remaining horizon) at ``1 + magnitude`` x.
    """
    span = max(horizon - start, 1e-9)
    if kind == "straggler_drift":
        lanes = range(max(n_lanes - max(n_lanes // 4, 1), 0), n_lanes)
        events = [LaneStraggler(lane=ln, start=start,
                                magnitude=magnitude, ramp_s=span / 5.0)
                  for ln in lanes]
    elif kind == "device_loss":
        lost = np.nonzero(dead_lane_mask(n_lanes, n_devices,
                                         [n_devices - 1]))[0]
        events = [DeviceLoss(at=start,
                             lanes=tuple(int(x) for x in lost))]
    elif kind == "dvfs_drift":
        events = [DVFSDrift(start=start, rate_per_s=magnitude / span,
                            cap=1.0 + magnitude)]
    elif kind == "brownout":
        events = [Brownout(start=start, period=span / 5.0, duty=0.5,
                           slowdown=1.0 + magnitude, until=horizon)]
    else:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"one of {FAULT_KINDS}")
    return FaultSchedule(n_lanes, events, seed=seed,
                         jitter_cv=jitter_cv)


@dataclasses.dataclass
class KalmanLaneDetector:
    """Straggler detection on the per-lane Eq. 7 posterior.

    Each round the gateway feeds the :class:`SlowdownFilterBank`'s
    ``(mu, std)`` plus the round's active mask.  A lane alarms when its
    mu, normalised by the fleet median mu (the
    :class:`~repro_torch.runtime.straggler.StragglerMonitor` normalisation —
    global drift moves the median too, so only *relative* stragglers
    alarm), exceeds ``max(1 + alarm_sigma * fleet_std, min_ratio)``
    where ``fleet_std`` is the *fleet median* posterior std: the
    healthy fleet's uncertainty sets the significance bar, so a
    straggler's own miss-inflated variance (Eq. 7 conservatism) cannot
    mask its alarm.  ``persistent_after`` consecutive alarms trip.  Pure
    observer: it never alters selection (ALERT's reaction *is* the mu
    inflation), so runs with and without a detector are bitwise
    identical.
    """

    n_lanes: int
    alarm_sigma: float = 3.0
    min_ratio: float = 1.3
    persistent_after: int = 3
    # Optional flight recorder (repro_torch.obs.FlightRecorder): trips
    # become a counter and instant events; thresholds never read it.
    obs: object = None

    def __post_init__(self):
        self.alarm_counts = np.zeros(self.n_lanes, dtype=np.int64)
        self.tripped = np.zeros(self.n_lanes, dtype=bool)
        self.first_trip_time = np.full(self.n_lanes, np.nan)
        self.rounds_seen = 0

    def observe(self, mu: np.ndarray, std: np.ndarray,
                active: np.ndarray, now: float) -> np.ndarray:
        """Absorb one round's posterior; returns the lanes newly
        tripped this round.  Inactive lanes freeze their counts (no
        evidence either way)."""
        mu = np.asarray(mu, dtype=np.float64)
        std = np.asarray(std, dtype=np.float64)
        active = np.asarray(active, dtype=bool)
        self.rounds_seen += 1
        if not active.any():
            return np.zeros(0, dtype=np.int64)
        med = float(np.median(mu[active]))
        ratio = mu / max(med, 1e-12)
        fleet_std = float(np.median(std[active]))
        threshold = max(1.0 + self.alarm_sigma * fleet_std,
                        self.min_ratio)
        alarm = active & (ratio > threshold)
        self.alarm_counts[alarm] += 1
        self.alarm_counts[active & ~alarm] = 0
        newly = np.nonzero((self.alarm_counts >= self.persistent_after)
                           & ~self.tripped)[0]
        self.tripped[newly] = True
        self.first_trip_time[newly] = now
        if newly.size and self.obs is not None \
                and getattr(self.obs, "enabled", False):
            self.obs.metrics.counter("detector_trips").inc(newly.size)
            self.obs.spans.event(
                "detector_trip", cat="fault",
                lanes=[int(x) for x in newly], now_s=float(now))
        return newly

    def recommendation(self, lane: int) -> str:
        """Mitigation for ``lane``: ``"reshard"`` once tripped
        (persistent straggler — drop the lane and re-mesh via
        :mod:`repro_torch.runtime.elastic`), else ``"tolerate"`` (transient;
        ALERT's conservative picks absorb it)."""
        return "reshard" if self.tripped[lane] else "tolerate"

    def detection_latency(self, lane: int, fault_start: float) -> float:
        """Seconds from ``fault_start`` to the lane's first trip
        (``nan`` if never tripped)."""
        return float(self.first_trip_time[lane]) - float(fault_start)
