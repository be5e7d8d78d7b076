"""Seeded open-loop arrival generators and tenant mixtures (port of
``repro.traffic.workloads``).

The tick-synchronous :class:`~repro_torch.serving.sim.FleetSim` feeds
every stream one input per tick, so offered load never stresses the
controller.  This module generates *arrival-driven* traffic instead: each
session draws request arrival times from a stochastic process, tags every
request with its session's deadline and goal, and the gateway
(:mod:`repro_torch.traffic.gateway`) serves whatever the clock has made
due.  All randomness flows through explicitly threaded
``numpy.random.Generator`` streams, in the reference's order, so a seed
gives the reference's workload bit for bit.  Host numpy, no tensors.

Processes (all open-loop: arrivals do not react to service):

* :class:`PoissonProcess`: memoryless arrivals at a fixed rate;
* :class:`MMPPProcess`: 2-state Markov-modulated Poisson bursts;
* :class:`DiurnalProcess`: a sinusoidal rate, realised by thinning
  against the peak rate;
* :class:`FlashCrowdProcess`: a baseline rate with a rectangular spike.

:class:`TenantSpec` bundles a process with a goal, constraints and an
environment-phase schedule; :func:`build_sessions` expands a tenant
mixture into per-session arrivals and environment traces, and
:func:`generate_requests` flattens them into one time-sorted request list
with deterministic ids.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.controller import Constraints, Goal
from repro_torch.serving.batcher import Request
from repro_torch.serving.sim import DEFAULT_ENV, EnvironmentTrace, Phase


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base class for open-loop arrival processes: :meth:`times` draws
    the absolute arrival instants over ``[0, horizon)`` from a caller
    threaded Generator; :meth:`scaled` returns the same process with all
    rates multiplied by ``factor`` (the load-sweep knob)."""

    def times(self, horizon: float,
              rng: np.random.Generator) -> np.ndarray:
        """Draw sorted absolute arrival times in ``[0, horizon)``."""
        raise NotImplementedError

    def scaled(self, factor: float) -> "ArrivalProcess":
        """This process with every rate multiplied by ``factor``."""
        raise NotImplementedError


def _poisson_times(rate: float, horizon: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson arrivals on [0, horizon) via exponential gaps
    (draws in geometric batches so the gap count never truncates)."""
    if rate <= 0.0 or horizon <= 0.0:
        return np.zeros(0)
    out = []
    t = 0.0
    n_draw = max(int(rate * horizon * 1.5) + 8, 8)
    while t < horizon:
        gaps = rng.exponential(1.0 / rate, n_draw)
        ts = t + np.cumsum(gaps)
        out.append(ts[ts < horizon])
        t = float(ts[-1])
    return np.concatenate(out) if out else np.zeros(0)


@dataclasses.dataclass(frozen=True)
class PoissonProcess(ArrivalProcess):
    """Memoryless arrivals at ``rate`` requests/second."""

    rate: float = 1.0

    def times(self, horizon: float,
              rng: np.random.Generator) -> np.ndarray:
        """Exponential-gap draws over the horizon."""
        return _poisson_times(self.rate, horizon, rng)

    def scaled(self, factor: float) -> "PoissonProcess":
        """Poisson at ``rate * factor``."""
        return PoissonProcess(rate=self.rate * factor)


@dataclasses.dataclass(frozen=True)
class MMPPProcess(ArrivalProcess):
    """2-state Markov-modulated Poisson bursts: the process alternates
    between a quiet state (``rate_low``, mean dwell ``dwell_low`` s) and
    a burst state (``rate_high``, mean dwell ``dwell_high`` s), with
    Poisson arrivals at the current state's rate."""

    rate_low: float = 0.5
    rate_high: float = 4.0
    dwell_low: float = 20.0
    dwell_high: float = 5.0

    def times(self, horizon: float,
              rng: np.random.Generator) -> np.ndarray:
        """Alternating exponential sojourns, Poisson within each."""
        out = []
        t = 0.0
        high = False
        while t < horizon:
            dwell = self.dwell_high if high else self.dwell_low
            rate = self.rate_high if high else self.rate_low
            end = min(t + rng.exponential(dwell), horizon)
            ts = t + _poisson_times(rate, end - t, rng)
            out.append(ts)
            t = end
            high = not high
        return np.concatenate(out) if out else np.zeros(0)

    def scaled(self, factor: float) -> "MMPPProcess":
        """Both state rates scaled; dwell structure unchanged."""
        return dataclasses.replace(self, rate_low=self.rate_low * factor,
                                   rate_high=self.rate_high * factor)


@dataclasses.dataclass(frozen=True)
class DiurnalProcess(ArrivalProcess):
    """Sinusoidal day/night rate ``rate * (1 + amplitude*sin(...))``,
    realised by thinning a peak-rate Poisson stream (Lewis–Shedler)."""

    rate: float = 1.0
    amplitude: float = 0.6      # in [0, 1]
    period: float = 60.0        # seconds per "day"
    phase: float = 0.0

    def times(self, horizon: float,
              rng: np.random.Generator) -> np.ndarray:
        """Thin peak-rate arrivals by the instantaneous rate ratio."""
        peak = self.rate * (1.0 + self.amplitude)
        ts = _poisson_times(peak, horizon, rng)
        lam = self.rate * (1.0 + self.amplitude * np.sin(
            2.0 * np.pi * ts / self.period + self.phase))
        keep = rng.random(ts.shape[0]) < lam / peak
        return ts[keep]

    def scaled(self, factor: float) -> "DiurnalProcess":
        """Mean rate scaled; cycle shape unchanged."""
        return dataclasses.replace(self, rate=self.rate * factor)


@dataclasses.dataclass(frozen=True)
class FlashCrowdProcess(ArrivalProcess):
    """Baseline ``rate`` with a rectangular spike at ``spike_rate``
    during ``[spike_start, spike_start + spike_len)`` — the flash-crowd
    overload scenario."""

    rate: float = 1.0
    spike_rate: float = 8.0
    spike_start: float = 20.0
    spike_len: float = 10.0

    def times(self, horizon: float,
              rng: np.random.Generator) -> np.ndarray:
        """Thin spike-rate arrivals by the piecewise-constant rate."""
        peak = max(self.rate, self.spike_rate)
        ts = _poisson_times(peak, horizon, rng)
        in_spike = (ts >= self.spike_start) & \
            (ts < self.spike_start + self.spike_len)
        lam = np.where(in_spike, self.spike_rate, self.rate)
        keep = rng.random(ts.shape[0]) < lam / peak
        return ts[keep]

    def scaled(self, factor: float) -> "FlashCrowdProcess":
        """Baseline and spike rates scaled together."""
        return dataclasses.replace(self, rate=self.rate * factor,
                                   spike_rate=self.spike_rate * factor)


# ------------------------------------------------------------------ #
# tenants and sessions                                               #
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant class of a traffic mixture: ``n_sessions`` sessions,
    each drawing arrivals from (its own seeded copy of) ``process`` and
    solving ``goal`` under ``constraints`` (relative deadline + goal
    value) in an environment following ``phases`` (the per-tenant
    contention schedule, rescaled to each session's request count)."""

    name: str
    goal: Goal
    constraints: Constraints
    process: ArrivalProcess
    n_sessions: int = 1
    phases: tuple[Phase, ...] = DEFAULT_ENV

    def scaled(self, factor: float) -> "TenantSpec":
        """This tenant with its arrival process scaled by ``factor``."""
        return dataclasses.replace(self,
                                   process=self.process.scaled(factor))


@dataclasses.dataclass(frozen=True)
class Session:
    """One long-lived tenant session: its arrival instants, its own
    pre-drawn :class:`~repro_torch.serving.sim.EnvironmentTrace` (one input
    per arrival — slow-down, length and deadline jitter), and the
    tenant's goal/constraints.  The per-input *nominal* relative
    deadline is ``constraints.deadline * trace.deadline_scale[i]``; the
    absolute deadline of request i is its arrival plus that."""

    sid: int
    tenant: str
    goal: Goal
    constraints: Constraints
    arrivals: np.ndarray
    trace: EnvironmentTrace

    @property
    def n_requests(self) -> int:
        """Number of requests this session emits."""
        return int(self.arrivals.shape[0])

    def rel_deadline(self, i: int) -> float:
        """Nominal relative deadline of this session's input ``i``."""
        return self.constraints.deadline * \
            float(self.trace.deadline_scale[i])


def _phases_sized(phases: tuple[Phase, ...], n: int) -> tuple[Phase, ...]:
    """Rescale a phase schedule to exactly ``n`` inputs, preserving the
    relative phase proportions (the last phase absorbs rounding)."""
    total = sum(p.n_inputs for p in phases)
    sized = []
    used = 0
    for k, p in enumerate(phases):
        take = n - used if k == len(phases) - 1 else \
            int(round(n * p.n_inputs / total))
        take = max(min(take, n - used), 0)
        if take:
            sized.append(dataclasses.replace(p, n_inputs=take))
        used += take
    if not sized:  # n == 0: keep a degenerate 1-input schedule
        sized = [dataclasses.replace(phases[0], n_inputs=max(n, 1))]
    return tuple(sized)


def build_sessions(mix: Sequence[TenantSpec], horizon: float,
                   seed: int = 0, length_cv: float = 0.0,
                   deadline_cv: float = 0.0) -> list[Session]:
    """Expand a tenant mixture into concrete sessions.

    Each session gets its own deterministic child seed (derived from
    ``seed`` and its global session index): one Generator drives its
    arrival draws and a *separate* integer-seeded
    :class:`~repro_torch.serving.sim.EnvironmentTrace` holds its environment
    randomness, sized to its arrival count — so a session's environment
    is reproducible independently of every other session (the
    FleetSim-equivalence tests lean on this).
    """
    sessions: list[Session] = []
    sid = 0
    for tenant in mix:
        for _ in range(tenant.n_sessions):
            arr_rng = np.random.default_rng(seed * 1_000_003 + sid)
            arrivals = np.sort(tenant.process.times(horizon, arr_rng))
            trace = EnvironmentTrace(
                _phases_sized(tenant.phases, arrivals.shape[0]),
                seed=seed + sid, length_cv=length_cv,
                deadline_cv=deadline_cv)
            sessions.append(Session(
                sid=sid, tenant=tenant.name, goal=tenant.goal,
                constraints=tenant.constraints, arrivals=arrivals,
                trace=trace))
            sid += 1
    return sessions


@dataclasses.dataclass(order=False)
class TrafficRequest(Request):
    """A :class:`~repro_torch.serving.batcher.Request` tagged with its session
    (``sid``), per-session input index (which binds the request to its
    pre-drawn environment draws), tenant name, and *nominal* relative
    deadline (the absolute ``deadline`` is ``arrival + rel_deadline``;
    the gateway recomputes the effective deadline from the relative one
    so zero queueing delay reproduces the nominal bitwise)."""

    sid: int = 0
    index: int = 0
    tenant: str = ""
    rel_deadline: float = 0.0


def generate_requests(sessions: Sequence[Session]) -> list[TrafficRequest]:
    """Flatten sessions into one time-sorted open-loop request list.

    Ids are assigned 0..N-1 in (arrival, sid) order — deterministic per
    workload, independent of any batcher — and each request carries its
    session's pre-drawn nominal relative deadline for its input index.
    """
    by_sid = {s.sid: s for s in sessions}
    rows = []
    for s in sessions:
        for i in range(s.n_requests):
            rows.append((float(s.arrivals[i]), s.sid, i))
    rows.sort()
    out = []
    for rid, (arr, sid, i) in enumerate(rows):
        s = by_sid[sid]
        rel = s.rel_deadline(i)
        out.append(TrafficRequest(
            deadline=arr + rel, arrival=arr, req_id=rid, sid=sid,
            index=i, tenant=s.tenant, rel_deadline=rel))
    return out
