"""Environment simulator (port of ``repro.serving.sim``): the paper's
evaluation protocol (Section 5.1) at fleet scale.

One input is one inference request.  The environment draws, per input n,
a phase-dependent slow-down ``xi_true(n)`` (Default / CPU / Memory
contention phases, paper Table 3) with lognormal jitter and a heavy tail
(Fig. 2), and an input-length factor ``lambda(n)``.  Config (i, j) then
takes ``t = t_train[i, j] * xi_true * lambda``; energy follows Eq. 9 with
the platform's true phi, accuracy Eq. 3 (traditional) or Eq. 10 (anytime
staircase).

Schemes (paper Table 3): ``alert``, ``alert_trad`` (no anytime
candidates), ``alert_dnn`` (system-default power), ``alert_power``
(fastest traditional DNN, controller power), ``alert_plus`` (the
E[min(t, T)] energy estimator), ``oracle`` (per-input perfect knowledge)
and ``oracle_static`` (the best single config in hindsight).

:class:`FleetSim` advances S streams on one global tick grid.  Each tick
makes one :class:`~repro_torch.core.batched.BatchedAlertEngine` select
over every lane (the ``alert_select`` kernel on the card), one host
:func:`deliver_tick`, and the feedback step (:func:`observe_fleet` and the
:class:`WindowedGoalBank`).  Filter and goal state live on the engine's
device; traces, delivery and results are host numpy, as in the reference.
Streams may differ in phases, goal, constraints and arrival tick; lanes
outside a stream's lifetime are masked, not re-padded.
``InferenceSim.run_alert`` is the S=1 slice of the same path.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.batched import (BatchedAlertEngine, WindowedGoalBank,
                                      goal_codes)
from repro_torch.core.controller import Constraints, Goal
from repro_torch.core.kalman import (IdlePowerFilterBank, SlowdownFilterBank,
                                     observe_fleet)
from repro_torch.core.profiles import ProfileTable
from repro_torch.launch.mesh import mesh_device

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class Phase:
    """One contention phase of an environment trace: ``n_inputs`` draws
    with mean slow-down ``slowdown``, lognormal jitter ``jitter_cv``, and
    a heavy tail (paper Table 3 / Fig. 2)."""

    n_inputs: int
    slowdown: float = 1.0      # mean xi_true
    jitter_cv: float = 0.08    # lognormal coefficient of variation
    tail_prob: float = 0.02    # heavy-tail outlier probability (Fig. 2)
    tail_scale: float = 3.0


DEFAULT_ENV = (Phase(400),)
CPU_ENV = (Phase(80), Phase(240, slowdown=1.5, jitter_cv=0.15),
           Phase(80))
MEMORY_ENV = (Phase(80), Phase(240, slowdown=2.2, jitter_cv=0.25,
                               tail_prob=0.04, tail_scale=3.0), Phase(80))

ENVS = {"default": DEFAULT_ENV, "cpu": CPU_ENV, "memory": MEMORY_ENV}


@dataclasses.dataclass
class TraceResult:
    """Per-input outcomes of one stream under one scheme (arrays [N])."""

    energy: np.ndarray        # [N] J per input
    accuracy: np.ndarray      # [N] delivered accuracy
    latency: np.ndarray       # [N] realised latency (s)
    missed: np.ndarray        # [N] deadline misses (bool)
    scheme: str = ""
    budget: np.ndarray | None = None   # [N] per-input energy budget
    # (model, power) of a single-config scheme (oracle_static), else None.
    config: tuple[int, int] | None = None

    @property
    def mean_energy(self) -> float:
        """Mean per-input energy (J), the paper's Table 4 column."""
        return float(self.energy.mean())

    @property
    def mean_error(self) -> float:
        """Mean (1 - delivered accuracy)."""
        return float(1.0 - self.accuracy.mean())

    @property
    def miss_rate(self) -> float:
        """Fraction of inputs that missed their deadline."""
        return float(self.missed.mean())

    def violates(self, goal: Goal, cons: Constraints,
                 window: int = 10, tol: float = 0.10) -> bool:
        """Constraint violated in more than ``tol`` of the ``window``-input
        windows (the Table 4 superscript convention)."""
        if goal is Goal.MINIMIZE_ENERGY:
            q = cons.accuracy_goal
            win = np.convolve(self.accuracy, np.ones(window) / window,
                              mode="valid")
            return float((win < q - 1e-9).mean()) > tol
        if self.budget is not None:
            bwin = np.convolve(self.budget, np.ones(window) / window,
                               mode="valid")
        else:
            bwin = cons.energy_goal
        win = np.convolve(self.energy, np.ones(window) / window,
                          mode="valid")
        return float((win > bwin + 1e-9).mean()) > tol


class EnvironmentTrace:
    """Pre-drawn environment randomness, so every scheme sees the same
    trace (a paired comparison).

    Every draw comes from one ``numpy.random.Generator`` in the
    reference's order, so an integer seed gives the reference's trace bit
    for bit.  ``seed`` may also be a ``Generator``, which construction
    consumes.
    """

    def __init__(self, phases: tuple[Phase, ...],
                 seed: int | np.random.Generator = 0,
                 length_cv: float = 0.0, deadline_cv: float = 0.0):
        self.phases = tuple(phases)
        self.seed = seed if isinstance(seed, int) else None
        self.length_cv = length_cv
        self.deadline_cv = deadline_cv
        rng = seed if isinstance(seed, np.random.Generator) \
            else np.random.default_rng(seed)
        xs, phase_id = [], []
        for pi, ph in enumerate(phases):
            sigma = np.sqrt(np.log(1 + ph.jitter_cv ** 2))
            draw = ph.slowdown * rng.lognormal(-sigma ** 2 / 2, sigma,
                                               ph.n_inputs)
            tail = rng.random(ph.n_inputs) < ph.tail_prob
            draw = np.where(tail, draw * ph.tail_scale, draw)
            xs.append(draw)
            phase_id.extend([pi] * ph.n_inputs)
        self.xi = np.concatenate(xs)
        n = len(self.xi)
        if length_cv > 0:
            sigma = np.sqrt(np.log(1 + length_cv ** 2))
            self.lam = rng.lognormal(-sigma ** 2 / 2, sigma, n)
        else:
            self.lam = np.ones(n)
        # Per-input deadline scale ("requirement variety"): visible to
        # every scheme at dispatch time.
        if deadline_cv > 0:
            sigma = np.sqrt(np.log(1 + deadline_cv ** 2))
            self.deadline_scale = rng.lognormal(-sigma ** 2 / 2, sigma, n)
        else:
            self.deadline_scale = np.ones(n)
        self.n = n
        self.phase_id = np.asarray(phase_id)

    def realized_scale(self, n: int) -> float:
        """True latency scale of input n (xi_true * lambda)."""
        return float(self.xi[n] * self.lam[n])


class InferenceSim:
    """Run one scheme over one environment trace.  The ALERT schemes run
    on ``device`` (default the card); the oracles are host numpy."""

    def __init__(self, table: ProfileTable, trace: EnvironmentTrace,
                 phi_true: float = 0.25, device=None):
        self.table = table
        self.trace = trace
        self.phi_true = phi_true
        self.device = device
        groups = table.anytime_groups()
        self._anytime_idx = sorted(
            {i for g in groups.values() for i in g})
        self._trad_idx = [i for i in range(len(table.candidates))
                          if i not in self._anytime_idx]
        # Each anytime candidate's level prefix (staircase delivery).
        self._level_rows = {}
        for g in groups.values():
            for pos, i in enumerate(g):
                self._level_rows[i] = g[:pos + 1]

    def _deadline_vec(self, cons: Constraints) -> np.ndarray:
        return cons.deadline * self.trace.deadline_scale

    def _budget_vec(self, cons: Constraints) -> np.ndarray | None:
        if cons.energy_goal is None:
            return None
        # E_goal = P_goal * T_goal (Section 3.1): budgets scale with the
        # per-input time allotment.
        return cons.energy_goal * self.trace.deadline_scale

    def _deliver(self, i: int, j: int, scale: float, deadline: float
                 ) -> tuple[float, float, float, bool,
                            tuple[float, float] | None]:
        """One input: (latency, delivered accuracy, energy, missed, obs).

        ``obs`` is the uncensored (observed, profiled) latency pair of the
        deepest anytime level that completed, which the runtime measured
        even when the target level missed; None for a traditional DNN.
        """
        t = self.table
        lat = t.latency[i, j] * scale
        obs = None
        if i in self._level_rows:  # anytime: staircase (Eq. 10)
            acc = t.q_fail
            for k in self._level_rows[i]:
                lk = t.latency[k, j] * scale
                if lk <= deadline:
                    acc = t.candidates[k].accuracy
                    obs = (lk, float(t.latency[k, j]))
            missed = lat > deadline
        else:
            missed = lat > deadline
            acc = t.q_fail if missed else t.candidates[i].accuracy
        run_t = min(lat, deadline)
        p = t.run_power[i, j]
        energy = p * run_t + self.phi_true * p * max(deadline - run_t, 0.0)
        return min(lat, deadline), acc, energy, missed, obs

    def run_alert(self, goal: Goal, cons: Constraints, *,
                  anytime: bool = True, power_control: bool = True,
                  dnn_control: bool = True, overhead: float = 0.0,
                  paper_faithful_energy: bool = True,
                  scheme_name: str = "alert") -> TraceResult:
        """One ALERT stream: the S=1 slice of the fleet path."""
        fleet = FleetSim(self.table, [self.trace], phi_true=self.phi_true,
                         device=self.device)
        res = fleet.run_alert(
            goal, cons, anytime=anytime, power_control=power_control,
            dnn_control=dnn_control, overhead=overhead,
            paper_faithful_energy=paper_faithful_energy,
            scheme_name=scheme_name)
        return res.stream(0)

    def _delivery_tensors(self, cons: Constraints):
        """Delivery of every config over the whole trace: ``(latency,
        accuracy, energy, missed)``, each ``[K, L, N]``."""
        t = self.table
        deadline = self._deadline_vec(cons)[None, None, :]  # [1,1,N]
        scale = self.trace.xi * self.trace.lam            # [N]
        lat = t.latency[:, :, None] * scale[None, None, :]
        missed = lat > deadline
        q = t.accuracies[:, None, None]
        acc = np.where(missed, t.q_fail, q)
        for i, rows in self._level_rows.items():          # anytime rows
            acc_i = np.full(lat.shape[1:], t.q_fail)
            for k in rows:
                lk = t.latency[k, :, None] * scale[None, :]
                acc_i = np.where(lk <= deadline[0],
                                 t.candidates[k].accuracy, acc_i)
            acc[i] = acc_i
        run_t = np.minimum(lat, deadline)
        p = t.run_power[:, :, None]
        energy = p * run_t + self.phi_true * p * \
            np.maximum(deadline - run_t, 0.0)
        return np.minimum(lat, deadline), acc, energy, missed

    def run_oracle(self, goal: Goal, cons: Constraints) -> TraceResult:
        """Per-input perfect latency/energy knowledge, the dynamic optimum
        over traditional DNNs.  Ties go to the first (model, power) in
        row-major order."""
        N = self.trace.n
        lat, acc, energy, missed = self._delivery_tensors(cons)
        bvec = self._budget_vec(cons)
        idx = self._trad_idx
        lat, acc = lat[idx], acc[idx]
        energy, missed = energy[idx], missed[idx]
        K, L, _ = lat.shape
        if goal is Goal.MINIMIZE_ENERGY:
            feasible = (acc >= cons.accuracy_goal - 1e-12) & ~missed
            score = np.where(feasible, energy, np.inf)
            pick = score.reshape(K * L, N).argmin(axis=0)
            # Nothing feasible: the most accurate config.
            none = ~feasible.any(axis=(0, 1))
            alt = acc.reshape(K * L, N).argmax(axis=0)
            pick = np.where(none, alt, pick)
        else:
            feasible = energy <= bvec[None, None, :] + 1e-12
            score = np.where(feasible, acc, -np.inf)
            pick = score.reshape(K * L, N).argmax(axis=0)
            none = ~feasible.any(axis=(0, 1))
            alt = energy.reshape(K * L, N).argmin(axis=0)
            pick = np.where(none, alt, pick)
        ar = np.arange(N)
        return TraceResult(
            energy.reshape(K * L, N)[pick, ar],
            acc.reshape(K * L, N)[pick, ar],
            lat.reshape(K * L, N)[pick, ar],
            missed.reshape(K * L, N)[pick, ar], "oracle", budget=bvec)

    def run_oracle_static(self, goal: Goal, cons: Constraints
                          ) -> TraceResult:
        """The best single (traditional model, power) for the whole trace
        in hindsight (the Table 4 baseline)."""
        lat, acc, energy, missed = self._delivery_tensors(cons)
        bvec = self._budget_vec(cons)
        best = None
        for i in self._trad_idx:
            for j in range(len(self.table.power_caps)):
                res = TraceResult(energy[i, j], acc[i, j], lat[i, j],
                                  missed[i, j], "oracle_static",
                                  budget=bvec, config=(i, j))
                # A static pick must satisfy the constraint in every
                # window; the 10 % rule only breaks ties after that.
                strict = res.violates(goal, cons, tol=0.0)
                loose = res.violates(goal, cons)
                if goal is Goal.MINIMIZE_ENERGY:
                    key = (strict, loose, res.mean_energy, res.mean_error)
                else:
                    key = (strict, loose, res.mean_error, res.mean_energy)
                if best is None or key < best[0]:
                    best = (key, res)
        return best[1]

    def run_alert_fleet(self, goal: Goal, cons: Constraints,
                        n_streams: int, *, seed: int = 0,
                        **kwargs) -> "FleetResult":
        """This trace's phases cloned into ``n_streams`` streams seeded
        ``seed, seed + 1, ...``, run in lockstep."""
        t = self.trace
        fleet = FleetSim.from_phases(self.table, t.phases, n_streams,
                                     seed=seed, phi_true=self.phi_true,
                                     length_cv=t.length_cv,
                                     deadline_cv=t.deadline_cv,
                                     device=self.device)
        return fleet.run_alert(goal, cons, **kwargs)

    def run_scheme(self, scheme: str, goal: Goal,
                   cons: Constraints) -> TraceResult:
        """Run one scheme by name (see the module docstring)."""
        if scheme == "alert":
            return self.run_alert(goal, cons, scheme_name="alert")
        if scheme == "alert_plus":
            return self.run_alert(goal, cons, paper_faithful_energy=False,
                                  scheme_name="alert_plus")
        if scheme == "alert_trad":
            return self.run_alert(goal, cons, anytime=False,
                                  scheme_name="alert_trad")
        if scheme == "alert_dnn":
            return self.run_alert(goal, cons, power_control=False,
                                  scheme_name="alert_dnn")
        if scheme == "alert_power":
            return self.run_alert(goal, cons, anytime=False,
                                  dnn_control=False,
                                  scheme_name="alert_power")
        if scheme == "oracle":
            return self.run_oracle(goal, cons)
        if scheme == "oracle_static":
            return self.run_oracle_static(goal, cons)
        raise ValueError(scheme)


# ------------------------------------------------------------------ #
# Delivery of one synchronous tick                                     #
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class DeliveredTick:
    """Realised outcomes of one delivery tick (arrays [S]), and the
    feedback pair for the filters (``observed``/``profiled`` latencies and
    the censored ``miss_flag``)."""

    latency: np.ndarray     # [S] run time, capped at the deadline
    accuracy: np.ndarray    # [S] delivered accuracy (staircase Eq. 10)
    energy: np.ndarray      # [S] Eq. 9 with the platform's true phi
    missed: np.ndarray      # [S] bool: target level missed its deadline
    run_power: np.ndarray   # [S] active power of the executed config
    observed: np.ndarray    # [S] latency observation fed to Eq. 6
    profiled: np.ndarray    # [S] matching profiled latency
    miss_flag: np.ndarray   # [S] censored-miss flag for the filter


def deliver_tick(table: ProfileTable, st, i_glob: np.ndarray,
                 j_act: np.ndarray, scale: np.ndarray, dvec: np.ndarray,
                 phi_true: float, is_anytime: np.ndarray,
                 profiled_pick: np.ndarray) -> DeliveredTick:
    """Host delivery of one tick for every lane: :func:`deliver_step` on
    CPU copies of the numpy lane inputs, its outputs viewed as numpy.

    ``i_glob``/``j_act`` are the executed (model, power) indices into
    ``table``, ``scale`` the true latency scale (xi * lambda), ``dvec``
    the per-input deadline, ``st`` the table's
    :meth:`~ProfileTable.staircase_tensors`.  ``profiled_pick`` is the
    profiled latency of the controller's pick (it differs from the
    executed config's only when the power is forced, ``alert_dnn``).
    """
    out = deliver_step(
        *(torch.from_numpy(np.array(x)) for x in (i_glob, j_act, scale,
                                                  dvec)),
        float(phi_true), latency_kl=table.latency,
        run_power_kl=table.run_power, q_fail=table.q_fail,
        is_anytime_k=is_anytime, lvl_lat_kml=st.lvl_lat,
        lvl_valid_km=st.lvl_valid, lvl_acc_km=st.lvl_acc,
        profiled_pick=np.array(profiled_pick))
    return DeliveredTick(*(x.numpy() for x in out))


def deliver_step(i_glob, j_act, scale, dvec, phi_true, *,
                 latency_kl, run_power_kl, q_fail, is_anytime_k,
                 lvl_lat_kml, lvl_valid_km, lvl_acc_km, profiled_pick=None,
                 f_zero=0.0):
    """Delivery of one tick for every lane, as PyTorch ops on the device
    of ``scale``: the reference's ``deliver_tick`` op for op on float64
    tensors, each op rounding once, so every output is bitwise equal to
    the reference's on the same inputs.

    ``i_glob``/``j_act``/``scale``/``dvec`` are the ``[S]`` lane inputs;
    the keyword arrays are the table's constants (numpy, or tensors
    already on the device, which are not copied: with device tensors
    throughout, the step makes no host copy and can be captured in a CUDA
    graph).  ``profiled_pick`` (the
    controller's pick's profiled latency) seeds the censored feedback;
    None means the executed config's (the gateway case).  A missed
    deadline whose staircase still completed level k yields the
    uncensored pair of level k instead (the Section 3.3 co-design).
    ``f_zero`` is added to each product of the energy sum:
    a runtime zero keeps a compiler that fuses multiply-adds from changing
    the rounding (``fma(a, b, 0) == round(a * b)``); eager callers leave
    the default.  Returns the :class:`DeliveredTick` fields as a tuple in
    declaration order.
    """
    dev = scale.device

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    i_glob = on(i_glob, torch.int64)
    j_act = on(j_act, torch.int64)
    latency_kl = on(latency_kl, F64)
    run_power_kl = on(run_power_kl, F64)
    is_anytime_k = on(is_anytime_k, torch.bool)
    lvl_lat_kml = on(lvl_lat_kml, F64)
    lvl_valid_km = on(lvl_valid_km, torch.bool)
    lvl_acc_km = on(lvl_acc_km, F64)
    m = lvl_lat_kml.shape[1]
    lat = latency_kl[i_glob, j_act] * scale
    missed = lat > dvec
    # Advanced indices split by a slice put the lane axis first: [S, M].
    lvl_lat = lvl_lat_kml[i_glob, :, j_act]
    completed = lvl_valid_km[i_glob] & \
        (lvl_lat * scale[:, None] <= dvec[:, None])
    any_done = completed.any(dim=1)
    # The last completed level; m - 1 where none completed, as the host
    # version's argmax over an all-False row gives.
    levels = torch.arange(m, device=dev)
    last_done = torch.where(completed, levels, -1).amax(dim=1)
    last_done = torch.where(any_done, last_done, m - 1)
    # q_fail as a scalar operand: no host-to-device copy, so the step can
    # be captured in a CUDA graph.
    acc = torch.where(any_done, lvl_acc_km[i_glob, last_done],
                      float(q_fail))
    run_t = torch.minimum(lat, dvec)
    p = run_power_kl[i_glob, j_act]
    energy = (p * run_t + f_zero) + \
        (phi_true * p * torch.clamp_min(dvec - run_t, 0.0) + f_zero)
    rows = torch.arange(i_glob.shape[0], device=dev)
    use_obs = missed & is_anytime_k[i_glob] & any_done
    obs_prof = lvl_lat[rows, last_done]
    obs_lat = obs_prof * scale
    observed = torch.where(use_obs, obs_lat, run_t)
    pick = latency_kl[i_glob, j_act] if profiled_pick is None \
        else on(profiled_pick, F64)
    profiled = torch.where(use_obs, obs_prof, pick)
    miss_flag = missed & ~use_obs
    return (run_t, acc, energy, missed, p, observed, profiled, miss_flag)


# ------------------------------------------------------------------ #
# Fleet-scale simulation: S streams, one engine call per tick         #
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One tenant of a fleet: its own environment trace, goal and
    constraints, and its ``arrival`` tick (it departs at ``arrival +
    trace.n``)."""

    trace: EnvironmentTrace
    goal: Goal
    constraints: Constraints
    arrival: int = 0


@dataclasses.dataclass
class FleetResult:
    """Per-stream, per-tick outcomes of a fleet run: ``[S, T]`` host
    arrays on the global tick grid, zero outside each stream's ``[arrival,
    arrival + length)`` window (``active`` marks the live cells).
    :meth:`stream` slices one stream's :class:`TraceResult` out."""

    energy: np.ndarray
    accuracy: np.ndarray
    latency: np.ndarray
    missed: np.ndarray
    scheme: str = ""
    budget: np.ndarray | None = None       # [S, T]
    arrivals: np.ndarray | None = None     # [S] global arrival tick
    lengths: np.ndarray | None = None      # [S] per-stream trace length
    active: np.ndarray | None = None       # [S, T] live-cell mask
    has_budget: np.ndarray | None = None   # [S] stream has an energy goal

    @property
    def n_streams(self) -> int:
        """Number of streams S."""
        return self.energy.shape[0]

    def _window(self, s: int) -> slice:
        a = 0 if self.arrivals is None else int(self.arrivals[s])
        n = self.energy.shape[1] if self.lengths is None \
            else int(self.lengths[s])
        return slice(a, a + n)

    def stream(self, s: int) -> TraceResult:
        """Stream s's own :class:`TraceResult`, its window of the grid."""
        w = self._window(s)
        budget = None
        if self.budget is not None and (
                self.has_budget is None or self.has_budget[s]):
            budget = self.budget[s, w]
        return TraceResult(
            self.energy[s, w], self.accuracy[s, w], self.latency[s, w],
            self.missed[s, w], self.scheme, budget=budget)

    @property
    def results(self) -> list[TraceResult]:
        """Every stream's :class:`TraceResult`."""
        return [self.stream(s) for s in range(self.n_streams)]

    def _live(self, x: np.ndarray) -> np.ndarray:
        return x if self.active is None else x[self.active]

    @property
    def mean_energy(self) -> float:
        """Mean per-input energy (J) over the live cells."""
        return float(self._live(self.energy).mean())

    @property
    def mean_error(self) -> float:
        """Mean (1 - delivered accuracy) over the live cells."""
        return float(1.0 - self._live(self.accuracy).mean())

    @property
    def miss_rate(self) -> float:
        """Deadline-miss fraction over the live cells."""
        return float(self._live(self.missed).mean())


class FleetSim:
    """S independent ALERT streams advanced on one global tick grid.

    Every stream has its own environment, Kalman state and windowed
    accuracy goal, and may have its own goal type, constraints and
    lifetime.  Per tick, selection for all lanes is one
    :class:`BatchedAlertEngine` call (per-lane ``goal_kind`` codes and an
    active mask), and the filter banks take one masked update.  Lanes
    outside their stream's window are dead: masked out of selection and
    feedback.  Per stream the semantics are the paper's scalar loop:
    windowed accuracy goal, miss inflation, overhead subtraction,
    relaxation, the anytime uncensored observation.

    ``device`` (default the card) holds the engine, both filter banks and
    the goal bank.
    """

    def __init__(self, table: ProfileTable,
                 traces: Sequence[EnvironmentTrace],
                 phi_true: float = 0.25,
                 arrivals: Sequence[int] | None = None, device=None):
        self.table = table
        self.phi_true = phi_true
        self.device = device
        self.n_streams = len(traces)
        self.lengths = np.asarray([t.n for t in traces], dtype=np.int64)
        self.arrivals = np.zeros(self.n_streams, dtype=np.int64) \
            if arrivals is None else np.asarray(arrivals, dtype=np.int64)
        if self.arrivals.shape != (self.n_streams,):
            raise ValueError(f"{self.arrivals.shape[0]} arrivals for "
                             f"{self.n_streams} traces")
        if np.any(self.arrivals < 0):
            raise ValueError("arrival ticks must be >= 0")
        self.n_ticks = int((self.arrivals + self.lengths).max())
        self.n_inputs = self.n_ticks
        s_n, t_n = self.n_streams, self.n_ticks
        # [S, T] environment grids: each trace in its arrival window,
        # padded with a benign 1.0 (dead lanes are masked out anyway).
        self.xi = np.ones((s_n, t_n))
        self.lam = np.ones((s_n, t_n))
        self.deadline_scale = np.ones((s_n, t_n))
        self.active = np.zeros((s_n, t_n), dtype=bool)
        for s, tr in enumerate(traces):
            a, n = int(self.arrivals[s]), int(self.lengths[s])
            self.xi[s, a:a + n] = tr.xi
            self.lam[s, a:a + n] = tr.lam
            self.deadline_scale[s, a:a + n] = tr.deadline_scale
            self.active[s, a:a + n] = True
        groups = table.anytime_groups()
        self._anytime_idx = sorted({i for g in groups.values() for i in g})
        self._trad_idx = [i for i in range(len(table.candidates))
                          if i not in self._anytime_idx]
        self._is_anytime = np.zeros(len(table.candidates), bool)
        self._is_anytime[self._anytime_idx] = True
        self.engine: BatchedAlertEngine | None = None  # last run's engine

    @classmethod
    def from_phases(cls, table: ProfileTable, phases: tuple[Phase, ...],
                    n_streams: int, *, seed: int = 0,
                    phi_true: float = 0.25, length_cv: float = 0.0,
                    deadline_cv: float = 0.0, device=None) -> "FleetSim":
        """Lockstep fleet of ``n_streams`` clones of one phase schedule,
        seeded ``seed, seed + 1, ...``."""
        traces = [EnvironmentTrace(phases, seed=seed + s,
                                   length_cv=length_cv,
                                   deadline_cv=deadline_cv)
                  for s in range(n_streams)]
        return cls(table, traces, phi_true=phi_true, device=device)

    @classmethod
    def from_specs(cls, table: ProfileTable, specs: Sequence[StreamSpec],
                   phi_true: float = 0.25, device=None) -> "FleetSim":
        """Heterogeneous, churning fleet of :class:`StreamSpec` tenants
        (run it with :meth:`run_specs`)."""
        return cls(table, [sp.trace for sp in specs], phi_true=phi_true,
                   arrivals=[sp.arrival for sp in specs], device=device)

    def run_alert(self, goal: Goal, cons: Constraints,
                  **kwargs) -> FleetResult:
        """One goal and one set of constraints for every stream (the
        Table 3 schemes); keyword arguments go to :meth:`run_streams`."""
        return self.run_streams([goal] * self.n_streams,
                                [cons] * self.n_streams, **kwargs)

    def run_specs(self, specs: Sequence[StreamSpec],
                  **kwargs) -> FleetResult:
        """The specs' goals and constraints (a fleet built with
        :meth:`from_specs` from the same specs, in the same order)."""
        if len(specs) != self.n_streams:
            raise ValueError(f"{len(specs)} specs for a fleet of "
                             f"{self.n_streams} streams")
        return self.run_streams([sp.goal for sp in specs],
                                [sp.constraints for sp in specs], **kwargs)

    def run_streams(self, goals: Sequence[Goal],
                    constraints: Sequence[Constraints], *,
                    anytime: bool = True, power_control: bool = True,
                    dnn_control: bool = True, overhead: float = 0.0,
                    paper_faithful_energy: bool = True,
                    scheme_name: str = "alert",
                    faults=None, mesh=None) -> FleetResult:
        """Advance the whole fleet, one masked engine call per tick.

        ``goals``/``constraints`` are per stream: a minimize-energy
        stream needs ``accuracy_goal``, a maximize-accuracy stream
        ``energy_goal``.  The fleet's ``device`` holds the engine and the
        banks, and picks the engine's backend (the card: the
        ``alert_select`` kernel, the CPU: its plain version).
        ``anytime=False`` drops the anytime candidates,
        ``power_control=False`` runs every pick at the system default
        (the top cap), ``dnn_control=False`` keeps only the fastest
        traditional DNN.

        ``mesh`` (a :class:`~repro_torch.launch.mesh.LaneMesh`, whose home
        is the fleet's device) shards the decision path: the engine
        launches its kernel once a shard and the filter banks hold one
        block a shard.  The lane pool is padded to a multiple of the mesh
        size with always-dead lanes; the goal bank stays unsharded on the
        home device, as the reference keeps it on the host.  Results are
        bitwise the unsharded run's.

        ``faults`` is any object with ``n_lanes`` (= ``n_streams``),
        ``dead_at(t)`` ([S] bool) and ``slow_at(t)`` ([S] factors), read at
        each tick.  The slow-down multiplies the true latency scale; a
        live lane that is dead loses its input (a miss with zero accuracy
        and energy) and is masked out of selection and feedback.
        """
        table = self.table
        if len(goals) != self.n_streams or \
                len(constraints) != self.n_streams:
            raise ValueError(f"need one goal and one Constraints per "
                             f"stream ({self.n_streams})")
        if faults is not None and faults.n_lanes != self.n_streams:
            raise ValueError(
                f"FaultSchedule covers {faults.n_lanes} lanes but the "
                f"fleet has {self.n_streams} streams")
        for g, c in zip(goals, constraints):
            if g is Goal.MINIMIZE_ENERGY and c.accuracy_goal is None:
                raise ValueError(f"{g} stream needs accuracy_goal")
            if g is Goal.MAXIMIZE_ACCURACY and c.energy_goal is None:
                raise ValueError(f"{g} stream needs energy_goal")
        dev = mesh_device(mesh, self.device)
        idx = list(range(len(table.candidates)))
        if not anytime:
            idx = self._trad_idx
        if not dnn_control:
            # The fastest traditional DNN only (ALERT_Power ablation).
            fastest = min(self._trad_idx,
                          key=lambda i: table.latency[i, -1])
            idx = [fastest]
        idx_arr = np.asarray(idx)
        sub = table.subset(idx)
        engine = BatchedAlertEngine(
            sub, None, overhead=overhead,
            paper_faithful_energy=paper_faithful_energy, device=dev,
            mesh=mesh)
        self.engine = engine
        s_n, t_n = self.n_streams, self.n_ticks
        # Under a mesh S must be a multiple of its size: the pool gains
        # `pad` always-dead lanes (sanitised by the select, masked out of
        # the feedback, so they cannot perturb a live lane).
        pad = 0 if mesh is None else (-s_n) % mesh.size
        s_all = s_n + pad
        gk = goal_codes(goals)                                      # [S]
        slow = SlowdownFilterBank(s_all, device=dev, mesh=mesh)
        idle = IdlePowerFilterBank(s_all, device=dev, mesh=mesh)
        has_q = np.asarray([c.accuracy_goal is not None
                            for c in constraints])
        q0 = np.asarray([c.accuracy_goal if c.accuracy_goal is not None
                         else 0.0 for c in constraints])
        has_b = np.asarray([c.energy_goal is not None
                            for c in constraints])
        e_base = np.asarray([c.energy_goal if c.energy_goal is not None
                             else 0.0 for c in constraints])
        dls = np.asarray([c.deadline for c in constraints])
        d_scale, act_grid = self.deadline_scale, self.active
        scale_mat = self.xi * self.lam                              # [S, T]
        if pad:
            gk = np.concatenate([gk, np.zeros(pad, dtype=np.int64)])
            q0 = np.concatenate([q0, np.zeros(pad)])
            e_base = np.concatenate([e_base, np.zeros(pad)])
            dls = np.concatenate([dls, np.ones(pad)])
            ones = np.ones((pad, t_n))
            d_scale = np.vstack([d_scale, ones])
            scale_mat = np.vstack([scale_mat, ones])
            act_grid = np.vstack([act_grid,
                                  np.zeros((pad, t_n), dtype=bool)])
        # The goal bank stays whole on the home device, as the reference
        # keeps it on the host under a mesh.
        goal_bank = WindowedGoalBank(q0, s_all, device=dev) \
            if has_q.any() else None
        # System default power: race-to-idle, the top cap.
        full_power_j = len(table.power_caps) - 1
        # Full-table staircases for the anytime delivery.
        st = table.staircase_tensors()

        # E_goal = P_goal * T_goal (Section 3.1): budgets scale with the
        # per-input time allotment.
        bmat = e_base[:, None] * d_scale                            # [S, T]
        # The tick loop reads and writes one column a tick: keep the grids
        # tick-major ([T, S]) so each column is contiguous.
        d_cols = np.ascontiguousarray((dls[:, None] * d_scale).T)
        b_cols = np.ascontiguousarray(bmat.T)
        scale_cols = np.ascontiguousarray(scale_mat.T)
        act_cols = np.ascontiguousarray(act_grid.T)
        o_lat, o_acc, o_en = (np.zeros((t_n, s_all)) for _ in range(3))
        o_miss = np.zeros((t_n, s_all), bool)

        for n in range(t_n):
            act = act_cols[n]                                       # [S]
            if faults is not None:
                dead = faults.dead_at(float(n))                     # [S]
                if pad:
                    dead = np.concatenate([dead, np.zeros(pad, bool)])
                lost = act & dead
                # The in-flight input died with its device: a miss with
                # no completion (zero accuracy and energy).
                o_miss[n, lost] = True
                act = act & ~dead
            dvec = d_cols[n]
            q_goal_eff = q0 if goal_bank is None else \
                goal_bank.current_goal()
            batch = engine.select(slow.mu, slow.sigma, idle.phi, dvec,
                                  accuracy_goal=q_goal_eff,
                                  energy_goal=b_cols[n],
                                  goal_kind=gk, active=act,
                                  predictions=False)
            i_local = batch.model_index                             # [S]
            j_pick = batch.power_index                              # [S]
            j_act = np.full(s_all, full_power_j) if not power_control \
                else j_pick
            i_glob = idx_arr[i_local]
            scale = scale_cols[n]
            if faults is not None:
                fmul = faults.slow_at(float(n))
                if pad:
                    fmul = np.concatenate([fmul, np.ones(pad)])
                scale = scale * fmul

            d = deliver_tick(table, st, i_glob, j_act, scale, dvec,
                             self.phi_true, self._is_anytime,
                             sub.latency[i_local, j_pick])
            np.copyto(o_lat[n], d.latency, where=act)
            np.copyto(o_acc[n], d.accuracy, where=act)
            np.copyto(o_en[n], d.energy, where=act)
            np.copyto(o_miss[n], d.missed, where=act)

            observe_fleet(
                slow, idle, d.observed, d.profiled,
                deadline_missed=d.miss_flag,
                idle_power=self.phi_true * d.run_power,
                active_power=sub.run_power[i_local, j_pick], mask=act)
            if goal_bank is not None:
                goal_bank.record(d.accuracy, mask=act)
        o_en, o_acc, o_lat, o_miss = (o[:, :s_n]
                                      for o in (o_en, o_acc, o_lat, o_miss))
        return FleetResult(
            np.ascontiguousarray(o_en.T), np.ascontiguousarray(o_acc.T),
            np.ascontiguousarray(o_lat.T), np.ascontiguousarray(o_miss.T),
            scheme_name, budget=bmat[:s_n] if has_b.any() else None,
            arrivals=self.arrivals, lengths=self.lengths,
            active=self.active, has_budget=has_b)


def run_fleet(table: ProfileTable, specs: Sequence[StreamSpec], *,
              phi_true: float = 0.25, device=None,
              **kwargs) -> FleetResult:
    """Build a :class:`FleetSim` from ``specs`` and run it: one masked
    engine call per tick, on ``device`` (default the card).  Pass
    ``mesh=`` (:func:`~repro_torch.launch.mesh.make_lane_mesh`) to run
    the decision path lane-sharded; the results are bitwise the same."""
    fleet = FleetSim.from_specs(table, specs, phi_true=phi_true,
                                device=device)
    return fleet.run_specs(specs, **kwargs)
