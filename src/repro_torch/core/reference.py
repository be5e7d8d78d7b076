"""The pre-engine scalar NumPy controller, kept as a frozen reference
(port of ``repro.core.reference``).

This is the ALERT decision loop as the controller computed it before
scoring moved to the batched engine: plain NumPy over the ``[K, L]``
grid, one stream and one input at a time, a Python loop re-scoring each
anytime candidate's staircase per call.  It has two jobs:

* **Parity oracle**: the batched engine's picks must equal this
  implementation's over random profiles, goals and constraints (both run
  float64; the tie-break tolerance is 1e-12).
* **Benchmark baseline**: the scalar side of a scalar-versus-batched
  decisions/sec measurement.

Its erf is scipy's ufunc (:func:`normal_cdf`), as the reference's is: a
frozen oracle, not the engine's fdlibm ``erf``
(:mod:`repro_torch.kernels.alert_select`).  Do not grow features here.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import erf as _erf

from repro_torch.core.controller import (Constraints, Decision, Goal,
                                         WindowedAccuracyGoal, _Estimates)
from repro_torch.core.kalman import IdlePowerFilter, SlowdownFilter
from repro_torch.core.profiles import ProfileTable

_SQRT2 = math.sqrt(2.0)


def normal_cdf(x: np.ndarray) -> np.ndarray:
    """Vectorised standard-normal CDF through scipy's ufunc erf."""
    return 0.5 * (1.0 + _erf(np.asarray(x, dtype=float) / _SQRT2))


class ScalarReferenceController:
    """Single-stream NumPy ALERT controller (paper §3), seed semantics."""

    def __init__(self, table: ProfileTable, goal: Goal,
                 kappa: float = 3.0, overhead: float = 0.0,
                 accuracy_window: int = 10,
                 paper_faithful_energy: bool = True):
        self.table = table
        self.goal = goal
        self.kappa = kappa
        self.overhead = overhead
        self.paper_faithful_energy = paper_faithful_energy
        self.slowdown = SlowdownFilter()
        self.idle_power = IdlePowerFilter()
        self._windowed_goal: WindowedAccuracyGoal | None = None
        self.accuracy_window = accuracy_window
        self._last_decision: Decision | None = None
        self._anytime_levels: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for _, idxs in table.anytime_groups().items():
            for pos, i in enumerate(idxs):
                lvl_lat = table.latency[idxs[:pos + 1], :]      # [m, L]
                lvl_acc = table.accuracies[idxs[:pos + 1]]       # [m]
                self._anytime_levels[i] = (lvl_lat, lvl_acc)

    def observe(self, observed_latency: float,
                deadline_missed: bool = False,
                idle_power: float | None = None,
                delivered_accuracy: float | None = None,
                profiled_override: float | None = None) -> None:
        """Paper feedback step for the last decision: Eq. 6 on the
        latency ratio (miss-inflated when censored), Eq. 8 on the power
        pair, and the accuracy window (fn.3)."""
        if self._last_decision is None:
            return
        d = self._last_decision
        profiled = profiled_override if profiled_override is not None \
            else self.table.latency[d.model_index, d.power_index]
        self.slowdown.observe(observed_latency, profiled,
                              deadline_missed=deadline_missed)
        if idle_power is not None:
            active = self.table.run_power[d.model_index, d.power_index]
            self.idle_power.observe(idle_power, active)
        if delivered_accuracy is not None and self._windowed_goal is not None:
            self._windowed_goal.record(delivered_accuracy)

    def estimate(self, deadline: float) -> _Estimates:
        """Per-cell [K, L] predictions, the paper formulas verbatim in
        numpy: Eq. 7 accuracy, Eq. 10 staircase override for anytime
        rows, Eq. 9 energy."""
        t_train = self.table.latency                      # [K, L]
        mu, sd = self.slowdown.mu, self.slowdown.std
        lat_mean = mu * t_train
        lat_std = np.maximum(sd * t_train, 1e-12)
        z = (deadline - lat_mean) / lat_std
        p_finish = normal_cdf(z)

        q = self.table.accuracies[:, None]                # [K, 1]
        q_fail = self.table.q_fail
        # Eq. 7 (traditional): expectation of the Eq. 3 step function.
        accuracy = q_fail + (q - q_fail) * p_finish
        # Eq. 10 (anytime staircase) overrides anytime candidates.
        for i, (lvl_lat, lvl_acc) in self._anytime_levels.items():
            lvl_mean = mu * lvl_lat                       # [m, L]
            lvl_std = np.maximum(sd * lvl_lat, 1e-12)
            f = normal_cdf((deadline - lvl_mean) / lvl_std)   # [m, L]
            f_next = np.vstack([f[1:], np.zeros((1, f.shape[1]))])
            accuracy[i] = q_fail * (1.0 - f[0]) + (lvl_acc[:, None] *
                                                   (f - f_next)).sum(axis=0)
            p_finish[i] = f[-1]

        phi = self.idle_power.phi
        caps = self.table.run_power                       # [K, L]
        if self.paper_faithful_energy:
            t_run = np.minimum(lat_mean, deadline)
        else:
            pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
            t_run = lat_mean * p_finish + deadline * (1 - p_finish) \
                - lat_std * pdf
            t_run = np.clip(t_run, 0.0, deadline)
        energy = caps * t_run + phi * caps * np.maximum(deadline - t_run, 0.0)
        return _Estimates(lat_mean, lat_std, accuracy, energy, p_finish)

    def select(self, constraints: Constraints) -> Decision:
        """Eq. 4 / Eq. 5 pick with Section 3.3 relaxation — the oracle
        the batched engine's picks are asserted bit-identical to."""
        deadline = max(constraints.deadline - self.overhead, 1e-9)
        est = self.estimate(deadline)

        q_goal = constraints.accuracy_goal
        if q_goal is not None:
            if self._windowed_goal is None or \
                    self._windowed_goal.goal != q_goal:
                self._windowed_goal = WindowedAccuracyGoal(
                    q_goal, self.accuracy_window)
            q_goal_eff = self._windowed_goal.current_goal()
        else:
            q_goal_eff = None

        if self.goal is Goal.MINIMIZE_ENERGY:
            decision = self._select_min_energy(est, q_goal_eff)
        else:
            decision = self._select_max_accuracy(est, constraints.energy_goal)
        self._last_decision = decision
        return decision

    def _mk(self, est: _Estimates, i: int, j: int, feasible: bool,
            relaxed: str) -> Decision:
        return Decision(
            model_index=i, power_index=j,
            model_name=self.table.candidates[i].name,
            power_cap=float(self.table.power_caps[j]),
            predicted_latency=float(est.lat_mean[i, j]),
            predicted_accuracy=float(est.accuracy[i, j]),
            predicted_energy=float(est.energy[i, j]),
            feasible=feasible, relaxed=relaxed)

    def _select_min_energy(self, est: _Estimates,
                           q_goal: float | None) -> Decision:
        assert q_goal is not None, "minimize-energy task needs accuracy_goal"
        feasible = est.accuracy >= q_goal
        if feasible.any():
            energy = np.where(feasible, est.energy, np.inf)
            i, j = np.unravel_index(int(np.argmin(energy)), energy.shape)
            return self._mk(est, i, j, True, "")
        i, j = np.unravel_index(int(np.argmax(est.accuracy)),
                                est.accuracy.shape)
        return self._mk(est, i, j, False, "accuracy")

    def _select_max_accuracy(self, est: _Estimates,
                             e_goal: float | None) -> Decision:
        assert e_goal is not None, "maximize-accuracy task needs energy_goal"
        feasible = est.energy <= e_goal
        if feasible.any():
            acc = np.where(feasible, est.accuracy, -np.inf)
            best = acc.max()
            tie = np.where(np.isclose(acc, best, rtol=0, atol=1e-12),
                           est.energy, np.inf)
            i, j = np.unravel_index(int(np.argmin(tie)), tie.shape)
            return self._mk(est, i, j, True, "")
        best = est.accuracy.max()
        tie = np.where(np.isclose(est.accuracy, best, rtol=0, atol=1e-12),
                       est.energy, np.inf)
        i, j = np.unravel_index(int(np.argmin(tie)), tie.shape)
        return self._mk(est, i, j, False, "power")
