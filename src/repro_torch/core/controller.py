"""The ALERT runtime controller, paper Section 3 (port of
``repro.core.controller``).

Per input the controller (1) takes the previous input's measurements,
(2) subtracts its own overhead from T_goal and re-derives the windowed
accuracy goal, (3) updates the xi and phi filters and predicts every
(model, power) cell, and (4) picks by Eq. 4 or Eq. 5 with the Section 3.3
relaxation.  Scoring is delegated to
:class:`repro_torch.core.batched.BatchedAlertEngine`; this class is its
S=1 wrapper with the paper-shaped single-stream API.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.kalman import IdlePowerFilter, SlowdownFilter
from repro_torch.core.profiles import ProfileTable


class Goal(enum.Enum):
    """Eq. 2/4 (minimize energy s.t. accuracy) or Eq. 1/5 (maximize
    accuracy s.t. energy)."""

    MINIMIZE_ENERGY = "minimize_energy"      # Eq. 2 / Eq. 4
    MAXIMIZE_ACCURACY = "maximize_accuracy"  # Eq. 1 / Eq. 5


@dataclasses.dataclass(frozen=True)
class Constraints:
    """One stream's requirements: ``deadline`` (T_goal, seconds) plus the
    goal value its :class:`Goal` needs."""

    deadline: float                    # T_goal (seconds)
    accuracy_goal: float | None = None  # Q_goal  (min-energy task)
    energy_goal: float | None = None    # E_goal (J) (max-accuracy task)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One selection outcome: the picked (model, power-cap) cell, its
    predictions, and which constraint had to be relaxed (Section 3.3)."""

    model_index: int
    power_index: int
    model_name: str
    power_cap: float
    predicted_latency: float
    predicted_accuracy: float
    predicted_energy: float
    feasible: bool
    relaxed: str            # "" | "power" | "accuracy"


@dataclasses.dataclass
class _Estimates:
    """All per-cell predictions for one selection round (``[K, L]``)."""

    lat_mean: np.ndarray
    lat_std: np.ndarray
    accuracy: np.ndarray
    energy: np.ndarray
    p_finish: np.ndarray


class WindowedAccuracyGoal:
    """Paper fn.3: the accuracy goal is the average over any N consecutive
    inputs, so the per-input goal compensates for recent deliveries."""

    def __init__(self, goal: float, window: int = 10):
        self.goal = goal
        self.window = window
        self._recent: list[float] = []

    def record(self, delivered: float) -> None:
        """Push one delivered accuracy into the last-N-1 window."""
        self._recent.append(delivered)
        if len(self._recent) > self.window - 1:
            self._recent.pop(0)

    def current_goal(self) -> float:
        """Effective per-input Q_goal after window compensation."""
        if not self._recent:
            return self.goal
        need = self.goal * self.window - sum(self._recent)
        remaining = self.window - len(self._recent)
        return need - (remaining - 1) * self.goal


class AlertController:
    """The ALERT decision loop for one stream over a :class:`ProfileTable`
    (``overhead`` is subtracted from T_goal; ``paper_faithful_energy``
    picks Eq. 9 verbatim or the E[min(t, T)] estimator)."""

    def __init__(self, table: ProfileTable, goal: Goal,
                 overhead: float = 0.0,
                 accuracy_window: int = 10,
                 paper_faithful_energy: bool = True, device=None):
        from repro_torch.core.batched import BatchedAlertEngine

        self.table = table
        self.goal = goal
        self.overhead = overhead
        self.paper_faithful_energy = paper_faithful_energy
        self.slowdown = SlowdownFilter()
        self.idle_power = IdlePowerFilter()
        self._windowed_goal: WindowedAccuracyGoal | None = None
        self.accuracy_window = accuracy_window
        self._last_decision: Decision | None = None
        self.engine = BatchedAlertEngine(
            table, goal, overhead=overhead,
            paper_faithful_energy=paper_faithful_energy, device=device)

    def observe(self, observed_latency: float,
                deadline_missed: bool = False,
                idle_power: float | None = None,
                delivered_accuracy: float | None = None,
                profiled_override: float | None = None) -> None:
        """Feed the previous input's measurements (``profiled_override``:
        an uncensored level-k completion time measured against level k's
        profile)."""
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
        """Per-cell ``[K, L]`` predictions (Eq. 7 / 9 / 10) at S=1."""
        est = self.engine.estimate(
            self.slowdown.mu, self.slowdown.sigma, self.idle_power.phi,
            np.asarray([deadline]))
        return _Estimates(est.lat_mean[0], est.lat_std[0],
                          est.accuracy[0], est.energy[0], est.p_finish[0])

    def select(self, constraints: Constraints) -> Decision:
        """One paper decision: windowed goal, overhead-adjusted deadline,
        Eq. 4/5 pick with Section 3.3 relaxation."""
        q_goal = constraints.accuracy_goal
        if q_goal is not None:
            if self._windowed_goal is None or \
                    self._windowed_goal.goal != q_goal:
                self._windowed_goal = WindowedAccuracyGoal(
                    q_goal, self.accuracy_window)
            q_goal_eff = self._windowed_goal.current_goal()
        else:
            q_goal_eff = None
        batch = self.engine.select(
            self.slowdown.mu, self.slowdown.sigma, self.idle_power.phi,
            np.asarray([constraints.deadline]),
            accuracy_goal=q_goal_eff, energy_goal=constraints.energy_goal)
        i = int(batch.model_index[0])
        j = int(batch.power_index[0])
        decision = Decision(
            model_index=i, power_index=j,
            model_name=self.table.candidates[i].name,
            power_cap=float(self.table.power_caps[j]),
            predicted_latency=float(batch.predicted_latency[0]),
            predicted_accuracy=float(batch.predicted_accuracy[0]),
            predicted_energy=float(batch.predicted_energy[0]),
            feasible=bool(batch.feasible[0]),
            relaxed=batch.relaxed_name(0))
        self._last_decision = decision
        return decision
