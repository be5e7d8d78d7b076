"""The end-to-end ALERT serving loop over a real model (port of
``repro.serving.alert_server``).

* :class:`AlertServer`: one request stream; its
  :class:`~repro_torch.core.controller.AlertController` is the S=1 wrapper
  of the batched engine.
* :class:`FleetAlertServer`: S request streams on one ServeEngine.  Per
  tick, ONE engine call scores every live stream's (model, power) grid
  (on the card: one ``alert_select`` kernel launch), each live stream's
  pick runs at its anytime level, and one masked update of the filter
  banks absorbs all measurements.  Streams are admitted and retired
  between ticks; lanes are recycled.

Power cannot be actuated here, so the power dimension is bookkeeping
through the same PowerModel the profile uses; the anytime level is real.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.batched import (BatchedAlertEngine, GOAL_MAX_ACCURACY,
                                      GOAL_MIN_ENERGY, WindowedGoalBank,
                                      goal_codes)
from repro_torch.core.controller import AlertController, Constraints, Goal
from repro_torch.core.kalman import (IdlePowerFilterBank, SlowdownFilterBank,
                                     observe_fleet)
from repro_torch.core.power import PowerModel
from repro_torch.core.profiles import Candidate, ProfileTable
from repro_torch.serving.engine import ServeEngine


@dataclasses.dataclass
class ServedInput:
    """One served request: executed level, booked power cap, realised
    latency/accuracy/energy, and whether the controller's pick was
    feasible."""

    level: int
    power_cap: float
    latency: float
    missed: bool
    accuracy: float
    energy: float
    feasible: bool


def profile_serve_table(engine: ServeEngine, params,
                        level_accuracies: list[float],
                        power_model: PowerModel,
                        n_power_buckets: int = 4,
                        profile_iters: int = 3, q_fail: float = 0.0,
                        prompt_len: int = 8,
                        gen_tokens: int = 4) -> ProfileTable:
    """t^train profiling: measure each anytime level with ``generate``
    (one warmup, then ``profile_iters`` runs) and extrapolate across power
    buckets with the compute-bound 1/f rule."""
    cfg = engine.model.cfg
    levels = engine.levels
    base = np.zeros(len(levels))
    prompt = np.zeros((engine.batch_size, prompt_len), np.int32)
    for li, lvl in enumerate(levels):
        engine.generate(params, prompt, gen_tokens, level=lvl)  # warmup
        ts = []
        for _ in range(profile_iters):
            r = engine.generate(params, prompt, gen_tokens, level=lvl)
            ts.append(r["latency"])
        base[li] = float(np.mean(ts))

    caps = power_model.buckets(n_power_buckets)
    lat = np.zeros((len(levels), len(caps)))
    pw = np.zeros_like(lat)
    for j, cap in enumerate(caps):
        f = power_model.speed_fraction(cap)
        lat[:, j] = base / f
        pw[:, j] = power_model.power_at_fraction(f)
    cands = [
        Candidate(name=f"level{lvl}", flops=0.0, bytes_hbm=0.0,
                  accuracy=level_accuracies[li], is_anytime_level=True,
                  anytime_group="anytime", level=li + 1)
        for li, lvl in enumerate(levels)]
    return ProfileTable(cands, caps, lat, pw, q_fail=q_fail)


class AlertServer:
    """One request stream over a real model: profile the levels at
    startup, then serve inputs one at a time through the controller."""

    def __init__(self, engine: ServeEngine, params,
                 level_accuracies: list[float], goal: Goal,
                 power_model: PowerModel | None = None,
                 n_power_buckets: int = 4,
                 profile_iters: int = 3, q_fail: float = 0.0,
                 prompt_len: int = 8, gen_tokens: int = 4):
        self.engine = engine
        self.params = params
        self.goal = goal
        self.prompt_len = prompt_len
        self.gen_tokens = gen_tokens
        pm = power_model or PowerModel()
        self.power_model = pm
        self.table = profile_serve_table(
            engine, params, level_accuracies, pm,
            n_power_buckets=n_power_buckets, profile_iters=profile_iters,
            q_fail=q_fail, prompt_len=prompt_len, gen_tokens=gen_tokens)
        self.controller = AlertController(self.table, goal,
                                          device=engine.device)
        self.history: list[ServedInput] = []

    def serve_one(self, prompt: np.ndarray, constraints: Constraints
                  ) -> ServedInput:
        """Pick a (level, power) for this input, run the level under the
        deadline, book energy through the power model, feed back."""
        d = self.controller.select(constraints)
        lvl = self.engine.levels[d.model_index]
        r = self.engine.generate(self.params, prompt, self.gen_tokens,
                                 level=lvl, deadline_s=constraints.deadline)
        lat = r["latency"]
        missed = (lat > constraints.deadline) or not r["complete"]
        acc = self.table.candidates[d.model_index].accuracy \
            if not missed else self.table.q_fail
        f = self.power_model.speed_fraction(d.power_cap)
        p = self.power_model.power_at_fraction(f)
        run_t = min(lat, constraints.deadline)
        energy = p * run_t + self.controller.idle_power.phi * p * \
            max(constraints.deadline - run_t, 0.0)
        self.controller.observe(
            run_t, deadline_missed=missed,
            idle_power=0.25 * p, delivered_accuracy=acc)
        out = ServedInput(level=lvl, power_cap=d.power_cap,
                          latency=lat, missed=missed, accuracy=acc,
                          energy=energy, feasible=d.feasible)
        self.history.append(out)
        return out


class FleetAlertServer:
    """Concurrent request streams, scored by one batched engine call per
    tick.  Each stream keeps its own Kalman state, windowed accuracy goal
    and goal type (Eq. 4 and Eq. 5 tenants share the call through
    per-lane ``goal_kind`` codes).  :meth:`admit` leases a free lane
    (doubling capacity when none is free) and :meth:`retire` releases
    one.  Filter, goal and scoring state live on the engine's device."""

    def __init__(self, engine: ServeEngine, params,
                 level_accuracies: list[float], goal: Goal,
                 n_streams: int,
                 power_model: PowerModel | None = None,
                 n_power_buckets: int = 4,
                 profile_iters: int = 3, q_fail: float = 0.0,
                 prompt_len: int = 8, gen_tokens: int = 4,
                 accuracy_window: int = 10,
                 start_active: bool = True):
        self.engine = engine
        self.params = params
        self.goal = goal
        self.gen_tokens = gen_tokens
        self.device = engine.device
        pm = power_model or PowerModel()
        self.power_model = pm
        self.table = profile_serve_table(
            engine, params, level_accuracies, pm,
            n_power_buckets=n_power_buckets, profile_iters=profile_iters,
            q_fail=q_fail, prompt_len=prompt_len, gen_tokens=gen_tokens)
        self.scoring = BatchedAlertEngine(self.table, goal,
                                          device=self.device)
        self.slowdown = SlowdownFilterBank(n_streams, device=self.device)
        self.idle_power = IdlePowerFilterBank(n_streams, device=self.device)
        self.accuracy_window = accuracy_window
        self._goal_bank: WindowedGoalBank | None = None
        self.active = np.full(n_streams, bool(start_active))
        # Quarantined lanes are never leased again until revived.
        self._dead = np.zeros(n_streams, bool)
        self.goal_kinds = np.full(n_streams, goal_codes([goal])[0],
                                  dtype=np.int64)
        # Per-lane Constraints overrides installed by admit().
        self.lane_constraints: list[Constraints | None] = [None] * n_streams
        self.history: list[list[ServedInput | None]] = []

    @property
    def n_streams(self) -> int:
        """Lane capacity (live + free); ``active`` marks the live ones."""
        return self.active.shape[0]

    # ------------------------------------------------------------------ #
    # churn: lane lease / release between ticks                          #
    # ------------------------------------------------------------------ #
    def admit(self, goal: Goal | None = None,
              constraints: Constraints | None = None) -> int:
        """Lease a lane for a new stream and return its id.  The lane's
        filter state is reset to the priors and its accuracy window
        cleared; ``constraints`` installs the lane's own deadline/goal,
        used whenever :meth:`serve_tick` gets none for it."""
        free = np.nonzero(~self.active & ~self._dead)[0]
        if free.size == 0:
            new_cap = max(2 * self.n_streams, 1)
            lane = self.n_streams
            extra = new_cap - lane
            self.slowdown.grow(new_cap)
            self.idle_power.grow(new_cap)
            if self._goal_bank is not None:
                self._goal_bank.grow(new_cap)
            self.active = np.concatenate([self.active, np.zeros(extra, bool)])
            self._dead = np.concatenate([self._dead, np.zeros(extra, bool)])
            self.goal_kinds = np.concatenate(
                [self.goal_kinds,
                 np.full(extra, goal_codes([self.goal])[0], dtype=np.int64)])
            self.lane_constraints.extend([None] * extra)
        else:
            lane = int(free[0])
        self.slowdown.reset_lanes([lane])
        self.idle_power.reset_lanes([lane])
        if self._goal_bank is not None:
            self._goal_bank.reset_lanes([lane])
        self.goal_kinds[lane] = goal_codes([goal or self.goal])[0]
        self.lane_constraints[lane] = constraints
        self.active[lane] = True
        return lane

    def retire(self, lane: int) -> None:
        """Release a lane; a later :meth:`admit` recycles it."""
        self.active[lane] = False
        self.lane_constraints[lane] = None

    def fail_lanes(self, lanes) -> None:
        """Quarantine ``lanes``: their streams stop at once and the lanes
        are never leased again until :meth:`revive_lanes`."""
        for lane in np.atleast_1d(np.asarray(lanes, dtype=np.int64)):
            self.active[lane] = False
            self._dead[lane] = True
            self.lane_constraints[lane] = None

    def revive_lanes(self, lanes) -> None:
        """Return quarantined ``lanes`` to the free pool."""
        for lane in np.atleast_1d(np.asarray(lanes, dtype=np.int64)):
            self._dead[lane] = False

    # ------------------------------------------------------------------ #
    def _effective_accuracy_goal(self, constraints):
        """Per-stream effective Q_goal (device vector); a stream whose goal
        changes gets a fresh window, other streams keep their history.
        Dead and Eq. 5 lanes carry a zero placeholder."""
        goals = np.zeros(self.n_streams, dtype=np.float64)
        for s in np.nonzero(self.active)[0]:
            if self.goal_kinds[s] != GOAL_MIN_ENERGY:
                continue
            c = constraints[s]
            if c is None or c.accuracy_goal is None:
                raise ValueError(f"minimize-energy stream {s} needs "
                                 "accuracy_goal on its Constraints")
            goals[s] = c.accuracy_goal
        if self._goal_bank is None:
            self._goal_bank = WindowedGoalBank(goals, self.n_streams,
                                               self.accuracy_window,
                                               device=self.device)
        else:
            self._goal_bank.set_goals(goals)
        return self._goal_bank.current_goal()

    def serve_tick(self, prompts,
                   constraints=None) -> list[ServedInput | None]:
        """Serve one input per live stream; one engine call scores all of
        them.  ``prompts``/``constraints`` are capacity-length sequences
        (entries at dead lanes are ignored); a ``None`` constraints
        argument or entry falls back to the lane's :meth:`admit`
        override.  Returns one ``ServedInput`` per live lane, ``None`` at
        dead lanes."""
        cap = self.n_streams
        if len(prompts) != cap:
            raise ValueError(f"{len(prompts)} prompts for {cap} lanes")
        if constraints is None:
            constraints = self.lane_constraints
        else:
            if len(constraints) != cap:
                raise ValueError(f"{len(constraints)} constraints for "
                                 f"{cap} lanes")
            constraints = [c if c is not None else self.lane_constraints[s]
                           for s, c in enumerate(constraints)]
        act = self.active.copy()
        deadlines = np.ones(cap)
        e_goals = np.zeros(cap)
        for s in np.nonzero(act)[0]:
            c = constraints[s]
            if c is None:
                raise ValueError(f"live stream {s} needs Constraints")
            deadlines[s] = c.deadline
            if self.goal_kinds[s] == GOAL_MAX_ACCURACY:
                if c.energy_goal is None:
                    raise ValueError(f"maximize-accuracy stream {s} needs "
                                     "energy_goal on its Constraints")
                e_goals[s] = c.energy_goal
        q_goals = self._effective_accuracy_goal(constraints)
        batch = self.scoring.select(
            self.slowdown.mu, self.slowdown.sigma, self.idle_power.phi,
            deadlines, accuracy_goal=q_goals, energy_goal=e_goals,
            goal_kind=self.goal_kinds, active=act)

        outs: list[ServedInput | None] = [None] * cap
        observed = np.zeros(cap)
        missed = np.zeros(cap, bool)
        accs = np.zeros(cap)
        active_p = np.ones(cap)
        # One host copy of phi for this tick's energy bookkeeping (phi
        # changes only in the end-of-tick update).
        phi_host = self.idle_power.phi.cpu().numpy()
        for s in np.nonzero(act)[0]:
            i = int(batch.model_index[s])
            lvl = self.engine.levels[i]
            r = self.engine.generate(self.params, prompts[s],
                                     self.gen_tokens, level=lvl,
                                     deadline_s=float(deadlines[s]))
            lat = r["latency"]
            miss = (lat > deadlines[s]) or not r["complete"]
            acc = self.table.q_fail if miss \
                else self.table.candidates[i].accuracy
            cap_w = float(self.table.power_caps[int(batch.power_index[s])])
            f = self.power_model.speed_fraction(cap_w)
            p = self.power_model.power_at_fraction(f)
            run_t = min(lat, float(deadlines[s]))
            energy = p * run_t + float(phi_host[s]) * p * \
                max(float(deadlines[s]) - run_t, 0.0)
            observed[s], missed[s], accs[s] = run_t, miss, acc
            active_p[s] = p
            outs[s] = ServedInput(
                level=lvl, power_cap=cap_w, latency=lat,
                missed=bool(miss), accuracy=float(acc),
                energy=float(energy), feasible=bool(batch.feasible[s]))

        profiled = self.table.latency[batch.model_index, batch.power_index]
        observe_fleet(self.slowdown, self.idle_power, observed, profiled,
                      deadline_missed=missed, idle_power=0.25 * active_p,
                      active_power=active_p, mask=act)
        if self._goal_bank is not None:
            self._goal_bank.record(accs, mask=act)
        self.history.append(outs)
        return outs
