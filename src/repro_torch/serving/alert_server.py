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

With a flight recorder (``obs=``, or the process recorder while
``torch.profiler`` records), each tick is one span tree: ``serve_tick``
(its self time is the server's own Python) over ``select``, one
``input`` a live lane (request id ``<tick>:<lane>``, inherited by the
engine's spans inside; its end is the input's completion stamp) and
``feedback``; an attached recorder also gets the reference's
``fleet_server`` counters.
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
from repro_torch.core.profiles import (Candidate, ProfileTable,
                                      extrapolate_power_buckets)
from repro_torch.launch.mesh import mesh_device
from repro_torch.obs import no_span, resolve_obs, span_recorder
from repro_torch.serving.engine import ServeEngine


@dataclasses.dataclass
class ServedInput:
    """One served request: executed level (0 for a model without
    nesting, as in the reference), booked power cap, realised
    latency/accuracy/energy, and whether the controller's pick was
    feasible."""

    level: int
    power_cap: float
    latency: float
    missed: bool
    accuracy: float
    energy: float
    feasible: bool


def serve_level_latencies(engine: ServeEngine, params, rounds: int,
                          prompt_len: int = 8,
                          gen_tokens: int = 4) -> np.ndarray:
    """``generate`` latency of each level over ``rounds`` rounds, ``[levels,
    rounds]`` seconds.  Each level gets one warm-up call first; then every
    round runs each level once, the order turned by one level a round, so
    that drift of the card's clocks over the profile falls on every level
    alike rather than on the levels profiled last."""
    levels = engine.levels
    prompt = np.zeros((engine.batch_size, prompt_len), np.int32)
    engine.warmup(params, prompt_len)    # captures, outside the timing
    for lvl in levels:
        engine.generate(params, prompt, gen_tokens, level=lvl)
    out = np.zeros((len(levels), rounds))
    for r in range(rounds):
        for i in range(len(levels)):
            li = (i + r) % len(levels)
            out[li, r] = engine.generate(params, prompt, gen_tokens,
                                         level=levels[li])["latency"]
    return out


def profile_serve_table(engine: ServeEngine, params,
                        level_accuracies: list[float],
                        power_model: PowerModel,
                        n_power_buckets: int = 4,
                        profile_iters: int = 3, q_fail: float = 0.0,
                        prompt_len: int = 8,
                        gen_tokens: int = 4) -> ProfileTable:
    """t^train profiling: the mean ``generate`` latency of each anytime
    level over ``profile_iters`` interleaved rounds
    (:func:`serve_level_latencies`), extrapolated across power buckets
    with the compute-bound 1/f rule.  A model without nesting is one
    candidate that is no anytime level, so only power adapts."""
    cfg = engine.model.cfg
    levels = engine.levels
    base = serve_level_latencies(engine, params, profile_iters, prompt_len,
                                 gen_tokens).mean(axis=1)

    caps, lat, pw = extrapolate_power_buckets(base, power_model,
                                              n_power_buckets)
    nested = cfg.nest_levels > 1
    cands = [
        Candidate(name=f"level{lvl}", flops=0.0, bytes_hbm=0.0,
                  accuracy=level_accuracies[li], is_anytime_level=nested,
                  anytime_group="anytime" if nested else None,
                  level=li + 1)
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
        out = ServedInput(level=lvl or 0, power_cap=d.power_cap,
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
    one.  Filter, goal and scoring state live on the engine's device.

    ``mesh=`` (a :class:`~repro_torch.launch.mesh.LaneMesh` whose home is
    the engine's device) shards the scoring pass and all bank state over
    its shards: the capacity is rounded up to a multiple of the mesh size
    (the spare lanes start dead) and always grows in such multiples.

    ``obs=`` (a :class:`~repro_torch.obs.FlightRecorder`) records each
    tick's spans and the ``fleet_server`` counters, a pure observer; the
    engine gets it too where it has none of its own."""

    def __init__(self, engine: ServeEngine, params,
                 level_accuracies: list[float], goal: Goal,
                 n_streams: int,
                 power_model: PowerModel | None = None,
                 n_power_buckets: int = 4,
                 profile_iters: int = 3, q_fail: float = 0.0,
                 prompt_len: int = 8, gen_tokens: int = 4,
                 accuracy_window: int = 10,
                 start_active: bool = True, mesh=None, obs=None):
        self._ob = resolve_obs(obs)
        if engine.obs is None:
            engine.obs = obs
        self.engine = engine
        self.params = params
        self.goal = goal
        self.gen_tokens = gen_tokens
        self.mesh = mesh
        self.device = mesh_device(mesh, engine.device)
        pm = power_model or PowerModel()
        self.power_model = pm
        self.table = profile_serve_table(
            engine, params, level_accuracies, pm,
            n_power_buckets=n_power_buckets, profile_iters=profile_iters,
            q_fail=q_fail, prompt_len=prompt_len, gen_tokens=gen_tokens)
        pad = 0 if mesh is None else (-n_streams) % mesh.size
        cap = n_streams + pad
        self.scoring = BatchedAlertEngine(self.table, goal,
                                          device=self.device, mesh=mesh)
        self.slowdown = SlowdownFilterBank(cap, device=self.device,
                                           mesh=mesh)
        self.idle_power = IdlePowerFilterBank(cap, device=self.device,
                                              mesh=mesh)
        self.accuracy_window = accuracy_window
        self._goal_bank: WindowedGoalBank | None = None
        self.active = np.concatenate(
            [np.full(n_streams, bool(start_active)), np.zeros(pad, bool)])
        # Quarantined lanes are never leased again until revived.
        self._dead = np.zeros(cap, bool)
        self.goal_kinds = np.full(cap, goal_codes([goal])[0],
                                  dtype=np.int64)
        # Per-lane Constraints overrides installed by admit().
        self.lane_constraints: list[Constraints | None] = [None] * cap
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
            if self.mesh is not None:
                # Doubling keeps a multiple of the mesh size; the max
                # covers a capacity of 0.
                new_cap = max(new_cap, self.mesh.size)
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
        lanes = np.atleast_1d(np.asarray(lanes, dtype=np.int64))
        for lane in lanes:
            self.active[lane] = False
            self._dead[lane] = True
            self.lane_constraints[lane] = None
        if self._ob is not None and lanes.size:
            lab = dict(gateway="fleet_server")
            self._ob.metrics.counter("quarantine_events", **lab).inc()
            self._ob.metrics.counter("lanes_quarantined", **lab).inc(
                int(lanes.size))
            self._ob.spans.event("quarantine", cat="fault",
                                 lanes=[int(x) for x in lanes])

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
                                               device=self.device,
                                               mesh=self.mesh)
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
        ob = span_recorder(self._ob)
        if ob is None:
            return self._serve_tick(prompts, constraints, no_span)
        with ob.spans.span("serve_tick", cat="fleet_server",
                           tick=len(self.history),
                           live=int(self.active.sum())):
            outs = self._serve_tick(prompts, constraints, ob.spans.span)
        m, lab = ob.metrics, dict(gateway="fleet_server")
        served = [o for o in outs if o is not None]
        m.counter("requests_served", **lab).inc(len(served))
        m.counter("deadline_misses", **lab).inc(
            sum(o.missed for o in served))
        m.counter("energy_served_j", **lab).inc(
            float(sum(o.energy for o in served)))
        m.counter("rounds_served", **lab).inc()
        m.timer("serve_tick", **lab).observe(ob.spans.last_s)
        return outs

    def _serve_tick(self, prompts, constraints, span):
        """:meth:`serve_tick`'s work, its phases inside ``span``s."""
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
        with span("select", cat="fleet_server"):
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
        tick = len(self.history)
        for s in np.nonzero(act)[0]:
            i = int(batch.model_index[s])
            lvl = self.engine.levels[i]
            with span("input", cat="fleet_server", lane=int(s), level=lvl,
                      request=f"{tick}:{s}"):
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
                level=lvl or 0, power_cap=cap_w, latency=lat,
                missed=bool(miss), accuracy=float(acc),
                energy=float(energy), feasible=bool(batch.feasible[s]))

        with span("feedback", cat="fleet_server"):
            profiled = self.table.latency[batch.model_index,
                                          batch.power_index]
            observe_fleet(self.slowdown, self.idle_power, observed,
                          profiled, deadline_missed=missed,
                          idle_power=0.25 * active_p, active_power=active_p,
                          mask=act)
            if self._goal_bank is not None:
                self._goal_bank.record(accs, mask=act)
        self.history.append(outs)
        return outs
