"""Discrete-event session gateway: many sessions over few engine lanes
(port of ``repro.traffic.gateway``).

The tick-synchronous :class:`~repro_torch.serving.sim.FleetSim` gives
every stream a lane and an input every tick.  Production traffic is
open-loop: requests *arrive* (:mod:`repro_torch.traffic.workloads`), far
more sessions exist than engine lanes, and the controller must hold its
constraints as load shifts.  :class:`SessionGateway` serves that regime
with ONE :class:`~repro_torch.core.batched.BatchedAlertEngine` sized to
``n_lanes``, on ``device`` (default the card):

* **Clock**: rounds fire on a fixed tick grid ``t_k = k * tick``, and
  each lane is busy until its request completes (or is abandoned at its
  T_goal, the paper's miss semantics), so a round scores whatever is due
  on whatever lanes are free.  ``tick`` defaults to the largest nominal
  deadline, which frees every lane every round.
* **Admission**: arrivals queue in a
  :class:`~repro_torch.serving.batcher.DeadlineBatcher`: EDF order,
  fail-fast rejection of requests whose remaining slack can no longer fit
  the fastest profiled config, and bounded-queue backpressure at submit.
* **Session paging**: each served session needs its own Kalman and goal
  state, but only ``n_lanes`` lanes exist.  A round that needs a
  non-resident session evicts the least-recently-used idle resident
  (``export_lanes``: one gather on the device and one copy to the host
  store a state tensor) and restores the incomer (``import_lanes``:
  same-shape ``[S]`` writes on the device).
* **Scoring**: one masked ``select`` a served round over every lane, the
  ``alert_select`` kernel on the card (its plain version on the CPU);
  idle lanes ride along masked out.
* **Delivery**: the host :func:`~repro_torch.serving.sim.deliver_tick`,
  so per-session outcomes at zero queueing delay are bitwise equal to an
  equivalent :class:`FleetSim` run (paging is invisible).

Faults (:mod:`repro_torch.traffic.faults`) compose onto the round, and a
run checkpoints atomically and resumes bit for bit
(:mod:`repro_torch.checkpoint.io`, the reference's on-disk layout, so a
checkpoint the reference wrote resumes here).
"""

from __future__ import annotations

import dataclasses
import itertools
from contextlib import nullcontext
from typing import Sequence

import numpy as np

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.batched import (BatchedAlertEngine, WindowedGoalBank,
                                      goal_codes)
from repro_torch.core.kalman import (IdlePowerFilterBank, SlowdownFilterBank,
                                     observe_fleet)
from repro_torch.core.profiles import ProfileTable
from repro_torch.kernels import alert_select as select_kernel
from repro_torch.launch.mesh import lane_pspec, mesh_device
from repro_torch.obs import resolve_obs as _resolve_obs
from repro_torch.runtime.elastic import reshard_state
from repro_torch.runtime.ft import InjectedFailure
from repro_torch.serving.batcher import DeadlineBatcher
from repro_torch.serving.sim import TraceResult, deliver_tick
from repro_torch.traffic.workloads import (Session, TrafficRequest,
                                           generate_requests)

# Request disposition codes recorded per offered request.
SERVED = 0
REJECTED_INFEASIBLE = 1     # EDF fail-fast: slack below any feasible run
REJECTED_BACKPRESSURE = 2   # bounded queue was full at arrival

# GatewayResult arrays a checkpoint must carry (the loop mutates these;
# sid/index/arrival are rebuilt from the workload at resume).
_CKPT_OUT_FIELDS = ("status", "start", "latency", "sojourn", "missed",
                    "accuracy", "energy", "model_index", "power_index")


def _obs_record_result(metrics, out: "GatewayResult", *, gateway: str,
                       policy: str) -> None:
    """Fold one finished run's :class:`GatewayResult` into the registry:
    disposition counters, paging totals and the headline SLO and energy
    gauges, one catalog for both gateways."""
    lab = dict(gateway=gateway, policy=policy)
    metrics.counter("requests_offered", **lab).inc(out.offered)
    metrics.counter("requests_served", **lab).inc(int(out.served.sum()))
    metrics.counter("requests_rejected_infeasible", **lab).inc(
        int((out.status == REJECTED_INFEASIBLE).sum()))
    metrics.counter("requests_rejected_backpressure", **lab).inc(
        int((out.status == REJECTED_BACKPRESSURE).sum()))
    metrics.counter("requests_good", **lab).inc(int(out.good.sum()))
    metrics.counter("deadline_misses", **lab).inc(
        int(out.missed[out.served].sum()))
    metrics.counter("energy_served_j", **lab).inc(
        float(out.energy[out.served].sum()))
    metrics.counter("rounds_served", **lab).inc(out.n_rounds)
    metrics.counter("pages_in", **lab).inc(out.pages_in)
    metrics.counter("pages_out", **lab).inc(out.pages_out)
    metrics.gauge("slo_miss_rate", **lab).set(out.slo_miss_rate)
    metrics.gauge("served_miss_rate", **lab).set(out.served_miss_rate)
    metrics.gauge("reject_rate", **lab).set(out.reject_rate)
    metrics.gauge("goodput_rps", **lab).set(out.goodput)
    eg = out.energy_per_good
    metrics.gauge("energy_per_good_j", **lab).set(
        eg if np.isfinite(eg) else 0.0)
    metrics.gauge("n_compiles_estimate", gateway=gateway).set(
        out.n_compiles[0])
    metrics.gauge("n_compiles_select", gateway=gateway).set(
        out.n_compiles[1])


@dataclasses.dataclass
class _RunState:
    """Everything one :meth:`SessionGateway.run` mutates outside the
    gateway's lane pool and banks: the resumable unit a checkpoint
    captures."""

    requests: list
    sess: dict
    tick: float
    queue: DeadlineBatcher
    out: "GatewayResult"
    ri: int = 0                 # next unsubmitted request index
    round_k: int = 0            # round clock
    n_rounds: int = 0           # rounds that served a batch
    last_completion: float = 0.0
    iters: int = 0              # loop iterations (checkpoint cadence)


@dataclasses.dataclass
class GatewayResult:
    """Per-request dispositions and outcomes of one gateway run.

    All arrays are indexed by offered-request row: requests sorted by
    ``(arrival, req_id)``, which for :func:`~repro_torch.traffic.workloads.
    generate_requests` workloads is ``req_id`` order.  ``status`` holds the
    disposition codes (:data:`SERVED` / :data:`REJECTED_INFEASIBLE` /
    :data:`REJECTED_BACKPRESSURE`); outcome fields are zero for unserved
    requests.  ``sojourn`` is queueing delay + run time, the latency a
    client observes.  ``select_launches`` is how much
    ``alert_select.launches`` rose during the call that returned this
    result: on the card one a round the call served under
    ``policy="alert"`` (for the megatick, one a round its clock ran: the
    last chunk's pad rounds too), else 0.  ``n_compiles`` stands for the
    reference's ``(estimate, select)`` compile count: ``(0, 0)`` for the
    host gateway, whose kernel is built ahead of the run; the megatick's
    second entry counts its chunk programs (on the card, captured CUDA
    graphs).
    """

    sid: np.ndarray
    index: np.ndarray
    arrival: np.ndarray
    status: np.ndarray
    start: np.ndarray
    latency: np.ndarray
    sojourn: np.ndarray
    missed: np.ndarray
    accuracy: np.ndarray
    energy: np.ndarray
    model_index: np.ndarray
    power_index: np.ndarray
    horizon: float = 0.0
    n_rounds: int = 0
    pages_in: int = 0
    pages_out: int = 0
    select_launches: int = 0
    n_compiles: tuple = (0, 0)

    @property
    def offered(self) -> int:
        """Number of requests the workload offered."""
        return int(self.status.shape[0])

    @property
    def served(self) -> np.ndarray:
        """Bool mask of requests that reached a lane."""
        return self.status == SERVED

    @property
    def good(self) -> np.ndarray:
        """Served AND met the absolute deadline (goodput numerator)."""
        return self.served & ~self.missed

    @property
    def goodput(self) -> float:
        """Deadline-met completions per second of gateway time."""
        return float(self.good.sum() / max(self.horizon, 1e-12))

    @property
    def served_miss_rate(self) -> float:
        """Miss fraction among *served* requests (what admission control
        bounds: hopeless requests are shed, not started)."""
        n = int(self.served.sum())
        return float(self.missed[self.served].sum() / n) if n else 0.0

    @property
    def reject_rate(self) -> float:
        """Fraction of offered requests shed (fail-fast + backpressure)."""
        return float((self.status != SERVED).mean()) if self.offered \
            else 0.0

    @property
    def slo_miss_rate(self) -> float:
        """Fraction of offered requests that did NOT complete in deadline
        (served-but-missed plus every rejection)."""
        return float(1.0 - self.good.sum() / self.offered) \
            if self.offered else 0.0

    def percentile_sojourn(self, q: float) -> float:
        """Sojourn-time percentile (seconds) over served requests."""
        s = self.sojourn[self.served]
        return float(np.percentile(s, q)) if s.size else 0.0

    @property
    def mean_energy_served(self) -> float:
        """Mean energy (J) per served request."""
        n = int(self.served.sum())
        return float(self.energy[self.served].mean()) if n else 0.0

    @property
    def energy_per_good(self) -> float:
        """Total served energy divided by deadline-met completions."""
        n = int(self.good.sum())
        return float(self.energy[self.served].sum() / n) if n else \
            float("inf")

    def stream(self, sid: int) -> TraceResult:
        """Session ``sid``'s served outcomes in input-index order, as a
        :class:`~repro_torch.serving.sim.TraceResult`: comparable (bitwise,
        at zero queueing delay) with a FleetSim stream."""
        sel = np.nonzero((self.sid == sid) & self.served)[0]
        sel = sel[np.argsort(self.index[sel], kind="stable")]
        return TraceResult(self.energy[sel], self.accuracy[sel],
                           self.latency[sel], self.missed[sel],
                           scheme="gateway")


class SessionGateway:
    """Open-loop traffic over one fixed-size batched scoring engine.

    The engine, filter banks, goal bank and lane pool are built once at
    ``n_lanes`` on ``device`` (default the card) and reused across
    :meth:`run` calls; every run resets the lane pool and session store.
    ``policy="alert"`` drives the full controller; ``policy="static"``
    executes one fixed ``(model, power)`` config through the identical
    clock, queue and delivery path (the hindsight-static baseline).
    ``obs`` takes a :class:`~repro_torch.obs.FlightRecorder`: spans,
    metrics, events and the telemetry ring, a pure observer (every result
    is bitwise the same with or without it).

    ``mesh=`` (a :class:`~repro_torch.launch.mesh.LaneMesh` whose home is
    ``device``; ``n_lanes`` a multiple of its size) shards the select and
    the filter banks over its shards; the goal window stays whole on the
    home device, as the reference keeps it on the host.  A checkpoint holds
    whole arrays, so a run killed under one mesh resumes under another
    (or none), bitwise.
    """

    def __init__(self, table: ProfileTable, n_lanes: int, *,
                 phi_true: float = 0.25, overhead: float = 0.0,
                 tick: float | None = None,
                 max_queue: int | None = None,
                 min_feasible_latency: float | None = None,
                 accuracy_window: int = 10, device=None, obs=None,
                 mesh=None):
        self.table = table
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.obs = obs
        self._ob = _resolve_obs(obs)
        self.n_lanes = int(n_lanes)
        self.phi_true = float(phi_true)
        self.tick = tick
        self.max_queue = max_queue
        self.min_feasible_latency = float(table.latency.min()) \
            if min_feasible_latency is None else float(min_feasible_latency)
        self.accuracy_window = int(accuracy_window)
        self.engine = BatchedAlertEngine(table, None, overhead=overhead,
                                         device=self.device, mesh=mesh)
        self.slow = SlowdownFilterBank(self.n_lanes, device=self.device,
                                       mesh=mesh)
        self.idle = IdlePowerFilterBank(self.n_lanes, device=self.device,
                                        mesh=mesh)
        self.goal_bank = WindowedGoalBank(
            np.zeros(self.n_lanes), self.n_lanes, accuracy_window,
            device=self.device)
        self._st = table.staircase_tensors()
        groups = table.anytime_groups()
        self._is_anytime = np.zeros(len(table.candidates), bool)
        self._is_anytime[sorted({i for g in groups.values()
                                 for i in g})] = True
        self._reset_lane_pool()

    # -------------------------------------------------------------- #
    # session paging                                                  #
    # -------------------------------------------------------------- #
    def _reset_lane_pool(self) -> None:
        """Fresh lane pool + empty session store (between runs); the
        ``[S]`` shapes are untouched."""
        self._resident = np.full(self.n_lanes, -1, dtype=np.int64)
        self._lane_of: dict[int, int] = {}
        self._store: dict[int, dict] = {}
        self._goal_kinds = np.zeros(self.n_lanes, dtype=np.int64)
        self._last_used = np.zeros(self.n_lanes, dtype=np.int64)
        self._busy_until = np.zeros(self.n_lanes)
        self._dead = np.zeros(self.n_lanes, dtype=bool)
        self.pages_in = self.pages_out = 0
        all_lanes = np.arange(self.n_lanes)
        self.slow.reset_lanes(all_lanes)
        self.idle.reset_lanes(all_lanes)
        self.goal_bank.reset_lanes(all_lanes, goal=np.zeros(self.n_lanes))

    def _evict_lanes(self, ev_lanes: Sequence[int]) -> None:
        """Page the residents of ``ev_lanes`` out to the host store (one
        batched ``export_lanes`` per bank) and free the lanes.  Shared by
        LRU eviction and device-loss quarantine: a dead lane's session
        state survives the device and can be re-admitted on a surviving
        lane."""
        if not len(ev_lanes):
            return
        slow_s = self.slow.export_lanes(ev_lanes)
        idle_s = self.idle.export_lanes(ev_lanes)
        goal_s = self.goal_bank.export_lanes(ev_lanes)
        for k, ln in enumerate(ev_lanes):
            old = int(self._resident[ln])
            self._store[old] = {
                "slow": {n: v[k:k + 1] for n, v in slow_s.items()},
                "idle": {n: v[k:k + 1] for n, v in idle_s.items()},
                "goal": {n: v[k:k + 1] for n, v in goal_s.items()},
            }
            del self._lane_of[old]
            self._resident[ln] = -1
            self.pages_out += 1

    def _page_in(self, sids: Sequence[int],
                 sessions: dict[int, Session], round_k: int,
                 now: float) -> np.ndarray:
        """Make every session in ``sids`` (distinct) lane-resident;
        returns their lanes aligned with ``sids``.

        Non-residents land in free idle lanes first, then evict the
        least-recently-used *idle* residents not needed this round (a busy
        lane's session is mid-service and cannot move): the evictees'
        filter and goal-window state goes to the host store (one batched
        ``export_lanes``) and the incomers' state is restored (one batched
        ``import_lanes`` for paged sessions, one ``reset_lanes`` for
        first-time sessions), same-shape writes only.
        """
        needed = set(sids)
        lanes = np.empty(len(sids), dtype=np.int64)
        missing: list[int] = []           # position in sids
        for pos, sid in enumerate(sids):
            lane = self._lane_of.get(sid, -1)
            lanes[pos] = lane
            if lane < 0:
                missing.append(pos)
        if missing:
            idle = (self._busy_until <= now) & ~self._dead
            free = [int(x) for x in
                    np.nonzero((self._resident < 0) & idle)[0]]
            n_evict = len(missing) - len(free)
            if n_evict > 0:
                evictable = [(int(self._last_used[ln]), ln)
                             for ln in range(self.n_lanes)
                             if idle[ln] and self._resident[ln] >= 0
                             and int(self._resident[ln]) not in needed]
                evictable.sort()
                ev_lanes = [ln for _, ln in evictable[:n_evict]]
            else:
                ev_lanes = []
            if ev_lanes:
                self._evict_lanes(ev_lanes)
                free += ev_lanes
            if len(free) < len(missing):
                # Every other resident is busy or needed this round; a
                # silent truncation would leave a lane of -1 downstream.
                raise RuntimeError(
                    f"page-in underflow: {len(missing)} non-resident "
                    f"session(s) need lanes but only {len(free)} lane(s)"
                    " are free or evictable (the rest are busy or needed"
                    " this round)")
            paged_lanes, paged_sids, fresh_lanes, fresh_sids = \
                [], [], [], []
            for pos, ln in zip(missing, free):
                sid = sids[pos]
                lanes[pos] = ln
                self._resident[ln] = sid
                self._lane_of[sid] = ln
                if sid in self._store:
                    paged_lanes.append(ln)
                    paged_sids.append(sid)
                else:
                    fresh_lanes.append(ln)
                    fresh_sids.append(sid)
                self._goal_kinds[ln] = goal_codes([sessions[sid].goal])[0]
            if paged_lanes:
                def cat(part):
                    return {n: np.concatenate([self._store[s][part][n]
                                               for s in paged_sids])
                            for n in self._store[paged_sids[0]][part]}

                self.slow.import_lanes(paged_lanes, cat("slow"))
                self.idle.import_lanes(paged_lanes, cat("idle"))
                self.goal_bank.import_lanes(paged_lanes, cat("goal"))
                for s in paged_sids:
                    del self._store[s]
                self.pages_in += len(paged_lanes)
            if fresh_lanes:
                self.slow.reset_lanes(fresh_lanes)
                self.idle.reset_lanes(fresh_lanes)
                self.goal_bank.reset_lanes(
                    fresh_lanes,
                    goal=[sessions[s].constraints.accuracy_goal or 0.0
                          for s in fresh_sids])
        if np.any(lanes < 0):
            raise RuntimeError(
                "page-in invariant violated: a requested session has no "
                "lane after paging (lanes={})".format(lanes.tolist()))
        self._last_used[lanes] = round_k
        return lanes

    # -------------------------------------------------------------- #
    # clock                                                           #
    # -------------------------------------------------------------- #
    @staticmethod
    def _round_of(arrival: float, tick: float) -> int:
        """Smallest round k with ``k * tick >= arrival`` (float-safe: a
        request arriving exactly on a round boundary is served in that
        round, which makes zero queueing delay *exactly* zero)."""
        k = max(int(np.ceil(arrival / tick)), 0)
        while k * tick < arrival:
            k += 1
        while k > 0 and (k - 1) * tick >= arrival:
            k -= 1
        return k

    # -------------------------------------------------------------- #
    # the event loop                                                  #
    # -------------------------------------------------------------- #
    def _init_run(self, sessions: Sequence[Session],
                  requests: list[TrafficRequest] | None, *,
                  policy: str, static_config, faults) -> _RunState:
        """Validate one run's inputs and build its fresh, resumable loop
        state (requests sorted and row-assigned, result shell, round
        clock, empty queue, reset lane pool)."""
        if policy not in ("alert", "static"):
            raise ValueError(policy)
        if policy == "static" and static_config is None:
            raise ValueError("policy='static' needs static_config=(i, j)")
        if faults is not None and faults.n_lanes != self.n_lanes:
            raise ValueError(
                f"FaultSchedule covers {faults.n_lanes} lanes but the "
                f"gateway has {self.n_lanes}")
        sess = {s.sid: s for s in sessions}
        if requests is None:
            requests = generate_requests(sessions)
        # Caller-supplied lists may be merged or unsorted: sort (stable)
        # and index results by sorted row.
        requests = sorted(
            requests,
            key=lambda r: (r.arrival,
                           0 if r.req_id is None else r.req_id))
        # Rows pair with requests by position; one object offered twice
        # would own two rows, so it is refused.
        if len({id(r) for r in requests}) != len(requests):
            raise ValueError(
                "the same TrafficRequest object was offered more than "
                "once; every offered request must be a distinct object")
        for k, r in enumerate(requests):
            r._row = k
        n = len(requests)
        out = GatewayResult(
            sid=np.asarray([r.sid for r in requests], dtype=np.int64),
            index=np.asarray([r.index for r in requests], dtype=np.int64),
            arrival=np.asarray([r.arrival for r in requests]),
            status=np.full(n, REJECTED_BACKPRESSURE, dtype=np.int64),
            start=np.zeros(n), latency=np.zeros(n), sojourn=np.zeros(n),
            missed=np.zeros(n, bool), accuracy=np.zeros(n),
            energy=np.zeros(n), model_index=np.zeros(n, dtype=np.int64),
            power_index=np.zeros(n, dtype=np.int64))
        tick = self.tick if self.tick is not None else \
            (max(r.rel_deadline for r in requests) if n else 1.0)
        self._reset_lane_pool()
        queue = DeadlineBatcher(batch_size=self.n_lanes,
                                min_feasible_latency=
                                self.min_feasible_latency,
                                max_queue=self.max_queue,
                                metrics=self._ob.metrics
                                if self._ob else None)
        return _RunState(requests=requests, sess=sess, tick=float(tick),
                         queue=queue, out=out)

    def run(self, sessions: Sequence[Session],
            requests: list[TrafficRequest] | None = None, *,
            policy: str = "alert",
            static_config: tuple[int, int] | None = None,
            faults=None, detector=None,
            checkpoint_dir: str | None = None,
            checkpoint_every: int = 8,
            kill_at_round: int | None = None) -> GatewayResult:
        """Serve one workload to completion; returns per-request
        dispositions and outcomes.

        ``requests`` defaults to ``generate_requests(sessions)``.
        ``policy="static"`` runs the fixed ``static_config`` (model,
        power) through the same clock, queue and delivery path with no
        controller state.

        * ``faults``: a :class:`~repro_torch.traffic.faults.FaultSchedule`
          read at every round instant: its slow-down multiplies the
          environment's true scale, and its lane-death mask quarantines
          lanes (residents paged out to the host store, capacity shrinks,
          survivors keep their state).
        * ``detector``: a
          :class:`~repro_torch.traffic.faults.KalmanLaneDetector` fed the
          slow-down bank's (mu, sigma) after each served round's update
          (a pure observer; never perturbs selection).
        * ``checkpoint_dir``: atomically snapshot the gateway, bank and
          queue state every ``checkpoint_every`` loop iterations;
          :meth:`resume` continues a killed run bit for bit.
        * ``kill_at_round``: raise
          :class:`~repro_torch.runtime.ft.InjectedFailure` at that loop
          iteration (before it executes).
        """
        rs = self._init_run(sessions, requests, policy=policy,
                            static_config=static_config, faults=faults)
        if rs.out.offered == 0:
            return rs.out
        return self._drive(rs, policy, static_config, faults, detector,
                           checkpoint_dir, checkpoint_every,
                           kill_at_round)

    def resume(self, sessions: Sequence[Session],
               requests: list[TrafficRequest] | None = None, *,
               checkpoint_dir: str,
               policy: str = "alert",
               static_config: tuple[int, int] | None = None,
               faults=None, detector=None,
               checkpoint_every: int = 8,
               kill_at_round: int | None = None) -> GatewayResult:
        """Resume a killed :meth:`run` from its latest checkpoint and drive
        it to completion, bit for bit as the uninterrupted run.

        The caller offers the SAME workload (the checkpoint stores loop
        state, not the workload).  A checkpoint written by the reference's
        gateway resumes here too: the layout and leaf names are the
        same."""
        rs = self._init_run(sessions, requests, policy=policy,
                            static_config=static_config, faults=faults)
        with self._ob.spans.span("checkpoint_restore", cat="checkpoint") \
                if self._ob else nullcontext():
            self._load_checkpoint(rs, checkpoint_dir)
        return self._drive(rs, policy, static_config, faults, detector,
                           checkpoint_dir, checkpoint_every,
                           kill_at_round)

    def _drive(self, rs: _RunState, policy: str, static_config,
               faults, detector, checkpoint_dir: str | None,
               checkpoint_every: int,
               kill_at_round: int | None) -> GatewayResult:
        """The round loop, resumable at any iteration boundary: every
        mutation lives in ``rs``, the lane pool or the banks, all of which
        the checkpoint captures."""
        requests, sess, tick, queue, out = \
            rs.requests, rs.sess, rs.tick, rs.queue, rs.out
        n = len(requests)
        launches0 = select_kernel.alert_select.launches
        ob = self._ob
        q_depth = ob.metrics.histogram("queue_depth", gateway="host") \
            if ob else None
        while rs.ri < n or len(queue):
            if kill_at_round is not None and rs.iters == kill_at_round:
                raise InjectedFailure(
                    f"injected kill at gateway iteration {rs.iters}")
            if not len(queue):
                rs.round_k = max(
                    rs.round_k,
                    self._round_of(requests[rs.ri].arrival, tick))
            now = rs.round_k * tick
            # --- the fault schedule at the round instant (host f64) ---
            fmul = None
            if faults is not None:
                dead_now = faults.dead_at(now)
                newly_dead = dead_now & ~self._dead
                if newly_dead.any():
                    # Device loss quarantines its lanes: residents page out
                    # to the host store (their state survives the device)
                    # and capacity shrinks to the survivors.
                    ev = [int(ln) for ln in np.nonzero(newly_dead)[0]
                          if self._resident[ln] >= 0]
                    self._evict_lanes(ev)
                    if ob:
                        lanes = [int(x) for x in np.nonzero(newly_dead)[0]]
                        ob.metrics.counter("quarantine_events",
                                           gateway="host").inc()
                        ob.metrics.counter("lanes_quarantined",
                                           gateway="host").inc(len(lanes))
                        ob.spans.event("quarantine", cat="fault",
                                       lanes=lanes, now_s=float(now))
                self._dead = dead_now
                fmul = faults.slow_at(now)
            # --- arrivals due by this round (backpressure at submit) ---
            while rs.ri < n and requests[rs.ri].arrival <= now:
                req = requests[rs.ri]
                if not queue.submit(req):
                    out.status[req._row] = REJECTED_BACKPRESSURE
                rs.ri += 1
            if q_depth is not None:
                q_depth.observe(len(queue))
            # --- EDF pop onto the lanes free this round, at most one
            # request per session (a session is sequential: its later
            # requests wait behind it).  A run of blocked same-session
            # requests longer than the deferral budget waits for the next
            # round instead of churning the backlog through the heap.
            n_rej = len(queue.rejected)
            avail = int(((self._busy_until <= now)
                         & ~self._dead).sum())
            batch: list[TrafficRequest] = []
            seen: set[int] = set()
            deferred: list[TrafficRequest] = []
            defer_budget = 4 * self.n_lanes
            while len(batch) < avail and len(deferred) <= defer_budget:
                req = queue.pop_one(now)
                if req is None:
                    break
                lane = self._lane_of.get(req.sid, -1)
                if req.sid in seen or \
                        (lane >= 0 and self._busy_until[lane] > now):
                    deferred.append(req)
                    continue
                seen.add(req.sid)
                batch.append(req)
            for req in deferred:
                # A deferral is not a new arrival: requeue() bypasses
                # backpressure and keeps the request's heap seq, so the
                # EDF submission-order tie-break survives.
                queue.requeue(req)
            for req in queue.rejected[n_rej:]:   # failed fast this round
                out.status[req._row] = REJECTED_INFEASIBLE
                out.start[req._row] = now
            if batch:
                with ob.spans.span("serve_round", cat="gateway",
                                   round_k=rs.round_k, batch=len(batch)) \
                        if ob else nullcontext():
                    rs.last_completion = max(
                        rs.last_completion, self._serve_round(
                            batch, sess, now, rs.round_k, policy,
                            static_config, out, fmul, detector))
                rs.n_rounds += 1
            rs.round_k += 1
            rs.iters += 1
            if checkpoint_dir is not None and \
                    rs.iters % max(checkpoint_every, 1) == 0:
                with ob.spans.span("checkpoint_write", cat="checkpoint",
                                   iters=rs.iters) if ob else nullcontext():
                    self._save_checkpoint(rs, checkpoint_dir)
        out.horizon = max(rs.last_completion,
                          float(out.arrival[-1]) if n else 0.0)
        out.n_rounds = rs.n_rounds
        out.pages_in, out.pages_out = self.pages_in, self.pages_out
        out.select_launches = select_kernel.alert_select.launches - launches0
        if ob:
            _obs_record_result(ob.metrics, out, gateway="host",
                               policy=policy)
        return out

    # -------------------------------------------------------------- #
    # checkpoint / resume                                             #
    # -------------------------------------------------------------- #
    def _save_checkpoint(self, rs: _RunState, directory: str) -> None:
        """Atomic snapshot of everything :meth:`_drive` mutates: loop
        scalars, the EDF heap (internal list order + seq counter, so
        restored pops are bitwise), the lane pool, every lane's filter and
        goal state, the paged-session store and the partial result
        arrays, in the reference's layout."""
        q = rs.queue
        # Peek the seq counter without perturbing it: consume one value
        # and replace the counter with a fresh count from that value.
        n0 = next(q._counter)
        q._counter = itertools.count(n0)
        all_lanes = np.arange(self.n_lanes)
        store_sids = np.asarray(sorted(self._store), dtype=np.int64)
        store: dict = {"sids": store_sids}
        if store_sids.size:
            s0 = self._store[int(store_sids[0])]
            for part in ("slow", "idle", "goal"):
                for name in s0[part]:
                    store[f"{part}.{name}"] = np.concatenate(
                        [self._store[int(s)][part][name]
                         for s in store_sids])
        tree = {
            "meta": {
                "ri": np.int64(rs.ri),
                "round_k": np.int64(rs.round_k),
                "n_rounds": np.int64(rs.n_rounds),
                "iters": np.int64(rs.iters),
                "last_completion": np.float64(rs.last_completion),
                "pages_in": np.int64(self.pages_in),
                "pages_out": np.int64(self.pages_out),
                "next_seq": np.int64(n0),
                "tick": np.float64(rs.tick),
                "n_requests": np.int64(len(rs.requests)),
            },
            "queue": {
                "seq": np.asarray([s for _, s, _ in q._heap],
                                  dtype=np.int64),
                "row": np.asarray([r._row for _, _, r in q._heap],
                                  dtype=np.int64),
            },
            "lanes": {
                "resident": self._resident.copy(),
                "goal_kinds": self._goal_kinds.copy(),
                "last_used": self._last_used.copy(),
                "busy_until": self._busy_until.copy(),
                "dead": self._dead.copy(),
            },
            "slow": self.slow.export_lanes(all_lanes),
            "idle": self.idle.export_lanes(all_lanes),
            "goal": self.goal_bank.export_lanes(all_lanes),
            "store": store,
            "out": {f: getattr(rs.out, f).copy() for f in
                    _CKPT_OUT_FIELDS},
        }
        ckpt_io.save(directory, tree, step=rs.iters)

    def _load_checkpoint(self, rs: _RunState, directory: str) -> None:
        """Overwrite the fresh ``rs``, lane pool and banks with the
        snapshot under ``directory``.  Under a lane mesh the restored bank
        state is resharded onto this gateway's mesh first
        (:func:`~repro_torch.runtime.elastic.reshard_state`), whatever
        mesh the checkpoint was written under."""
        tree, _step = ckpt_io.restore_tree(directory)
        meta = tree["meta"]
        if int(meta["n_requests"]) != len(rs.requests):
            raise ValueError(
                f"checkpoint was taken over {int(meta['n_requests'])} "
                f"requests but this run offers {len(rs.requests)}: "
                "resume needs the identical workload")
        if float(meta["tick"]) != rs.tick:
            raise ValueError(
                f"checkpoint tick {float(meta['tick'])} != run tick "
                f"{rs.tick}: resume needs the identical round clock")
        rs.ri = int(meta["ri"])
        rs.round_k = int(meta["round_k"])
        rs.n_rounds = int(meta["n_rounds"])
        rs.iters = int(meta["iters"])
        rs.last_completion = float(meta["last_completion"])
        self.pages_in = int(meta["pages_in"])
        self.pages_out = int(meta["pages_out"])
        q = rs.queue
        q._counter = itertools.count(int(meta["next_seq"]))
        heap = []
        for s, rw in zip(tree["queue"]["seq"].tolist(),
                         tree["queue"]["row"].tolist()):
            req = rs.requests[int(rw)]
            req._seq = int(s)
            heap.append((req.deadline, int(s), req))
        # Saved in internal list order, so the heap invariant holds
        # verbatim and restored pops are bitwise-identical.
        q._heap = heap
        ln = tree["lanes"]
        self._resident = ln["resident"].astype(np.int64)
        self._goal_kinds = ln["goal_kinds"].astype(np.int64)
        self._last_used = ln["last_used"].astype(np.int64)
        self._busy_until = ln["busy_until"].astype(np.float64)
        self._dead = ln["dead"].astype(bool)
        self._lane_of = {int(s): int(l)
                         for l, s in enumerate(self._resident) if s >= 0}
        all_lanes = np.arange(self.n_lanes)
        slow_state, idle_state = tree["slow"], tree["idle"]
        if self.mesh is not None:
            spec = lane_pspec(self.mesh)
            slow_state, idle_state = (
                reshard_state(st, self.mesh, lambda path, leaf: spec)
                for st in (slow_state, idle_state))
        self.slow.import_lanes(all_lanes, slow_state)
        self.idle.import_lanes(all_lanes, idle_state)
        self.goal_bank.import_lanes(all_lanes, tree["goal"])
        self._store = {}
        for k, sid in enumerate(tree["store"]["sids"].tolist()):
            entry: dict = {"slow": {}, "idle": {}, "goal": {}}
            for key, arr in tree["store"].items():
                if key == "sids":
                    continue
                part, name = key.split(".", 1)
                entry[part][name] = arr[k:k + 1]
            self._store[int(sid)] = entry
        for f in _CKPT_OUT_FIELDS:
            getattr(rs.out, f)[:] = tree["out"][f]

    def _serve_round(self, batch, sess, now: float, round_k: int,
                     policy: str, static_config, out: GatewayResult,
                     fmul=None, detector=None) -> float:
        """One synchronous round: page the batch's sessions in, score all
        lanes with one masked engine call (or the fixed static config),
        deliver through the host tick delivery, absorb feedback.  Returns
        the round's last completion time."""
        ob = self._ob
        with ob.spans.span("page_in", cat="paging", round_k=round_k) \
                if ob else nullcontext():
            lanes = self._page_in([r.sid for r in batch], sess, round_k,
                                  now)
        act = np.zeros(self.n_lanes, bool)
        dvec = np.ones(self.n_lanes)
        e_goal = np.zeros(self.n_lanes)
        scale = np.ones(self.n_lanes)
        for req, lane in zip(batch, lanes):
            s = sess[req.sid]
            act[lane] = True
            # Effective T_goal: the nominal allotment minus queueing
            # delay, from the *relative* deadline so a request served on
            # its arrival instant sees its nominal bitwise.
            dvec[lane] = req.rel_deadline - (now - req.arrival)
            e_goal[lane] = (s.constraints.energy_goal or 0.0) * \
                s.trace.deadline_scale[req.index]
            scale[lane] = s.trace.xi[req.index] * s.trace.lam[req.index]
        if fmul is not None:
            # The injected slow-down composes onto the true scale after
            # the per-lane fill, as (xi*lam) * f: the reference's order.
            scale = scale * fmul
        if policy == "alert":
            b = self.engine.select(
                self.slow.mu, self.slow.sigma, self.idle.phi, dvec,
                accuracy_goal=self.goal_bank.current_goal(),
                energy_goal=e_goal, goal_kind=self._goal_kinds,
                active=act, predictions=False)
            i_pick, j_pick = b.model_index, b.power_index
        else:
            b = None
            i_pick = np.full(self.n_lanes, static_config[0],
                             dtype=np.int64)
            j_pick = np.full(self.n_lanes, static_config[1],
                             dtype=np.int64)
        d = deliver_tick(self.table, self._st, i_pick, j_pick, scale,
                         dvec, self.phi_true, self._is_anytime,
                         self.table.latency[i_pick, j_pick])
        # The Eq. 6 prior before the update, read only for the innovation
        # histogram (a host copy; the bank is not touched).
        mu_prev = self.slow.mu.cpu().numpy() \
            if (ob is not None and policy == "alert") else None
        if policy == "alert":
            observe_fleet(self.slow, self.idle, d.observed, d.profiled,
                          deadline_missed=d.miss_flag,
                          idle_power=self.phi_true * d.run_power,
                          active_power=self.table.run_power[i_pick,
                                                            j_pick],
                          mask=act)
            self.goal_bank.record(d.accuracy, mask=act)
            if detector is not None:
                # Detection reads the Eq. 7 posterior AFTER the round's
                # update, through host copies; selection never sees it.
                newly = detector.observe(self.slow.mu.cpu().numpy(),
                                         self.slow.sigma.cpu().numpy(), act,
                                         now)
                if ob is not None and newly.size:
                    ob.metrics.counter("fault_trips",
                                       gateway="host").inc(newly.size)
                    ob.spans.event("fault_trip", cat="fault",
                                   lanes=[int(x) for x in newly],
                                   now_s=float(now))
        if ob is not None:
            if mu_prev is not None:
                # |z - mu_prior|, z = observed / profiled: the innovation
                # the Kalman gain weighs this round.
                z = d.observed / d.profiled
                ob.metrics.histogram(
                    "kalman_innovation", gateway="host").observe_many(
                    np.abs(z - mu_prev)[act])
            feas = (b.feasible & act) if b is not None else act
            relaxed = ((b.relaxed_code != 0) & act) if b is not None \
                else np.zeros_like(act)
            ob.ring.push_rounds(
                now_s=[now], n_active=[int(act.sum())],
                n_feasible=[int(feas.sum())],
                n_relaxed=[int(relaxed.sum())],
                energy_j=[float(d.energy[act].sum())],
                n_missed=[int(d.missed[act].sum())])
        last = now
        for req, lane in zip(batch, lanes):
            rid = req._row
            out.status[rid] = SERVED
            out.start[rid] = now
            out.latency[rid] = d.latency[lane]
            out.sojourn[rid] = (now - req.arrival) + d.latency[lane]
            out.missed[rid] = d.missed[lane]
            out.accuracy[rid] = d.accuracy[lane]
            out.energy[rid] = d.energy[lane]
            out.model_index[rid] = i_pick[lane]
            out.power_index[rid] = j_pick[lane]
            self._busy_until[lane] = now + float(d.latency[lane])
            last = max(last, now + float(d.latency[lane]))
        return last
