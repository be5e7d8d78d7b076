"""The gateway's round clock on the device: one CUDA graph a chunk of
rounds (port of ``repro.traffic.megatick``).

:class:`~repro_torch.traffic.gateway.SessionGateway` runs its round clock
as a host Python loop: per round one ``select``, one host delivery, one
feedback call and one paging pass.  :class:`MegatickGateway` serves the
same workload with the inner round (the effective deadline, the masked
select, the delivery and the Eq. 6/8 and goal-window feedback) on the
device, ``chunk`` rounds at a time.

**Regime.**  At ``tick >= max(rel_deadline)`` (the gateway's default
tick) every admission decision is independent of latencies: a round's run
time is capped at its effective deadline, which is at most the tick, so
every lane is idle at every round boundary.  The loop then splits in two
exact halves:

* a **host planner** replays the host loop's clock, arrivals, EDF
  fail-fast admission, backpressure, same-session deferral, LRU paging
  bookkeeping and fault protocol up front (the same
  :class:`~repro_torch.serving.batcher.DeadlineBatcher`, the same paging
  order, so ``pages_in``/``pages_out`` and every disposition match) and
  emits a dense ``[R, L]`` round schedule;
* the **round clock** runs that schedule with every session's filter and
  goal-window state ``[S]``-resident on the device: a round gathers its
  sessions to lanes by index and scatters them back, so paging moves no
  state (the host loop's export/import round trips are lossless and every
  per-lane op is lane-independent).

A finer tick couples admission to in-round latencies; :meth:`run` raises
on it (that regime stays with ``SessionGateway``).

**On the card** the round clock is one CUDA graph per (policy, static
config, ring, S): ``chunk`` rounds of the body unrolled in one capture,
captured once and replayed for every chunk of every run (the
counterpart of the reference's donated ``lax.scan``).  The ``[S + 1]``
state lives in static tensors updated in place; row ``S`` is a pad of
prior values that inactive lanes point at (the reference's clamped
gather and dropped scatter).  Before a replay the chunk's schedule goes
into static input buffers, one copy per dtype from pinned host memory;
after it the outputs come back one copy per dtype.  A replay adds to
``alert_select.launches`` what its capture counted (one a round under
``policy="alert"``, the last chunk's all-inactive pad rounds included);
a capture that fails raises.  On the CPU, or with
``graphs=False``, the same body runs eagerly.  Every piece of the body is
the host loop's op for op (:meth:`~repro_torch.core.batched.
BatchedAlertEngine.select_step_impl`, :func:`~repro_torch.serving.sim.
deliver_step`, :func:`~repro_torch.core.kalman.fused_fleet_step`, the goal
window's record step and pairwise sum), so a result is bitwise the host
gateway's.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.batched import (BatchedAlertEngine, _goal_record_step,
                                      goal_codes, goal_current_step_hostsum)
from repro_torch.core.kalman import (IdlePowerFilterBank, SlowdownFilterBank,
                                     fused_fleet_step)
from repro_torch.core.profiles import ProfileTable
from repro_torch.kernels import alert_select as select_kernel
from repro_torch.launch.mesh import mesh_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.ring import round_aggregates
from repro_torch.serving.batcher import DeadlineBatcher
from repro_torch.serving.sim import deliver_step
from repro_torch.traffic.gateway import (REJECTED_BACKPRESSURE,
                                         REJECTED_INFEASIBLE, SERVED,
                                         GatewayResult, SessionGateway,
                                         _obs_record_result, _resolve_obs)
from repro_torch.traffic.workloads import (Session, TrafficRequest,
                                           generate_requests)

F64 = torch.float64
I64 = torch.int64
# Per-round f64 inputs ([C, L] each), then the round instants [C].
_F64_IN = ("rel", "arr", "e_goal", "scale")
# Per-round outputs: f64 run time, delivered accuracy, sojourn; int64
# model and power index; bool miss flag; with a ring, 5 f64 sums a round.
_F64_OUT = ("run_t", "acc", "sojourn")


@dataclasses.dataclass
class _Plan:
    """The planner's dense round schedule: ``[R, L]`` per-lane inputs for
    ``n_active`` real rounds (padded with all-inactive rounds to a chunk
    multiple), and the :class:`GatewayResult` shell with every disposition
    already decided."""

    out: GatewayResult
    n_active: int
    act: np.ndarray         # [R, L] bool
    sid: np.ndarray         # [R, L] int64 dense session index; S inactive
    row: np.ndarray         # [R, L] int64 result row; -1 inactive
    rel: np.ndarray         # [R, L] f64 nominal relative deadline
    arr: np.ndarray         # [R, L] f64 arrival instant
    e_goal: np.ndarray      # [R, L] f64 effective energy goal
    scale: np.ndarray       # [R, L] f64 effective latency scale
    gk: np.ndarray          # [R, L] int64 goal codes
    dead: np.ndarray        # [R, L] bool lane-death mask (faults)
    now: np.ndarray         # [R] f64 round instants k * tick


class _Chunk:
    """The static buffers of one (policy, static config, ring, S) key, and
    on the card the CUDA graph of ``chunk`` rounds over them."""

    def __init__(self, gw: "MegatickGateway", policy: str, static_config,
                 ring: bool, n_sessions: int):
        dev = gw.device
        c, ln = gw.chunk, gw.n_lanes
        self.policy, self.ring = policy, ring
        self.n_sessions = n_sessions
        cl = c * ln
        pin = dev.type == "cuda"

        def pair(n, dtype):
            host = torch.zeros(n, dtype=dtype, pin_memory=pin)
            return host, (host if dev.type == "cpu"
                          else torch.zeros(n, dtype=dtype, device=dev))

        # Inputs, one buffer a dtype.
        self.f64_in_host, self.f64_in = pair(len(_F64_IN) * cl + c, F64)
        self.i64_in_host, self.i64_in = pair(2 * cl, I64)
        self.b_in_host, self.b_in = pair(2 * cl, torch.bool)
        rows = lambda t, k: t[k * cl:(k + 1) * cl].view(c, ln)
        self.x = {name: rows(self.f64_in, k)
                  for k, name in enumerate(_F64_IN)}
        self.x["now"] = self.f64_in[len(_F64_IN) * cl:]
        self.x["sid"], self.x["gk"] = rows(self.i64_in, 0), \
            rows(self.i64_in, 1)
        self.x["act"], self.x["dead"] = rows(self.b_in, 0), \
            rows(self.b_in, 1)
        # Outputs, one buffer a dtype.
        n_ring = 5 * c if ring else 0
        self.f64_out_host, self.f64_out = pair(len(_F64_OUT) * cl + n_ring,
                                               F64)
        self.i64_out_host, self.i64_out = pair(2 * cl, I64)
        self.b_out_host, self.b_out = pair(cl, torch.bool)
        self.y = {name: rows(self.f64_out, k)
                  for k, name in enumerate(_F64_OUT)}
        self.y["ring"] = self.f64_out[len(_F64_OUT) * cl:].view(5, c) \
            if ring else None
        self.y["i"], self.y["j"] = rows(self.i64_out, 0), \
            rows(self.i64_out, 1)
        self.y["missed"] = self.b_out.view(c, ln)
        # [S + 1] state, row S the pad inactive lanes point at.
        s1 = n_sessions + 1
        depth = max(gw.accuracy_window - 1, 0)
        self.state = None
        if policy == "alert":
            self.state = {n: torch.zeros(s1, dtype=F64, device=dev)
                          for n in ("mu", "sigma", "gain", "q", "phi",
                                    "var", "goal")}
            self.state["buf"] = torch.zeros((s1, max(depth, 1)), dtype=F64,
                                            device=dev)
            self.state["pos"] = torch.zeros(s1, dtype=I64, device=dev)
            self.state["count"] = torch.zeros(s1, dtype=I64, device=dev)
        else:
            self.fixed = (torch.full((ln,), int(static_config[0]),
                                     dtype=I64, device=dev),
                          torch.full((ln,), int(static_config[1]),
                                     dtype=I64, device=dev))
        self.graph = None
        self.launches = 0           # alert_select launches a replay
        if gw.graphs:
            self._capture(gw)

    def _capture(self, gw: "MegatickGateway") -> None:
        """One eager chunk on a side stream (loads the kernel library
        outside the capture; the state it touches is reset before a run),
        then the capture.  Neither serves a round, so neither counts: the
        capture's launches are kept and added on every replay."""
        dev = gw.device
        before = select_kernel.alert_select.launches
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                gw._chunk_body(self)
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = select_kernel.alert_select.launches
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                gw._chunk_body(self)
            self.launches = select_kernel.alert_select.launches - warm
            select_kernel.alert_select.launches = before
            graph.instantiate()
        self.graph = graph


class MegatickGateway:
    """Open-loop traffic with the round clock on the device.

    Drop-in for :class:`~repro_torch.traffic.gateway.SessionGateway` at
    ``tick >= max(rel_deadline)``: the same constructor surface and
    :meth:`run` contract and a bitwise equal :class:`GatewayResult`, with
    the rounds run ``chunk`` at a time (the schedule is padded to a chunk
    multiple, so one chunk program serves every dispatch of a load sweep).
    ``device`` defaults to the card; ``graphs=False`` runs the chunk
    eagerly there (the CPU always does).  ``obs`` takes a
    :class:`~repro_torch.obs.FlightRecorder` (spans, metrics and the
    telemetry ring, whose sums the round body computes; a pure observer).

    ``mesh=`` (a :class:`~repro_torch.launch.mesh.LaneMesh` whose home is
    ``device``; ``n_lanes`` a multiple of its size) launches the round's
    select once a shard on its block of lanes: the chunk's graph then
    holds ``mesh.size`` ``alert_select`` nodes a round.  Session state
    stays whole on the home device (the reference keeps it unsharded
    too).  A graph is captured on one device, so with ``graphs=True``
    every shard must be on the home device; a mesh over several devices
    runs its chunks eagerly (``graphs=False``).
    """

    def __init__(self, table: ProfileTable, n_lanes: int, *,
                 phi_true: float = 0.25, overhead: float = 0.0,
                 tick: float | None = None,
                 max_queue: int | None = None,
                 min_feasible_latency: float | None = None,
                 accuracy_window: int = 10, chunk: int = 128, obs=None,
                 device=None, graphs: bool = True, mesh=None):
        self.table = table
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.graphs = bool(graphs) and self.device.type == "cuda"
        if mesh is not None:
            if int(n_lanes) % mesh.size:
                raise ValueError(
                    f"lane-sharded megatick needs n_lanes divisible by the "
                    f"mesh size ({mesh.size}); got {n_lanes}")
            if self.graphs and any(d != self.device for d in mesh.devices):
                raise ValueError(
                    f"a chunk's CUDA graph is captured on one device, and "
                    f"{mesh} spans several: pass graphs=False")
        self.obs = obs
        self._ob = _resolve_obs(obs)
        # The phase timers accumulate across runs even without a recorder.
        reg = self._ob.metrics if self._ob else MetricsRegistry()
        self._plan_timer = reg.timer("megatick_plan", gateway="megatick")
        self._scan_timer = reg.timer("megatick_scan", gateway="megatick")
        self.n_lanes = int(n_lanes)
        self.phi_true = float(phi_true)
        self.tick = tick
        self.max_queue = max_queue
        self.min_feasible_latency = float(table.latency.min()) \
            if min_feasible_latency is None else float(min_feasible_latency)
        self.accuracy_window = int(accuracy_window)
        self.chunk = int(chunk)
        self.engine = BatchedAlertEngine(table, None, overhead=overhead,
                                         device=self.device, mesh=mesh)
        self._select = self.engine.select_step_impl()
        st = table.staircase_tensors()
        groups = table.anytime_groups()
        is_anytime = np.zeros(len(table.candidates), bool)
        is_anytime[sorted({i for g in groups.values() for i in g})] = True
        dev = self.device
        self._consts = dict(
            latency_kl=self.engine._latency,
            run_power_kl=self.engine._run_power,
            q_fail=float(table.q_fail),
            is_anytime_k=torch.as_tensor(is_anytime, device=dev),
            lvl_lat_kml=torch.as_tensor(st.lvl_lat, dtype=F64, device=dev),
            lvl_valid_km=torch.as_tensor(st.lvl_valid, device=dev),
            lvl_acc_km=torch.as_tensor(st.lvl_acc, dtype=F64, device=dev))
        self._slow_tpl = SlowdownFilterBank(1, device="cpu")
        self._idle_tpl = IdlePowerFilterBank(1, device="cpu")
        self._slow_params = self._slow_tpl.step_params()
        self._idle_params = self._idle_tpl.step_params()
        self._chunks: dict = {}
        self._round_base = 0        # the first round of the chunk running

    # -------------------------------------------------------------- #
    # phase timers                                                    #
    # -------------------------------------------------------------- #
    @property
    def last_plan_s(self) -> float:
        """Wall time of the latest :meth:`run`'s host planner."""
        return self._plan_timer.last_s

    @property
    def last_scan_s(self) -> float:
        """Wall time of the latest :meth:`run`'s round clock: the chunk
        dispatches (copies in, replay, copies out) and the result
        scatter."""
        return self._scan_timer.last_s

    @property
    def total_plan_s(self) -> float:
        """Planner wall time over every :meth:`run` of this gateway."""
        return self._plan_timer.total_s

    @property
    def total_scan_s(self) -> float:
        """Round-clock wall time over every :meth:`run` of this gateway."""
        return self._scan_timer.total_s

    # -------------------------------------------------------------- #
    # host planner                                                    #
    # -------------------------------------------------------------- #
    def _reset_lru(self, n_sessions: int) -> None:
        """Fresh paging bookkeeping, indexed by dense session index (a
        bijection with sids, so lanes, evictions and page counts are the
        host loop's)."""
        self._resident = np.full(self.n_lanes, -1, dtype=np.int64)
        self._lane_arr = np.full(max(n_sessions, 1), -1, dtype=np.int64)
        self._stored_arr = np.zeros(max(n_sessions, 1), dtype=bool)
        self._last_used = np.zeros(self.n_lanes, dtype=np.int64)
        self._dead = np.zeros(self.n_lanes, dtype=bool)
        self.pages_in = self.pages_out = 0

    def _page_in_meta(self, sids: np.ndarray, round_k: int) -> np.ndarray:
        """:meth:`SessionGateway._page_in`'s lane assignment and paging
        counts without moving state: free lanes in ascending order, then
        evictions by (last_used, lane) (a stable argsort over ascending
        lanes, the host's tuple sort), to the missing sessions in order.
        Every lane is idle at every boundary in this regime."""
        lanes = self._lane_arr[sids]
        miss = np.nonzero(lanes < 0)[0]
        if miss.size:
            free = np.nonzero((self._resident < 0) & ~self._dead)[0]
            n_evict = miss.size - free.size
            if n_evict > 0:
                mask = (self._resident >= 0) & ~self._dead
                mask[mask] = ~np.isin(self._resident[mask], sids)
                cand = np.nonzero(mask)[0]
                order = np.argsort(self._last_used[cand], kind="stable")
                ev = cand[order][:n_evict]
                olds = self._resident[ev]
                self._stored_arr[olds] = True
                self._lane_arr[olds] = -1
                self._resident[ev] = -1
                self.pages_out += int(ev.size)
                free = np.concatenate([free, ev])
            if free.size < miss.size:
                raise RuntimeError(
                    f"page-in underflow: {miss.size} session(s) need "
                    f"lanes but only {free.size} are available")
            take = free[:miss.size]
            msids = sids[miss]
            lanes[miss] = take
            self._resident[take] = msids
            self._lane_arr[msids] = take
            self.pages_in += int(self._stored_arr[msids].sum())
            self._stored_arr[msids] = False
        self._last_used[lanes] = round_k
        return lanes

    def _plan(self, sessions: Sequence[Session],
              requests: list[TrafficRequest] | None,
              sid_index: dict[int, int], faults=None) -> _Plan:
        """Replay the host loop's clock and admission up front (the
        control flow of :meth:`SessionGateway.run` with every lane idle at
        every boundary) and emit the dense round schedule.  ``faults``
        replays the host loop's fault protocol at the same instants: death
        transitions quarantine lanes, and each scheduled round's scale
        row is multiplied by the schedule's slow-down in the host's
        ``(xi*lam) * f`` order."""
        sess = {s.sid: s for s in sessions}
        if requests is None:
            requests = generate_requests(sessions)
        requests = sorted(
            requests,
            key=lambda r: (r.arrival,
                           0 if r.req_id is None else r.req_id))
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
        if n == 0:
            return _Plan(out, 0, *(np.zeros((0, self.n_lanes)),) * 9,
                         np.zeros(0))
        tick = self.tick if self.tick is not None else \
            max(r.rel_deadline for r in requests)
        max_rel = max(r.rel_deadline for r in requests)
        if tick < max_rel:
            raise ValueError(
                f"megatick needs tick >= max relative deadline "
                f"({tick} < {max_rel}): a finer tick couples admission "
                f"to in-round latencies (busy lanes at round "
                f"boundaries); use SessionGateway for that regime")
        self._reset_lru(len(sessions))
        ob = self._ob
        queue = DeadlineBatcher(batch_size=self.n_lanes,
                                min_feasible_latency=
                                self.min_feasible_latency,
                                max_queue=self.max_queue,
                                metrics=ob.metrics if ob else None)
        q_depth = ob.metrics.histogram("queue_depth",
                                       gateway="megatick") if ob else None
        code_of: dict = {}          # goal_codes is pure per goal
        for s in sessions:
            if s.goal not in code_of:
                code_of[s.goal] = int(goal_codes([s.goal])[0])
        gk_of = {s.sid: code_of[s.goal] for s in sessions}
        # Flat per-field accumulators, one entry per served request,
        # scattered into the [R, L] schedule in one pass.
        now_l: list[float] = []
        f_round: list[int] = []
        f_lane: list[int] = []
        f_row: list[int] = []
        f_sid: list[int] = []
        f_rel: list[float] = []
        f_arr: list[float] = []
        f_eg: list[float] = []
        f_sc: list[float] = []
        f_gk: list[int] = []
        fault_mul: list[np.ndarray] = []
        fault_dead: list[np.ndarray] = []
        ri = 0
        round_k = 0
        while ri < n or len(queue):
            if not len(queue):
                round_k = max(round_k, SessionGateway._round_of(
                    requests[ri].arrival, tick))
            now = round_k * tick
            if faults is not None:
                dead_now = faults.dead_at(now)
                newly_dead = dead_now & ~self._dead
                if newly_dead.any():
                    ev = np.nonzero(newly_dead & (self._resident >= 0))[0]
                    if ev.size:
                        olds = self._resident[ev]
                        self._stored_arr[olds] = True
                        self._lane_arr[olds] = -1
                        self._resident[ev] = -1
                        self.pages_out += int(ev.size)
                    if ob:
                        lanes = [int(x) for x in np.nonzero(newly_dead)[0]]
                        ob.metrics.counter("quarantine_events",
                                           gateway="megatick").inc()
                        ob.metrics.counter(
                            "lanes_quarantined",
                            gateway="megatick").inc(len(lanes))
                        ob.spans.event("quarantine", cat="fault",
                                       lanes=lanes, now_s=float(now))
                self._dead = dead_now
            while ri < n and requests[ri].arrival <= now:
                req = requests[ri]
                if not queue.submit(req):
                    out.status[req._row] = REJECTED_BACKPRESSURE
                ri += 1
            if q_depth is not None:
                q_depth.observe(len(queue))
            n_rej = len(queue.rejected)
            # Every lane is idle at a boundary: the host's free-lane count
            # is the live-lane count.
            avail = self.n_lanes - int(self._dead.sum())
            batch: list[TrafficRequest] = []
            seen: set[int] = set()
            deferred: list[TrafficRequest] = []
            defer_budget = 4 * self.n_lanes
            while len(batch) < avail and len(deferred) <= defer_budget:
                req = queue.pop_one(now)
                if req is None:
                    break
                if req.sid in seen:
                    deferred.append(req)
                    continue
                seen.add(req.sid)
                batch.append(req)
            for req in deferred:
                queue.requeue(req)
            for req in queue.rejected[n_rej:]:
                out.status[req._row] = REJECTED_INFEASIBLE
                out.start[req._row] = now
            if batch:
                dense = [sid_index[r.sid] for r in batch]
                lanes = self._page_in_meta(
                    np.asarray(dense, dtype=np.int64), round_k)
                k = len(now_l)
                now_l.append(now)
                if faults is not None:
                    fault_mul.append(faults.slow_at(now))
                    fault_dead.append(self._dead.copy())
                for req, lane, dk in zip(batch, lanes, dense):
                    s = sess[req.sid]
                    f_round.append(k)
                    f_lane.append(int(lane))
                    f_row.append(req._row)
                    f_sid.append(dk)
                    f_rel.append(req.rel_deadline)
                    f_arr.append(req.arrival)
                    f_eg.append((s.constraints.energy_goal or 0.0)
                                * s.trace.deadline_scale[req.index])
                    f_sc.append(s.trace.xi[req.index]
                                * s.trace.lam[req.index])
                    f_gk.append(gk_of[req.sid])
            round_k += 1
        n_active = len(now_l)
        r_tot = n_active + (-n_active % self.chunk)
        s_tot = len(sessions)
        ln = self.n_lanes
        act = np.zeros((r_tot, ln), bool)
        sid = np.full((r_tot, ln), s_tot, dtype=np.int64)
        row = np.full((r_tot, ln), -1, dtype=np.int64)
        rel = np.zeros((r_tot, ln))
        arr = np.zeros((r_tot, ln))
        e_goal = np.zeros((r_tot, ln))
        scale = np.ones((r_tot, ln))
        gk = np.zeros((r_tot, ln), dtype=np.int64)
        now_v = np.zeros(r_tot)
        now_v[:n_active] = now_l
        kk = np.asarray(f_round, dtype=np.int64)
        lv = np.asarray(f_lane, dtype=np.int64)
        rw = np.asarray(f_row, dtype=np.int64)
        act[kk, lv] = True
        sid[kk, lv] = f_sid
        row[kk, lv] = rw
        rel[kk, lv] = f_rel
        arr[kk, lv] = f_arr
        e_goal[kk, lv] = f_eg
        scale[kk, lv] = f_sc
        gk[kk, lv] = f_gk
        dead = np.zeros((r_tot, ln), bool)
        if faults is not None and n_active:
            # The host's elementwise f64 product after its lane fill.
            scale[:n_active] = scale[:n_active] * np.stack(fault_mul)
            dead[:n_active] = np.stack(fault_dead)
        # Each row's disposition is unique (served, rejected or shed).
        out.status[rw] = SERVED
        out.start[rw] = now_v[kk]
        return _Plan(out, n_active, act, sid, row, rel, arr, e_goal,
                     scale, gk, dead, now_v)

    # -------------------------------------------------------------- #
    # round clock                                                     #
    # -------------------------------------------------------------- #
    def _pick(self, ch: _Chunk, r: int, *lanes):
        """Round ``r`` of the chunk's select (``self._round_base + r`` is
        the run's round when the chunk runs eagerly)."""
        return self._select(*lanes)

    def _round(self, ch: _Chunk, r: int) -> None:
        """Round ``r`` of a chunk, the host gateway's ``_serve_round`` op
        for op: gather the round's sessions to lanes, the effective
        deadline, select, deliver, the fused Eq. 6/8 and goal-window
        feedback, scatter back; its outputs into row ``r`` of the output
        buffers.  No op syncs with the host."""
        x, y = ch.x, ch.y
        # A dead lane is never scheduled; the mask only hardens the body.
        act = x["act"][r] & ~x["dead"][r]
        sidv, now = x["sid"][r], x["now"][r]
        relv, arrv, scl = x["rel"][r], x["arr"][r], x["scale"][r]
        dvec = torch.where(act, relv - (now - arrv), 1.0)
        if ch.policy == "static":
            i, j = ch.fixed
            run_t, acc, energy, missed, *_ = deliver_step(
                i, j, scl, dvec, self.phi_true, **self._consts)
            feas, relaxed = act, torch.zeros_like(i)
        else:
            st = ch.state
            get = lambda name: st[name].index_select(0, sidv)
            mu_l, sd_l, ph_l = get("mu"), get("sigma"), get("phi")
            g_l, q_l, v_l = get("gain"), get("q"), get("var")
            depth = max(self.accuracy_window - 1, 0)
            if depth:
                buf_l, pos_l, cnt_l = get("buf"), get("pos"), get("count")
                acc_goal = goal_current_step_hostsum(
                    get("goal"), buf_l, cnt_l, self.accuracy_window)
            else:
                acc_goal = get("goal")
            i, j, _, _, _, feas, relaxed = self._pick(
                ch, r, mu_l, sd_l, ph_l, dvec, acc_goal, x["e_goal"][r],
                x["gk"][r], act)
            (run_t, acc, energy, missed, p, observed, profiled,
             miss_flag) = deliver_step(i, j, scl, dvec, self.phi_true,
                                       **self._consts)
            new = fused_fleet_step(
                mu_l, sd_l, g_l, q_l, observed,
                torch.where(act, profiled, 1.0), miss_flag, act,
                *self._slow_params, ph_l, v_l, self.phi_true * p,
                torch.where(act, p, 1.0), *self._idle_params)
            for name, v in zip(("mu", "sigma", "gain", "q", "phi", "var"),
                               new):
                st[name].index_copy_(0, sidv, v)
            if depth:
                for name, v in zip(("buf", "pos", "count"),
                                   _goal_record_step(buf_l, pos_l, cnt_l,
                                                     acc, act, depth)):
                    st[name].index_copy_(0, sidv, v)
        y["run_t"][r].copy_(run_t)
        y["acc"][r].copy_(acc)
        y["sojourn"][r].copy_((now - arrv) + run_t)
        y["i"][r].copy_(i)
        y["j"][r].copy_(j)
        y["missed"][r].copy_(missed)
        if ch.ring:
            y["ring"][:, r].copy_(torch.stack(round_aggregates(
                act, feas, relaxed, energy, missed)))

    def _chunk_body(self, ch: _Chunk) -> None:
        """``chunk`` rounds, unrolled: what one CUDA graph holds."""
        for r in range(self.chunk):
            self._round(ch, r)

    def _chunk_for(self, policy: str, static_config, ring: bool,
                   n_sessions: int) -> _Chunk:
        key = (policy, None if static_config is None
               else tuple(int(v) for v in static_config), ring, n_sessions)
        if key not in self._chunks:
            self._chunks[key] = _Chunk(self, policy, static_config, ring,
                                       n_sessions)
        return self._chunks[key]

    def _init_state(self, ch: _Chunk, sessions: Sequence[Session]) -> None:
        """Every session (and the pad row) at the filter priors, its window
        empty and its own goal: what the host loop's first-touch
        ``reset_lanes`` installs."""
        st = ch.state
        for name, prior in zip(("mu", "sigma", "gain", "q"),
                               self._slow_tpl._priors()):
            st[name].fill_(prior)
        for name, prior in zip(("phi", "var"), self._idle_tpl._priors()):
            st[name].fill_(prior)
        for name in ("buf", "pos", "count"):
            st[name].zero_()
        goal = np.zeros(len(sessions) + 1)
        goal[:-1] = [s.constraints.accuracy_goal or 0.0 for s in sessions]
        st["goal"].copy_(torch.from_numpy(goal))

    def _dispatch(self, ch: _Chunk, plan: _Plan, lo: int) -> dict:
        """One chunk: its schedule into the input buffers (one copy per
        dtype), the graph's replay (or the eager body), the outputs back
        (one copy per dtype).  Returns host numpy views of the outputs."""
        hi = lo + self.chunk
        f = ch.f64_in_host.numpy()
        cl = self.chunk * self.n_lanes
        for k, name in enumerate(_F64_IN):
            f[k * cl:(k + 1) * cl] = getattr(plan, name)[lo:hi].ravel()
        f[len(_F64_IN) * cl:] = plan.now[lo:hi]
        ints = ch.i64_in_host.numpy()
        ints[:cl], ints[cl:] = plan.sid[lo:hi].ravel(), \
            plan.gk[lo:hi].ravel()
        bools = ch.b_in_host.numpy()
        bools[:cl], bools[cl:] = plan.act[lo:hi].ravel(), \
            plan.dead[lo:hi].ravel()
        card = self.device.type == "cuda"
        if card:
            for dev, host in ((ch.f64_in, ch.f64_in_host),
                              (ch.i64_in, ch.i64_in_host),
                              (ch.b_in, ch.b_in_host)):
                dev.copy_(host, non_blocking=True)
        self._round_base = lo
        if ch.graph is not None:
            ch.graph.replay()
            select_kernel.alert_select.launches += ch.launches
        else:
            self._chunk_body(ch)
        if card:
            for dev, host in ((ch.f64_out, ch.f64_out_host),
                              (ch.i64_out, ch.i64_out_host),
                              (ch.b_out, ch.b_out_host)):
                host.copy_(dev, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        c, ln = self.chunk, self.n_lanes
        fo = ch.f64_out_host.numpy()
        io = ch.i64_out_host.numpy()
        out = {name: fo[k * cl:(k + 1) * cl].reshape(c, ln)
               for k, name in enumerate(_F64_OUT)}
        out["ring"] = fo[len(_F64_OUT) * cl:].reshape(5, c) \
            if ch.ring else None
        out["i"], out["j"] = io[:cl].reshape(c, ln), io[cl:].reshape(c, ln)
        out["missed"] = ch.b_out_host.numpy().reshape(c, ln)
        return out

    # -------------------------------------------------------------- #
    # public API                                                      #
    # -------------------------------------------------------------- #
    def run(self, sessions: Sequence[Session],
            requests: list[TrafficRequest] | None = None, *,
            policy: str = "alert",
            static_config: tuple[int, int] | None = None,
            faults=None) -> GatewayResult:
        """Serve one workload to completion: the
        :meth:`SessionGateway.run` contract, as the planner and the
        chunked round clock.  Raises when the tick is below the
        workload's largest relative deadline.  ``faults`` (a
        :class:`~repro_torch.traffic.faults.FaultSchedule`) replays the
        host gateway's fault protocol, bitwise."""
        if policy not in ("alert", "static"):
            raise ValueError(policy)
        if policy == "static" and static_config is None:
            raise ValueError("policy='static' needs static_config=(i, j)")
        if faults is not None and faults.n_lanes != self.n_lanes:
            raise ValueError(
                f"FaultSchedule covers {faults.n_lanes} lanes but the "
                f"gateway has {self.n_lanes}")
        ob = self._ob
        launches0 = select_kernel.alert_select.launches
        t0 = time.perf_counter()
        with ob.spans.span("plan", cat="megatick") if ob else nullcontext():
            sid_index = {s.sid: k for k, s in enumerate(sessions)}
            plan = self._plan(sessions, requests, sid_index, faults)
        self._plan_timer.observe(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = plan.out
        if plan.n_active:
            ch = self._chunk_for(policy, static_config, ob is not None,
                                 len(sessions))
            if policy == "alert":
                self._init_state(ch, sessions)
            for lo in range(0, plan.act.shape[0], self.chunk):
                hi = lo + self.chunk
                with ob.spans.span("scan_dispatch", cat="megatick",
                                   chunk_lo=lo) if ob else nullcontext():
                    ys = self._dispatch(ch, plan, lo)
                a = plan.act[lo:hi]
                rows = plan.row[lo:hi][a]
                out.latency[rows] = ys["run_t"][a]
                out.accuracy[rows] = ys["acc"][a]
                out.missed[rows] = ys["missed"][a]
                out.model_index[rows] = ys["i"][a]
                out.power_index[rows] = ys["j"][a]
                out.sojourn[rows] = ys["sojourn"][a]
                # Energy in numpy from the round's outputs, as the host
                # delivery computes it (the reference recomputes it on
                # the host too).
                rt = out.latency[rows]
                ii, jj = out.model_index[rows], out.power_index[rows]
                pw = self.table.run_power[ii, jj]
                dv = (plan.rel[lo:hi]
                      - (plan.now[lo:hi, None] - plan.arr[lo:hi]))[a]
                out.energy[rows] = pw * rt + self.phi_true * pw * \
                    np.maximum(dv - rt, 0.0)
                if ob is not None:
                    # The pad rounds of the last chunk are dropped; the
                    # ring's energy is the body's own sum.
                    n_real = min(self.chunk, plan.n_active - lo)
                    ring = ys["ring"]
                    ob.ring.push_rounds(
                        now_s=plan.now[lo:lo + n_real],
                        n_active=ring[0, :n_real],
                        n_feasible=ring[1, :n_real],
                        n_relaxed=ring[2, :n_real],
                        energy_j=ring[3, :n_real],
                        n_missed=ring[4, :n_real])
        self._scan_timer.observe(time.perf_counter() - t0)
        served = out.status == SERVED
        last_completion = float(np.max(out.start[served]
                                       + out.latency[served])) \
            if served.any() else 0.0
        out.horizon = max(last_completion,
                          float(out.arrival[-1]) if out.offered else 0.0)
        out.n_rounds = plan.n_active
        out.pages_in = getattr(self, "pages_in", 0)
        out.pages_out = getattr(self, "pages_out", 0)
        out.n_compiles = self.n_compiles()
        out.select_launches = select_kernel.alert_select.launches - launches0
        if ob:
            _obs_record_result(ob.metrics, out, gateway="megatick",
                               policy=policy)
        return out

    def n_compiles(self) -> tuple[int, int]:
        """``(0, chunk programs built)``, the reference's ``(estimate,
        scan)`` pair: one program a (policy, static config, ring, S) key,
        on the card a captured CUDA graph.  ``(0, 1)`` after a whole load
        sweep of one policy means every dispatch replayed one graph."""
        return (0, len(self._chunks))

    def chunk_graphs(self) -> list:
        """The captured CUDA graphs (empty when the chunks run eagerly)."""
        return [c.graph for c in self._chunks.values()
                if c.graph is not None]
