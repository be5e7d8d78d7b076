"""Fleet-scale batched scoring engine for the ALERT decision loop (port of
``repro.core.batched``).

The paper's per-input hot path (Section 3.2: estimation Eq. 7/9/10 and
selection Eq. 4/5 with the Section 3.3 relaxation) runs for S streams x K
models x L power buckets in one call:

* Filter state arrives as ``[S]`` float64 vectors (``mu``, ``sigma``,
  ``phi``), from the filter banks of :mod:`repro_torch.core.kalman` or
  from one stream's scalar filters.
* The anytime staircases fold into a ``[K, K]`` weight matrix at build
  time (:meth:`BatchedAlertEngine._staircase_weight_matrix`), so Eq. 7 and
  Eq. 10 are one erf per (stream, candidate, bucket) plus a small
  contraction.
* Fleets may mix Eq. 4 and Eq. 5 lanes (``goal_kind``) and carry dead
  lanes (``active``); dead lanes may hold garbage and come back with a
  null decision.
* ``mesh=`` (a :class:`~repro_torch.launch.mesh.LaneMesh`) shards the
  lane axis: the kernel is launched once a shard on that shard's
  contiguous block (through :func:`~repro_torch.launch.mesh.
  lane_shard_map`), and the results are bitwise the unsharded engine's.

Selection goes through
:func:`repro_torch.kernels.alert_select.alert_select_packed`: the CUDA
kernel for an engine on the card (``backend="cuda"``), its plain PyTorch
version for an engine on the CPU (``backend="torch"``).  A call moves the
host's lane inputs to the device in one copy per dtype and its results
back in one copy per dtype.  A CUDA
engine never runs the plain version and a CPU engine never runs the
kernel.  Scoring is float64 on the engine's device; torch's global
default dtype is never touched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.profiles import ProfileTable
from repro_torch.launch.mesh import (LaneShards, lane_fill, lane_map,
                                     lane_place, lane_shard_map,
                                     mesh_device, put_lanes, take_lanes)

F64 = torch.float64

# Relaxation codes (Section 3.3), returned per stream by select().
RELAXED_NONE = 0        # a cell satisfied every constraint
RELAXED_ACCURACY = 1    # min-energy task: accuracy goal unreachable
RELAXED_POWER = 2       # max-accuracy task: energy budget unreachable
RELAXED_NAMES = {RELAXED_NONE: "", RELAXED_ACCURACY: "accuracy",
                 RELAXED_POWER: "power"}

# Per-stream goal codes for heterogeneous fleets (``goal_kind`` lanes).
GOAL_MIN_ENERGY = 0     # Eq. 4: argmin energy s.t. accuracy
GOAL_MAX_ACCURACY = 1   # Eq. 5: argmax accuracy s.t. energy


def goal_codes(goals) -> np.ndarray:
    """Encode :class:`~repro_torch.core.controller.Goal` values (or raw
    int codes) as an int64 ``goal_kind`` vector for :meth:`select`."""
    from repro_torch.core.controller import Goal  # avoid import cycle

    arr = np.asarray(goals)
    if arr.dtype != object:
        return np.atleast_1d(arr).astype(np.int64)
    return np.asarray([
        (GOAL_MIN_ENERGY if g is Goal.MINIMIZE_ENERGY else GOAL_MAX_ACCURACY)
        if isinstance(g, Goal) else int(g)
        for g in np.atleast_1d(arr)], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class EstimateBatch:
    """Per-cell predictions for S streams: all arrays are ``[S, K, L]``."""

    lat_mean: np.ndarray
    lat_std: np.ndarray
    accuracy: np.ndarray
    energy: np.ndarray
    p_finish: np.ndarray


@dataclasses.dataclass(frozen=True)
class DecisionBatch:
    """One selection round for S streams: all arrays are ``[S]``."""

    model_index: np.ndarray        # int
    power_index: np.ndarray        # int
    predicted_latency: np.ndarray
    predicted_accuracy: np.ndarray
    predicted_energy: np.ndarray
    feasible: np.ndarray           # bool
    relaxed_code: np.ndarray       # int, see RELAXED_*

    def relaxed_name(self, s: int) -> str:
        """Stream s's relaxed constraint (``""``/``"accuracy"``/``"power"``)."""
        return RELAXED_NAMES[int(self.relaxed_code[s])]


class BatchedAlertEngine:
    """Stateless batched estimation + selection over a ProfileTable.

    ``goal`` picks Eq. 4 vs Eq. 5 for lanes that do not pass ``goal_kind``
    (``None``: every call must pass codes); ``overhead`` is subtracted from
    each deadline inside :meth:`select`; ``paper_faithful_energy`` selects
    Eq. 9 verbatim or the E[min(t, T)] estimator.  ``device`` (default
    ``"cuda"``) holds the profile constants; ``backend`` defaults to the
    one that device runs (``"cuda"``: the kernel, ``"torch"``: the plain
    version) and raises if it names the other.

    ``mesh`` (a 1-D :class:`~repro_torch.launch.mesh.LaneMesh`) turns on
    lane sharding: :meth:`select` and :meth:`select_step_impl` launch the
    kernel once a shard on its ``[S / size]`` block, each shard's device
    holding its own copy of the tables, and join the results in lane
    order on the mesh's home device (the engine's ``device``).  S must be
    a multiple of the mesh size (fleet callers pad with dead lanes).  The
    grid has no cross-lane op, so the decisions are bitwise the unsharded
    engine's.
    """

    def __init__(self, table: ProfileTable, goal=None, *,
                 overhead: float = 0.0,
                 paper_faithful_energy: bool = True,
                 backend: str | None = None, device=None, mesh=None):
        from repro_torch.core.controller import Goal  # avoid import cycle
        from repro_torch.kernels import alert_select as kernel

        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        if mesh is not None and \
                {d.type for d in mesh.devices} != {self.device.type}:
            raise ValueError(f"a lane mesh's shards must all be CUDA or all "
                             f"CPU devices: {mesh}")
        native = "cuda" if self.device.type == "cuda" else "torch"
        self.backend = native if backend is None else str(backend)
        if self.backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}: expected "
                             f"'cuda' or 'torch'")
        if self.backend != native:
            raise ValueError(f"backend {self.backend!r} does not run on "
                             f"{self.device}: 'cuda' is the kernel on the "
                             f"card, 'torch' the plain version on the CPU")
        self._kernel = kernel
        self.table = table
        self.goal = goal
        self.overhead = float(overhead)
        self.paper_faithful_energy = bool(paper_faithful_energy)
        self._minimize_energy = goal is Goal.MINIMIZE_ENERGY
        self._k, self._l = table.latency.shape

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                                   device=self.device)

        self._latency = dev(table.latency)
        self._run_power = dev(table.run_power)
        self._weights = dev(self._staircase_weight_matrix(table))
        self._q_fail = float(table.q_fail)
        # Under a mesh, the tables on each shard's device.
        home = (self._latency, self._run_power, self._weights)
        self._tables = {}
        for dev in (mesh.devices if mesh is not None else ()):
            if dev not in self._tables:
                self._tables[dev] = home if dev == self.device else \
                    tuple(t.to(dev) for t in home)
        if self.backend == "cuda":   # once here, not on every select
            for tables in (home, *self._tables.values()):
                kernel.check_tables(*tables)

    @staticmethod
    def _staircase_weight_matrix(table: ProfileTable) -> np.ndarray:
        """Fold Eq. 7 + Eq. 10 into one ``[K, K]`` weight matrix ``P``:
        ``q_hat[s, k, l] = q_fail + sum_u P[k, u] * F[s, u, l]`` with
        ``P[k, r_m] = q_m - q_{m-1}`` along k's level prefix
        (``q_0 = q_fail``); a traditional model gets ``P[k, k] = q_k -
        q_fail``, Eq. 7 verbatim."""
        k = len(table.candidates)
        weights = np.zeros((k, k), dtype=np.float64)
        for i, r in table.staircase_rows().items():
            prev = float(table.q_fail)
            for u in r:
                q_u = float(table.candidates[u].accuracy)
                weights[i, u] += q_u - prev
                prev = q_u
        return weights

    # ------------------------------------------------------------------ #
    def _vec(self, x, s: int, floor: float | None = None) -> torch.Tensor:
        """``[S]`` float64 vector on the engine's device from a scalar,
        numpy array or tensor (``floor`` applied after the move); a
        :class:`LaneShards` on the engine's mesh stays sharded (on
        another mesh it is gathered)."""
        if isinstance(x, LaneShards):
            if x.mesh != self.mesh:
                return self._vec(x.full(self.device), s, floor)
            return lane_map(lambda p: p.to(F64) if floor is None
                            else torch.clamp_min(p.to(F64), floor), x)
        if isinstance(x, torch.Tensor):
            v = x.to(device=self.device, dtype=F64)
        else:
            v = torch.from_numpy(np.array(x, np.float64)).to(self.device)
        if v.ndim == 0:
            v = v.expand(s)
        v = v if floor is None else torch.clamp_min(v, floor)
        return v.contiguous()

    def _lane_ints(self, x) -> torch.Tensor:
        """``[S]`` int32 vector (goal codes, lane mask) on the device."""
        if isinstance(x, LaneShards):
            if x.mesh != self.mesh:
                return self._lane_ints(x.full(self.device))
            return lane_map(lambda p: p.to(torch.int32), x)
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32).contiguous()
        return torch.from_numpy(np.array(x, np.int32)).to(self.device)

    def _lane_vectors(self, s: int, floats, ints):
        """The kernel's eight ``[S]`` lane vectors on the device: float64
        ``mu, sigma (floored at 1e-6), phi, deadline, accuracy_goal,
        energy_goal`` from ``floats`` and int32 ``goal_kind, active`` from
        ``ints``.  Tensors move on their own (one already on the device is
        not copied through the host); the host values of each dtype go
        over in one copy."""
        floors = (None, 1e-6, None, None, None, None)
        out = [None] * 8
        host = [n for n, x in enumerate(floats)
                if not isinstance(x, (torch.Tensor, LaneShards))]
        if host:
            buf = np.empty((len(host), s), np.float64)
            for row, n in enumerate(host):
                buf[row] = floats[n]
                if floors[n] is not None:
                    np.maximum(buf[row], floors[n], out=buf[row])
            moved = torch.from_numpy(buf).to(self.device)
            for row, n in enumerate(host):
                out[n] = moved[row]
        for n, x in enumerate(floats):
            if out[n] is None:
                out[n] = self._vec(x, s, floor=floors[n])
        if any(isinstance(x, (torch.Tensor, LaneShards)) for x in ints):
            out[6:] = [self._lane_ints(x) for x in ints]
        else:
            buf = np.empty((2, s), np.int32)
            buf[0], buf[1] = ints
            moved = torch.from_numpy(buf).to(self.device)
            out[6:] = moved[0], moved[1]
        return out

    def _n_lanes(self, deadline) -> int:
        """S from ``deadline``; under a mesh it must divide the mesh size
        (fleet callers pad with dead lanes)."""
        shape = tuple(deadline.shape) \
            if isinstance(deadline, (torch.Tensor, LaneShards)) \
            else np.shape(deadline)
        s = shape[0] if shape else 1
        if self.mesh is not None:
            self.mesh.blocks(s)
        return s

    def _packed(self, *lanes, predictions: bool):
        """:func:`~repro_torch.kernels.alert_select.alert_select_packed`
        over the eight ``[S]`` lane vectors: one launch, or under a mesh
        one a shard on its block, the two buffers joined in lane order on
        the home device."""
        kernel = self._kernel

        def launch(*blocks):
            lat, rp, w = (self._latency, self._run_power, self._weights) \
                if self.mesh is None else self._tables[blocks[0].device]
            return kernel.alert_select_packed(
                *blocks, latency=lat, run_power=rp, weights=w,
                q_fail=self._q_fail, overhead=self.overhead,
                paper_faithful_energy=self.paper_faithful_energy,
                predictions=predictions)

        if self.mesh is None:
            return launch(*lanes)
        return lane_shard_map(launch, self.mesh, n_in=8, n_out=2,
                              out_axis=1)(*lanes)

    def estimate(self, mu, sigma, phi, deadline, *,
                 active=None) -> EstimateBatch:
        """Score every (stream, model, power) cell: ``[S, K, L]`` grids.

        ``deadline`` is the effective deadline (overhead already applied
        by the caller).  ``active`` (optional ``[S]`` bool) replaces dead
        lanes' inputs with benign constants before any arithmetic and
        zeroes their output rows.  The grids are the debugging view of
        the select path and come from the plain PyTorch ops on either
        device (the kernel never writes an ``[S, K, L]`` grid), on the
        engine's (home) device under a mesh."""
        mu, sigma, phi, deadline, active = (
            x.full() if isinstance(x, LaneShards) else x
            for x in (mu, sigma, phi, deadline, active))
        s = self._n_lanes(deadline)
        mu, sd = self._vec(mu, s), self._vec(sigma, s, floor=1e-6)
        phi, t = self._vec(phi, s), self._vec(deadline, s)
        if active is not None:
            act = self._lane_ints(np.broadcast_to(active, (s,))
                                  if not isinstance(active, torch.Tensor)
                                  else active) != 0
            mu = torch.where(act, mu, 1.0)
            sd = torch.where(act, sd, 0.1)
            phi = torch.where(act, phi, 0.25)
            t = torch.where(act, t, 1.0)
        out = self._kernel.estimate_grid(
            mu, sd, phi, t, latency=self._latency,
            run_power=self._run_power, weights=self._weights,
            q_fail=self._q_fail,
            paper_faithful_energy=self.paper_faithful_energy)
        if active is not None:
            a3 = act[:, None, None]
            out = tuple(torch.where(a3, x, 0.0) for x in out)
        return EstimateBatch(*(o.cpu().numpy() for o in out))

    def _resolve_goal_kind(self, goal_kind, s: int):
        """``[S]`` goal codes (int64 numpy, or a device tensor passed
        through) from ints, Goals, or the engine default."""
        if goal_kind is not None:
            if isinstance(goal_kind, torch.Tensor):
                return goal_kind
            return np.broadcast_to(goal_codes(goal_kind), (s,))
        if self.goal is None:
            raise ValueError("engine has no default goal: pass goal_kind")
        code = GOAL_MIN_ENERGY if self._minimize_energy \
            else GOAL_MAX_ACCURACY
        return np.full(s, code, dtype=np.int64)

    def select(self, mu, sigma, phi, deadline, *,
               accuracy_goal=None, energy_goal=None,
               goal_kind=None, active=None,
               predictions: bool = True) -> DecisionBatch:
        """One decision per stream.

        ``mu``/``sigma``/``phi`` are ``[S]`` filter-state vectors (scalars
        broadcast); ``deadline`` is the raw per-stream T_goal (the engine
        subtracts ``overhead``).  Homogeneous fleets (no ``goal_kind`` /
        ``active``, engine built with a ``goal``) need ``accuracy_goal``
        (Eq. 4) or ``energy_goal`` (Eq. 5).  Heterogeneous or churning
        fleets pass ``goal_kind`` codes and/or an ``active`` mask; every
        active Eq. 4 lane needs an ``accuracy_goal`` entry and every active
        Eq. 5 lane an ``energy_goal`` entry (checked for host inputs).  Dead
        lanes come back with indices 0, zero predictions,
        ``feasible=False`` and ``RELAXED_NONE``.  ``predictions=False``
        skips the prediction gathers (those fields come back zero).
        Results come back as host numpy arrays.
        """
        s = self._n_lanes(deadline)
        if goal_kind is None and active is None and self.goal is not None:
            goal_val = accuracy_goal if self._minimize_energy \
                else energy_goal
            if goal_val is None:
                need = "accuracy_goal" if self._minimize_energy else \
                    "energy_goal"
                raise ValueError(f"{self.goal} task needs {need}")
            zero = 0.0
            accuracy_goal = goal_val if self._minimize_energy else zero
            energy_goal = zero if self._minimize_energy else goal_val
            gk = self._resolve_goal_kind(None, s)
            act = np.ones(s, bool)
        else:
            gk = self._resolve_goal_kind(goal_kind, s)
            if active is None:
                act = np.ones(s, bool)
            elif isinstance(active, (torch.Tensor, LaneShards)):
                act = active
            else:
                act = np.broadcast_to(np.asarray(active, bool), (s,))
            on_host = isinstance(act, np.ndarray) and \
                isinstance(gk, np.ndarray)
            if on_host and accuracy_goal is None and \
                    np.any(act & (gk == GOAL_MIN_ENERGY)):
                raise ValueError("active minimize-energy lanes need "
                                 "accuracy_goal")
            if on_host and energy_goal is None and \
                    np.any(act & (gk == GOAL_MAX_ACCURACY)):
                raise ValueError("active maximize-accuracy lanes need "
                                 "energy_goal")
        lanes = self._lane_vectors(
            s, (mu, sigma, phi, deadline,
                0.0 if accuracy_goal is None else accuracy_goal,
                0.0 if energy_goal is None else energy_goal), (gk, act))
        ints, f64 = self._packed(*lanes, predictions=predictions)
        ints, f64 = ints.cpu().numpy(), f64.cpu().numpy()
        return DecisionBatch(model_index=ints[0], power_index=ints[1],
                             predicted_latency=f64[0],
                             predicted_accuracy=f64[1],
                             predicted_energy=f64[2], feasible=ints[2] != 0,
                             relaxed_code=ints[3])

    def select_step_impl(self):
        """The pick-only heterogeneous select over ``[S]`` device tensors,
        for a caller's own round body (the megatick): ``(mu, sigma, phi,
        deadline, accuracy_goal, energy_goal, goal_kind, active) -> (i, j,
        lat, acc, energy, feasible, relaxed)`` with :meth:`select`'s
        semantics at ``predictions=False``, sigma floored at 1e-6 as
        :meth:`select` floors it.  Float inputs are float64 tensors on the
        engine's device, ``goal_kind`` and ``active`` integer or bool
        tensors there; the outputs stay on the device (views of the
        kernel's two buffers: nothing is copied to the host and nothing
        syncs, so the call can be captured in a CUDA graph).  Under a
        mesh the kernel runs once a shard and the two buffers are joined
        on the home device."""
        kernel = self._kernel

        def step(mu, sd, phi, deadline, acc_goal, en_goal, gk, act):
            """One pick-only select on device tensors."""
            ints, f64 = self._packed(
                mu, torch.clamp_min(sd, 1e-6), phi, deadline, acc_goal,
                en_goal, gk.to(torch.int32), act.to(torch.int32),
                predictions=False)
            return kernel.unpack(ints, f64)

        return step


# --------------------------------------------------------------------- #
# Windowed accuracy goals                                                #
# --------------------------------------------------------------------- #
def pairwise_sum_cols(cols):
    """Sum equal-shaped tensors in numpy's pairwise-summation order.

    ``np.sum(buf, axis=1)`` accumulates 8-wide blocks combined as
    ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``, with a plain fold below 8
    terms and recursive halving above 128 (halving point rounded down to a
    multiple of 8).  Building the same tree column by column makes the
    bank's window sum bitwise equal to the scalar reference's."""
    n = len(cols)
    if n == 0:
        raise ValueError("pairwise_sum_cols needs at least one column")
    if n < 8:
        res = cols[0]
        for c in cols[1:]:
            res = res + c
        return res
    if n <= 128:
        r = list(cols[:8])
        i = 8
        while i + 8 <= n:
            for j in range(8):
                r[j] = r[j] + cols[i + j]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + \
            ((r[4] + r[5]) + (r[6] + r[7]))
        while i < n:
            res = res + cols[i]
            i += 1
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum_cols(cols[:n2]) + pairwise_sum_cols(cols[n2:])


def _goal_record_step(buf, pos, count, delivered, m, depth):
    """Masked ring-buffer push on ``[S]`` tensors (``buf`` ``[S, depth]``,
    written in place): masked-in lanes store ``delivered`` at ``pos`` and
    advance.  Returns ``(buf, pos, count)``; :meth:`WindowedGoalBank.
    record` and the megatick's round body run it."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, pos] = torch.where(m, delivered, buf[rows, pos])
    pos = torch.where(m, (pos + 1) % depth, pos)
    count = torch.where(m, torch.clamp_max(count + 1, depth), count)
    return buf, pos, count


def goal_current_step_hostsum(goal, buf, count, window):
    """The compensation rule (paper fn.3) on tensors, the window summed in
    numpy's pairwise order (:func:`pairwise_sum_cols`): per-stream
    effective Q_goal, the raw goal where the window is empty.  Bitwise the
    reference's function of the same name (whose runtime zero only guards
    XLA's multiply-add contraction, which PyTorch's separate ops never
    do); :meth:`WindowedGoalBank.current_goal` and the megatick run it."""
    total = pairwise_sum_cols([buf[:, c] for c in range(buf.shape[1])])
    need = goal * window - total
    remaining = window - count
    per_input = need - (remaining - 1) * goal
    return torch.where(count == 0, goal, per_input)


class WindowedGoalBank:
    """Vectorised :class:`~repro_torch.core.controller.WindowedAccuracyGoal`
    on the device: per-stream ring buffers of the last N-1 delivered
    accuracies (paper fn.3) and the same compensation rule.  ``goal`` may
    be a scalar or an ``[S]`` vector; :meth:`set_goals` resets exactly the
    streams whose goal changed.  The ring buffer is updated in place.

    ``mesh=`` (a :class:`~repro_torch.launch.mesh.LaneMesh`) keeps the
    window state (``goal [S]``, ``buf [S, N-1]``, ``count``/``pos [S]``)
    as one block a shard, :meth:`record` and :meth:`current_goal` running
    once a shard; the capacity stays a multiple of the mesh size.  The
    window sum runs along a lane's own row in the same pairwise order, so
    a sharded bank's goals are bitwise the unsharded bank's."""

    _lane_state = (("goal", "goal"), ("buf", "_buf"), ("count", "_count"),
                   ("pos", "_pos"))

    def __init__(self, goal, n_streams: int, window: int = 10, device=None,
                 mesh=None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        if mesh is not None and n_streams % mesh.size:
            raise ValueError(
                f"goal-bank capacity {n_streams} must be a multiple of the "
                f"lane-mesh size {mesh.size}")
        self.window = int(window)
        self._depth = max(self.window - 1, 0)
        self.goal = lane_place(mesh, self.device, np.broadcast_to(
            np.asarray(goal, np.float64), (n_streams,)), F64)
        self._buf = lane_fill(mesh, self.device,
                              (n_streams, max(self._depth, 1)), 0.0, F64)
        self._count = lane_fill(mesh, self.device, (n_streams,), 0,
                                torch.int64)
        self._pos = lane_fill(mesh, self.device, (n_streams,), 0,
                              torch.int64)

    def _lanes(self, x, dtype):
        """An ``[S]`` host input as a lane value of this bank."""
        if self.mesh is None:
            return torch.as_tensor(x, dtype=dtype, device=self.device)
        return self.mesh.split(x, dtype)

    def _goals(self, goals):
        if self.mesh is None:
            return torch.as_tensor(goals, dtype=F64,
                                   device=self.device).expand(
                                       self.goal.shape)
        return self._lanes(np.broadcast_to(np.asarray(goals, np.float64),
                                           self.goal.shape), F64)

    def _clear(self, sel) -> None:
        self._buf, self._count, self._pos = lane_map(
            lambda m, b, c, p: (torch.where(m[:, None], 0.0, b),
                                torch.where(m, 0, c), torch.where(m, 0, p)),
            sel, self._buf, self._count, self._pos)

    def set_goals(self, goals) -> None:
        """Install per-stream goals; lanes whose goal changed get a fresh
        window, other lanes keep their history."""
        new = self._goals(goals)
        changed = lane_map(lambda a, b: a != b, new, self.goal)
        self._clear(changed)
        self.goal = lane_map(lambda c, a, b: torch.where(c, a, b), changed,
                             new, self.goal)

    def reset_lanes(self, lanes, goal=None) -> None:
        """Recycle ``lanes`` for newly admitted streams: clear their window
        and (optionally) install a new per-lane goal."""
        sel = np.zeros(self.goal.shape[0], bool)
        sel[np.asarray(lanes, np.int64)] = True
        if goal is not None:
            self.goal = put_lanes(self.goal, lanes,
                                  np.asarray(goal, np.float64))
        self._clear(self._lanes(sel, torch.bool))

    def export_lanes(self, lanes) -> dict:
        """Snapshot ``lanes``' window state as host numpy arrays (keys
        ``goal``, ``buf``, ``count``, ``pos``, as the reference's): the
        page-out half of session paging, bitwise round-trippable through
        :meth:`import_lanes`."""
        return {key: take_lanes(getattr(self, attr), lanes)
                for key, attr in self._lane_state}

    def import_lanes(self, lanes, state: dict) -> None:
        """Restore an :meth:`export_lanes` snapshot into ``lanes`` (the
        page-in half of session paging): same-shape indexed writes on the
        device, bitwise lossless."""
        for key, attr in self._lane_state:
            setattr(self, attr, put_lanes(getattr(self, attr), lanes,
                                          state[key]))

    def grow(self, n_streams: int, goal_fill: float = 0.0) -> None:
        """Extend the bank to ``n_streams`` lanes with fresh windows and
        goal ``goal_fill`` (admission installs the real one); under a mesh
        ``n_streams`` must be a multiple of its size."""
        extra = int(n_streams) - self.goal.shape[0]
        if extra <= 0:
            return
        if self.mesh is not None and int(n_streams) % self.mesh.size:
            raise ValueError(
                f"sharded goal-bank capacity must grow in multiples of the "
                f"mesh size {self.mesh.size}; got {n_streams}")
        def pad(x, value):
            """``x`` through the host, extended, placed back (under a mesh
            in its new blocks)."""
            host = np.asarray(x.cpu())
            fill = np.full((extra,) + host.shape[1:], value, host.dtype)
            return lane_place(self.mesh, self.device,
                              np.concatenate([host, fill]), x.dtype)

        self.goal = pad(self.goal, float(goal_fill))
        self._buf = pad(self._buf, 0.0)
        self._count = pad(self._count, 0)
        self._pos = pad(self._pos, 0)

    def record(self, delivered, mask=None) -> None:
        """Push this tick's delivered accuracies (``[S]``) into the ring
        buffers; ``mask`` (``[S]`` bool) freezes masked-out lanes."""
        if self._depth == 0:
            return
        s = self._buf.shape[0]
        m = lane_fill(self.mesh, self.device, (s,), True, torch.bool) \
            if mask is None else self._lanes(mask, torch.bool)
        d = self._lanes(delivered, F64)
        self._buf, self._pos, self._count = lane_map(
            _goal_record_step, self._buf, self._pos, self._count, d, m,
            self._depth)

    def current_goal(self):
        """Per-stream effective Q_goal after window compensation (paper
        fn.3); lanes with an empty window return their raw goal.  Under a
        mesh a :class:`~repro_torch.launch.mesh.LaneShards` that feeds the
        sharded engine as it is."""
        if self._depth == 0:
            return lane_map(torch.clone, self.goal)
        return lane_map(goal_current_step_hostsum, self.goal, self._buf,
                        self._count, self.window)
