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

Selection goes through :func:`repro_torch.kernels.alert_select.alert_select`:
the CUDA kernel for an engine on the card (``backend="cuda"``), its plain
PyTorch version for an engine on the CPU (``backend="torch"``).  A CUDA
engine never runs the plain version and a CPU engine never runs the
kernel.  Scoring is float64 on the engine's device; torch's global
default dtype is never touched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.profiles import ProfileTable
from repro_torch.device import resolve_device

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
    """

    def __init__(self, table: ProfileTable, goal=None, *,
                 overhead: float = 0.0,
                 paper_faithful_energy: bool = True,
                 backend: str | None = None, device=None):
        from repro_torch.core.controller import Goal  # avoid import cycle
        from repro_torch.kernels import alert_select as kernel

        self.device = resolve_device(device)
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
        numpy array or tensor (``floor`` applied after the move)."""
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
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32).contiguous()
        return torch.from_numpy(np.array(x, np.int32)).to(self.device)

    @staticmethod
    def _n_lanes(deadline) -> int:
        shape = tuple(deadline.shape) if isinstance(deadline, torch.Tensor) \
            else np.shape(deadline)
        return shape[0] if shape else 1

    def estimate(self, mu, sigma, phi, deadline, *,
                 active=None) -> EstimateBatch:
        """Score every (stream, model, power) cell: ``[S, K, L]`` grids.

        ``deadline`` is the effective deadline (overhead already applied
        by the caller).  ``active`` (optional ``[S]`` bool) replaces dead
        lanes' inputs with benign constants before any arithmetic and
        zeroes their output rows.  The grids are the debugging view of
        the select path and come from the plain PyTorch ops on either
        device (the kernel never writes an ``[S, K, L]`` grid)."""
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
            elif isinstance(active, torch.Tensor):
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
        out = self._kernel.alert_select(
            self._vec(mu, s), self._vec(sigma, s, floor=1e-6),
            self._vec(phi, s), self._vec(deadline, s),
            self._vec(0.0 if accuracy_goal is None else accuracy_goal, s),
            self._vec(0.0 if energy_goal is None else energy_goal, s),
            self._lane_ints(gk), self._lane_ints(act),
            latency=self._latency, run_power=self._run_power,
            weights=self._weights, q_fail=self._q_fail,
            overhead=self.overhead,
            paper_faithful_energy=self.paper_faithful_energy,
            predictions=predictions)
        i, j, lat, acc, en, feas, relaxed = (o.cpu().numpy() for o in out)
        return DecisionBatch(model_index=i, power_index=j,
                             predicted_latency=lat, predicted_accuracy=acc,
                             predicted_energy=en, feasible=feas,
                             relaxed_code=relaxed)


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


class WindowedGoalBank:
    """Vectorised :class:`~repro_torch.core.controller.WindowedAccuracyGoal`
    on the device: per-stream ring buffers of the last N-1 delivered
    accuracies (paper fn.3) and the same compensation rule.  ``goal`` may
    be a scalar or an ``[S]`` vector; :meth:`set_goals` resets exactly the
    streams whose goal changed.  The ring buffer is updated in place."""

    def __init__(self, goal, n_streams: int, window: int = 10, device=None):
        self.device = resolve_device(device)
        self.goal = torch.as_tensor(
            np.broadcast_to(np.asarray(goal, np.float64), (n_streams,))
            .copy(), device=self.device)
        self.window = int(window)
        self._depth = max(self.window - 1, 0)
        self._buf = torch.zeros((n_streams, max(self._depth, 1)), dtype=F64,
                                device=self.device)
        self._count = torch.zeros(n_streams, dtype=torch.int64,
                                  device=self.device)
        self._pos = torch.zeros(n_streams, dtype=torch.int64,
                                device=self.device)

    def _goals(self, goals) -> torch.Tensor:
        return torch.as_tensor(goals, dtype=F64,
                               device=self.device).expand(self.goal.shape)

    def _clear(self, sel: torch.Tensor) -> None:
        self._buf = torch.where(sel[:, None], 0.0, self._buf)
        self._count = torch.where(sel, 0, self._count)
        self._pos = torch.where(sel, 0, self._pos)

    def set_goals(self, goals) -> None:
        """Install per-stream goals; lanes whose goal changed get a fresh
        window, other lanes keep their history."""
        new = self._goals(goals)
        changed = new != self.goal
        self._clear(changed)
        self.goal = torch.where(changed, new, self.goal)

    def reset_lanes(self, lanes, goal=None) -> None:
        """Recycle ``lanes`` for newly admitted streams: clear their window
        and (optionally) install a new per-lane goal."""
        idx = torch.as_tensor(np.asarray(lanes, np.int64), device=self.device)
        sel = torch.zeros(self.goal.shape[0], dtype=torch.bool,
                          device=self.device)
        sel[idx] = True
        if goal is not None:
            g = self.goal.clone()
            g[idx] = torch.as_tensor(goal, dtype=F64, device=self.device)
            self.goal = g
        self._clear(sel)

    def grow(self, n_streams: int) -> None:
        """Extend the bank to ``n_streams`` lanes with fresh windows and a
        zero goal (admission installs the real one)."""
        extra = int(n_streams) - self.goal.shape[0]
        if extra <= 0:
            return

        def pad(x, value):
            fill = torch.full((extra,) + tuple(x.shape[1:]), value,
                              dtype=x.dtype, device=self.device)
            return torch.cat([x, fill])

        self.goal = pad(self.goal, 0.0)
        self._buf = pad(self._buf, 0.0)
        self._count = pad(self._count, 0)
        self._pos = pad(self._pos, 0)

    def record(self, delivered, mask=None) -> None:
        """Push this tick's delivered accuracies (``[S]``) into the ring
        buffers; ``mask`` (``[S]`` bool) freezes masked-out lanes."""
        if self._depth == 0:
            return
        s = self._buf.shape[0]
        m = torch.ones(s, dtype=torch.bool, device=self.device) \
            if mask is None else torch.as_tensor(mask, dtype=torch.bool,
                                                 device=self.device)
        d = torch.as_tensor(delivered, dtype=F64, device=self.device)
        rows = torch.arange(s, device=self.device)
        self._buf[rows, self._pos] = torch.where(m, d,
                                                 self._buf[rows, self._pos])
        self._pos = torch.where(m, (self._pos + 1) % self._depth, self._pos)
        self._count = torch.where(
            m, torch.clamp_max(self._count + 1, self._depth), self._count)

    def current_goal(self) -> torch.Tensor:
        """Per-stream effective Q_goal after window compensation (paper
        fn.3); lanes with an empty window return their raw goal."""
        if self._depth == 0:
            return self.goal.clone()
        total = pairwise_sum_cols([self._buf[:, c]
                                   for c in range(self._buf.shape[1])])
        need = self.goal * self.window - total
        remaining = self.window - self._count
        per_input = need - (remaining - 1) * self.goal
        return torch.where(self._count == 0, self.goal, per_input)
