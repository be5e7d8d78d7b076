"""Kalman-filter estimators from the ALERT paper, Eqs. 6 and 8 (port of
``repro.core.kalman``).

* :class:`SlowdownFilter` tracks the global slow-down factor xi (observed /
  profiled latency) as N(mu, sigma^2), Eq. 6.
* :class:`IdlePowerFilter` tracks phi, the DNN-idle power ratio, Eq. 8.

The scalar filters are plain Python on the host control path of one
stream.  :class:`SlowdownFilterBank` and :class:`IdlePowerFilterBank` hold
the same state for S streams as ``[S]`` float64 tensors on the device and
apply the identical recurrences to every lane; :func:`observe_fleet` runs
both banks' masked updates as one tick's feedback step.  Lane-pool
operations (:meth:`reset_lanes`, :meth:`grow`, :meth:`shrink`) recycle,
add or drop lanes for churning fleets; :meth:`export_lanes` and
:meth:`import_lanes` page a session's state out to the host and back.
Bank updates replace the state tensors (no in-place writes), so a
caller's earlier reference to ``bank.mu`` is never mutated.  A bank built
with ``mesh=`` (a :class:`~repro_torch.launch.mesh.LaneMesh`) holds each
state vector as :class:`~repro_torch.launch.mesh.LaneShards`, one block a
shard on its device, and runs its recurrences once a shard; its capacity
stays a multiple of the mesh size.
:class:`ScalarKalman` is the straggler monitor's generic filter.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.launch.mesh import (LaneShards, lane_fill, lane_map,
                                     lane_place, mesh_device, put_lanes,
                                     take_lanes)

F64 = torch.float64


@dataclasses.dataclass
class SlowdownFilter:
    """ALERT Eq. 6: adaptive-noise Kalman filter for the slow-down factor
    (paper constants ``K0=0.5, R=0.001, Q0=0.1, alpha=0.3, mu0=1,
    sigma0=0.1``)."""

    mu: float = 1.0
    sigma: float = 0.1
    gain: float = 0.5
    meas_noise: float = 1e-3             # R
    process_noise_floor: float = 0.1     # Q^(0)
    process_noise: float = 0.1           # Q^(n)
    alpha: float = 0.3                   # forgetting factor
    miss_inflation: float = 0.2
    n_updates: int = 0

    def observe(self, observed_latency: float, profiled_latency: float,
                deadline_missed: bool = False) -> float:
        """Feed one (observed, profiled) latency pair; returns updated mu.
        A missed deadline inflates the ratio by ``miss_inflation``
        (Section 3.3)."""
        if profiled_latency <= 0.0:
            raise ValueError("profiled_latency must be positive")
        ratio = observed_latency / profiled_latency
        if deadline_missed:
            ratio *= (1.0 + self.miss_inflation)
        y = ratio - self.mu
        self.process_noise = max(
            self.process_noise_floor,
            self.alpha * self.process_noise
            + (1.0 - self.alpha) * (self.gain * y) ** 2,
        )
        prior_gain = self.gain
        denom = (1.0 - prior_gain) * self.sigma + self.process_noise \
            + self.meas_noise
        self.gain = ((1.0 - prior_gain) * self.sigma
                     + self.process_noise) / denom
        self.mu = self.mu + self.gain * y
        self.sigma = (1.0 - prior_gain) * self.sigma + self.process_noise
        self.n_updates += 1
        return self.mu

    @property
    def std(self) -> float:
        """Standard deviation of xi (sigma floored at 1e-6)."""
        return max(self.sigma, 1e-6)

    def predict_latency(self, profiled_latency: float) -> tuple[float, float]:
        """Predicted (mean, std) of the latency of a config profiled at
        ``profiled_latency``: ``t = xi * t_profiled`` (Idea 1)."""
        return self.mu * profiled_latency, self.std * profiled_latency


@dataclasses.dataclass
class IdlePowerFilter:
    """ALERT Eq. 8: Kalman filter for the DNN-idle power ratio phi
    (paper constants ``M0=0.01, S=1e-4, V=1e-3``)."""

    phi: float = 0.3
    variance: float = 0.01       # M^(0)
    process_noise: float = 1e-4  # S
    meas_noise: float = 1e-3     # V
    n_updates: int = 0

    def observe(self, idle_power: float, active_power: float) -> float:
        """Feed one (idle, active) power pair; returns the updated phi."""
        if active_power <= 0.0:
            raise ValueError("active_power must be positive")
        measured = idle_power / active_power
        gain = (self.variance + self.process_noise) / (
            self.variance + self.process_noise + self.meas_noise)
        self.variance = (1.0 - gain) * (self.variance + self.process_noise)
        self.phi = self.phi + gain * (measured - self.phi)
        self.n_updates += 1
        return self.phi


# --------------------------------------------------------------------- #
# [S]-lane recurrences                                                   #
# --------------------------------------------------------------------- #
def _slowdown_bank_step(mu, sigma, gain, q, obs, prof, miss, mask,
                        q0, alpha, r, miss_inflation):
    """Masked Eq. 6 over ``[S]`` lanes; same op order as the scalar filter."""
    ratio = obs / prof
    ratio = torch.where(miss, ratio * (1.0 + miss_inflation), ratio)
    y = ratio - mu
    gy = gain * y
    q_new = torch.clamp_min(alpha * q + (1.0 - alpha) * (gy * gy), q0)
    carried = (1.0 - gain) * sigma
    denom = carried + q_new + r
    gain_new = (carried + q_new) / denom
    mu_new = mu + gain_new * y
    sigma_new = carried + q_new
    return (torch.where(mask, mu_new, mu), torch.where(mask, sigma_new, sigma),
            torch.where(mask, gain_new, gain), torch.where(mask, q_new, q))


def _idle_bank_step(phi, var, idle, active, mask, s, v):
    """Masked Eq. 8 over ``[S]`` lanes."""
    measured = idle / active
    gain = (var + s) / (var + s + v)
    var_new = (1.0 - gain) * (var + s)
    phi_new = phi + gain * (measured - phi)
    return torch.where(mask, phi_new, phi), torch.where(mask, var_new, var)


def fused_fleet_step(mu, sigma, gain, q, obs, prof, miss, mask,
                     q0, alpha, r, miss_inflation,
                     phi, var, idle, active, s_noise, v_noise):
    """Both banks' masked recurrences (Eq. 6 and Eq. 8) on ``[S]``
    tensors, for a caller that runs the feedback inside its own round
    body (the megatick): per lane the same ops as :func:`observe_fleet`.
    Returns ``(mu, sigma, gain, q, phi, var)``."""
    slow = _slowdown_bank_step(mu, sigma, gain, q, obs, prof, miss, mask,
                               q0, alpha, r, miss_inflation)
    return slow + _idle_bank_step(phi, var, idle, active, mask, s_noise,
                                  v_noise)


class _LaneBank:
    """Shared lane-pool plumbing: ``_state_names`` lists the ``[S]``
    float64 state tensors, ``_priors()`` their reset values.  Each state
    vector is one tensor on ``device``, or under ``mesh`` a
    :class:`~repro_torch.launch.mesh.LaneShards`."""

    _state_names: tuple = ()
    mesh = None

    def _priors(self) -> tuple:
        raise NotImplementedError

    def _init_home(self, n_streams: int, mesh, device) -> None:
        """Install ``mesh`` and the fresh state: one tensor on the device,
        or one block a shard on its device under a mesh."""
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        if mesh is not None and n_streams % mesh.size:
            raise ValueError(
                f"bank capacity {n_streams} must be a multiple of the "
                f"lane-mesh size {mesh.size}")
        for name, prior in zip(self._state_names, self._priors()):
            setattr(self, name, lane_fill(mesh, self.device, (n_streams,),
                                          prior, F64))
        self.n_updates = lane_fill(mesh, self.device, (n_streams,), 0,
                                   torch.int64)

    @property
    def n_streams(self) -> int:
        """Lane capacity S (live + recyclable lanes)."""
        return getattr(self, self._state_names[0]).shape[0]

    def _vec(self, x, dtype=F64):
        """An ``[S]`` input as a lane value of this bank: on the device,
        or split into the mesh's blocks."""
        if self.mesh is None:
            return torch.as_tensor(x, dtype=dtype, device=self.device)
        if isinstance(x, LaneShards):
            return lane_map(lambda p: p.to(dtype), x)
        return self.mesh.split(x, dtype)

    def _mask(self, mask):
        if mask is None:
            return lane_fill(self.mesh, self.device, (self.n_streams,), True,
                             torch.bool)
        return self._vec(mask, torch.bool)

    def _masked_positive(self, values, mask, what: str):
        """Require strictly positive values on masked-in lanes (checked on
        the host for host input; device tensors are trusted, as a check
        would force a sync) and give masked-out lanes a harmless divisor."""
        if not isinstance(values, (torch.Tensor, LaneShards)):
            v = np.asarray(values, np.float64)
            if np.any(v[np.asarray(mask.cpu())] <= 0.0):
                raise ValueError(f"{what} must be positive")
        return lane_map(lambda m, x: torch.where(m, x, 1.0), mask,
                        self._vec(values))

    def export_lanes(self, lanes) -> dict:
        """Snapshot ``lanes``' full filter state as host numpy arrays, one
        ``[len(lanes)]`` entry per ``_state_names`` tensor plus
        ``n_updates`` (the reference's keys): the page-out half of session
        paging.  One gather on the device (on each shard that owns some of
        the lanes) and one copy back a tensor; :meth:`import_lanes`
        restores the snapshot bitwise."""
        return {name: take_lanes(getattr(self, name), lanes)
                for name in self._state_names + ("n_updates",)}

    def import_lanes(self, lanes, state: dict) -> None:
        """Restore an :meth:`export_lanes` snapshot into ``lanes``: the
        page-in half of session paging, a same-shape indexed write of
        each state tensor on the device (bitwise lossless).  A state
        resharded onto this bank's mesh
        (:func:`~repro_torch.runtime.elastic.reshard_state`) may be
        imported into every lane at once."""
        for name in self._state_names + ("n_updates",):
            setattr(self, name, put_lanes(getattr(self, name), lanes,
                                          state[name]))

    def reset_lanes(self, lanes) -> None:
        """Reinitialise ``lanes`` (host indices) to the filter priors:
        stream admission into a recycled lane, same ``[S]`` shape."""
        for name, prior in zip(self._state_names, self._priors()):
            setattr(self, name, put_lanes(getattr(self, name), lanes, prior))
        self.n_updates = put_lanes(self.n_updates, lanes, 0)

    def _resize(self, n_streams: int, what: str) -> None:
        """Capacity ``n_streams``: the state through the host, cut or
        extended with fresh priors, placed back (under a mesh in its new
        blocks, so ``n_streams`` must be a multiple of the mesh size)."""
        if self.mesh is not None and n_streams % self.mesh.size:
            raise ValueError(
                f"sharded bank capacity must {what} in multiples of the "
                f"mesh size {self.mesh.size}; got {n_streams}")
        keep = min(n_streams, self.n_streams)
        extra = n_streams - keep
        for name, prior in zip(self._state_names + ("n_updates",),
                               self._priors() + (0,)):
            cur = getattr(self, name)
            old = np.asarray(cur.cpu())
            host = np.concatenate([old[:keep],
                                   np.full(extra, prior, old.dtype)])
            setattr(self, name, lane_place(self.mesh, self.device, host,
                                           cur.dtype))

    def grow(self, n_streams: int) -> None:
        """Extend capacity to ``n_streams``; new lanes hold fresh priors.
        Under a mesh ``n_streams`` must be a multiple of its size."""
        if int(n_streams) > self.n_streams:
            self._resize(int(n_streams), "grow")

    def shrink(self, n_streams: int) -> None:
        """Truncate capacity to the first ``n_streams`` lanes (under a
        mesh a multiple of its size)."""
        if int(n_streams) < self.n_streams:
            self._resize(int(n_streams), "shrink")

    def _count(self, m) -> None:
        self.n_updates = lane_map(lambda n, k: n + k, self.n_updates, m)


class SlowdownFilterBank(_LaneBank):
    """Struct-of-arrays :class:`SlowdownFilter` over S lanes (Eq. 6)."""

    _state_names = ("mu", "sigma", "gain", "process_noise")

    def __init__(self, n_streams: int, *, mu0: float = 1.0,
                 sigma0: float = 0.1, gain0: float = 0.5,
                 meas_noise: float = 1e-3, process_noise_floor: float = 0.1,
                 alpha: float = 0.3, miss_inflation: float = 0.2,
                 device=None, mesh=None):
        self.mu0, self.sigma0, self.gain0 = mu0, sigma0, gain0
        self.meas_noise = meas_noise
        self.process_noise_floor = process_noise_floor
        self.alpha = alpha
        self.miss_inflation = miss_inflation
        self._init_home(n_streams, mesh, device)

    def _priors(self) -> tuple:
        return (self.mu0, self.sigma0, self.gain0, self.process_noise_floor)

    def step_params(self) -> tuple:
        """The scalar hyperparameters of this bank's Eq. 6 recurrence, in
        the order :func:`fused_fleet_step` takes them after the slow-down
        state and observations: ``(Q0, alpha, R, miss_inflation)``."""
        return (self.process_noise_floor, self.alpha, self.meas_noise,
                self.miss_inflation)

    def _step_args(self, observed_latency, profiled_latency,
                   deadline_missed, m):
        miss = lane_map(torch.zeros_like, m) if deadline_missed is None \
            else self._vec(deadline_missed, torch.bool)
        prof = self._masked_positive(profiled_latency, m, "profiled_latency")
        return (self.mu, self.sigma, self.gain, self.process_noise,
                self._vec(observed_latency), prof, miss, m,
                self.process_noise_floor, self.alpha, self.meas_noise,
                self.miss_inflation)

    def observe(self, observed_latency, profiled_latency,
                deadline_missed=None, mask=None) -> torch.Tensor:
        """Masked Eq. 6 update for all S lanes; masked-out lanes keep their
        state bit for bit.  Returns the updated ``mu``."""
        m = self._mask(mask)
        (self.mu, self.sigma, self.gain, self.process_noise) = \
            lane_map(_slowdown_bank_step, *self._step_args(
                observed_latency, profiled_latency, deadline_missed, m))
        self._count(m)
        return self.mu

    @property
    def std(self):
        """Per-lane xi standard deviation (sigma floored at 1e-6)."""
        return lane_map(lambda x: torch.clamp_min(x, 1e-6), self.sigma)


class IdlePowerFilterBank(_LaneBank):
    """Struct-of-arrays :class:`IdlePowerFilter` over S lanes (Eq. 8)."""

    _state_names = ("phi", "variance")

    def __init__(self, n_streams: int, *, phi0: float = 0.3,
                 variance0: float = 0.01, process_noise: float = 1e-4,
                 meas_noise: float = 1e-3, device=None, mesh=None):
        self.phi0, self.variance0 = phi0, variance0
        self.process_noise = process_noise
        self.meas_noise = meas_noise
        self._init_home(n_streams, mesh, device)

    def _priors(self) -> tuple:
        return (self.phi0, self.variance0)

    def step_params(self) -> tuple:
        """The scalar hyperparameters of this bank's Eq. 8 recurrence, in
        the order :func:`fused_fleet_step` takes them after the idle-power
        state and observations: ``(S, V)``."""
        return (self.process_noise, self.meas_noise)

    def _step_args(self, idle_power, active_power, m):
        active = self._masked_positive(active_power, m, "active_power")
        return (self.phi, self.variance, self._vec(idle_power), active, m,
                self.process_noise, self.meas_noise)

    def observe(self, idle_power, active_power, mask=None) -> torch.Tensor:
        """Masked Eq. 8 update for all S lanes; returns the updated phi."""
        m = self._mask(mask)
        self.phi, self.variance = lane_map(
            _idle_bank_step, *self._step_args(idle_power, active_power, m))
        self._count(m)
        return self.phi


def observe_fleet(slow: SlowdownFilterBank, idle: IdlePowerFilterBank,
                  observed_latency, profiled_latency, *,
                  deadline_missed=None, idle_power, active_power,
                  mask=None) -> None:
    """One tick's whole feedback step: the masked Eq. 6 and Eq. 8 updates
    of both banks (per lane identical to ``slow.observe`` then
    ``idle.observe``).  ``[S]`` inputs may be numpy arrays or tensors.
    Banks on a lane mesh run the step once a shard; both banks must be on
    the same mesh (or both on one device)."""
    if slow.mesh != idle.mesh:
        raise ValueError("observe_fleet needs both banks on the same mesh "
                         "(or both unsharded)")
    if slow.device != idle.device:
        raise ValueError("observe_fleet needs both banks on one device")
    m = slow._mask(mask)
    phi, var, idle_w, active, _, s_noise, v_noise = idle._step_args(
        idle_power, active_power, m)
    (slow.mu, slow.sigma, slow.gain, slow.process_noise, idle.phi,
     idle.variance) = lane_map(
        fused_fleet_step,
        *slow._step_args(observed_latency, profiled_latency,
                         deadline_missed, m),
        phi, var, idle_w, active, s_noise, v_noise)
    slow._count(m)
    idle._count(m)


@dataclasses.dataclass
class ScalarKalman:
    """Generic scalar Kalman filter (random-walk model), used by the
    straggler monitor of :mod:`repro_torch.runtime.straggler`: one filter
    per host tracking that host's step-time ratio, the paper's xi
    mechanism at pod scale."""

    mean: float = 1.0
    variance: float = 0.1
    process_noise: float = 1e-3
    meas_noise: float = 1e-2

    def observe(self, value: float) -> float:
        """One predict+update step on a scalar measurement; returns the
        posterior mean."""
        prior_var = self.variance + self.process_noise
        gain = prior_var / (prior_var + self.meas_noise)
        self.mean = self.mean + gain * (value - self.mean)
        self.variance = (1.0 - gain) * prior_var
        return self.mean

    @property
    def std(self) -> float:
        """Posterior standard deviation (variance floored at 1e-12)."""
        return math.sqrt(max(self.variance, 1e-12))
