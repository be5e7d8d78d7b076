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
operations (:meth:`reset_lanes`, :meth:`grow`) recycle or add lanes for
churning fleets.  Bank updates replace the state tensors (no in-place
writes), so a caller's earlier reference to ``bank.mu`` is never mutated.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

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


class _LaneBank:
    """Shared lane-pool plumbing: ``_state_names`` lists the ``[S]``
    float64 state tensors, ``_priors()`` their reset values."""

    _state_names: tuple = ()

    def _priors(self) -> tuple:
        raise NotImplementedError

    @property
    def n_streams(self) -> int:
        """Lane capacity S (live + recyclable lanes)."""
        return getattr(self, self._state_names[0]).shape[0]

    def _vec(self, x, dtype=F64) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _mask(self, mask) -> torch.Tensor:
        if mask is None:
            return torch.ones(self.n_streams, dtype=torch.bool,
                              device=self.device)
        return self._vec(mask, torch.bool)

    def _masked_positive(self, values, mask: torch.Tensor, what: str):
        """Require strictly positive values on masked-in lanes (checked on
        the host for host input; device tensors are trusted, as a check
        would force a sync) and give masked-out lanes a harmless divisor."""
        if not isinstance(values, torch.Tensor):
            v = np.asarray(values, np.float64)
            if np.any(v[mask.cpu().numpy()] <= 0.0):
                raise ValueError(f"{what} must be positive")
        return torch.where(mask, self._vec(values), 1.0)

    def reset_lanes(self, lanes) -> None:
        """Reinitialise ``lanes`` (host indices) to the filter priors:
        stream admission into a recycled lane, same ``[S]`` shape."""
        idx = torch.as_tensor(np.asarray(lanes, np.int64), device=self.device)
        for name, prior in zip(self._state_names, self._priors()):
            state = getattr(self, name).clone()
            state[idx] = prior
            setattr(self, name, state)
        counts = self.n_updates.clone()
        counts[idx] = 0
        self.n_updates = counts

    def grow(self, n_streams: int) -> None:
        """Extend capacity to ``n_streams``; new lanes hold fresh priors."""
        extra = int(n_streams) - self.n_streams
        if extra <= 0:
            return
        for name, prior in zip(self._state_names, self._priors()):
            setattr(self, name, torch.cat(
                [getattr(self, name),
                 torch.full((extra,), prior, dtype=F64, device=self.device)]))
        self.n_updates = torch.cat(
            [self.n_updates,
             torch.zeros(extra, dtype=torch.int64, device=self.device)])


class SlowdownFilterBank(_LaneBank):
    """Struct-of-arrays :class:`SlowdownFilter` over S lanes (Eq. 6)."""

    _state_names = ("mu", "sigma", "gain", "process_noise")

    def __init__(self, n_streams: int, *, mu0: float = 1.0,
                 sigma0: float = 0.1, gain0: float = 0.5,
                 meas_noise: float = 1e-3, process_noise_floor: float = 0.1,
                 alpha: float = 0.3, miss_inflation: float = 0.2,
                 device=None):
        self.device = resolve_device(device)
        self.mu0, self.sigma0, self.gain0 = mu0, sigma0, gain0
        self.meas_noise = meas_noise
        self.process_noise_floor = process_noise_floor
        self.alpha = alpha
        self.miss_inflation = miss_inflation
        for name, prior in zip(self._state_names, self._priors()):
            setattr(self, name, torch.full((n_streams,), prior, dtype=F64,
                                           device=self.device))
        self.n_updates = torch.zeros(n_streams, dtype=torch.int64,
                                     device=self.device)

    def _priors(self) -> tuple:
        return (self.mu0, self.sigma0, self.gain0, self.process_noise_floor)

    def _step_args(self, observed_latency, profiled_latency,
                   deadline_missed, m):
        miss = torch.zeros_like(m) if deadline_missed is None \
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
            _slowdown_bank_step(*self._step_args(
                observed_latency, profiled_latency, deadline_missed, m))
        self.n_updates = self.n_updates + m
        return self.mu

    @property
    def std(self) -> torch.Tensor:
        """Per-lane xi standard deviation (sigma floored at 1e-6)."""
        return torch.clamp_min(self.sigma, 1e-6)


class IdlePowerFilterBank(_LaneBank):
    """Struct-of-arrays :class:`IdlePowerFilter` over S lanes (Eq. 8)."""

    _state_names = ("phi", "variance")

    def __init__(self, n_streams: int, *, phi0: float = 0.3,
                 variance0: float = 0.01, process_noise: float = 1e-4,
                 meas_noise: float = 1e-3, device=None):
        self.device = resolve_device(device)
        self.phi0, self.variance0 = phi0, variance0
        self.process_noise = process_noise
        self.meas_noise = meas_noise
        for name, prior in zip(self._state_names, self._priors()):
            setattr(self, name, torch.full((n_streams,), prior, dtype=F64,
                                           device=self.device))
        self.n_updates = torch.zeros(n_streams, dtype=torch.int64,
                                     device=self.device)

    def _priors(self) -> tuple:
        return (self.phi0, self.variance0)

    def _step_args(self, idle_power, active_power, m):
        active = self._masked_positive(active_power, m, "active_power")
        return (self.phi, self.variance, self._vec(idle_power), active, m,
                self.process_noise, self.meas_noise)

    def observe(self, idle_power, active_power, mask=None) -> torch.Tensor:
        """Masked Eq. 8 update for all S lanes; returns the updated phi."""
        m = self._mask(mask)
        self.phi, self.variance = _idle_bank_step(
            *self._step_args(idle_power, active_power, m))
        self.n_updates = self.n_updates + m
        return self.phi


def observe_fleet(slow: SlowdownFilterBank, idle: IdlePowerFilterBank,
                  observed_latency, profiled_latency, *,
                  deadline_missed=None, idle_power, active_power,
                  mask=None) -> None:
    """One tick's whole feedback step: the masked Eq. 6 and Eq. 8 updates
    of both banks (per lane identical to ``slow.observe`` then
    ``idle.observe``).  ``[S]`` inputs may be numpy arrays or tensors."""
    if slow.device != idle.device:
        raise ValueError("observe_fleet needs both banks on one device")
    m = slow._mask(mask)
    (slow.mu, slow.sigma, slow.gain, slow.process_noise) = \
        _slowdown_bank_step(*slow._step_args(
            observed_latency, profiled_latency, deadline_missed, m))
    idle.phi, idle.variance = _idle_bank_step(
        *idle._step_args(idle_power, active_power, m))
    slow.n_updates = slow.n_updates + m
    idle.n_updates = idle.n_updates + m
