"""Power/energy models for ALERT (port of ``repro.core.power``).

The actuator is modelled, not measured: a cubic DVFS model where dynamic
power grows with the cube of the clock fraction and compute throughput
scales linearly with it,

    p(f) = p_idle + (p_tdp - p_idle) * f^3        f in (0, 1]
    speed(p) = f = ((p - p_idle) / (p_tdp - p_idle)) ** (1/3)

The controller sees a discrete set of power buckets (paper Section 3.3).
Host-side Python, identical arithmetic to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Cubic-DVFS power model for one device (constants configurable)."""

    p_idle: float = 60.0     # W, device + host share at idle
    p_tdp: float = 200.0     # W, at full clock
    min_fraction: float = 0.3  # lowest supported clock fraction

    def speed_fraction(self, power_cap: float) -> float:
        """Fraction of peak compute throughput achievable under ``power_cap``."""
        if power_cap >= self.p_tdp:
            return 1.0
        usable = max(power_cap - self.p_idle, 0.0)
        f = (usable / (self.p_tdp - self.p_idle)) ** (1.0 / 3.0)
        return float(np.clip(f, self.min_fraction, 1.0))

    def power_at_fraction(self, f: float) -> float:
        """Operating-point draw (W) at clock fraction ``f``."""
        f = float(np.clip(f, self.min_fraction, 1.0))
        return self.p_idle + (self.p_tdp - self.p_idle) * f ** 3

    def buckets(self, n: int = 8) -> np.ndarray:
        """``n`` discrete power caps spanning the feasible range."""
        lo = self.power_at_fraction(self.min_fraction)
        return np.linspace(lo, self.p_tdp, n)


def predict_energy(power_cap: float, latency: float, idle_ratio: float,
                   period: float) -> float:
    """ALERT Eq. 9 for one input: ``p * t_run + phi * p * (T - t_run)``,
    with the idle slack clamped at zero."""
    slack = max(period - latency, 0.0)
    return power_cap * latency + idle_ratio * power_cap * slack


def batched_predict_energy(power_caps: np.ndarray, latencies: np.ndarray,
                           idle_ratio: float, period: float) -> np.ndarray:
    """Eq. 9 over a ``(n_models, n_powers)`` grid (numpy, broadcasting
    ``power_caps`` against ``latencies``)."""
    slack = np.maximum(period - latencies, 0.0)
    return power_caps * latencies + idle_ratio * power_caps * slack
