"""Straggler detection with the paper's global-slow-down mechanism (port
of ``repro.runtime.straggler``).

Each host's per-step wall time divided by the fleet median is that host's
xi; a per-host :class:`~repro_torch.core.kalman.ScalarKalman` smooths it,
and mu above ``max(1 + alarm_sigma * std, min_ratio)`` flags the host.
Mitigations returned as recommendations: ``"reshard"`` (persistent fault:
drop the host and re-mesh) or ``"tolerate"`` (transient contention, which
ALERT's conservative picks absorb).
"""

from __future__ import annotations

import dataclasses
import statistics

from repro_torch.core.kalman import ScalarKalman


@dataclasses.dataclass
class StragglerMonitor:
    """Per-host straggler detector on median-normalised step times: one
    ScalarKalman per host tracks its wall-time ratio to the fleet
    median; mu above ``max(1 + alarm_sigma * std, min_ratio)`` flags
    the host, and ``persistent_after`` consecutive flags escalate
    :meth:`recommendation` from "tolerate" to "reshard"."""

    n_hosts: int
    alarm_sigma: float = 3.0
    min_ratio: float = 1.3
    persistent_after: int = 5

    def __post_init__(self):
        self.filters = [ScalarKalman() for _ in range(self.n_hosts)]
        self.alarm_counts = [0] * self.n_hosts

    def observe(self, step_times: list[float]) -> list[int]:
        """Feed one step's per-host wall times; returns flagged host ids."""
        med = statistics.median(step_times)
        flagged = []
        for h, t in enumerate(step_times):
            f = self.filters[h]
            f.observe(t / max(med, 1e-12))
            threshold = max(1.0 + self.alarm_sigma * f.std, self.min_ratio)
            if f.mean > threshold:
                self.alarm_counts[h] += 1
                flagged.append(h)
            else:
                self.alarm_counts[h] = 0
        return flagged

    def recommendation(self, host: int) -> str:
        """``"reshard"`` once the alarm has held for ``persistent_after``
        consecutive steps, else ``"tolerate"``."""
        return "reshard" if self.alarm_counts[host] >= \
            self.persistent_after else "tolerate"
