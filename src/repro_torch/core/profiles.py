"""Profile tables for the ALERT controller (port of ``repro.core.profiles``).

Per candidate configuration (d_i, p_j) the controller consumes the
profiled mean latency ``t_train[i, j]``, the accuracy ``q[i]`` and the
active power ``p_run[i, j]``, plus ``q_fail`` and, for anytime families,
the per-level accuracy staircase (Eq. 10).  The table is small host data
(numpy); the scoring engine copies what it needs to the device once.

Measured timing: CUDA work is asynchronous, so :func:`measure_mean_latency`
syncs on every call inside the timed region (``torch.cuda.synchronize`` by
default); both clock and sync are injectable for deterministic tests.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.power import PowerModel


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One member d_i of the model family the controller selects from."""

    name: str
    flops: float               # per-inference FLOPs
    bytes_hbm: float           # per-inference device-memory traffic
    accuracy: float            # q_i  (higher is better)
    is_anytime_level: bool = False
    anytime_group: str | None = None  # levels of one anytime net share a group
    level: int = 0             # nesting level within the group (1-based)


@dataclasses.dataclass
class ProfileTable:
    """The (models x power buckets) profile the controller operates on."""

    candidates: list[Candidate]
    power_caps: np.ndarray          # [L]
    latency: np.ndarray             # [K, L] seconds, profiled-environment mean
    run_power: np.ndarray           # [K, L] W, active power under each cap
    q_fail: float = 0.0

    def __post_init__(self) -> None:
        k, l = self.latency.shape
        if len(self.candidates) != k:
            raise ValueError(f"{len(self.candidates)} candidates for a "
                             f"{k}-row latency table")
        if self.power_caps.shape != (l,) or self.run_power.shape != (k, l):
            raise ValueError("power_caps/run_power shapes do not match "
                             f"latency {self.latency.shape}")
        if not np.all(self.latency > 0):
            raise ValueError("profiled latencies must be positive")

    @property
    def accuracies(self) -> np.ndarray:
        """Per-candidate q_i vector ``[K]``."""
        return np.array([c.accuracy for c in self.candidates])

    def anytime_groups(self) -> dict[str, list[int]]:
        """Indices of candidates per anytime group, sorted by level."""
        groups: dict[str, list[int]] = {}
        for idx, c in enumerate(self.candidates):
            if c.is_anytime_level and c.anytime_group is not None:
                groups.setdefault(c.anytime_group, []).append(idx)
        for g in groups.values():
            g.sort(key=lambda i: self.candidates[i].level)
        return groups

    def staircase_rows(self) -> dict[int, list[int]]:
        """Per-candidate staircase prefix: candidate k -> the candidate
        indices of its levels 1..m (a traditional model is just ``[k]``)."""
        rows = {i: [i] for i in range(len(self.candidates))}
        for _, idxs in self.anytime_groups().items():
            for pos, i in enumerate(idxs):
                rows[i] = idxs[:pos + 1]
        return rows

    def subset(self, indices: Sequence[int]) -> "ProfileTable":
        """Restrict the table to candidate rows ``indices``."""
        idx = list(indices)
        return ProfileTable(
            candidates=[self.candidates[i] for i in idx],
            power_caps=self.power_caps,
            latency=self.latency[idx],
            run_power=self.run_power[idx],
            q_fail=self.q_fail,
        )


def synthetic_table(seed: int, n_single: int = 8, n_levels: int = 4,
                    n_power: int = 8) -> ProfileTable:
    """A seeded table of ``n_single`` traditional models plus one
    ``n_levels``-level anytime group over ``n_power`` power buckets
    (K = n_single + n_levels rows).  Latencies and accuracies rise within
    each family, so the staircase is valid; used to exercise the scoring
    kernel at a production-like table size."""
    rng = np.random.default_rng(seed)
    pm = PowerModel()
    caps = pm.buckets(n_power)
    accs = list(np.sort(rng.uniform(0.4, 0.95, n_single)))
    base = list(np.sort(rng.uniform(0.002, 0.5, n_single)))
    cands = [Candidate(f"single{t}", 1e9, 1e8, float(a))
             for t, a in enumerate(accs)]
    a_accs = np.sort(rng.uniform(0.4, 0.95, n_levels))
    a_lats = np.sort(rng.uniform(0.002, 0.6, n_levels))
    for m in range(n_levels):
        cands.append(Candidate(f"anytime-l{m + 1}", 1e9, 1e8,
                               float(a_accs[m]), True, "anytime", m + 1))
    base = np.asarray(base + list(a_lats))
    lat = np.zeros((len(cands), n_power))
    pw = np.zeros_like(lat)
    for j, cap in enumerate(caps):
        f = pm.speed_fraction(cap)
        lat[:, j] = base / f
        pw[:, j] = pm.power_at_fraction(f)
    return ProfileTable(cands, caps, lat, pw,
                        q_fail=float(rng.uniform(0.0, 0.2)))


def default_sync(value):
    """Default measurement sync: wait for all queued CUDA work.  ``value``
    is the callable's return and is not inspected (CPU callers inject
    their own sync)."""
    import torch

    torch.cuda.synchronize()
    return value


def measure_mean_latency(fns: Sequence[Callable[[], object]],
                         warmup: int = 2,
                         iters: int = 5,
                         clock: Callable[[], float] | None = None,
                         sync: Callable[[object], object] | None = None,
                         ) -> np.ndarray:
    """Mean wall-clock latency of each callable, synced inside the timed
    region (a CUDA call returns when it is queued, not when it is done);
    warmup calls are synced too.  ``clock``/``sync`` default to
    ``time.perf_counter`` / :func:`default_sync`."""
    if clock is None:
        clock = time.perf_counter
    if sync is None:
        sync = default_sync
    base = np.zeros(len(fns))
    for i, fn in enumerate(fns):
        for _ in range(warmup):
            sync(fn())
        t0 = clock()
        for _ in range(iters):
            sync(fn())
        base[i] = (clock() - t0) / iters
    return base
