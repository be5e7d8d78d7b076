"""Profile tables for the ALERT controller (port of ``repro.core.profiles``).

Per candidate configuration (d_i, p_j) the controller consumes the
profiled mean latency ``t_train[i, j]``, the accuracy ``q[i]`` and the
active power ``p_run[i, j]``, plus ``q_fail`` and, for anytime families,
the per-level accuracy staircase (Eq. 10).  The table is small host data
(numpy); the scoring engine copies what it needs to the device once.  A
table is built analytically from roofline terms
(:func:`profile_from_roofline`) or from measured callables
(:func:`profile_measured`).

Measured timing: CUDA work is asynchronous, so :func:`measure_mean_latency`
syncs on every call inside the timed region (:func:`default_sync`: a
handle's ``block_until_ready()``, else ``torch.cuda.synchronize``); both
clock and sync are injectable for deterministic tests.
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


@dataclasses.dataclass(frozen=True)
class StaircaseTensors:
    """Padded anytime staircases (the fleet simulator's delivery reads
    them): ``lvl_lat[k, m, :]`` is the profiled latency of level m+1 of
    candidate k's staircase at each power bucket, ``lvl_acc[k, m]`` its
    accuracy, ``lvl_valid[k, m]`` whether the level exists.  Traditional
    candidates are 1-level staircases of themselves."""

    lvl_lat: np.ndarray     # [K, M, L] float64
    lvl_acc: np.ndarray     # [K, M]   float64
    lvl_valid: np.ndarray   # [K, M]   bool
    n_levels: np.ndarray    # [K]      int


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

    @property
    def names(self) -> list[str]:
        """Per-candidate display names (length K)."""
        return [c.name for c in self.candidates]

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

    def staircase_tensors(self) -> StaircaseTensors:
        """Every candidate's staircase padded to ``M = max levels`` with
        ``valid=False`` rows (an anytime level-m candidate has its group's
        levels 1..m, a traditional one itself).  Built once per table and
        cached."""
        if getattr(self, "_staircase_cache", None) is None:
            k, l = self.latency.shape
            rows = self.staircase_rows()
            m = max(len(r) for r in rows.values()) if rows else 1
            lvl_lat = np.ones((k, m, l), dtype=np.float64)
            lvl_acc = np.zeros((k, m), dtype=np.float64)
            lvl_valid = np.zeros((k, m), dtype=bool)
            n_levels = np.zeros(k, dtype=np.int64)
            for i, r in rows.items():
                lvl_lat[i, :len(r)] = self.latency[r, :]
                lvl_acc[i, :len(r)] = [self.candidates[j].accuracy
                                       for j in r]
                lvl_valid[i, :len(r)] = True
                n_levels[i] = len(r)
            self._staircase_cache = StaircaseTensors(
                lvl_lat=lvl_lat, lvl_acc=lvl_acc, lvl_valid=lvl_valid,
                n_levels=n_levels)
        return self._staircase_cache

    def subset(self, indices: Sequence[int]) -> "ProfileTable":
        """Restrict the table to candidate rows ``indices``.  When every
        kept candidate's staircase prefix survives, the parent's cached
        staircase tensors are shared by row slicing; a subset that cuts a
        group mid-prefix rebuilds its own on first use."""
        idx = list(indices)
        sub = ProfileTable(
            candidates=[self.candidates[i] for i in idx],
            power_caps=self.power_caps,
            latency=self.latency[idx],
            run_power=self.run_power[idx],
            q_fail=self.q_fail,
        )
        cache = getattr(self, "_staircase_cache", None)
        if cache is not None:
            kept = set(idx)
            rows = self.staircase_rows()
            if all(set(rows[i]) <= kept for i in idx):
                sub._staircase_cache = StaircaseTensors(
                    lvl_lat=cache.lvl_lat[idx], lvl_acc=cache.lvl_acc[idx],
                    lvl_valid=cache.lvl_valid[idx],
                    n_levels=cache.n_levels[idx])
        return sub

    def power_subset(self, indices: Sequence[int]) -> "ProfileTable":
        """Restrict the table to power-cap columns ``indices`` (the
        application-only baseline pins the system-default column).  The
        candidates, and so the staircases, are untouched: a cached
        staircase is carried over column-sliced, never rebuilt."""
        idx = list(indices)
        sub = ProfileTable(
            candidates=list(self.candidates),
            power_caps=self.power_caps[idx],
            latency=self.latency[:, idx],
            run_power=self.run_power[:, idx],
            q_fail=self.q_fail,
        )
        cache = getattr(self, "_staircase_cache", None)
        if cache is not None:
            sub._staircase_cache = StaircaseTensors(
                lvl_lat=cache.lvl_lat[:, :, idx], lvl_acc=cache.lvl_acc,
                lvl_valid=cache.lvl_valid, n_levels=cache.n_levels)
        return sub


def roofline_latency(flops: float, bytes_hbm: float, speed_fraction: float,
                     peak_flops: float, hbm_bw: float) -> float:
    """Latency under clock fraction ``speed_fraction``: the compute term
    scales 1/f, the memory term is clock-invariant; the larger wins."""
    compute = flops / (peak_flops * speed_fraction)
    memory = bytes_hbm / hbm_bw
    return max(compute, memory)


def profile_from_roofline(candidates: Sequence[Candidate],
                          power_model: PowerModel,
                          n_power_buckets: int = 8,
                          peak_flops: float = 197e12,
                          hbm_bw: float = 819e9,
                          q_fail: float = 0.0,
                          overhead: float = 0.0) -> ProfileTable:
    """A table built analytically from each candidate's roofline terms at
    every power bucket, with the bucket's operating-point draw as its
    active power.  The default peak rates are the reference's, so both
    packages build the same table from the same candidates."""
    caps = power_model.buckets(n_power_buckets)
    lat = np.zeros((len(candidates), len(caps)))
    pw = np.zeros_like(lat)
    for i, cand in enumerate(candidates):
        for j, cap in enumerate(caps):
            f = power_model.speed_fraction(cap)
            lat[i, j] = roofline_latency(cand.flops, cand.bytes_hbm, f,
                                         peak_flops, hbm_bw) + overhead
            pw[i, j] = power_model.power_at_fraction(f)
    return ProfileTable(list(candidates), caps, lat, pw, q_fail=q_fail)


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
    """Default measurement sync.  A ``value`` with ``block_until_ready()``
    (an asynchronous handle, such as the fakes of
    :mod:`repro_torch.profiling.clock`) is blocked on; for any other value
    it waits for all queued CUDA work, and raises where CUDA is missing
    (CPU callers inject their own sync)."""
    ready = getattr(value, "block_until_ready", None)
    if callable(ready):
        ready()
        return value
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


def extrapolate_power_buckets(base: np.ndarray, power_model: PowerModel,
                              n_power_buckets: int,
                              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spread full-clock latencies over power buckets with the 1/f rule
    (compute-bound; the cap cannot be actuated here), drawing each
    bucket's power from the DVFS model.  Returns ``(caps [L], lat [K, L],
    run_power [K, L])``."""
    base = np.asarray(base, dtype=np.float64)
    caps = power_model.buckets(n_power_buckets)
    lat = np.zeros((len(base), len(caps)))
    pw = np.zeros_like(lat)
    for j, cap in enumerate(caps):
        f = power_model.speed_fraction(cap)
        lat[:, j] = base / f
        pw[:, j] = power_model.power_at_fraction(f)
    return caps, lat, pw


def profile_measured(fns: Sequence[Callable[[], object]],
                     names: Sequence[str],
                     accuracies: Sequence[float],
                     power_model: PowerModel,
                     n_power_buckets: int = 4,
                     warmup: int = 2,
                     iters: int = 5,
                     q_fail: float = 0.0,
                     clock: Callable[[], float] | None = None,
                     sync: Callable[[object], object] | None = None,
                     ) -> ProfileTable:
    """A table of traditional candidates from the measured mean latency of
    real callables (:func:`measure_mean_latency`, synced), power buckets
    extrapolated with :func:`extrapolate_power_buckets`."""
    base = measure_mean_latency(fns, warmup=warmup, iters=iters,
                                clock=clock, sync=sync)
    caps, lat, pw = extrapolate_power_buckets(base, power_model,
                                              n_power_buckets)
    cands = [Candidate(name=n, flops=0.0, bytes_hbm=0.0, accuracy=a)
             for n, a in zip(names, accuracies)]
    return ProfileTable(cands, caps, lat, pw, q_fail=q_fail)
