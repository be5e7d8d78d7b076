"""Plain reference of the ALERT controller over a fleet of request streams
(paper Section 3, Eqs. 4-10), in NumPy.

Per tick, for every live stream: the windowed accuracy goal (paper fn. 3),
the estimates of every (model, power) cell from the Kalman state (Eq. 7
finish probability, the Eq. 10 anytime staircase, Eq. 9 energy), and the
Eq. 4 (least energy under an accuracy goal) or Eq. 5 (most accuracy under
an energy budget) pick with the Section 3.3 relaxation; then the feedback:
the Eq. 6 slow-down filter on the observed / profiled latency ratio
(inflated on a miss), the Eq. 8 idle-power filter, and the delivered
accuracy into the goal window.

The profile table is measured by the program at set-up (the mean latency
of each level at full clock).  The reference takes only those measured
base latencies and derives the power buckets, the per-bucket latencies
and powers itself from the cubic DVFS model.  The observed latencies are
measurements too; the reference replays them against the program's picks
(teacher forcing), so one differing pick does not change every later
tick.  ``dtype`` float32 gives the control.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import erf

GOAL_MIN_ENERGY, GOAL_MAX_ACCURACY = 0, 1

# The paper's filter constants (Eq. 6: K0, R, Q0, alpha, mu0, sigma0;
# Eq. 8: phi0, M0, S, V) and the miss inflation of Section 3.3.
SLOWDOWN = dict(mu=1.0, sigma=0.1, gain=0.5, q=0.1, r=1e-3, q0=0.1,
                alpha=0.3, miss_inflation=0.2)
IDLE = dict(phi=0.3, var=0.01, s=1e-4, v=1e-3)
# The cubic DVFS model: p(f) = p_idle + (p_tdp - p_idle) f^3, for clock
# fractions from a stated least one to 1.
POWER = dict(p_idle=60.0, p_tdp=200.0)


def speed_fraction(cap: float, min_fraction: float) -> float:
    """Clock fraction a power cap allows."""
    if cap >= POWER["p_tdp"]:
        return 1.0
    usable = max(cap - POWER["p_idle"], 0.0)
    f = (usable / (POWER["p_tdp"] - POWER["p_idle"])) ** (1.0 / 3.0)
    return float(min(max(f, min_fraction), 1.0))


def power_at(f: float, min_fraction: float) -> float:
    """Draw at clock fraction ``f``."""
    f = float(min(max(f, min_fraction), 1.0))
    return POWER["p_idle"] + (POWER["p_tdp"] - POWER["p_idle"]) * f ** 3


def derive_table(base: np.ndarray, buckets: int, min_fraction: float):
    """``(caps [L], latency [K, L], run_power [K, L])`` from the full-clock
    latency of each level, the compute-bound 1/f rule across ``buckets``
    evenly spaced caps from the draw at ``min_fraction`` of the clock to
    the full draw."""
    lo = power_at(min_fraction, min_fraction)
    caps = np.linspace(lo, POWER["p_tdp"], buckets)
    fr = np.array([speed_fraction(c, min_fraction) for c in caps])
    lat = np.asarray(base, np.float64)[:, None] / fr[None, :]
    pw = np.broadcast_to(np.array([power_at(f, min_fraction) for f in fr]),
                         lat.shape)
    return caps, lat, np.ascontiguousarray(pw)


def staircase(accuracies: np.ndarray, q_fail: float) -> np.ndarray:
    """``W [K, K]``: the expected accuracy of level k is ``q_fail +
    sum_u W[k, u] F_u`` with ``F_u`` level u's finish probability (Eq. 10:
    the deepest level finished before the deadline is delivered)."""
    k = len(accuracies)
    w = np.zeros((k, k))
    for i in range(k):
        prev = q_fail
        for u in range(i + 1):
            w[i, u] += accuracies[u] - prev
            prev = accuracies[u]
    return w


class FleetReference:
    """The controller's state and decisions for ``streams`` lanes."""

    def __init__(self, base_latency, accuracies, q_fail: float,
                 buckets: int, min_fraction: float, streams: int,
                 window: int, dtype=np.float64):
        self.dt = np.dtype(dtype)
        self.caps, lat, pw = derive_table(base_latency, buckets,
                                          min_fraction)
        self.latency = lat.astype(self.dt)
        self.run_power = pw.astype(self.dt)
        self.accuracies = np.asarray(accuracies, np.float64)
        self.q_fail = self.dt.type(q_fail)
        self.w = staircase(self.accuracies, q_fail).astype(self.dt)
        full = lambda v: np.full(streams, v, self.dt)
        self.mu, self.sigma = full(SLOWDOWN["mu"]), full(SLOWDOWN["sigma"])
        self.gain, self.q = full(SLOWDOWN["gain"]), full(SLOWDOWN["q"])
        self.phi, self.var = full(IDLE["phi"]), full(IDLE["var"])
        self.window = window
        self.buf = np.zeros((streams, window - 1), self.dt)
        self.count = np.zeros(streams, np.int64)
        self.pos = np.zeros(streams, np.int64)

    def goals(self, raw: np.ndarray) -> np.ndarray:
        """The windowed per-input accuracy goal of every lane."""
        raw = raw.astype(self.dt)
        need = raw * self.dt.type(self.window) - self.buf.sum(axis=1)
        per_input = need - (self.window - self.count - 1).astype(self.dt) \
            * raw
        return np.where(self.count == 0, raw, per_input)

    def estimate(self, deadline: np.ndarray):
        """``(lat_mean, accuracy, energy)`` grids ``[S, K, L]``."""
        t = deadline.astype(self.dt)[:, None, None]
        lat_mean = self.mu[:, None, None] * self.latency[None]
        lat_std = np.maximum(np.maximum(self.sigma, 1e-6)[:, None, None]
                             * self.latency[None], 1e-12)
        f = 0.5 * (1.0 + erf((t - lat_mean) / lat_std
                             / self.dt.type(math.sqrt(2.0))))
        acc = self.w[None, :, 0, None] * f[:, 0:1, :]
        for u in range(1, self.w.shape[1]):
            acc = acc + self.w[None, :, u, None] * f[:, u:u + 1, :]
        acc = self.q_fail + acc
        t_run = np.minimum(lat_mean, t)
        caps = self.run_power[None]
        energy = caps * t_run + self.phi[:, None, None] * caps \
            * np.maximum(t - t_run, 0.0)
        return lat_mean, acc, energy

    def select(self, deadline, acc_goal, energy_goal, goal_kind):
        """Each lane's pick ``(i, j)`` and its predicted latency, accuracy
        and energy: Eq. 4 or Eq. 5 with the Section 3.3 relaxation,
        first-occurrence argmin over the cells in row-major order."""
        lat, acc, en = self.estimate(np.maximum(deadline, 1e-9))
        s, k, l = acc.shape
        acc_f, en_f = acc.reshape(s, -1), en.reshape(s, -1)
        ag = self.goals(acc_goal)[:, None]
        eg = np.asarray(energy_goal, self.dt)[:, None]
        is_min = (np.asarray(goal_kind) == GOAL_MIN_ENERGY)[:, None]
        feas = np.where(is_min, acc_f >= ag, en_f <= eg)
        any_f = feas.any(axis=1, keepdims=True)
        acc_use = np.where(feas | ~any_f, acc_f, -np.inf)
        best = acc_use.max(axis=1, keepdims=True)
        sc_a = np.where(best - acc_use <= 1e-12, en_f, np.inf)
        sc_e = np.where(any_f, np.where(feas, en_f, np.inf), -acc_f)
        pick = np.argmin(np.where(is_min, sc_e, sc_a), axis=1)
        self.grids = (lat.reshape(s, -1), acc_f, en_f)
        return (pick // l, pick % l) + self.at(pick // l, pick % l)

    def at(self, i, j) -> tuple:
        """The last :meth:`select`'s predicted latency, accuracy and energy
        of cell ``(i, j)`` of every lane."""
        cell = np.asarray(i) * self.latency.shape[1] + np.asarray(j)
        rows = np.arange(len(cell))
        return tuple(g[rows, cell] for g in self.grids)

    def observe(self, i, j, observed, missed, delivered, active_power):
        """One tick's feedback for every lane, at the picks ``(i, j)`` the
        served inputs ran at."""
        d = self.dt.type
        ratio = observed.astype(self.dt) / self.latency[i, j]
        ratio = np.where(missed, ratio * d(1.0 + SLOWDOWN["miss_inflation"]),
                         ratio)
        y = ratio - self.mu
        gy = self.gain * y
        q = np.maximum(d(SLOWDOWN["alpha"]) * self.q
                       + d(1.0 - SLOWDOWN["alpha"]) * (gy * gy),
                       d(SLOWDOWN["q0"]))
        carried = (d(1.0) - self.gain) * self.sigma
        gain = (carried + q) / (carried + q + d(SLOWDOWN["r"]))
        self.mu = self.mu + gain * y
        self.sigma, self.gain, self.q = carried + q, gain, q
        idle = d(0.25) * active_power.astype(self.dt)
        g = (self.var + d(IDLE["s"])) / (self.var + d(IDLE["s"])
                                         + d(IDLE["v"]))
        self.var = (d(1.0) - g) * (self.var + d(IDLE["s"]))
        self.phi = self.phi + g * (idle / active_power.astype(self.dt)
                                   - self.phi)
        rows = np.arange(len(self.pos))
        self.buf[rows, self.pos] = delivered
        self.pos = (self.pos + 1) % (self.window - 1)
        self.count = np.minimum(self.count + 1, self.window - 1)

    def state(self) -> dict:
        """The filter and goal state, as the program's banks hold it."""
        return {"mu": self.mu, "sigma": self.sigma, "gain": self.gain,
                "process_noise": self.q, "phi": self.phi,
                "variance": self.var, "goal_buf": self.buf,
                "goal_count": self.count, "goal_pos": self.pos}
