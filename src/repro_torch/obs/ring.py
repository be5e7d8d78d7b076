"""Telemetry ring: per-round aggregates from the megatick's round clock
(port of ``repro.obs.ring``).

The megatick gateway runs its rounds as one CUDA graph a chunk (eagerly
on the CPU); the ring piggybacks on that body by computing a small tuple
of per-round reductions (:data:`RING_FIELDS`) *inside* it, from values
the body already computed, into the chunk's output buffer.  The ``[S]``
state is untouched, so the ring costs no extra host syncs and cannot
perturb the round clock.

Host side, :class:`TelemetryRing` is a fixed-capacity circular buffer
of those per-round records (oldest rounds overwritten first, with the
total-seen count kept exact).  The host gateway pushes the same record
shape from its Python round loop, so one report renderer serves both
regimes.
"""

from __future__ import annotations

import json

import numpy as np

# One record per round, in push order.  Layout:
#   now_s       — absolute round time t_k (seconds)
#   n_active    — lanes occupied this round
#   n_feasible  — lanes whose pick satisfied all constraints (static
#                 policies count every active lane)
#   n_relaxed   — lanes served under a relaxed constraint (code != 0)
#   energy_j    — summed energy delivered this round (scan-native sum;
#                 may differ in the last ulp from the host FMA recompute)
#   n_missed    — lanes whose delivery overran the deadline
RING_FIELDS = ("now_s", "n_active", "n_feasible", "n_relaxed",
               "energy_j", "n_missed")

DEFAULT_RING_CAPACITY = 4096


def round_aggregates(act, feasible, relaxed, energy, missed):
    """Per-round ring reductions, computed inside the round's body.

    All inputs are per-lane ``[L]`` tensors the body already produced
    (active mask, feasibility mask, relaxation codes, delivered energy,
    miss flags); the output is the :data:`RING_FIELDS` tuple minus
    ``now_s`` (the caller supplies the round time), as float64 0-d
    tensors on their device.  Reductions over existing values only."""
    import torch

    actf = act.to(torch.float64)
    return (torch.sum(actf),
            torch.sum(feasible.to(torch.float64) * actf),
            torch.sum((relaxed != 0).to(torch.float64) * actf),
            torch.sum(energy * actf),
            torch.sum(missed.to(torch.float64) * actf))


class TelemetryRing:
    """Fixed-capacity circular buffer of per-round telemetry records."""

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY):
        self.capacity = int(capacity)
        self._buf = {f: np.zeros(self.capacity, dtype=np.float64)
                     for f in RING_FIELDS}
        self._head = 0       # next write slot
        self.n_seen = 0      # total rounds ever pushed

    def push_rounds(self, **fields) -> None:
        """Append ``[R]`` arrays (one value per round) for every ring
        field; older rounds are overwritten once capacity wraps."""
        arrs = {f: np.asarray(fields[f], dtype=np.float64).ravel()
                for f in RING_FIELDS}
        n = arrs[RING_FIELDS[0]].size
        if any(a.size != n for a in arrs.values()):
            raise ValueError("ring push: field length mismatch")
        if n == 0:
            return
        if n >= self.capacity:  # keep only the newest `capacity` rounds
            for f in RING_FIELDS:
                self._buf[f][:] = arrs[f][n - self.capacity:]
            self._head = 0
            self.n_seen += n
            return
        idx = (self._head + np.arange(n)) % self.capacity
        for f in RING_FIELDS:
            self._buf[f][idx] = arrs[f]
        self._head = int((self._head + n) % self.capacity)
        self.n_seen += n

    def __len__(self) -> int:
        return min(self.n_seen, self.capacity)

    def view(self) -> dict[str, np.ndarray]:
        """Retained records, oldest first, as ``{field: [n] array}``."""
        n = len(self)
        if self.n_seen <= self.capacity:
            return {f: self._buf[f][:n].copy() for f in RING_FIELDS}
        order = (self._head + np.arange(self.capacity)) % self.capacity
        return {f: self._buf[f][order] for f in RING_FIELDS}

    def summary(self) -> dict:
        """Totals/rates over the retained window (JSON-ready)."""
        v = self.view()
        n = len(self)
        active = float(v["n_active"].sum()) if n else 0.0
        return {
            "rounds_seen": int(self.n_seen),
            "rounds_retained": int(n),
            "capacity": int(self.capacity),
            "lane_rounds_active": active,
            "feasible_frac": float(v["n_feasible"].sum()) / active
            if active else 0.0,
            "relaxed_frac": float(v["n_relaxed"].sum()) / active
            if active else 0.0,
            "energy_j": float(v["energy_j"].sum()) if n else 0.0,
            "missed": int(v["n_missed"].sum()) if n else 0,
        }

    def save(self, path: str) -> None:
        """Write ``{"summary": ..., "rounds": {field: [...]}}`` JSON."""
        v = self.view()
        doc = {"summary": self.summary(),
               "fields": list(RING_FIELDS),
               "rounds": {f: [float(x) for x in v[f]] for f in RING_FIELDS}}
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")

    @staticmethod
    def load(path: str) -> dict:
        """Read a :meth:`save`-written ring file back as a dict."""
        with open(path) as f:
            return json.load(f)
