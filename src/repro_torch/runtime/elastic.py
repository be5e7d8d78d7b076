"""Lane groups under device loss (the single-device parts of
``repro.runtime.elastic``).

A lane mesh lays its lanes out in contiguous blocks, one block a device,
so losing a device loses a contiguous block of lanes.  These helpers
compute that layout on the host; building meshes and resharding state
onto them waits for the pod tooling.
"""

from __future__ import annotations

import numpy as np


def best_mesh_shape(n_devices: int, model_parallel: int
                    ) -> tuple[int, ...]:
    """Largest (data, model) grid with the requested TP degree that fits
    the surviving device count; drops TP degree if it no longer divides."""
    while model_parallel > 1 and n_devices % model_parallel:
        model_parallel //= 2
    return (n_devices // model_parallel, model_parallel)


def lane_groups(n_lanes: int, n_devices: int) -> np.ndarray:
    """Device id owning each lane under the 1-D lane mesh's contiguous
    block layout (``[n_lanes]`` int64).  ``n_devices`` must divide
    ``n_lanes``."""
    if n_lanes % n_devices:
        raise ValueError(f"n_lanes={n_lanes} not divisible by "
                         f"n_devices={n_devices}")
    return np.repeat(np.arange(n_devices), n_lanes // n_devices)


def dead_lane_mask(n_lanes: int, n_devices: int,
                   lost_devices) -> np.ndarray:
    """Lane-death mask (``[n_lanes]`` bool) when the devices in
    ``lost_devices`` die: every lane in a lost device's contiguous block
    is dead (correlated loss)."""
    return np.isin(lane_groups(n_lanes, n_devices),
                   np.asarray(list(lost_devices), dtype=np.int64))


def surviving_lane_capacity(n_lanes: int, n_devices: int,
                            n_lost: int) -> int:
    """Lane capacity after ``n_lost`` of ``n_devices`` devices die."""
    return (n_lanes // n_devices) * (n_devices - n_lost)
