"""Elastic re-meshing of the decision plane (port of
``repro.runtime.elastic``, its lane half).

A lane mesh lays its lanes out in contiguous blocks, one block a shard,
so losing a device loses a contiguous block of lanes.  The layout helpers
compute that on the host; :func:`remesh_lanes` rebuilds the lane mesh from
the devices that survive and :func:`reshard_state` places a state tree on
it.  Checkpoints hold whole arrays (:mod:`repro_torch.checkpoint.io`), so
state saved under one mesh restores onto any other.  ``remesh`` for
(data, model) grids comes with the data plane.
"""

from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import (LaneMesh, LanePlacement,
                                     make_lane_mesh)
from repro_torch.tree import children, is_namedtuple


def best_mesh_shape(n_devices: int, model_parallel: int
                    ) -> tuple[int, ...]:
    """Largest (data, model) grid with the requested TP degree that fits
    the surviving device count; drops TP degree if it no longer divides."""
    while model_parallel > 1 and n_devices % model_parallel:
        model_parallel //= 2
    return (n_devices // model_parallel, model_parallel)


def remesh_lanes(devices=None) -> LaneMesh:
    """Rebuild the decision plane's 1-D lane mesh from the surviving
    ``devices`` (default every visible CUDA device): the device-loss twin
    of :func:`~repro_torch.launch.mesh.make_lane_mesh`.  A device may be
    listed more than once (several shards on one device)."""
    if devices is None:
        return make_lane_mesh()
    return LaneMesh(devices)


def reshard_state(state, mesh: LaneMesh, spec_fn):
    """Place every leaf of ``state`` on ``mesh`` by the rule
    ``spec_fn(path, leaf)`` gives it: :func:`~repro_torch.launch.mesh.
    lane_pspec` splits the leaf's leading axis into the mesh's blocks (a
    :class:`~repro_torch.launch.mesh.LaneShards`), ``()`` or ``None``
    puts the whole leaf on every shard's device.  ``path`` is the tuple of
    the leaf's path components (dict keys, sequence indices)."""
    def place(node, path):
        if node is None:
            return None
        if isinstance(node, (dict, list, tuple)):
            items = [(name, place(child, path + (name,)))
                     for name, child in children(node)]
            if isinstance(node, dict):
                return {k: v for k, (_, v) in
                        zip(sorted(node), items)}
            if is_namedtuple(node):
                return type(node)(*(v for _, v in items))
            vals = [v for _, v in items]
            return vals if isinstance(node, list) else tuple(vals)
        return LanePlacement(mesh, spec_fn(path, node)).place(node)

    return place(state, ())


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
