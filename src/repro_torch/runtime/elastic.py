"""Elastic re-meshing (port of ``repro.runtime.elastic``): rebuild a mesh
from the devices that survive and place the state on it.

Checkpoints hold whole arrays (:mod:`repro_torch.checkpoint.io`) and the
data pipeline is a pure function of the step, so scaling a training run
from one (data, model) grid to another is: pick the new grid
(:func:`remesh`), take the placements from the same partition-spec rules
(:mod:`repro_torch.launch.shardings`), restore.  The decision plane's
lanes lie in contiguous blocks, one a shard, so losing a device loses a
contiguous block of lanes; the layout helpers compute that on the host
and :func:`remesh_lanes` rebuilds the lane mesh.  :func:`reshard_state`
places a state tree on either kind of mesh.
"""

from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import (GridMesh, GridPlacement, LaneMesh,
                                     LanePlacement, make_host_mesh,
                                     make_lane_mesh)
from repro_torch.tree import tree_map_with_path


def best_mesh_shape(n_devices: int, model_parallel: int
                    ) -> tuple[int, ...]:
    """Largest (data, model) grid with the requested TP degree that fits
    the surviving device count; drops TP degree if it no longer divides."""
    while model_parallel > 1 and n_devices % model_parallel:
        model_parallel //= 2
    return (n_devices // model_parallel, model_parallel)


def remesh(devices=None, model_parallel: int = 1) -> GridMesh:
    """Rebuild a (data, model) grid from the surviving ``devices``
    (default every visible CUDA device), shrinking the model-parallel
    degree until it divides the device count (:func:`best_mesh_shape`).
    A device may be listed more than once (several shards on it)."""
    if devices is None:
        return make_host_mesh(model_parallel)
    devices = list(devices)
    shape = best_mesh_shape(len(devices), model_parallel)
    return GridMesh(np.array(devices[:shape[0] * shape[1]], dtype=object)
                    .reshape(shape), ("data", "model"))


def remesh_lanes(devices=None) -> LaneMesh:
    """Rebuild the decision plane's 1-D lane mesh from the surviving
    ``devices`` (default every visible CUDA device): the device-loss twin
    of :func:`~repro_torch.launch.mesh.make_lane_mesh`.  A device may be
    listed more than once (several shards on one device)."""
    if devices is None:
        return make_lane_mesh()
    return LaneMesh(devices)


def reshard_state(state, mesh, spec_fn):
    """Place every leaf of ``state`` on ``mesh`` by the rule
    ``spec_fn(path, leaf)`` gives it (``path`` the tuple of the leaf's path
    components).  On a :class:`~repro_torch.launch.mesh.GridMesh` the spec
    cuts the leaf into one block a grid coordinate (a
    :class:`~repro_torch.launch.mesh.GridShards`; ``()`` or ``None`` a
    copy on every shard).  On a lane mesh :func:`~repro_torch.launch.mesh.
    lane_pspec` splits the leaf's leading axis into the mesh's blocks (a
    :class:`~repro_torch.launch.mesh.LaneShards`), and ``()`` or ``None``
    puts the whole leaf on every shard's device."""
    placement = GridPlacement if isinstance(mesh, GridMesh) \
        else LanePlacement
    return tree_map_with_path(
        lambda path, leaf: placement(mesh, spec_fn(path, leaf)).place(leaf),
        state)


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
