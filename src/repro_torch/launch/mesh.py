"""Device meshes for the port (port of ``repro.launch.mesh``).

The decision plane lays the fleet's ``[S]`` lane axis over devices: a
:class:`LaneMesh` is a 1-D tuple of ``torch.device``s, one a shard, and
shard ``k`` owns the ``k``-th contiguous block of ``S / size`` lanes (the
layout of :func:`repro_torch.runtime.elastic.lane_groups`).  The decision
grid has no cross-lane op, so each shard's ``alert_select`` launch on its
own block is exact, and a sharded run equals the unsharded one bit for
bit.

A lane-sharded value is a :class:`LaneShards`: the per-shard blocks of
one ``[S, ...]`` array, each on its shard's device.  The filter banks keep
their state so; :func:`lane_shard_map` is the one seam through which a
per-shard kernel launch runs.

``make_lane_mesh(n, device="cpu")`` (or ``"cuda:0"``) lays ``n`` shards on
one device: the port's counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``, which fakes devices
for its tests.  The shards then run the same per-shard code as shards on
distinct devices, one launch each.

The data plane lays a training state over a (data, model) grid: a
:class:`GridMesh` is an n-D array of devices with named axes, a
:class:`GridShards` one array cut into a block a grid coordinate by a
partition spec (:mod:`repro_torch.launch.shardings`), and a
:class:`GridPlacement` the rule that cuts it.  ``make_production_mesh``
builds the pod grids (``device="meta"`` to reckon over them with nothing
placed), ``make_host_mesh`` a small grid over the devices at hand.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.device import resolve_device

LANE_AXIS = "lanes"


def _pinned(device) -> torch.device:
    """``device`` resolved (the card unless told otherwise), a CUDA device
    with its index, so equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LaneMesh:
    """A 1-D lane mesh: ``devices[k]`` holds shard ``k``.

    A device may hold several shards (see :func:`make_lane_mesh`).
    ``axis_names`` is ``(LANE_AXIS,)``; two meshes are equal when they
    list the same devices in the same order."""

    def __init__(self, devices, axis_names=(LANE_AXIS,)):
        self.devices = tuple(_pinned(d) for d in devices)
        self.axis_names = tuple(axis_names)
        if not self.devices:
            raise ValueError("a lane mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError("lane sharding needs a 1-D mesh "
                             f"(got axes {self.axis_names})")

    @property
    def size(self) -> int:
        """Number of shards."""
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Shard 0's device: where gathered results and the state a
        caller keeps unsharded live."""
        return self.devices[0]

    def blocks(self, s: int) -> list[tuple[int, int]]:
        """Each shard's contiguous ``(start, stop)`` over ``s`` lanes;
        ``s`` must be a multiple of :attr:`size`."""
        if s % self.size:
            raise ValueError(
                f"lane-sharded engine needs S divisible by the mesh size "
                f"({self.size}); got S={s} — pad with dead lanes")
        b = s // self.size
        return [(k * b, (k + 1) * b) for k in range(self.size)]

    def split(self, x, dtype=None) -> "LaneShards":
        """``x`` (a numpy array or tensor with ``[S]`` leading axis) as
        :class:`LaneShards`: each block on its shard's device.  A tensor's
        block that is already there is a view of ``x``; a host array goes
        to the home device in one copy, and its blocks are views of that
        where their shard is there."""
        if isinstance(x, LaneShards):
            if x.mesh != self:
                raise ValueError(f"value is sharded over {x.mesh}, not "
                                 f"{self}")
            return x
        if not isinstance(x, torch.Tensor):
            a = np.ascontiguousarray(x)
            x = torch.from_numpy(a if a.flags.writeable else a.copy()) \
                .to(self.home)
        if dtype is not None:
            x = x.to(dtype)
        return LaneShards(self, [x[a:b].to(dev) for (a, b), dev in
                                 zip(self.blocks(x.shape[0]), self.devices)])

    def __eq__(self, other) -> bool:
        return isinstance(other, LaneMesh) and \
            other.devices == self.devices and \
            other.axis_names == self.axis_names

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        return f"LaneMesh({[str(d) for d in self.devices]})"


class LaneShards:
    """One ``[S, ...]`` value over a :class:`LaneMesh`: ``parts[k]`` is
    shard ``k``'s block on ``mesh.devices[k]``.  A tree leaf for the
    checkpoint (saved as the whole array, so a checkpoint does not depend
    on the mesh it was written from)."""

    __slots__ = ("mesh", "parts")

    def __init__(self, mesh: LaneMesh, parts):
        parts = tuple(parts)
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{mesh.size} shards")
        for p, dev in zip(parts, mesh.devices):
            if p.device != dev:
                raise ValueError(f"a shard's block is on {p.device}, its "
                                 f"shard on {dev}")
        self.mesh, self.parts = mesh, parts

    @property
    def shape(self) -> tuple:
        first = self.parts[0].shape
        return (sum(p.shape[0] for p in self.parts),) + tuple(first[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def full(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default the mesh's home): the
        blocks joined in lane order."""
        home = self.mesh.home
        out = self.parts[0] if len(self.parts) == 1 else \
            torch.cat([p.to(home) for p in self.parts])
        return out.to(home if device is None else device)

    def cpu(self) -> torch.Tensor:
        return self.full("cpu")

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def on_device(dev: torch.device):
    """Context that makes ``dev`` current for work launched on it."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def make_lane_mesh(n_devices: int | None = None, *, device=None
                   ) -> LaneMesh:
    """1-D decision-plane mesh: the fleet's ``[S]`` lane axis over devices.

    By default one shard a visible CUDA device (``n_devices`` of them, all
    if ``None``); there is no CPU fallback.  With ``device=`` (``"cpu"``,
    or ``"cuda:0"`` on a one-card machine) it lays ``n_devices`` shards
    (default 1) on that one device: the counterpart of the reference's
    ``XLA_FLAGS=--xla_force_host_platform_device_count``, which fakes
    devices for its tests, and how the CPU tests and a one-card run reach
    the multi-shard path.  Pass the mesh to ``BatchedAlertEngine(mesh=)``,
    the filter banks, ``FleetSim.run_*(mesh=)``, ``run_fleet``,
    ``FleetAlertServer``, ``SessionGateway`` or ``MegatickGateway``."""
    if device is not None:
        return LaneMesh([_pinned(device)] * (1 if n_devices is None
                                             else int(n_devices)))
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to lay "
                           "the lane mesh on the CPU")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n > count:
        raise ValueError(f"{n} lane shards asked for, {count} CUDA devices "
                         f"visible; pass device= to lay several shards on "
                         f"one device")
    return LaneMesh([torch.device("cuda", k) for k in range(n)])


def lane_pspec(mesh) -> tuple[str]:
    """The lane placement rule over a 1-D mesh's single axis: the leading
    axis shards over it (the reference's ``PartitionSpec("lanes")``; the
    replicated rule is ``()``)."""
    if len(mesh.axis_names) != 1:
        raise ValueError("lane sharding needs a 1-D mesh "
                         f"(got axes {mesh.axis_names})")
    return (mesh.axis_names[0],)


class LanePlacement:
    """Where a leaf goes on a lane mesh: ``spec`` :func:`lane_pspec`
    splits its leading axis into the mesh's blocks (a
    :class:`LaneShards`), ``()`` puts the whole leaf on every shard's
    device (a tuple, one copy a shard)."""

    def __init__(self, mesh: LaneMesh, spec=()):
        self.mesh, self.spec = mesh, tuple(spec or ())

    def place(self, x):
        """``x`` (host array, tensor or :class:`LaneShards` over any mesh)
        placed on this mesh; each block or copy is a new tensor."""
        if isinstance(x, LaneShards):
            x = x.full()
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        if self.spec:
            return lane_place(self.mesh, None, x, x.dtype)
        return tuple(x.to(dev, copy=True) for dev in self.mesh.devices)

    def __repr__(self) -> str:
        return f"LanePlacement({self.mesh}, spec={self.spec})"


def lane_shardings(mesh) -> tuple[LanePlacement, LanePlacement]:
    """``(lane-sharded, replicated)`` placements over a 1-D lane mesh:
    ``[S]`` state shards its leading axis, profile constants replicate.
    The single source of lane placements."""
    spec = lane_pspec(mesh)
    return LanePlacement(mesh, spec), LanePlacement(mesh, ())


def lane_shard_map(fn, mesh: LaneMesh, *, n_in: int, n_out: int,
                   out_axis: int = 0):
    """``fn`` run once a shard over a 1-D lane mesh: the single seam of
    every per-shard launch.

    The returned function takes ``n_in`` inputs, each a tensor whose
    leading axis is the lanes (shard ``k`` gets block ``k``: a view with a
    storage offset where the tensor is already on the shard's device, a
    copy on it otherwise) or a :class:`LaneShards` over ``mesh``.  It calls
    ``fn`` on each shard's blocks on that shard's device and joins each of
    the ``n_out`` outputs in lane order along ``out_axis`` on the mesh's
    home device: each shard's output lands in its block.  No op crosses
    shards, as the decision grid has none."""
    lane_pspec(mesh)

    def mapped(*xs):
        if len(xs) != n_in:
            raise TypeError(f"expected {n_in} inputs, got {len(xs)}")
        first = xs[0]
        blocks = mesh.blocks(first.shape[0])
        shards = []
        for x in xs:
            if isinstance(x, LaneShards):
                shards.append(mesh.split(x).parts)
            else:
                shards.append([x[a:b].to(dev) for (a, b), dev
                               in zip(blocks, mesh.devices)])
        outs = []
        for k, dev in enumerate(mesh.devices):
            with on_device(dev):
                y = fn(*(sh[k] for sh in shards))
            y = (y,) if isinstance(y, torch.Tensor) else tuple(y)
            if len(y) != n_out:
                raise TypeError(f"fn returned {len(y)} outputs, expected "
                                f"{n_out}")
            outs.append(y)
        if mesh.size == 1:
            return outs[0]
        home = mesh.home
        return tuple(torch.cat([o[i].to(home) for o in outs], dim=out_axis)
                     for i in range(n_out))

    return mapped


def lane_map(fn, *args):
    """``fn(*args)`` on lane values: where an argument is a
    :class:`LaneShards`, once a shard on that shard's blocks (other
    arguments passed to every call as they are), each output joined back
    into a :class:`LaneShards`; otherwise one call.  The filter banks'
    elementwise recurrences run through here."""
    sharded = [a for a in args if isinstance(a, LaneShards)]
    if not sharded:
        return fn(*args)
    mesh = sharded[0].mesh
    outs = []
    for k, dev in enumerate(mesh.devices):
        with on_device(dev):
            outs.append(fn(*(mesh.split(a).parts[k]
                             if isinstance(a, LaneShards) else a
                             for a in args)))
    if isinstance(outs[0], torch.Tensor):
        return LaneShards(mesh, outs)
    return tuple(LaneShards(mesh, [o[i] for o in outs])
                 for i in range(len(outs[0])))


def lane_fill(mesh, device, shape, value, dtype) -> "torch.Tensor | LaneShards":
    """A ``shape`` (leading axis the lanes) array of ``value``: one tensor
    on ``device``, or under ``mesh`` one block a shard (the lane count
    must be a multiple of the mesh size)."""
    shape = tuple(shape)
    if mesh is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    if shape[0] % mesh.size:
        raise ValueError(f"lane capacity {shape[0]} must be a multiple of "
                         f"the lane-mesh size {mesh.size}")
    b = shape[0] // mesh.size
    return LaneShards(mesh, [torch.full((b,) + shape[1:], value, dtype=dtype,
                                        device=dev) for dev in mesh.devices])


def lane_place(mesh, device, x, dtype) -> "torch.Tensor | LaneShards":
    """``x`` (host array or tensor) as a new lane value: one tensor on
    ``device``, or under ``mesh`` its blocks, each a new tensor on its
    shard's device."""
    if isinstance(x, LaneShards):
        x = x.full()
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    if mesh is None:
        return t.to(device=device, dtype=dtype, copy=True)
    if t.shape[0] % mesh.size:
        raise ValueError(f"lane capacity {t.shape[0]} must be a multiple of "
                         f"the lane-mesh size {mesh.size}")
    return LaneShards(mesh, [p.to(device=dev, dtype=dtype, copy=True)
                             for p, dev in zip(mesh.split(t).parts,
                                               mesh.devices)])


def _by_shard(x: LaneShards, lanes: np.ndarray):
    """``(shard, positions in lanes, local indices)`` for every shard that
    owns some of ``lanes``."""
    b = x.parts[0].shape[0]
    shard = lanes // b
    for k in range(x.mesh.size):
        pos = np.nonzero(shard == k)[0]
        if pos.size:
            yield k, pos, lanes[pos] - k * b


def take_lanes(x, lanes) -> np.ndarray:
    """Rows ``lanes`` of a lane value as a host numpy array (a gather on
    each shard that owns some of them)."""
    if not isinstance(x, LaneShards):
        idx = torch.as_tensor(np.asarray(lanes, np.int64), device=x.device)
        return x[idx].cpu().numpy()
    lanes = np.asarray(lanes, np.int64).reshape(-1)
    out = np.empty((lanes.size,) + tuple(x.shape[1:]),
                   dtype=torch.empty(0, dtype=x.dtype).numpy().dtype)
    for k, pos, local in _by_shard(x, lanes):
        part = x.parts[k]
        out[pos] = part[torch.as_tensor(local, device=part.device)] \
            .cpu().numpy()
    return out


def put_lanes(x, lanes, values):
    """A new lane value: ``x`` with rows ``lanes`` set to ``values`` (a
    scalar or host array broadcast over them).  Only the shards that own
    some of ``lanes`` are copied.  A whole-pool write of a
    :class:`LaneShards` already on ``x``'s mesh installs its blocks."""
    if not isinstance(x, LaneShards):
        t = x.clone()
        idx = torch.as_tensor(np.asarray(lanes, np.int64), device=x.device)
        t[idx] = torch.as_tensor(np.asarray(values), dtype=t.dtype,
                                 device=x.device)
        return t
    lanes = np.asarray(lanes, np.int64).reshape(-1)
    if isinstance(values, LaneShards) and values.mesh == x.mesh and \
            np.array_equal(lanes, np.arange(x.shape[0])):
        return LaneShards(x.mesh, [v.to(dtype=p.dtype, copy=True)
                                   for v, p in zip(values.parts, x.parts)])
    vals = np.broadcast_to(np.asarray(values),
                           (lanes.size,) + tuple(x.shape[1:]))
    parts = list(x.parts)
    for k, pos, local in _by_shard(x, lanes):
        t = parts[k].clone()
        t[torch.as_tensor(local, device=t.device)] = torch.as_tensor(
            np.ascontiguousarray(vals[pos]), dtype=t.dtype, device=t.device)
        parts[k] = t
    return LaneShards(x.mesh, parts)


def mesh_device(mesh, device=None) -> torch.device:
    """The device a component built with ``mesh=`` keeps its unsharded
    state on: the mesh's home, which ``device`` (if given) must name."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and _pinned(device) != mesh.home:
        raise ValueError(f"device {device} is not the lane mesh's home "
                         f"{mesh.home}")
    return mesh.home


class GridMesh:
    """A grid of devices with named axes (the reference's ``jax.sharding.
    Mesh``): ``devices`` is an n-D numpy array of ``torch.device``s,
    ``axis_names`` names its axes, ``shape`` is the tuple of their sizes
    and ``axis_size(name)`` one axis's size (the reference's
    ``mesh.shape[name]``).  A device may appear at several coordinates
    (several shards on one device)."""

    def __init__(self, devices, axis_names):
        self.devices = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not self.devices.size:
            raise ValueError(f"a grid of shape {self.devices.shape} needs "
                             f"one name an axis and a device; got axes "
                             f"{self.axis_names}")
        for idx in np.ndindex(self.devices.shape):
            self.devices[idx] = _pinned(self.devices[idx])

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The device at coordinate 0: where a joined value lands."""
        return self.devices.flat[0]

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def __eq__(self, other) -> bool:
        return isinstance(other, GridMesh) and \
            other.axis_names == self.axis_names and \
            other.shape == self.shape and \
            all(a == b for a, b in zip(other.devices.flat, self.devices.flat))

    def __repr__(self) -> str:
        return (f"GridMesh({dict(zip(self.axis_names, self.shape))}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def _spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one partition-spec entry splits its dimension over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entries(spec, mesh: GridMesh, ndim: int) -> tuple:
    """``spec`` padded with ``None`` to ``ndim`` entries, checked against
    ``mesh``: at most ``ndim`` entries, known axes, each axis once."""
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{ndim} dims")
    used = [a for e in spec for a in _spec_axes(e)]
    for a in used:
        if a not in mesh.axis_names:
            raise ValueError(f"spec {spec} names axis {a!r}, not one of "
                             f"{mesh.axis_names}")
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} names an axis twice")
    return spec + (None,) * (ndim - len(spec))


def _split(entry, mesh: GridMesh) -> int:
    """How many blocks ``entry`` cuts its dimension into."""
    return int(np.prod([mesh.axis_size(a) for a in _spec_axes(entry)],
                       dtype=np.int64))


def shard_shape(spec, mesh: GridMesh, shape) -> tuple[int, ...]:
    """A leaf's per-device shape under ``spec`` on ``mesh``, nothing
    placed: a dimension split ``a`` ways holds ``ceil(n / a)`` (the padded
    block XLA allocates for an uneven split; where ``a`` divides ``n``,
    ``NamedSharding.shard_shape``'s)."""
    shape = tuple(int(n) for n in shape)
    return tuple(-(-n // _split(e, mesh))
                 for n, e in zip(shape, _entries(spec, mesh, len(shape))))


def _block(entries, mesh: GridMesh, shape, coord) -> tuple[slice, ...]:
    """The slices of the block at grid coordinate ``coord``: on a dimension
    split ``a`` ways, block ``k`` (the coordinate over the entry's axes,
    the first axis major) holds ``[k * ceil(n/a), min((k+1) * ceil(n/a),
    n))``, jax's layout (a trailing block may be short or empty)."""
    out = []
    for n, e in zip(shape, entries):
        axes = _spec_axes(e)
        if not axes:
            out.append(slice(None))
            continue
        k = int(np.ravel_multi_index(
            [coord[mesh.axis_names.index(a)] for a in axes],
            [mesh.axis_size(a) for a in axes]))
        c = -(-n // _split(e, mesh))
        out.append(slice(min(k * c, n), min((k + 1) * c, n)))
    return tuple(out)


class GridShards:
    """One array over a :class:`GridMesh`: ``parts[coord]`` is the block
    of grid coordinate ``coord`` on ``mesh.devices[coord]``, cut by
    ``spec`` (see :func:`_block`; an axis the spec does not name holds a
    copy).  A tree leaf for the checkpoint, saved as the whole array."""

    __slots__ = ("mesh", "spec", "shape", "parts")

    def __init__(self, mesh: GridMesh, spec, shape, parts):
        self.mesh, self.shape = mesh, tuple(shape)
        self.spec = _entries(spec, mesh, len(self.shape))
        if np.shape(parts) != mesh.shape:
            raise ValueError(f"{np.shape(parts)} parts for a grid of shape "
                             f"{mesh.shape}")
        for idx in np.ndindex(mesh.shape):
            if parts[idx].device != mesh.devices[idx]:
                raise ValueError(f"the block at {idx} is on "
                                 f"{parts[idx].device}, its shard on "
                                 f"{mesh.devices[idx]}")
        self.parts = parts

    @property
    def dtype(self) -> torch.dtype:
        return self.parts.flat[0].dtype

    def slices(self, idx) -> tuple[slice, ...]:
        """The slices of the whole array that the block at grid coordinate
        ``idx`` holds."""
        return _block(self.spec, self.mesh, self.shape, idx)

    def full(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default the grid's home), joined
        from one block of each distinct slice (copies along the axes the
        spec does not name are read once)."""
        dev = self.mesh.home if device is None else torch.device(device)
        named = {a for e in self.spec for a in _spec_axes(e)}
        coords = [idx for idx in np.ndindex(self.mesh.shape)
                  if all(i < 1 for i, a in zip(idx, self.mesh.axis_names)
                         if a not in named)]
        if len(coords) == 1:
            return self.parts[coords[0]].to(dev)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for idx in coords:
            out[self.slices(idx)] = self.parts[idx].to(dev)
        return out

    def clone(self) -> "GridShards":
        """A copy of every block, placed as this one."""
        parts = np.empty(self.mesh.shape, dtype=object)
        for idx in np.ndindex(self.mesh.shape):
            parts[idx] = self.parts[idx].detach().clone()
        return GridShards(self.mesh, self.spec, self.shape, parts)

    def __repr__(self) -> str:
        return (f"GridShards(shape={self.shape}, spec={self.spec}, "
                f"{self.mesh})")


class GridPlacement:
    """Where a leaf goes on a grid (the reference's ``NamedSharding``):
    ``spec`` cuts it into blocks, one a grid coordinate, each on that
    coordinate's device."""

    def __init__(self, mesh: GridMesh, spec=()):
        self.mesh, self.spec = mesh, () if spec is None else spec

    def place(self, x) -> GridShards:
        """``x`` (host array, tensor, or a value sharded over any mesh) as
        :class:`GridShards` on this grid; every block a new tensor."""
        if isinstance(x, (GridShards, LaneShards)):
            x = x.full()
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        shape = tuple(x.shape)
        spec = _entries(self.spec, self.mesh, len(shape))
        parts = np.empty(self.mesh.shape, dtype=object)
        for idx in np.ndindex(self.mesh.shape):
            parts[idx] = x[_block(spec, self.mesh, shape, idx)].to(
                self.mesh.devices[idx], copy=True).contiguous()
        return GridShards(self.mesh, spec, shape, parts)

    def __repr__(self) -> str:
        return f"GridPlacement({self.mesh}, spec={self.spec})"


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> GridMesh:
    """The production grid: (16, 16) over ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) over ``("pod", "data", "model")`` (the pod
    axis extends data parallelism across pods).

    By default one shard a visible CUDA device, refusing a machine with
    fewer than 256 (512) of them.  With ``device=`` every shard lies on
    that one device; ``device="meta"`` is the counterpart of the
    reference's 512 faked host devices (``XLA_FLAGS=--xla_force_host_
    platform_device_count=512`` in its dry run): a grid to reckon the
    rules and per-device shapes over, on which nothing is placed."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if device is not None:
        return GridMesh(np.array([device] * n, dtype=object).reshape(shape),
                        axes)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(f"the production grid {shape} needs {n} CUDA "
                           f"devices, {count} visible; pass device='meta' "
                           f"to reckon over it")
    return GridMesh(np.array([torch.device("cuda", k) for k in range(n)],
                             dtype=object).reshape(shape), axes)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_host_mesh(model_parallel: int = 1, *, devices=None) -> GridMesh:
    """Small (data, model) grid over whatever devices exist (``devices``,
    default every visible CUDA device), the model-parallel degree halved
    until it divides the device count: on one device any degree shrinks
    to 1.  A device may be listed more than once (several shards on
    it)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices= to lay "
                               "the grid on the CPU")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [_pinned(d) for d in devices]
    n = len(devices)
    mp = int(model_parallel)
    while mp > 1 and n % mp:
        mp //= 2
    return GridMesh(np.array(devices, dtype=object).reshape(n // mp, mp),
                    ("data", "model"))
