"""Atomic checkpoints of nested trees of arrays (port of
``repro.checkpoint.io``).

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
numpy or Python scalars, or tensors.  :func:`save` writes one
``arrays.npz`` (leaves ``leaf_0``, ``leaf_1``, ...) and a
``manifest.json`` that maps each leaf to its ``/``-joined path, in the
order ``jax.tree_util`` visits leaves: dict keys sorted, sequence items by
index, a ``NamedTuple``'s fields by name as ``.<field>`` (a train state's
``.params/...``), ``None`` an empty subtree.  So both packages write the
same names and read each other's checkpoints.

A bfloat16 leaf is written by its bits: numpy has no bfloat16, so the
array holds the 16-bit patterns as numpy's 2-byte void type ``V2`` (the
bytes the reference's npz holds for an ``ml_dtypes`` bfloat16 leaf) and
the manifest records ``"bfloat16"``.  A plain ``uint16`` array would be
read back by value by any reader that casts (16320 is not 1.5), which
``V2`` refuses.  :func:`restore` gives the bits back exactly.

The write is torn-write safe: the new checkpoint is built in
``<dir>.tmp``, the live one parked at ``<dir>.old``, the new one promoted
with ``os.replace`` and only then ``.old`` removed, so a crash at any
point leaves a complete checkpoint under ``<dir>`` or ``<dir>.old``.

:func:`restore` gives each leaf back in the dtype of the ``like`` tree's
leaf (float64 stays float64) as a tensor on that leaf's device (placed as
it, where it is sharded), or placed by ``shardings``: a ``torch.device``,
a lane placement of a :class:`~repro_torch.launch.mesh.LaneMesh`
(:func:`~repro_torch.launch.mesh.lane_shardings`), or a grid placement of
a :class:`~repro_torch.launch.mesh.GridMesh`
(:func:`~repro_torch.launch.shardings.param_shardings`,
:func:`~repro_torch.launch.shardings.named`).  A sharded leaf
(:class:`~repro_torch.launch.mesh.LaneShards`,
:class:`~repro_torch.launch.mesh.GridShards`) is saved as its whole array,
so a checkpoint written under one mesh restores onto any other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import (GridPlacement, GridShards,
                                     LanePlacement, LaneShards)
from repro_torch.tree import children, is_namedtuple, tree_map


def _leaves(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order."""
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        for name, child in children(tree):
            yield from _leaves(child, path + (name,))
    else:
        yield "/".join(path), tree


def _to_numpy(leaf) -> np.ndarray:
    """The leaf as a numpy array; a bfloat16 one (a tensor, or an
    ``ml_dtypes`` array) as its bits in ``V2``; a sharded one whole."""
    if isinstance(leaf, (GridShards, LaneShards)):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view("V2")
    return arr


def save(directory: str, tree, step: int = 0, extra: dict | None = None
         ) -> str:
    """Atomically write ``tree`` under ``directory``.  Safe against a
    crash at any point: the previous checkpoint survives as
    ``directory`` or ``<directory>.old`` until the new one is fully
    promoted.  Returns ``directory``."""
    tmp = directory + ".tmp"
    old = directory + ".old"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_leaves(tree)):
        arr = _to_numpy(leaf)
        name = f"leaf_{i}"
        arrays[name] = arr
        manifest["leaves"].append({
            "name": name, "path": key, "shape": list(arr.shape),
            "dtype": "bfloat16" if arr.dtype == np.dtype("V2")
            else str(arr.dtype)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # Never remove the live checkpoint before its replacement exists: park
    # it at .old, promote tmp, then drop .old.
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(directory):
        os.replace(directory, old)
    os.replace(tmp, directory)
    if os.path.exists(old):
        shutil.rmtree(old)
    return directory


def _resolve(directory: str) -> str:
    """The live checkpoint dir: ``directory`` if present, else
    ``<directory>.old`` (a save crashed between park and promote)."""
    if os.path.exists(directory):
        return directory
    old = directory + ".old"
    if os.path.exists(old):
        return old
    return directory


def load_manifest(directory: str) -> dict:
    """The checkpoint's manifest (step, extra, leaf layout), from
    ``<directory>.old`` if a save was torn."""
    with open(os.path.join(_resolve(directory), "manifest.json")) as f:
        return json.load(f)


def _saved_tensor(arr: np.ndarray, saved_dtype: str) -> torch.Tensor:
    """A saved array as a CPU tensor; the bits of a ``"bfloat16"`` leaf
    (``V2`` or ``uint16``) as bfloat16."""
    if saved_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _like_leaf(arr: torch.Tensor, leaf, key: str):
    """``arr`` as a tensor shaped, typed and placed as ``leaf`` (over the
    same mesh where ``leaf`` is a :class:`LaneShards` or
    :class:`GridShards`; on the CPU where ``leaf`` is a ``meta`` tensor,
    abstract state that gives a shape and dtype only)."""
    if isinstance(leaf, (LaneShards, GridShards)):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {key}: checkpoint shape "
                             f"{tuple(arr.shape)} != model shape "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, GridShards):
            return GridPlacement(leaf.mesh, leaf.spec).place(
                arr.to(leaf.dtype))
        return leaf.mesh.split(arr.to(leaf.dtype).clone())
    if isinstance(leaf, torch.Tensor):
        dtype, device = leaf.dtype, leaf.device
        if device.type == "meta":
            device = torch.device("cpu")
        shape = tuple(leaf.shape)
    else:
        ref = np.asarray(leaf)
        dtype = torch.bfloat16 if ref.dtype.name == "bfloat16" else \
            torch.from_numpy(np.zeros(0, ref.dtype)).dtype
        device, shape = torch.device("cpu"), ref.shape
    if tuple(arr.shape) != shape:
        raise ValueError(f"leaf {key}: checkpoint shape {tuple(arr.shape)} "
                         f"!= model shape {shape}")
    return arr.to(device=device, dtype=dtype)


def _place(x, where):
    """A restored leaf onto a ``torch.device`` or a lane or grid
    placement."""
    if isinstance(where, (LanePlacement, GridPlacement)):
        return where.place(x)
    if isinstance(x, (LaneShards, GridShards)):
        return x.full(where)
    return x.to(where)


def restore(directory: str, like, shardings=None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of arrays,
    scalars or tensors; dicts, lists, tuples and ``NamedTuple``s, each
    rebuilt as its own type): each leaf comes back as a tensor of the
    like leaf's shape and dtype on its device (a numpy leaf: the CPU).
    ``shardings`` (a tree of the same structure) places each leaf
    instead: a ``torch.device``, a lane placement
    (:func:`~repro_torch.launch.mesh.lane_shardings`) that splits it into
    a mesh's blocks or copies it to every shard, or a grid placement
    (:func:`~repro_torch.launch.shardings.param_shardings`) that cuts it
    into a block a grid coordinate.  A ``meta`` like leaf gives only the
    shape and dtype, as the reference's ``ShapeDtypeStruct``s.  Returns
    ``(tree, step)``."""
    directory = _resolve(directory)
    manifest = load_manifest(directory)
    saved = {rec["path"]: rec for rec in manifest["leaves"]}
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        def build(node, path):
            if node is None:
                return None
            if isinstance(node, (dict, list, tuple)):
                items = {name: build(child, path + (name,))
                         for name, child in children(node)}
                if isinstance(node, dict):
                    return {k: items[str(k)] for k in node}
                if is_namedtuple(node):
                    return type(node)(*items.values())
                return list(items.values()) if isinstance(node, list) \
                    else tuple(items.values())
            key = "/".join(path)
            if key not in saved:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            rec = saved[key]
            return _like_leaf(_saved_tensor(data[rec["name"]],
                                            rec["dtype"]), node, key)

        tree = build(like, ())
    if shardings is not None:
        tree = tree_map(_place, tree, shardings)
    return tree, manifest["step"]


def restore_tree(directory: str) -> tuple[dict, int]:
    """Restore a checkpoint as a nested dict of numpy arrays WITHOUT a
    ``like`` tree, rebuilt from the manifest's ``/``-joined paths (a
    gateway checkpoint's queue length varies, so no like tree exists);
    shapes and dtypes are the saved arrays'.  Returns
    ``(nested_dict, step)``."""
    directory = _resolve(directory)
    manifest = load_manifest(directory)
    tree: dict = {}
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        for rec in manifest["leaves"]:
            parts = rec["path"].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[rec["name"]]
    return tree, manifest["step"]


def latest_step(directory: str) -> int | None:
    """Step recorded in the checkpoint under ``directory`` (or its
    ``.old`` fallback); ``None`` when no checkpoint exists."""
    try:
        return load_manifest(directory)["step"]
    except (FileNotFoundError, KeyError):
        return None
