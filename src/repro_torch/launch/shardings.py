"""Partition-spec rules of the data plane (port of
``repro.launch.shardings``): parameters, optimizer state, batches, caches.

Strategy:
  * DP  — batch over (pod, data)
  * TP  — attention/MLP inner dims over model (Megatron pattern: column-
          parallel in-projections, row-parallel out-projections)
  * EP  — MoE expert dim over model
  * SP  — decode KV-cache sequence over data (and model when the kv-head
          dim cannot shard) for small-batch long-context cells
  * vocab over model (embed rows / unembed cols / logits)

Rules are name-based on the trailing dims; leading dims get ``None``.
The port's layers are unstacked (a list, one entry a layer), where the
reference's scanned layers carry a leading repeat axis, so a port leaf's
spec is the reference's with that leading ``None`` dropped.  Paths are the
port's tree paths (:func:`repro_torch.tree.children`).  A placement is a
:class:`~repro_torch.launch.mesh.GridPlacement` (the reference's
``NamedSharding``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.mesh import GridMesh, GridPlacement
from repro_torch.tree import tree_map_with_path


class PartitionSpec(tuple):
    """One leaf's partition spec: an entry a dimension, ``None`` (not
    split), an axis name, or a tuple of names (split over their product,
    the first major).  Entries equal jax's ``PartitionSpec``'s: a tuple of
    one name is that name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# name -> (base trailing ndim, trailing spec)
_BASE_RULES: dict[str, tuple[int, tuple]] = {
    "embed": (2, ("model", None)),
    "unembed": (2, (None, "model")),
    "final_norm": (1, (None,)),
    "enc_final_norm": (1, (None,)),
    # attention
    "wq": (2, (None, "model")),
    "wk": (2, (None, "model")),
    "wv": (2, (None, "model")),
    "wo": (2, ("model", None)),
    "bq": (1, ("model",)),
    "bk": (1, ("model",)),
    "bv": (1, ("model",)),
    "norm": (1, (None,)),
    # dense mlp
    "w_gate": (2, (None, "model")),
    "w_up": (2, (None, "model")),
    "w_down": (2, ("model", None)),
    # moe (3-dim leaves; expert dim sharded — see spec_for)
    "router": (2, (None, None)),
    # mamba
    "in_proj": (2, (None, "model")),
    "conv_w": (2, (None, "model")),
    "conv_b": (1, ("model",)),
    "x_proj": (2, ("model", None)),
    "dt_proj": (2, (None, "model")),
    "dt_bias": (1, ("model",)),
    "a_log": (2, ("model", None)),
    "d_skip": (1, ("model",)),
    "out_proj": (2, ("model", None)),
    # rwkv
    "w_r": (2, (None, "model")),
    "w_k": (2, (None, "model")),
    "w_v": (2, (None, "model")),
    "w_g": (2, (None, "model")),
    "w_o": (2, ("model", None)),
    "decay_w0": (1, (None,)),
    "decay_a": (2, (None, None)),
    "decay_b": (2, (None, "model")),
    "bonus_u": (1, ("model",)),
    "ln_x_g": (1, (None,)),
    "ln_x_b": (1, (None,)),
    "mu_r": (1, (None,)), "mu_k": (1, (None,)), "mu_v": (1, (None,)),
    "mu_g": (1, (None,)), "mu_w": (1, (None,)),
    "cmix_mu_k": (1, (None,)), "cmix_mu_r": (1, (None,)),
    "cmix_wk": (2, (None, "model")),
    "cmix_wv": (2, ("model", None)),
    "cmix_wr": (2, (None, "model")),
    "cmix_norm": (1, (None,)),
}

_MOE_LEAVES = {"w_gate", "w_up", "w_down"}


def _leaf_name(path) -> str:
    return str(path[-1])


def spec_for(cfg: ModelConfig, path, leaf) -> PartitionSpec:
    """PartitionSpec for one parameter (or optimizer-moment) leaf."""
    name = _leaf_name(path)
    if name in ("step",):
        return P()
    ndim = len(leaf.shape)
    if cfg.n_experts and name in _MOE_LEAVES and ndim >= 3 and \
            leaf.shape[-3] == cfg.n_experts and \
            (leaf.shape[-2] in (cfg.d_model, cfg.d_ff)):
        # Expert-parallel: E over model, per-expert weights unsharded.
        base = ("model", None, None)
        return P(*((None,) * (ndim - 3) + base))
    if name not in _BASE_RULES:
        # Unknown leaf: replicate (safe default).
        return P(*((None,) * ndim))
    base_nd, base = _BASE_RULES[name]
    if name in ("embed", "unembed") and cfg.vocab % 16:
        base = (None, None)        # whisper's odd vocab: replicate
    return P(*((None,) * (ndim - base_nd) + tuple(base)))


def param_shardings(cfg: ModelConfig, mesh: GridMesh, tree) -> Any:
    """Placements for a params/opt-state tree (same rules)."""
    return tree_map_with_path(
        lambda path, leaf: GridPlacement(mesh, spec_for(cfg, path, leaf)),
        tree)


# --------------------------------------------------------------------- #
# Batch / cache shardings                                                #
# --------------------------------------------------------------------- #
def _dp_axes(mesh: GridMesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _n_dp(mesh: GridMesh) -> int:
    return int(np.prod([mesh.axis_size(a) for a in _dp_axes(mesh)]))


def batch_specs(cfg: ModelConfig, mesh: GridMesh, shape: ShapeSpec,
                batch: dict) -> dict:
    """PartitionSpecs for an ``input_specs()`` batch dict."""
    dp = _dp_axes(mesh)
    shard_batch = shape.global_batch % _n_dp(mesh) == 0
    out = {}
    for key, leaf in batch.items():
        nd = len(leaf.shape)
        if key == "pos3d":
            out[key] = P(None, dp if shard_batch else None, None)
        elif key == "cache_len":
            out[key] = P()
        elif key == "frames":
            out[key] = P(dp if shard_batch else None, None, None)
        elif key in ("tokens", "labels") and nd == 2:
            out[key] = P(dp, None) if shard_batch else P(None, None)
        else:
            out[key] = P(*(None,) * nd)
    return out


def cache_specs_tree(cfg: ModelConfig, mesh: GridMesh, shape: ShapeSpec,
                     caches) -> Any:
    """Placements for decode caches.

    KV buffers [..., B, S, kv, hd]:
      * batch over (pod, data) when divisible, else
      * sequence over (data) [SP], and
      * kv-heads over model when divisible, else sequence over model.
    Recurrent states (mamba [.., B, di, ds] / rwkv [.., B, h, hd, hd] and
    shift tails [.., B, d]): batch over dp if divisible; feature dim over
    model.
    """
    dp = _dp_axes(mesh)
    n_mp = mesh.axis_size("model")
    batch_ok = shape.global_batch % _n_dp(mesh) == 0

    def one(path, leaf):
        shp = leaf.shape
        nd = len(shp)
        # KV cache: trailing (B, S, kv, hd)
        if nd >= 4 and shp[-1] == cfg.head_dim and \
                shp[-2] == cfg.n_kv_heads and shp[-3] == shape.seq_len:
            kv_ok = cfg.n_kv_heads % n_mp == 0
            spec = [None] * (nd - 4)
            spec.append(dp if batch_ok else None)          # B
            if batch_ok:
                spec.append("model" if not kv_ok else None)  # S
            else:
                spec.append(("data", "model") if not kv_ok else "data")
            spec.append("model" if kv_ok else None)          # kv
            spec.append(None)                                # hd
            return P(*spec)
        # rwkv wkv state [.., B, h, hd, hd]
        if nd >= 4 and shp[-1] == shp[-2] == cfg.rwkv_head_dim and cfg.rwkv:
            return P(*([None] * (nd - 4) + [dp if batch_ok else None,
                                            "model" if shp[-3] % n_mp == 0
                                            else None, None, None]))
        # mamba ssm state [.., B, di, ds]
        if nd >= 3 and shp[-1] == cfg.mamba_d_state and \
                shp[-2] == cfg.mamba_d_inner:
            return P(*([None] * (nd - 3) +
                       [dp if batch_ok else None, "model", None]))
        # conv tail [.., B, dc-1, di]
        if nd >= 3 and shp[-1] == cfg.mamba_d_inner:
            return P(*([None] * (nd - 3) +
                       [dp if batch_ok else None, None, "model"]))
        # shift tails [.., B, d]
        if nd >= 2 and shp[-1] == cfg.d_model:
            return P(*([None] * (nd - 2) +
                       [dp if batch_ok else None, None]))
        return P(*([None] * nd))

    return tree_map_with_path(
        lambda path, leaf: GridPlacement(mesh, one(path, leaf)), caches)


def named(mesh: GridMesh, tree_of_specs) -> Any:
    """Each :class:`PartitionSpec` of ``tree_of_specs`` as a placement on
    ``mesh``."""
    return tree_map_with_path(
        lambda path, spec: GridPlacement(mesh, spec), tree_of_specs,
        is_leaf=lambda x: isinstance(x, PartitionSpec))
