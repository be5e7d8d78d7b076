"""Train-step factories (port of ``repro.train.step``): the standard and
the anytime joint or greedy loss (paper Section 4.3), gradient
accumulation over microbatches, and int8 gradient compression.

Every factory returns a plain function of tensors; the step is eager
PyTorch, its forward through ``lm_apply(mode="train")`` (the ``blocks``
projections and ``ref`` attention: no kernel has a backward), its
gradients from :func:`torch.autograd.grad`, its update the functional
:class:`~repro_torch.optim.adamw.AdamW`.  A state is a
:class:`TrainState` of tensor trees; a step returns a new one.

:func:`make_grid_train_step` trains a state laid over a (data, model)
grid (:mod:`repro_torch.launch.shardings`).  The reference jits its
unsharded step under the grid's shardings, and GSPMD computes the same
function; the port computes that function too, without emulating XLA's
partitioned program: each data shard gathers the leaves and takes its
slice of the batch, the gradients are joined as microbatches are, and
each block gets its AdamW update.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nesting import greedy_stage_weights, joint_anytime_loss
from repro_torch.launch.mesh import (GridMesh, GridPlacement, GridShards,
                                     batch_axes, on_device)
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.compress import (CompressionState, compress_grads,
                                        init_compression)
from repro_torch.train.losses import chunked_cross_entropy, cross_entropy
from repro_torch.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    compress_state: CompressionState | None


def make_loss_fn(model, cfg: ModelConfig):
    """``loss_fn(params, batch) -> (loss, {"ce", "aux_loss"})``: next-token
    CE (chunked over ``cfg.loss_chunk`` positions for a decoder-only model
    without nesting, from the final hidden states) plus
    ``cfg.router_aux_weight`` times the MoE aux loss."""
    def loss_fn(params, batch):
        if cfg.loss_chunk and not cfg.encoder_layers and cfg.nest_levels == 1:
            out = tfm.lm_apply(params, cfg, batch["tokens"], mode="train",
                               pos3d=batch.get("pos3d"), return_hidden=True)
            unembed = params.get("unembed")
            if unembed is None:
                unembed = params["embed"].T
            ce = chunked_cross_entropy(out.logits, unembed, batch["labels"],
                                       cfg.loss_chunk)
            aux = out.aux_loss
        else:
            logits, aux = model.train_logits(params, batch)
            ce = cross_entropy(logits, batch["labels"])
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux_loss": aux}
    return loss_fn


def make_anytime_loss_fn(model, cfg: ModelConfig, level_weights=None,
                         greedy_stage: int = 0):
    """Joint (``level_weights``, uniform by default) or greedy (one-hot on
    ``greedy_stage``) anytime loss over every level's logits from one
    forward pass, plus the weighted aux loss; the metrics add each level's
    CE as ``ce_level<k>``."""
    if cfg.nest_levels <= 1:
        raise ValueError("the anytime loss needs nest_levels > 1")

    def loss_fn(params, batch):
        logits_per_level, aux = model.train_logits(params, batch,
                                                   all_levels=True)
        losses = [cross_entropy(lg, batch["labels"])
                  for lg in logits_per_level]
        weights = level_weights
        if greedy_stage:
            weights = greedy_stage_weights(greedy_stage, cfg.nest_levels)
        loss = joint_anytime_loss(losses, weights) \
            + cfg.router_aux_weight * aux
        metrics = {"ce": losses[-1], "aux_loss": aux}
        for i, lv in enumerate(losses):
            metrics[f"ce_level{i + 1}"] = lv
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``, the
    gradients a tree like ``params`` in each leaf's dtype (zeros where a
    leaf does not reach the loss); nothing returned holds a graph."""
    leaves = tree_leaves(params)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_map(lambda _: next(grads), params)


def _pieces(batch: dict, n: int, what: str) -> list[dict]:
    """``batch`` cut into ``n`` equal pieces on axis 0 (``pos3d`` on axis
    1; a leaf without the batch axis goes whole to every piece)."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible into {n} {what}")
    mb = b // n
    out = []
    for i in range(n):
        piece = {k: (v[i * mb:(i + 1) * mb]
                     if v.dim() and v.shape[0] == b else v)
                 for k, v in batch.items() if k != "pos3d"}
        if "pos3d" in batch:
            piece["pos3d"] = batch["pos3d"][:, i * mb:(i + 1) * mb]
        out.append(piece)
    return out


def _mean(parts, n: int, device: torch.device):
    """``(loss, metrics, grads)`` averaged over the ``n`` items of
    ``parts`` (each :func:`value_and_grad`'s ``((loss, metrics), grads)``
    of one piece), in order: float32 ``g / n`` added to zeros on
    ``device``, as the reference's microbatch ``lax.scan`` accumulates."""
    nt = torch.tensor(float(n), device=device)
    loss = torch.zeros((), dtype=torch.float32, device=device)
    metrics = grads = None
    for (l_i, m_i), g_i in parts:
        if grads is None:
            grads = tree_map(lambda g: torch.zeros(
                g.shape, dtype=torch.float32, device=device), g_i)
            metrics = {k: torch.zeros_like(v, device=device)
                       for k, v in m_i.items()}
        grads = tree_map(lambda a, g: a + g.to(device).float() / nt, grads,
                         g_i)
        loss = loss + l_i.to(device) / nt
        metrics = {k: metrics[k] + m_i[k].to(device) / nt for k in metrics}
    return loss, metrics, grads


def make_train_step(model, cfg: ModelConfig, opt: AdamW, *,
                    microbatches: int = 1, compress: bool = False,
                    loss_fn=None):
    """``train_step(state, batch) -> (state, metrics)``.

    ``microbatches > 1`` splits the batch on axis 0 (``pos3d`` on axis 1)
    and accumulates float32 gradients ``g / microbatches`` in order, as
    the reference's ``lax.scan`` does; with one microbatch the gradients
    stay in each parameter's dtype.  ``compress=True`` runs the gradients
    through int8 quantisation with error feedback before the optimizer.
    """
    loss_fn = loss_fn or make_loss_fn(model, cfg)

    def compute_grads(params, batch):
        if microbatches <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads
        parts = (value_and_grad(loss_fn, params, micro)
                 for micro in _pieces(batch, microbatches, "microbatches"))
        return _mean(parts, microbatches, batch["tokens"].device)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grads = compute_grads(state.params, batch)
        comp_state = state.compress_state
        if compress:
            grads, comp_state, cmetrics = compress_grads(grads, comp_state)
            metrics.update(cmetrics)
        params, opt_state, ometrics = opt.update(grads, state.opt_state,
                                                 state.params)
        metrics.update(ometrics)
        metrics["loss"] = loss
        return TrainState(params, opt_state, comp_state), metrics

    return train_step


def make_grid_train_step(model, cfg: ModelConfig, opt: AdamW,
                         mesh: GridMesh, *, microbatches: int = 1,
                         compress: bool = False, loss_fn=None):
    """``train_step(state, batch) -> (state, metrics)`` over a state whose
    leaves are :class:`~repro_torch.launch.mesh.GridShards` on ``mesh``
    (placed by :func:`~repro_torch.launch.shardings.param_shardings`).

    Data shard ``d`` (the coordinates over ``batch_axes(mesh)``, the first
    major, as ``batch_specs`` splits the batch) computes on the device at
    its coordinate with every other axis 0: it gathers each leaf there and
    takes pieces ``d * microbatches`` to ``(d + 1) * microbatches - 1`` of
    the batch cut into ``n_dp * microbatches``, each piece's loss and
    gradients in turn.  The gradients, loss and metrics are joined over
    the pieces in that order as float32 ``g / n`` on the grid's home
    device; compression, the global gradient norm, AdamW's clip and the
    ``grad_norm`` metric act on the joined whole gradients; then each
    block gets its AdamW update from its slice of them on its device.  So
    the step computes :func:`make_train_step` with ``microbatches = n_dp *
    microbatches``, bit for bit where the devices compute alike; the model
    axis only decides where blocks live.  Where the loss couples a batch's
    rows (a MoE layer routes each dispatch group of its tokens under a
    capacity set by the group, and its aux loss is a product of means),
    that is the function of microbatches, each data shard's tokens routed
    among themselves, not the one over the whole batch."""
    loss_fn = loss_fn or make_loss_fn(model, cfg)
    dp = batch_axes(mesh)
    sizes = [mesh.axis_size(a) for a in dp]
    n_dp = int(np.prod(sizes))
    n = n_dp * microbatches
    home = mesh.home
    shard_devices = []
    for d in range(n_dp):
        at = dict(zip(dp, np.unravel_index(d, sizes)))
        shard_devices.append(mesh.devices[tuple(
            int(at.get(a, 0)) for a in mesh.axis_names)])
    coords = list(np.ndindex(mesh.shape))

    def pieces(params, batch):
        cut = _pieces(batch, n, "pieces (data shards x microbatches)")
        for d, dev in enumerate(shard_devices):
            with on_device(dev):
                full = tree_map(lambda s: s.full(dev), params)
                for piece in cut[d * microbatches:(d + 1) * microbatches]:
                    yield value_and_grad(loss_fn, full, {
                        k: v.to(dev) for k, v in piece.items()})

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grads = _mean(pieces(state.params, batch), n, home)
        comp_state = state.compress_state
        if compress:
            whole = tree_map(lambda s: s.full(home), comp_state)
            grads, whole, cmetrics = compress_grads(grads, whole)
            comp_state = tree_map(
                lambda new, old: GridPlacement(mesh, old.spec).place(new),
                whole, comp_state)
            metrics.update(cmetrics)
        gnorm = global_norm(grads)
        grad_leaves = tree_leaves(grads)
        leaves = [tree_leaves(t) for t in (state.params, state.opt_state.m,
                                           state.opt_state.v)]
        out = [[np.empty(mesh.shape, dtype=object) for _ in grad_leaves]
               for _ in range(3)]
        steps = np.empty(mesh.shape, dtype=object)
        for idx in coords:
            dev = mesh.devices[idx]
            p, m, v = ([leaf.parts[idx] for leaf in ls] for ls in leaves)
            g = [gl[s.slices(idx)].to(dev)
                 for gl, s in zip(grad_leaves, leaves[0])]
            with on_device(dev):
                new_p, new_st, om = opt.apply(
                    g, AdamWState(state.opt_state.step.parts[idx], m, v), p,
                    gnorm)
            for k, new in enumerate((new_p, new_st.m, new_st.v)):
                for j, blk in enumerate(new):
                    out[k][j][idx] = blk
            steps[idx] = new_st.step
            if idx == coords[0]:
                lr = om["lr"]

        def rebuild(tree, parts):
            it = iter(parts)
            return tree_map(lambda s: GridShards(mesh, s.spec, s.shape,
                                                 next(it)), tree)

        st = state.opt_state
        opt_state = AdamWState(
            GridShards(mesh, st.step.spec, st.step.shape, steps),
            rebuild(st.m, out[1]), rebuild(st.v, out[2]))
        metrics.update({"grad_norm": gnorm, "lr": lr, "loss": loss})
        return TrainState(rebuild(state.params, out[0]), opt_state,
                          comp_state), metrics

    return train_step


def init_train_state(model, cfg: ModelConfig, opt: AdamW,
                     generator: torch.Generator | None = None, device=None,
                     compress: bool = False, params=None) -> TrainState:
    """Parameters from ``model.init(generator, device)`` (or the given
    ``params``), fresh optimizer moments, and the compression residuals
    when ``compress``."""
    if params is None:
        params = model.init(generator=generator, device=device)
    return TrainState(params, opt.init(params),
                      init_compression(params) if compress else None)
