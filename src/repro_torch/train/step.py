"""Train-step factories (port of ``repro.train.step``): the standard and
the anytime joint or greedy loss (paper Section 4.3), gradient
accumulation over microbatches, and int8 gradient compression.

Every factory returns a plain function of tensors; the step is eager
PyTorch, its forward through ``lm_apply(mode="train")`` (the ``blocks``
projections and ``ref`` attention: no kernel has a backward), its
gradients from :func:`torch.autograd.grad`, its update the functional
:class:`~repro_torch.optim.adamw.AdamW`.  A state is a
:class:`TrainState` of tensor trees; a step returns a new one.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nesting import greedy_stage_weights, joint_anytime_loss
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamW, AdamWState
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
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} not divisible into "
                             f"{microbatches} microbatches")
        mb = b // microbatches
        dev = batch["tokens"].device
        n = torch.tensor(float(microbatches), device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = grads = None
        for i in range(microbatches):
            micro = {k: (v[i * mb:(i + 1) * mb]
                         if v.dim() and v.shape[0] == b else v)
                     for k, v in batch.items() if k != "pos3d"}
            if "pos3d" in batch:
                micro["pos3d"] = batch["pos3d"][:, i * mb:(i + 1) * mb]
            (l_i, m_i), g_i = value_and_grad(loss_fn, params, micro)
            if grads is None:
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                metrics = {k: torch.zeros_like(v) for k, v in m_i.items()}
            grads = tree_map(lambda a, g: a + g.float() / n, grads, g_i)
            loss = loss + l_i / n
            metrics = {k: metrics[k] + m_i[k] / n for k in metrics}
        return loss, metrics, grads

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
