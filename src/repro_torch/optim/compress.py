"""Gradient compression with error feedback (port of
``repro.optim.compress``): int8 quantisation of each gradient leaf to a
per-tensor scale, the residual of one step's quantisation added back
before the next (Seide et al. 2014), so the error does not accumulate.
It models a compressed data-parallel reduction: quantise, dequantise,
then the optimizer step.  ``torch.round`` rounds halves to even, as
``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class CompressionState(NamedTuple):
    error: Any   # float32 residuals, as the gradients


def init_compression(params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32)``: ``scale = max|x| / 127 + 1e-12``,
    ``q = clip(round(x / scale), -127, 127)``."""
    f = lambda v: _f32(v, x.device)
    scale = torch.max(torch.abs(x)) / f(127.0) + f(1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, state: CompressionState
                   ) -> tuple[Any, CompressionState, dict]:
    """Quantise every gradient leaf with error feedback; returns
    ``(grads', state', {"compress_err": norm of the new residuals})``,
    each gradient back in its own dtype."""
    gf = tree_map(lambda g, e: g.float() + e, grads, state.error)
    deq = tree_map(lambda x: dequantize_int8(*quantize_int8(x)), gf)
    new_grads = tree_map(lambda d, g: d.to(g.dtype), deq, grads)
    new_err = tree_map(torch.sub, gf, deq)
    err_norm = torch.sqrt(sum(torch.sum(torch.square(leaf))
                              for leaf in tree_leaves(new_err)))
    return new_grads, CompressionState(new_err), {"compress_err": err_norm}

