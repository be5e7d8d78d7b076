"""AdamW, functional and tree-native (port of ``repro.optim.adamw``).

``init`` gives float32 first and second moments shaped as each parameter;
``update(grads, state, params)`` returns new parameters (each in its own
dtype), the new state and metrics, and mutates nothing.  It is not
``torch.optim.AdamW``, whose clipping, decay rule and ``eps`` placement
differ: here the gradient is clipped to ``clip_norm`` by its global norm,
the decay is added to the Adam direction of every leaf with two or more
dims (none on norms and biases), and ``eps`` is added to ``sqrt(v_hat)``.

Every constant that meets a tensor is a float32 tensor on its device, as
the reference computes in float32: the bias corrections ``1 - b^step``
come from a float32 power, and a schedule's rate is a float32 tensor.
(A Python float is float64, and the card divides by a scalar through its
reciprocal; either would move a bf16 parameter's rounding.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Any               # float32, as params
    v: Any               # float32, as params


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable = 3e-4     # a float, or step (int32 tensor) -> rate
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params
               ) -> tuple[Any, AdamWState, dict]:
        gnorm = global_norm(grads)
        new_params, new_state, metrics = self.apply(grads, state, params,
                                                    gnorm)
        return new_params, new_state, {"grad_norm": gnorm, **metrics}

    def apply(self, grads, state: AdamWState, params, gnorm: torch.Tensor
              ) -> tuple[Any, AdamWState, dict]:
        """The update given the global gradient norm ``gnorm``: every op
        after it is elementwise, so a grid shard applies it to its blocks
        alone (the clip scale and the rate are scalars)."""
        dev = state.step.device
        step = state.step + 1
        lr = _f32(self.lr(step) if callable(self.lr) else self.lr, dev)
        gnorm = gnorm.to(dev)
        metrics = {}
        if self.clip_norm is not None:
            scale = torch.minimum(
                _f32(1.0, dev), _f32(self.clip_norm, dev)
                / torch.maximum(gnorm, _f32(1e-12, dev)))
            grads = tree_map(lambda g: g.float() * scale, grads)
        b1, b2 = _f32(self.b1, dev), _f32(self.b2, dev)
        c1, c2 = _f32(1 - self.b1, dev), _f32(1 - self.b2, dev)
        m = tree_map(lambda mu, g: b1 * mu + c1 * g.float(), state.m, grads)
        v = tree_map(lambda nu, g: b2 * nu + c2 * torch.square(g.float()),
                     state.v, grads)
        one = _f32(1.0, dev)
        stepf = step.float()
        bc1 = one - torch.pow(b1, stepf)
        bc2 = one - torch.pow(b2, stepf)
        eps, wd = _f32(self.eps, dev), _f32(self.weight_decay, dev)

        def upd(p, mu, nu):
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if self.weight_decay and p.dim() >= 2:   # none on norms/biases
                delta = delta + wd * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        metrics["lr"] = lr
        return new_params, AdamWState(step, m, v), metrics


def global_norm(tree) -> torch.Tensor:
    """``sqrt`` of the float32 sum of squares over every leaf, the leaves'
    sums added in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then cosine
    decay to ``floor * peak_lr`` at ``total``; the rate of a step (an int
    or an integer tensor) is a float32 tensor on the step's device."""
    def lr(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        step = _f32(step, dev)
        f = lambda x: _f32(x, step.device)
        warm = f(peak_lr) * step / f(max(warmup, 1))
        frac = torch.clamp((step - f(warmup)) / f(max(total - warmup, 1)),
                           0.0, 1.0)
        cos = f(floor) + f((1 - floor) * 0.5) * (
            f(1.0) + torch.cos(f(math.pi) * frac))
        return torch.where(step < f(warmup), warm, f(peak_lr) * cos)
    return lr
