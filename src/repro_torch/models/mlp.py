"""Width-nested SwiGLU feed-forward block (port of the nested path of
``repro.models.mlp``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nesting import (StripeSpec, nested_linear,
                                      nested_norm_linear)
from repro_torch.models.common import dense_init


def mlp_init(cfg: ModelConfig, generator: torch.Generator,
             device: torch.device) -> dict:
    dtype = getattr(torch, cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": torch.ones(d, dtype=dtype, device=device),
        "w_gate": dense_init((d, f), dtype, generator, device),
        "w_up": dense_init((d, f), dtype, generator, device),
        "w_down": dense_init((f, d), dtype, generator, device),
    }


def mlp_stripe_specs(cfg: ModelConfig) -> tuple[StripeSpec, StripeSpec]:
    return (StripeSpec.pow2(cfg.d_model, cfg.nest_levels),
            StripeSpec.pow2(cfg.d_ff, cfg.nest_levels))


def nested_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
               level: int | None = None) -> torch.Tensor:
    d_spec, f_spec = mlp_stripe_specs(cfg)
    be = cfg.nest_backend
    gate = nested_norm_linear(x, params["norm"], params["w_gate"],
                              d_spec, f_spec, level=level,
                              eps=cfg.norm_eps, backend=be)
    up = nested_norm_linear(x, params["norm"], params["w_up"],
                            d_spec, f_spec, level=level,
                            eps=cfg.norm_eps, backend=be)
    return nested_linear(F.silu(gate) * up, params["w_down"], f_spec,
                         d_spec, level=level, backend=be)
