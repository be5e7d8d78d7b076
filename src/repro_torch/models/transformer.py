"""Decoder-only width-nested anytime LM (port of the dense nested path of
``repro.models.transformer``).

Parameters are a plain dict: ``embed [V, d]``, ``unembed [d, V]``,
``final_norm [d]`` and ``layers``, a list with one
``{"mixer": attention params, "ffn": MLP params}`` dict per layer (the
reference stacks layers for ``lax.scan``; here they are a Python loop).
``level`` selects the level-k prefix subnetwork: the whole pipeline runs
on the ``d_k`` prefix of the residual stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nesting import StripeSpec, prefix_rmsnorm
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import embed_init


class LMOutput(NamedTuple):
    logits: torch.Tensor
    caches: list[KVCache]


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device=None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; a fresh seed-0 generator when omitted)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    params = {
        "embed": embed_init((cfg.vocab, cfg.d_model), dtype, generator, dev),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "unembed": embed_init((cfg.d_model, cfg.vocab), dtype, generator,
                              dev) * cfg.d_model ** -0.5,
    }
    params["layers"] = [
        {"mixer": attn_mod.attn_init(cfg, generator, dev),
         "ffn": mlp_mod.mlp_init(cfg, generator, dev)}
        for _ in range(cfg.n_layers)]
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> list[KVCache]:
    """Zeroed ``[B, max_len, n_kv, head_dim]`` KV buffers, one per layer."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return [KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(cfg.n_layers)]


def apply_layer(lp: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, cache: KVCache | None = None,
                cache_len: int | None = None, level: int | None = None):
    """One pre-norm block (nested attention + nested SwiGLU).  Returns
    ``(x, new_cache)``."""
    a, new_cache = attn_mod.nested_attention(
        lp["mixer"], x, positions, cfg, level=level, cache=cache,
        cache_len=cache_len)
    x = x + a
    x = x + mlp_mod.nested_mlp(lp["ffn"], x, cfg, level=level)
    return x, new_cache


def lm_apply(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
             mode: str = "prefill", caches: list[KVCache] | None = None,
             cache_len: int | None = None,
             level: int | None = None) -> LMOutput:
    """Forward pass at nesting ``level`` (default: the deepest).

    * ``mode='prefill'``: ``tokens [B, S]``, no caches in; the per-layer
      k/v of the prompt come back (the serving engine copies them into
      its ``max_len`` buffers).
    * ``mode='decode'``: ``tokens [B, 1]`` with ``caches`` and the int
      ``cache_len``; the step's k/v are written into the caches in place.

    Returns ``[B, S, V]`` logits of the chosen level.
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    b, s = tokens.shape
    decode = mode == "decode"
    if decode:
        positions = torch.full((b, s), int(cache_len), dtype=torch.int32,
                               device=tokens.device)
    else:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens]
    d_spec = StripeSpec.pow2(cfg.d_model, cfg.nest_levels)
    k = cfg.nest_levels if level is None else level
    if k < cfg.nest_levels:
        x = x[..., :d_spec.width(k)]
    new_caches = []
    for i, lp in enumerate(params["layers"]):
        x, nc = apply_layer(lp, x, positions, cfg,
                            cache=caches[i] if decode else None,
                            cache_len=cache_len if decode else None,
                            level=level)
        new_caches.append(nc)
    hk = prefix_rmsnorm(x, params["final_norm"], d_spec, k, cfg.norm_eps)
    return LMOutput(hk @ params["unembed"][:d_spec.width(k), :], new_caches)
