"""Width-nested (anytime) attention with RoPE and a KV cache (port of the
nested path of ``repro.models.attention``).

Heads are striped: q heads follow the pow2 stripe spec, KV heads are
striped when divisible and otherwise saturated into stripe 1.  The
projections are ``nested_norm_linear`` / ``nested_linear``, so level-k
execution touches only level-k weights.  Prefill attention is chunked over
queries so the score tensor stays bounded; decode attends one position
over the cache.  Scores and softmax are float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nesting import (StripeSpec, nested_linear,
                                      nested_norm_linear)
from repro_torch.models.common import apply_rope, dense_init


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, S_max, n_kv, head_dim]
    v: torch.Tensor        # [B, S_max, n_kv, head_dim]


def attn_init(cfg: ModelConfig, generator: torch.Generator,
              device: torch.device) -> dict:
    dtype = getattr(torch, cfg.dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(shape, scale=None):
        return dense_init(shape, dtype, generator, device, scale=scale)

    return {
        "norm": torch.ones(d, dtype=dtype, device=device),
        "wq": w((d, h * hd)),
        "wk": w((d, kv * hd)),
        "wv": w((d, kv * hd)),
        "wo": w((h * hd, d),
                scale=(h * hd) ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                  chunk: int) -> torch.Tensor:
    """q: ``[B,S,h,hd]``; k/v: ``[B,T,kv,hd]``; positions ``[B,S]`` /
    ``[B,T]``.  One query chunk of scores at a time."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    groups = h // n_kv
    scale = hd ** -0.5
    kf = k.float()
    outs = []
    for start in range(0, s, chunk):
        qi = q[:, start:start + chunk]
        c = qi.shape[1]
        qg = qi.reshape(b, c, n_kv, groups, hd).float()
        logits = torch.einsum("bckgd,btkd->bkgct", qg, kf) * scale
        qp = q_pos[:, start:start + c]
        mask = (k_pos[:, None, :] >= 0).expand(b, c, t)
        if causal:
            mask = mask & (qp[:, :, None] >= k_pos[:, None, :])
        logits = torch.where(mask[:, None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgct,btkd->bckgd", probs, v)
                    .reshape(b, c, h, hd))
    return torch.cat(outs, dim=1)


def _sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: int) -> torch.Tensor:
    """Single-position decode: q ``[B,1,h,hd]`` over cache k/v
    ``[B,S,kv,hd]`` whose first ``cache_len`` positions are valid."""
    b, _, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    groups = h // n_kv
    qg = q.reshape(b, n_kv, groups, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * hd ** -0.5
    mask = torch.arange(s, device=q.device) < cache_len
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(b, 1, h, hd)


def _scatter_at(buf: torch.Tensor, update: torch.Tensor,
                index: int) -> torch.Tensor:
    """Write ``update`` ``[B,s,...]`` into ``buf`` ``[B,S,...]`` at
    position ``index`` along axis 1, in place (the cache buffer is owned
    by one request's generation loop), and return ``buf``."""
    buf[:, index:index + update.shape[1]] = update.to(buf.dtype)
    return buf


def head_stripe_specs(cfg: ModelConfig) -> tuple[StripeSpec, StripeSpec,
                                                 StripeSpec]:
    """(d_model spec, q-head-channel spec, kv-head-channel spec)."""
    levels = cfg.nest_levels
    d_spec = StripeSpec.pow2(cfg.d_model, levels)
    denom = 2 ** (levels - 1)
    if cfg.n_heads % denom == 0:
        q_spec = StripeSpec.pow2(cfg.n_heads * cfg.head_dim, levels)
    else:
        q_spec = StripeSpec.saturated(cfg.n_heads * cfg.head_dim, levels)
    if cfg.n_kv_heads % denom == 0:
        kv_spec = StripeSpec.pow2(cfg.n_kv_heads * cfg.head_dim, levels)
    else:
        kv_spec = StripeSpec.saturated(cfg.n_kv_heads * cfg.head_dim, levels)
    return d_spec, q_spec, kv_spec


def nested_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig, *, level: int | None = None,
                     cache: KVCache | None = None,
                     cache_len: int | None = None,
                     ) -> tuple[torch.Tensor, KVCache]:
    """Anytime width-nested causal attention.  Level k uses the first
    ``width_q(k)/head_dim`` query heads and the matching KV prefix.
    Without a cache (prefill) the returned cache holds this call's k/v;
    with ``cache`` and ``cache_len`` (decode) the step's k/v are written at
    ``cache_len`` and the updated cache is returned."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    d_spec, q_spec, kv_spec = head_stripe_specs(cfg)
    be = cfg.nest_backend

    def proj(w, spec):
        return nested_norm_linear(x, params["norm"], w, d_spec, spec,
                                  level=level, eps=cfg.norm_eps, backend=be)

    q, k, v = (proj(params["wq"], q_spec), proj(params["wk"], kv_spec),
               proj(params["wv"], kv_spec))
    n_q = q.shape[-1] // hd
    n_kv = k.shape[-1] // hd
    q = apply_rope(q.reshape(b, s, n_q, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, n_kv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, n_kv, hd)
    if cache is not None and cache_len is not None:
        new_cache = KVCache(_scatter_at(cache.k, k, cache_len),
                            _scatter_at(cache.v, v, cache_len))
        out = _sdpa_decode(q, new_cache.k, new_cache.v, cache_len + s)
    else:
        out = _sdpa_chunked(q, k, v, positions, positions, causal=True,
                            chunk=min(cfg.attn_chunk, s))
        new_cache = KVCache(k, v)
    out = out.reshape(b, s, n_q * hd)
    return nested_linear(out, params["wo"], q_spec, d_spec, level=level,
                         backend=be), new_cache
