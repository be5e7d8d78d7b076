"""Attention with RoPE, an optional sliding window and a KV cache (port of
``repro.models.attention``): the dense block (``attention``, with optional
q/k/v biases, non-causal for an encoder and cross-attention over an
encoder's k/v) and the width-nested anytime block (``nested_attention``).

Nested heads are striped: q heads follow the pow2 stripe spec, KV heads
are striped when divisible and otherwise saturated into stripe 1.  The
nested projections are ``nested_norm_linear`` / ``nested_linear``, so
level-k execution touches only level-k weights.  Scores and softmax are
float32.

``cfg.attn_backend`` picks the attention itself, as the reference's config
declares it (``ref | kernel``):

* ``"ref"``: prefill attention is chunked over queries so the score tensor
  stays bounded (with ``cfg.window_banded`` and a window, each chunk reads
  only its key band); decode attends one position over the cache.
* ``"kernel"``: prefill runs ``flash_attention`` and decode
  ``decode_attention`` (the CUDA kernels on the card, their plain versions
  on the CPU), one launch per layer and forward pass; cross-attention runs
  ``flash_attention`` over the encoder's frames with several queries and
  ``decode_attention`` with one.

Decode takes ``cache_len`` as an int, a 0-d integer tensor or a ``[B]``
integer tensor (one length per batch row); a tensor is read on the device
only, so a CUDA graph of the step replays at its current values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nesting import (StripeSpec, nested_linear,
                                      nested_norm_linear)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                      rms_norm)


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, S_max, n_kv, head_dim]
    v: torch.Tensor        # [B, S_max, n_kv, head_dim]


def attn_init(cfg: ModelConfig, generator: torch.Generator,
              device: torch.device, cross: bool = False) -> dict:
    """One attention block's params; a ``cross`` block (the
    encoder-decoder's cross-attention) has no q/k/v biases, even in a
    ``qkv_bias`` config, as in the reference."""
    dtype = getattr(torch, cfg.dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(shape, scale=None):
        return dense_init(shape, dtype, generator, device, scale=scale)

    params = {
        "norm": torch.ones(d, dtype=dtype, device=device),
        "wq": w((d, h * hd)),
        "wk": w((d, kv * hd)),
        "wv": w((d, kv * hd)),
        "wo": w((h * hd, d),
                scale=(h * hd) ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias and not cross:   # zero, as the reference initialises
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            params[name] = torch.zeros(n * hd, dtype=dtype, device=device)
    return params


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                  chunk: int, window: int | None = None,
                  softcap: float | None = None,
                  banded: bool = False) -> torch.Tensor:
    """q: ``[B,S,h,hd]``; k/v: ``[B,T,kv,hd]``; positions ``[B,S]`` /
    ``[B,T]``.  One query chunk of scores at a time.  With a window, key
    ``j`` is live for query ``i`` iff ``q_pos[i] - k_pos[j] < window``.

    ``banded`` (the reference's ``window_banded``): for causal windowed
    self-attention whose chunks divide S, chunk ``c`` reads only the
    ``min(T, chunk + window)`` keys ending at its last row (clamped to the
    sequence), at index positions, as the reference's band does."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    groups = h // n_kv
    scale = hd ** -0.5
    use_band = (banded and causal and window is not None and t == s
                and s % chunk == 0)
    span = min(t, chunk + (window or 0)) if use_band else t
    kf = k.float()
    outs = []
    for start in range(0, s, chunk):
        qi = q[:, start:start + chunk]
        c = qi.shape[1]
        qg = qi.reshape(b, c, n_kv, groups, hd).float()
        if use_band:
            k0 = min(max(start + chunk - span, 0), t - span)
            kb, vb = kf[:, k0:k0 + span], v[:, k0:k0 + span]
            kp = torch.arange(k0, k0 + span, device=q.device).expand(b, span)
        else:
            kb, vb, kp = kf, v, k_pos
        logits = torch.einsum("bckgd,btkd->bkgct", qg, kb) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        qp = q_pos[:, start:start + c]
        mask = (kp[:, None, :] >= 0).expand(b, c, kb.shape[1])
        if causal:
            mask = mask & (qp[:, :, None] >= kp[:, None, :])
        if window is not None:
            mask = mask & ((qp[:, :, None] - kp[:, None, :]) < window)
        logits = torch.where(mask[:, None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgct,btkd->bckgd", probs, vb)
                    .reshape(b, c, h, hd))
    return torch.cat(outs, dim=1)


def _sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len, *, window: int | None = None,
                 softcap: float | None = None) -> torch.Tensor:
    """Single-position decode: q ``[B,1,h,hd]`` over cache k/v
    ``[B,S,kv,hd]`` whose positions ``< cache_len`` (and, with a window,
    ``>= cache_len - window``) are valid; ``cache_len`` is a scalar or one
    length per row ``[B]``."""
    b, _, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    groups = h // n_kv
    qg = q.reshape(b, n_kv, groups, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * hd ** -0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    lens = cache_len
    if isinstance(lens, torch.Tensor) and lens.dim() > 0:
        lens = lens.reshape(-1, 1)                 # one length per row
    mask = pos < lens                              # [S] or [B, S]
    if window is not None:
        mask = mask & (pos >= lens - window)
    logits = torch.where(mask.reshape(-1, 1, 1, s), logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(b, 1, h, hd)


def _scatter_at(buf: torch.Tensor, update: torch.Tensor,
                index) -> torch.Tensor:
    """Write ``update`` ``[B,s,...]`` into ``buf`` ``[B,S,...]`` at
    position ``index`` along axis 1, in place (the cache buffer is owned
    by one request's generation loop), and return ``buf``.  ``index`` is
    an int, a 0-d integer tensor, or a ``[B]`` integer tensor (row ``b``
    written at ``index[b]``); a tensor is read on the device (no host
    copy, so a CUDA graph of the call replays at the tensor's current
    values)."""
    s = update.shape[1]
    if isinstance(index, torch.Tensor) and index.dim() > 0:
        rows = index.reshape(-1, 1) + torch.arange(s, device=buf.device)
        rows = rows.reshape(rows.shape + (1,) * (buf.dim() - 2))
        return buf.scatter_(1, rows.expand(update.shape),
                            update.to(buf.dtype))
    if isinstance(index, torch.Tensor):
        rows = index + torch.arange(s, device=buf.device)
        return buf.index_copy_(1, rows, update.to(buf.dtype))
    buf[:, index:index + s] = update.to(buf.dtype)
    return buf


def _attend(q, k, v, positions, cfg: ModelConfig, cache, cache_len,
            window: int | None, banded: bool, causal: bool = True):
    """The attention of one layer on projected, rotated q, k, v: prefill
    (no cache: ``k``/``v`` are the prompt's, returned as the cache; the
    encoder's self-attention passes ``causal=False``) or a decode step
    (``k``/``v`` written into ``cache`` at ``cache_len``, then one
    position attends over it).  Returns ``(out [B,s,h,hd], cache)``."""
    s = q.shape[1]
    kernel = cfg.attn_backend == "kernel"
    softcap = cfg.attn_logit_softcap
    if cache is not None and cache_len is not None:
        if kernel and softcap is not None:
            raise ValueError("attn_backend='kernel': decode_attention has no "
                             "logit softcap (nor has the reference's "
                             "kernel); use attn_backend='ref'")
        new_cache = KVCache(_scatter_at(cache.k, k, cache_len),
                            _scatter_at(cache.v, v, cache_len))
        if kernel:
            out = decode_attention(q[:, 0], new_cache.k, new_cache.v,
                                   cache_len + s, window=window)[:, None]
        else:
            out = _sdpa_decode(q, new_cache.k, new_cache.v, cache_len + s,
                               window=window, softcap=softcap)
        return out, new_cache
    if kernel:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    else:
        out = _sdpa_chunked(q, k, v, positions, positions, causal=causal,
                            chunk=min(cfg.attn_chunk, s), window=window,
                            softcap=softcap, banded=banded)
    return out, KVCache(k, v)


def _cross(q, k, v, positions, cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of the ``s`` decoder queries over all ``T`` encoder
    frames: no causal mask, no window.  On the ``kernel`` backend a single
    query (a decode step) runs ``decode_attention`` with every frame live,
    which splits the T-key read across blocks, and more queries (a
    prefill) run ``flash_attention``; the ``ref`` backend runs the chunked
    softmax with the frames at positions ``0..T-1``, as the reference."""
    b, s = q.shape[:2]
    t = k.shape[1]
    softcap = cfg.attn_logit_softcap
    if cfg.attn_backend != "kernel":
        k_pos = torch.arange(t, device=q.device).expand(b, t)
        return _sdpa_chunked(q, k, v, positions, k_pos, causal=False,
                             chunk=min(cfg.attn_chunk, s), softcap=softcap)
    if s > 1:
        return flash_attention(q, k, v, causal=False, softcap=softcap)
    if softcap is not None:
        raise ValueError("attn_backend='kernel': decode_attention has no "
                         "logit softcap (nor has the reference's kernel); "
                         "use attn_backend='ref'")
    return decode_attention(q[:, 0], k, v, t)[:, None]


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, causal: bool = True,
              window: int | None = None,
              cache: KVCache | None = None,
              cache_len: int | torch.Tensor | None = None,
              cross_kv: KVCache | None = None,
              positions_3d: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor, KVCache | None]:
    """Pre-norm attention of a model without nesting: RMSNorm, the q/k/v
    projections (plus ``bq``/``bk``/``bv`` where the params have them),
    RoPE at ``positions`` (M-RoPE at ``positions_3d [3, B, s]`` when
    ``cfg.m_rope`` is set and they are given, as in the reference),
    attention (causal unless ``causal=False``, as the encoder's is) with
    an optional sliding ``window``, the output projection.  Without a
    cache (prefill) the returned cache holds this call's k/v; with
    ``cache`` and ``cache_len`` (decode) the step's k/v are written at
    ``cache_len`` in place.

    With ``cross_kv`` (the encoder-decoder's cross-attention: the encoder
    output's k/v ``[B, T, kv, hd]``) only q is projected, with no RoPE,
    and it attends over all T frames (:func:`_cross`); no cache comes
    back.

    With ``cfg.attn_backend == "kernel"`` prefill masks on index
    positions, which equal ``positions`` because prefill starts at 0
    (``transformer.lm_apply``)."""
    b, s, _ = x.shape
    h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    q = xn @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(b, s, h, hd)
    if cross_kv is not None:
        out = _cross(q, *cross_kv, positions, cfg)
        return out.reshape(b, s, h * hd) @ params["wo"], None
    k, v = xn @ params["wk"], xn @ params["wv"]
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    k = k.reshape(b, s, n_kv, hd)
    if cfg.m_rope and positions_3d is not None:
        q = apply_mrope(q, positions_3d, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions_3d, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    v = v.reshape(b, s, n_kv, hd)
    out, new_cache = _attend(q, k, v, positions, cfg, cache, cache_len,
                             window, cfg.window_banded, causal)
    return out.reshape(b, s, h * hd) @ params["wo"], new_cache


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
                     window: int | None = None,
                     cache: KVCache | None = None,
                     cache_len: int | torch.Tensor | None = None,
                     ) -> tuple[torch.Tensor, KVCache]:
    """Anytime width-nested causal attention, with an optional sliding
    ``window``.  Level k uses the first ``width_q(k)/head_dim`` query
    heads and the matching KV prefix.  Without a cache (prefill) the
    returned cache holds this call's k/v; with ``cache`` and ``cache_len``
    (decode; an int, or a 0-d or ``[B]`` integer tensor on the device) the
    step's k/v are written at ``cache_len`` and the updated cache is
    returned.  The reference's nested block has no key band, so
    ``window_banded`` does not apply here.

    With ``cfg.attn_backend == "kernel"`` prefill masks on index positions,
    which equal ``positions`` because prefill starts at 0
    (``transformer.lm_apply``); the kernels read q, k and v through their
    strides.  Decode with ``attn_logit_softcap`` set raises there: the
    decode kernel, like the reference's, has no softcap."""
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
    out, new_cache = _attend(q, k, v, positions, cfg, cache, cache_len,
                             window, banded=False)
    out = out.reshape(b, s, n_q * hd)
    return nested_linear(out, params["wo"], q_spec, d_spec, level=level,
                         backend=be), new_cache
