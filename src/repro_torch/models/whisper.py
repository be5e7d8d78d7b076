"""Whisper-style encoder-decoder backbone (port of ``repro.models.whisper``,
arXiv:2212.04356).

As in the reference the conv frontend is a stub: the encoder takes
precomputed frame embeddings ``[B, T, d_model]``.  Its divergences from
upstream Whisper are the reference's: RoPE instead of learned or
sinusoidal positions, RMSNorm instead of LayerNorm.  The encoder is
bidirectional, the decoder causal with a cross-attention over the
encoder's output in every layer.

Parameters are a plain dict: ``embed [V, d]``, ``unembed [d, V]`` (always
present: the encoder-decoder reads no ``tie_embeddings``), ``final_norm``
and ``enc_final_norm [d]``, ``encoder``, a list with one ``{"attn",
"ffn"}`` dict per encoder layer, and ``decoder``, a list with one
``{"self", "cross", "ffn"}`` dict per decoder layer (the reference stacks
each for ``lax.scan``; here they are Python loops).  Like the reference,
this backbone reads none of the LM's other switches: every FFN is the
dense SwiGLU (``n_experts`` is ignored), every mixer is attention
(``attn_every``, ``rwkv``), there is no window (``sliding_window``), no
M-RoPE, no nesting and no last-position prefill.  It does read
``qkv_bias`` (self-attention only), ``attn_logit_softcap`` (self- and
cross-attention) and ``attn_backend``.

The decoder's caches are lists per layer: ``KVCache`` self caches
``[B, max_len, kv, hd]``, and the cross k/v ``[B, T, kv, hd]`` that
:func:`cross_kv` computes once per request.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import embed_init, rms_norm
from repro_torch.models.transformer import (LMOutput, check_trainable,
                                            remat, token_positions)


def init_encdec(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; a fresh seed-0 generator when omitted).  Every ``wo`` is
    scaled by ``sqrt(2 * cfg.n_layers)``, the decoder's layer count, the
    encoder's too, as in the reference.  On ``meta``: abstract state,
    nothing drawn."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)

    def ones():
        return torch.ones(cfg.d_model, dtype=dtype, device=dev)

    params = {
        "embed": embed_init((cfg.vocab, cfg.d_model), dtype, generator, dev),
        "unembed": embed_init((cfg.d_model, cfg.vocab), dtype, generator,
                              dev) * cfg.d_model ** -0.5,
        "final_norm": ones(),
        "enc_final_norm": ones(),
    }
    params["encoder"] = [
        {"attn": attn_mod.attn_init(cfg, generator, dev),
         "ffn": mlp_mod.mlp_init(cfg, generator, dev)}
        for _ in range(cfg.encoder_layers)]
    params["decoder"] = [
        {"self": attn_mod.attn_init(cfg, generator, dev),
         "cross": attn_mod.attn_init(cfg, generator, dev, cross=True),
         "ffn": mlp_mod.mlp_init(cfg, generator, dev)}
        for _ in range(cfg.n_layers)]
    return params


def encode(params: dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """``frames [B, T, d]`` (the stubbed frontend's embeddings) through the
    bidirectional encoder: RoPE at ``0..T-1``, no causal mask, then the
    encoder's final norm.  With ``cfg.remat`` each layer is recomputed in
    the backward pass while autograd records, as the reference remats its
    encoder.  Returns ``[B, T, d]``."""
    b, t, _ = frames.shape
    positions = token_positions(b, t, frames.device, None)

    def layer(lp, x):
        a, _ = attn_mod.attention(lp["attn"], x, positions, cfg,
                                  causal=False)
        x = x + a
        return x + mlp_mod.mlp(lp["ffn"], x, cfg)

    x = frames
    for lp in params["encoder"]:
        x = remat(cfg, layer, lp, x)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def cross_kv(params: dict, cfg: ModelConfig,
             h_enc: torch.Tensor) -> list[KVCache]:
    """Each decoder layer's cross k/v ``[B, T, kv, hd]`` from the encoder
    output: ``rms_norm(h_enc, cross.norm) @ wk`` and ``@ wv`` (the same
    norm that normalises the decoder stream for q), no RoPE."""
    b, t, _ = h_enc.shape
    shape = (b, t, cfg.n_kv_heads, cfg.head_dim)
    out = []
    for lp in params["decoder"]:
        xn = rms_norm(h_enc, lp["cross"]["norm"], cfg.norm_eps)
        out.append(KVCache((xn @ lp["cross"]["wk"]).reshape(shape),
                           (xn @ lp["cross"]["wv"]).reshape(shape)))
    return out


def decoder_apply(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  ckv: list[KVCache], *, mode: str = "prefill",
                  caches: list[KVCache] | None = None,
                  cache_len: int | torch.Tensor | None = None) -> LMOutput:
    """The causal decoder over ``tokens [B, s]`` with each layer's
    cross-attention over ``ckv`` (:func:`cross_kv`).

    * ``mode='prefill'``: positions ``0..s-1``; the self-attention k/v of
      the prompt come back as the caches.
    * ``mode='decode'``: ``tokens [B, 1]`` at ``cache_len`` (an int, or a
      0-d or ``[B]`` integer tensor on the device) with the self
      ``caches``, whose k/v are written in place and returned.
    * ``mode='train'``: as a prefill without caches (None), each layer
      recomputed in the backward pass under ``cfg.remat``, and a zero
      float32 ``aux_loss`` (the encoder-decoder has no MoE).

    Returns ``[B, s, V]`` logits (always through ``unembed``) and the
    caches."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    train = mode == "train"
    if train:
        check_trainable(cfg)
    b, s = tokens.shape
    decode = mode == "decode"
    positions = token_positions(b, s, tokens.device,
                                cache_len if decode else None)

    def layer(lp, x, ckv_i, cache):
        a, nc = attn_mod.attention(lp["self"], x, positions, cfg,
                                   cache=cache,
                                   cache_len=cache_len if decode else None)
        x = x + a
        c, _ = attn_mod.attention(lp["cross"], x, positions, cfg,
                                  cross_kv=ckv_i)
        x = x + c
        return x + mlp_mod.mlp(lp["ffn"], x, cfg), nc

    x = params["embed"][tokens]
    new_caches = []
    for i, lp in enumerate(params["decoder"]):
        if train:
            x = remat(cfg, lambda *a: layer(*a)[0], lp, x, ckv[i], None)
            continue
        x, nc = layer(lp, x, ckv[i], caches[i] if decode else None)
        new_caches.append(nc)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if train:
        return LMOutput(h @ params["unembed"], None,
                        torch.zeros((), dtype=torch.float32,
                                    device=h.device))
    return LMOutput(h @ params["unembed"], new_caches)


def encdec_train(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                 tokens: torch.Tensor) -> LMOutput:
    """A train forward of the encoder-decoder: :func:`encode`,
    :func:`cross_kv`, then :func:`decoder_apply` in mode ``"train"``."""
    check_trainable(cfg)
    ckv = cross_kv(params, cfg, encode(params, cfg, frames))
    return decoder_apply(params, cfg, tokens, ckv, mode="train")


def encdec_decode(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  ckv: list[KVCache], caches: list[KVCache],
                  cache_len) -> LMOutput:
    """One decode step of the decoder (:func:`decoder_apply`)."""
    return decoder_apply(params, cfg, tokens, ckv, mode="decode",
                         caches=caches, cache_len=cache_len)


def init_decoder_caches(cfg: ModelConfig, batch: int, max_len: int,
                        device=None) -> list[KVCache]:
    """Zeroed self-attention caches ``[B, max_len, kv, hd]``, one per
    decoder layer."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return [KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(cfg.n_layers)]
