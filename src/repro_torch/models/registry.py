"""Uniform model API (port of ``repro.models.registry`` for every family:
the decoder-only LMs of models/transformer.py and, where
``cfg.encoder_layers > 0``, the encoder-decoder of models/whisper.py):
``build_model(cfg)`` ->

    model.init(generator=None, device=None)   -> params
    model.train_logits(params, batch, level=None, all_levels=False)
                                              -> (logits, aux_loss)
    model.prefill(params, batch)              -> (logits, caches)
    model.decode_step(params, batch, caches)  -> (logits, caches)
    model.init_caches(batch_size, max_len)    -> caches

``batch`` is a dict with ``tokens [B, S]``, for decode ``cache_len``, for
training ``labels [B, S]`` (read by the losses, not here), and
for a ``vlm`` model optionally ``pos3d [3, B, S]`` (M-RoPE's position
streams; without them its attention runs plain RoPE, as text-only serving
does), and for an encoder-decoder's prefill ``frames [B, T, d]`` (the
stubbed frontend's embeddings).  An encoder-decoder's caches are a dict:
``"self"``, the decoder's per-layer KV caches, and ``"cross"``, each
layer's cross k/v over the T frames, which a prefill computes and a
decode step carries through unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as wsp


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., dict]
    train_logits: Callable[..., tuple[Any, Any]]
    prefill: Callable[..., tuple[Any, Any]]
    decode_step: Callable[..., tuple[Any, Any]]
    init_caches: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    """The model API of ``cfg``: an encoder-decoder where
    ``cfg.encoder_layers > 0`` (whatever its family, as in the reference),
    else a decoder-only LM."""
    if cfg.encoder_layers:
        return _build_encdec(cfg)
    return _build_lm(cfg)


def _build_lm(cfg: ModelConfig) -> Model:
    def train_logits(params, batch, level=None, all_levels=False):
        out = tfm.lm_apply(params, cfg, batch["tokens"], mode="train",
                           pos3d=batch.get("pos3d"), level=level,
                           all_levels=all_levels)
        return out.logits, out.aux_loss

    def prefill(params, batch):
        out = tfm.lm_apply(params, cfg, batch["tokens"], mode="prefill",
                           pos3d=batch.get("pos3d"))
        return out.logits, out.caches

    def decode_step(params, batch, caches):
        out = tfm.lm_apply(params, cfg, batch["tokens"], mode="decode",
                           caches=caches, cache_len=batch["cache_len"],
                           pos3d=batch.get("pos3d"))
        return out.logits, out.caches

    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: tfm.init_lm(
            cfg, generator=generator, device=device),
        train_logits=train_logits,
        prefill=prefill,
        decode_step=decode_step,
        init_caches=lambda b, s, device=None: tfm.init_caches(
            cfg, b, s, device=device),
    )


def _build_encdec(cfg: ModelConfig) -> Model:
    def train_logits(params, batch, level=None, all_levels=False):
        # an encoder-decoder has no nesting: level and all_levels are
        # ignored, as in the reference
        out = wsp.encdec_train(params, cfg, batch["frames"], batch["tokens"])
        return out.logits, out.aux_loss

    def prefill(params, batch):
        ckv = wsp.cross_kv(params, cfg, wsp.encode(params, cfg,
                                                   batch["frames"]))
        out = wsp.decoder_apply(params, cfg, batch["tokens"], ckv,
                                mode="prefill")
        return out.logits, {"self": out.caches, "cross": ckv}

    def decode_step(params, batch, caches):
        out = wsp.encdec_decode(params, cfg, batch["tokens"],
                                caches["cross"], caches["self"],
                                batch["cache_len"])
        return out.logits, {"self": out.caches, "cross": caches["cross"]}

    def init_caches(batch, max_len, device=None):
        # the cross k/v sized to max_len, the reference's stand-in for
        # the frame count
        return {"self": wsp.init_decoder_caches(cfg, batch, max_len,
                                                device=device),
                "cross": wsp.init_decoder_caches(cfg, batch, max_len,
                                                 device=device)}

    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: wsp.init_encdec(
            cfg, generator=generator, device=device),
        train_logits=train_logits,
        prefill=prefill,
        decode_step=decode_step,
        init_caches=init_caches,
    )
