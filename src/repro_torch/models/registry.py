"""Uniform model API (port of ``repro.models.registry`` for the LM
family): ``build_model(cfg)`` ->

    model.init(generator=None, device=None)   -> params
    model.prefill(params, batch)              -> (logits, caches)
    model.decode_step(params, batch, caches)  -> (logits, caches)
    model.init_caches(batch_size, max_len)    -> caches

``batch`` is a dict with ``tokens [B, S]`` and, for decode, ``cache_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., dict]
    prefill: Callable[..., tuple[Any, Any]]
    decode_step: Callable[..., tuple[Any, Any]]
    init_caches: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    """The model API of a dense width-nested LM config."""

    def prefill(params, batch):
        out = tfm.lm_apply(params, cfg, batch["tokens"], mode="prefill")
        return out.logits, out.caches

    def decode_step(params, batch, caches):
        out = tfm.lm_apply(params, cfg, batch["tokens"], mode="decode",
                           caches=caches, cache_len=batch["cache_len"])
        return out.logits, out.caches

    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: tfm.init_lm(
            cfg, generator=generator, device=device),
        prefill=prefill,
        decode_step=decode_step,
        init_caches=lambda b, s, device=None: tfm.init_caches(
            cfg, b, s, device=device),
    )
