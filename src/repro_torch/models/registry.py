"""Uniform model API (port of ``repro.models.registry`` for the LM
families ported so far: ``dense``, width-nested anytime LMs and LMs
without nesting, ``moe``, ``hybrid``, ``vlm`` and the ``ssm`` family's
RWKV-6):
``build_model(cfg)`` ->

    model.init(generator=None, device=None)   -> params
    model.prefill(params, batch)              -> (logits, caches)
    model.decode_step(params, batch, caches)  -> (logits, caches)
    model.init_caches(batch_size, max_len)    -> caches

``batch`` is a dict with ``tokens [B, S]``, for decode ``cache_len``, and
for a ``vlm`` model optionally ``pos3d [3, B, S]`` (M-RoPE's position
streams; without them its attention runs plain RoPE, as text-only serving
does).
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
    """The model API of ``cfg``, on the decoder-only LM chassis of
    models/transformer.py (``ModelConfig`` refuses what the port does not
    run yet)."""

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
        prefill=prefill,
        decode_step=decode_step,
        init_caches=lambda b, s, device=None: tfm.init_caches(
            cfg, b, s, device=device),
    )
