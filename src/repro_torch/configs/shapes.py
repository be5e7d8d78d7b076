"""The assigned input-shape sets and ``input_specs`` (port of
``repro.configs.shapes``): ``meta`` tensors stand in for the batch, so
nothing is allocated (the counterpart of the reference's
``ShapeDtypeStruct``s).

LM shapes (applied to all 10 archs):
    train_4k     seq_len=4096,   global_batch=256   (training)
    prefill_32k  seq_len=32768,  global_batch=32    (inference-prefill)
    decode_32k   seq_len=32768,  global_batch=128   (inference-decode)
    long_500k    seq_len=524288, global_batch=1     (long-context-decode)

``decode_*``/``long_*`` run one new token against a cache of seq_len.
``long_500k`` needs sub-quadratic attention: it is skipped for pure
full-attention archs (see ``cell_supported``) and run for ssm, hybrid and
local-window archs.

Tokens and labels take the port's index dtype, int64 (``torch.long``,
what the serving engine feeds the embedding), where the reference's are
int32; ``pos3d`` and ``cache_len`` stay int32, as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k: sub-quadratic sequence mixing.
_LONG_OK_FAMILIES = ("ssm", "hybrid")
TOKEN_DTYPE = torch.int64
_POS_DTYPE = torch.int32


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not).  The 40-cell grid minus documented skips."""
    if shape.name == "long_500k":
        if cfg.family in _LONG_OK_FAMILIES:
            return True, ""
        if cfg.sliding_window and cfg.global_every:
            # gemma3: 5/6 of layers are windowed; decode cost is dominated
            # by the local layers -> sub-quadratic-dominant, runs.
            return True, ""
        return False, ("long_500k skipped: pure full-attention arch "
                       "(quadratic prefill / O(S) KV per token); see "
                       "DESIGN.md 'Arch-applicability'")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch of (cfg, shape) as ``meta`` tensors.

    train:   {tokens, labels [B,S]} (+pos3d [3,B,S] for vlm, +frames
             [B,S,d] for encdec)
    prefill: {tokens [B,S]} (+pos3d/frames)
    decode:  {tokens [B,1], cache_len []} (+pos3d [3,B,1]); the caches
             come from ``cache_specs``.
    """
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": spec((b, s), TOKEN_DTYPE)}
        if shape.kind == "train":
            batch["labels"] = spec((b, s), TOKEN_DTYPE)
        if cfg.m_rope:
            batch["pos3d"] = spec((3, b, s), _POS_DTYPE)
        if cfg.encoder_layers:
            batch["frames"] = spec((b, s, cfg.d_model), act)
        return batch
    batch = {"tokens": spec((b, 1), TOKEN_DTYPE),
             "cache_len": spec((), _POS_DTYPE)}
    if cfg.m_rope:
        batch["pos3d"] = spec((3, b, 1), _POS_DTYPE)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, model) -> dict:
    """The serve-time caches (KV buffers, SSM states) sized to the shape's
    sequence length, on ``meta``."""
    return model.init_caches(shape.global_batch, shape.seq_len,
                             device="meta")
