"""Shared model primitives: RMSNorm, LayerNorm, rotary embeddings (M-RoPE
included), init (port of ``repro.models.common``).  Norm statistics and
rotary angles are float32 whatever the activation dtype, as in the
reference."""

from __future__ import annotations

import functools

import numpy as np
import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(x.float().square(), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: float32 statistics (biased variance),
    the normalised values cast back to ``x.dtype`` before ``* gamma +
    beta``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma + beta


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """``[head_dim/2]`` inverse frequencies."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_inv(head_dim: int, theta: float,
              device: torch.device) -> torch.Tensor:
    """float32 inverse frequencies on ``device``, made once (not a
    host-to-device copy per call), outside inference mode."""
    with torch.inference_mode(False):
        return torch.as_tensor(rope_freqs(head_dim, theta),
                               dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE.  x: ``[..., seq, heads, head_dim]``; positions:
    ``[..., seq]``."""
    hd = x.shape[-1]
    inv = _rope_inv(hd, theta, x.device)
    ang = positions[..., :, None].float() * inv          # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_slots(sections: tuple[int, int, int],
                 device: torch.device) -> torch.Tensor:
    """The position stream (0 = t, 1 = h, 2 = w) of each frequency slot,
    on ``device``, made once."""
    with torch.inference_mode(False):
        return torch.as_tensor(np.repeat(np.arange(3), np.asarray(sections)),
                               device=device)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191): the ``head_dim/2``
    frequency slots are cut into (temporal, height, width) ``sections``,
    and each section rotates by its own position stream.  With three equal
    streams (text) it equals :func:`apply_rope`.

    x: ``[B, S, heads, head_dim]``; positions_3d: ``[3, B, S]``."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} != head_dim/2 "
                         f"{hd // 2}")
    inv = _rope_inv(hd, theta, x.device)                 # [hd/2]
    slots = _mrope_slots(tuple(sections), x.device)      # [hd/2]
    pos = positions_3d.float()[slots]                    # [hd/2, B, S]
    ang = pos.permute(1, 2, 0) * inv                     # [B, S, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(shape: tuple[int, ...], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-3 sd) fan-in init, drawn and scaled in float32
    (in place, so the float32 draw is the only temporary) and then cast.
    On the ``meta`` device: an empty tensor of the shape and dtype, no
    draw (abstract state, as ``jax.eval_shape`` of the init)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(std).to(dtype)     # scaled in place: no second float32 copy


def embed_init(shape: tuple[int, ...], dtype: torch.dtype,
               generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """Truncated-normal (+-3) embedding init, unit scale (on ``meta``:
    empty, no draw)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.to(dtype)
