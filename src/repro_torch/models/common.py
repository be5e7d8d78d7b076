"""Shared model primitives: RMSNorm, rotary embeddings, init (port of
``repro.models.common``).  Norm statistics and rotary angles are float32
whatever the activation dtype, as in the reference."""

from __future__ import annotations

import functools

import numpy as np
import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(x.float().square(), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


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


def dense_init(shape: tuple[int, ...], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-3 sd) fan-in init, drawn in float32."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(dtype)


def embed_init(shape: tuple[int, ...], dtype: torch.dtype,
               generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """Truncated-normal (+-3) embedding init, unit scale."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.to(dtype)
