"""Plain float32 building blocks shared by the reference model families.

Every function works on float32 tensors with TF32 switched off (see
:func:`exact_matmuls`), so the reference computes in the precision it
states.  ``q8`` rounds a tensor to float8 e4m3 with one scale per row or
column and back: the control's lower precision.  Nothing here imports the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

E4M3_MAX = 448.0


def exact_matmuls() -> None:
    """Switch TF32 off for float32 products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, control: bool) -> torch.Tensor:
    """``x @ w``; under ``control`` the rows of ``x`` go through
    :func:`q8` first (``w`` arrives already rounded, per column)."""
    return (q8(x, -1) if control else x) @ w


def stripe_bounds(total: int, levels: int) -> list[int]:
    """Cumulative widths of the paper's power-of-2 nesting levels."""
    denom = 2 ** (levels - 1)
    if total % denom:
        raise ValueError(f"{total} is not divisible by {denom}")
    return [0] + [total * 2 ** (k - 1) // denom for k in range(1, levels + 1)]


def head_bounds(n_heads: int, head_dim: int, levels: int) -> list[int]:
    """Stripes of a head dimension: power-of-2 when the heads divide into
    the levels, otherwise every head in level 1."""
    total = n_heads * head_dim
    if n_heads % 2 ** (levels - 1) == 0:
        return stripe_bounds(total, levels)
    return [0] + [total] * levels


def rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``1 / rms(x)`` over the last axis."""
    return torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on ``x [..., L, heads, hd]`` at positions
    ``0..L-1``, the two halves of each head rotated together."""
    hd, length = x.shape[-1], x.shape[-3]
    inv = torch.as_tensor(1.0 / theta ** (np.arange(0, hd, 2) / hd),
                          dtype=torch.float32, device=x.device)
    ang = torch.arange(length, device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention of ``q [B, L, h, hd]`` over ``k, v [B, L,
    kv, hd]`` (``h / kv`` query heads share a key head)."""
    b, length, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, length, kv, h // kv, hd)
    s = torch.einsum("blkgd,btkd->bkglt", qg, k) * hd ** -0.5
    mask = torch.ones(length, length, dtype=torch.bool,
                      device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bkglt,btkd->blkgd", p, v).reshape(b, length, h, hd)


def teacher_forced(prompt: np.ndarray, tokens: np.ndarray) -> np.ndarray:
    """The sequence a served input ran over: its prompt, then every served
    token but the last.  The logits at positions ``S0-1 .. S0+n-2`` are
    the ones that chose the ``n`` served tokens."""
    return np.concatenate([prompt, tokens[:, :-1]], axis=1)


def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each chosen token's
    logit lies, in logits (0 where the chosen token is the best)."""
    return logits.amax(dim=-1) - logits.gather(-1, chosen[..., None])[..., 0]


def group_inputs(inputs) -> dict:
    """Served inputs grouped by (level, prompt length, tokens served),
    so that each group runs as one stacked batch."""
    groups: dict = {}
    for n, (prompt, toks, level) in enumerate(inputs):
        groups.setdefault((level, prompt.shape[1], toks.shape[1]),
                          []).append(n)
    return groups
