"""Mamba (S6) mixer, Jamba's SSM layer (port of ``repro.models.mamba``).

A selective SSM with a diagonal ``A`` and input-dependent ``delta``, ``B``
and ``C``: per layer an input projection to ``x`` and the gate ``z``, a
depthwise causal conv over the sequence (its last ``d_conv - 1`` inputs
carried as a streaming tail), the projections to ``delta`` (through a
low-rank ``dt_proj``), ``B`` and ``C``, the recurrence

    h_t = h_{t-1} * exp(delta_t A) + (delta_t x_t) B_t,    y_t = h_t C_t

over a float32 state ``h [B, d_inner, d_state]``, the skip ``D``, the
gate and the output projection.

The recurrence runs in plain PyTorch, as the reference runs it in
``lax.scan`` (no Pallas kernel).  The reference cuts the sequence into
``mamba_chunk`` chunks and pads the last one with ``delta = 0``, which
leaves ``h`` as it was (``exp(0) = 1``, zero input); here the same
recurrence is a loop over tokens.  Per chunk the elementwise factors of
every token (``exp(delta A)`` and ``delta x B``, each multiplied in the
reference's order) are formed in one go, then each token takes one
multiply and one add on ``h``, and the chunk's outputs are one product
with ``C``; every element goes through the reference's operations in
the reference's order.  Decode (one token) is one step of that loop,
carrying ``MambaState(ssm, conv)``.  Shapes depend only on the input's,
and nothing is read back to the host, so a CUDA graph can capture the
block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, rms_norm

# Parameters that stay float32 whatever ``cfg.dtype``, as the reference
# keeps them.
FLOAT32_PARAMS = ("a_log", "d_skip", "conv_b", "dt_bias")


class MambaState(NamedTuple):
    ssm: torch.Tensor       # [B, d_inner, d_state] float32
    conv: torch.Tensor      # [B, d_conv - 1, d_inner] cfg.dtype


def mamba_param_shapes(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.mamba_d_inner
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dt = cfg.mamba_dt_rank_actual
    return {
        "in_proj": (d, 2 * di),
        "conv_w": (dc, di),
        "conv_b": (di,),
        "x_proj": (di, dt + 2 * ds),
        "dt_proj": (dt, di),
        "dt_bias": (di,),
        "a_log": (di, ds),
        "d_skip": (di,),
        "out_proj": (di, d),
        "norm": (d,),
    }


def mamba_init(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device) -> dict:
    """Parameters as the reference initialises them: ``a_log = log(1..
    d_state)`` in every row (S4D-real), ``d_skip`` ones, ``conv_b`` and
    ``dt_bias`` zeros (all four float32), ``norm`` ones, the matrices and
    ``conv_w`` fan-in truncated normals from ``generator``."""
    dtype = getattr(torch, cfg.dtype)
    out = {}
    for name, shape in sorted(mamba_param_shapes(cfg).items()):
        if name == "norm":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name == "a_log":
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32,
                             device=device)
            out[name] = torch.log(a).expand(shape).contiguous()
        elif name == "d_skip":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif name in ("conv_b", "dt_bias"):
            out[name] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
        else:
            out[name] = dense_init(shape, dtype, generator, device)
    return out


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``: no threshold where it returns ``x``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along the sequence: x ``[B, S, d_inner]``,
    w ``[d_conv, d_inner]``.  ``tail`` holds the previous ``d_conv - 1``
    inputs of the stream (zeros when None); returns the output and the
    new tail, the last ``d_conv - 1`` inputs, so decode can continue the
    stream (a prompt shorter than that keeps part of the old tail)."""
    dc = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    out = 0
    for i in range(dc):
        out = out + xp[:, i:i + s, :] * w[i]
    new_tail = xp[:, xp.shape[1] - (dc - 1):, :] if dc > 1 else tail
    return out + b.to(x.dtype), new_tail


def _ssm_scan(h: torch.Tensor, delta: torch.Tensor, bu: torch.Tensor,
              cu: torch.Tensor, xu: torch.Tensor, a: torch.Tensor,
              chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over the sequence, a token at a time.  h ``[B, di,
    ds]``; delta and xu ``[B, S, di]``; bu and cu ``[B, S, ds]``; a ``[di,
    ds]``; all float32.  Per token, as the reference's step:
    ``da = exp(delta * a)``, ``h = h * da + delta * xu * bu`` (multiplied
    left to right), ``y = sum_s h * cu``.  Returns ``(h_S, y [B, S,
    di])``."""
    s = delta.shape[1]
    ys = []
    for t0 in range(0, s, chunk):
        d_ = delta[:, t0:t0 + chunk, :, None]
        da = torch.exp(d_ * a)                              # [B,c,di,ds]
        dbx = d_ * xu[:, t0:t0 + chunk, :, None] * bu[:, t0:t0 + chunk,
                                                       None, :]
        hs = []
        for t in range(da.shape[1]):
            h = h * da[:, t] + dbx[:, t]
            hs.append(h)
        ys.append(torch.einsum("bcis,bcs->bci", torch.stack(hs, dim=1),
                               cu[:, t0:t0 + chunk]))
    return h, torch.cat(ys, dim=1)


def mamba(params: dict, x: torch.Tensor, cfg: ModelConfig,
          state: MambaState | None = None
          ) -> tuple[torch.Tensor, MambaState]:
    """Pre-norm Mamba block: x ``[B, S, d]`` -> (``[B, S, d]``, new state).
    Without ``state`` the stream starts from zeros (prefill); with it
    (decode, or a prompt continued) from its SSM state and conv tail.
    Casts follow the reference's: ``dt_raw @ dt_proj`` (cfg.dtype) plus
    the float32 ``dt_bias`` is float32, ``conv_b`` and ``d_skip`` are cast
    to ``x.dtype``, the scan's output is cast back before the skip."""
    b, s, _ = x.shape
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    dt_rank = cfg.mamba_dt_rank_actual
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    xin, z = (xn @ params["in_proj"]).chunk(2, dim=-1)

    conv_tail = state.conv if state is not None else None
    xc, new_tail = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                conv_tail)
    xc = F.silu(xc)

    dt_raw, b_ssm, c_ssm = (xc @ params["x_proj"]).split(
        [dt_rank, ds, ds], dim=-1)
    delta = softplus(dt_raw @ params["dt_proj"]
                     + params["dt_bias"]).float()
    a = -torch.exp(params["a_log"])                          # [di, ds]
    h0 = state.ssm if state is not None else \
        torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    h, y = _ssm_scan(h0, delta, b_ssm.float(), c_ssm.float(), xc.float(),
                     a, min(cfg.mamba_chunk, s))

    y = y.to(x.dtype) + xc * params["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    return y @ params["out_proj"], MambaState(ssm=h, conv=new_tail)


def mamba_init_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> MambaState:
    """A zero state: the float32 SSM state and a ``cfg.dtype`` conv
    tail."""
    return MambaState(
        ssm=torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                         dtype=getattr(torch, cfg.dtype), device=device))
