"""RWKV-6 "Finch" (arXiv:2404.05892) mixer and channel-mix FFN (port of
``repro.models.rwkv``).

Time mixing, per head of ``rwkv_head_dim``::

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with the data-dependent decay ``w_t = exp(-exp(w0 + tanh(x_w A) B))``.
:func:`rwkv_time_mix` picks the recurrence by its ``mode``:

* ``"train"`` runs :func:`_wkv_chunk_scan`, the reference's training
  recurrence: a token loop in plain PyTorch over chunks of
  ``cfg.rwkv_chunk`` tokens, each chunk recomputed in the backward pass
  while autograd records (``rwkv_scan`` has no backward, nor has the
  reference's Pallas kernel);
* every other mode (a prefill, a decode step) runs
  :func:`repro_torch.kernels.rwkv_scan.rwkv_scan`, the one-token decode
  step included: on the card one kernel launch per layer and forward pass,
  on the CPU its plain version, whose arithmetic the chunk scan repeats
  op for op.  The reference prefills through its chunk scan too (its
  model never calls its kernel); the port serves on its kernel.

r, k, v and w go in as float32, as in the reference.  ``ln_x`` is a
LayerNorm over the whole ``d_model``, as the reference writes it (RWKV-6
itself uses a per-head GroupNorm).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.models.common import dense_init, layer_norm, rms_norm


class RwkvState(NamedTuple):
    wkv: torch.Tensor      # [B, heads, head_dim, head_dim] float32
    shift_t: torch.Tensor  # [B, d] last normed input of the time mix
    shift_c: torch.Tensor  # [B, d] last normed input of the channel mix


def rwkv_param_shapes(cfg: ModelConfig) -> dict:
    d, lora = cfg.d_model, cfg.rwkv_decay_lora
    return {
        "mu_r": (d,), "mu_k": (d,), "mu_v": (d,), "mu_g": (d,), "mu_w": (d,),
        "w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
        "w_o": (d, d),
        "decay_w0": (d,), "decay_a": (d, lora), "decay_b": (lora, d),
        "bonus_u": (d,),
        "ln_x_g": (d,), "ln_x_b": (d,),
        "norm": (d,),
        # channel mix
        "cmix_mu_k": (d,), "cmix_mu_r": (d,),
        "cmix_wk": (d, cfg.d_ff), "cmix_wv": (cfg.d_ff, d), "cmix_wr": (d, d),
        "cmix_norm": (d,),
    }


def rwkv_init(cfg: ModelConfig, generator: torch.Generator,
              device: torch.device) -> dict:
    """The reference's init rules: norms and ``ln_x_g`` ones, token-shift
    mixes 0.5, ``decay_w0`` -1 and ``bonus_u`` 0 in float32, ``ln_x_b``
    0, matrices fan-in truncated normal (drawn in sorted name order)."""
    dtype = getattr(torch, cfg.dtype)
    out = {}
    for name, shape in sorted(rwkv_param_shapes(cfg).items()):
        if name in ("norm", "cmix_norm", "ln_x_g"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name.startswith("mu_") or name.startswith("cmix_mu"):
            out[name] = torch.full(shape, 0.5, dtype=dtype, device=device)
        elif name == "decay_w0":
            out[name] = torch.full(shape, -1.0, dtype=torch.float32,
                                   device=device)
        elif name in ("bonus_u", "ln_x_b"):
            out[name] = torch.zeros(shape, dtype=torch.float32
                                    if name == "bonus_u" else dtype,
                                    device=device)
        else:
            out[name] = dense_init(shape, dtype, generator, device)
    return out


def _token_shift(x: torch.Tensor, mu: torch.Tensor,
                 prev: torch.Tensor | None) -> torch.Tensor:
    """lerp(x_{t-1}, x_t, mu); ``prev [B,d]`` is the streaming tail (zeros
    when None)."""
    if prev is None:
        prev_seq = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev_seq = torch.cat([prev[:, None, :], x[:, :-1]], dim=1)
    return mu * x + (1.0 - mu) * prev_seq


def _wkv_chunk(state, r, k, v, w, u):
    """One chunk of the recurrence, token by token in float32: ``kv = k
    v^T``, ``y = r . (S + u * kv)``, ``S = diag(w) S + kv`` (the reference's
    ``inner``).  Returns ``(state, y [B,chunk,h,hd])``."""
    uf = u[..., :, None]                                   # [h, hd, 1]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # [B,h,hd,hd]
        ys.append(torch.matmul(r[:, t, :, None, :],
                               state + uf * kv)[..., 0, :])
        state = w[:, t, :, :, None] * state + kv
    return state, torch.stack(ys, dim=1)


def _wkv_chunk_scan(s0: torch.Tensor, r, k, v, w, u: torch.Tensor,
                    chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_wkv_chunk_scan``: ``r/k/v/w [B,S,h,hd]`` float32,
    ``s0 [B,h,hd,hd]``, ``u [h,hd]`` -> ``(sN, y [B,S,h,hd])``.  The
    sequence is padded to whole chunks with ``k = 0`` (adds nothing to the
    state) and ``w = 1`` (leaves its decay alone); each chunk runs under
    :func:`torch.utils.checkpoint.checkpoint` while autograd records (the
    reference's ``jax.checkpoint`` around ``outer``), so the backward pass
    keeps one state a chunk and recomputes the chunk's tokens."""
    s = r.shape[1]
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    state, ys = s0, []
    for c in range(n_chunks):
        xs = [t[:, c * chunk:(c + 1) * chunk] for t in (r, k, v, w)]
        if torch.is_grad_enabled():
            state, y = checkpoint(_wkv_chunk, state, *xs, u,
                                  use_reentrant=False)
        else:
            state, y = _wkv_chunk(state, *xs, u)
        ys.append(y)
    return state, torch.cat(ys, dim=1)[:, :s]


def rwkv_time_mix(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: RwkvState | None = None, mode: str = "prefill"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(out [B,S,d], new wkv state, new shift tail)``; ``mode
    == "train"`` runs the chunk scan, any other mode ``rwkv_scan``."""
    b, s, d = x.shape
    h, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    prev = state.shift_t if state is not None else None

    xr = _token_shift(xn, params["mu_r"], prev)
    xk = _token_shift(xn, params["mu_k"], prev)
    xv = _token_shift(xn, params["mu_v"], prev)
    xg = _token_shift(xn, params["mu_g"], prev)
    xw = _token_shift(xn, params["mu_w"], prev)

    r = (xr @ params["w_r"]).reshape(b, s, h, hd)
    k = (xk @ params["w_k"]).reshape(b, s, h, hd)
    v = (xv @ params["w_v"]).reshape(b, s, h, hd)
    g = F.silu(xg @ params["w_g"])
    decay_raw = params["decay_w0"] + \
        torch.tanh(xw @ params["decay_a"]) @ params["decay_b"]
    w = torch.exp(-torch.exp(decay_raw.float()))            # in (0, 1)
    w = w.reshape(b, s, h, hd)

    u = params["bonus_u"].reshape(h, hd).float()
    s0 = state.wkv if state is not None else \
        torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)

    if mode == "train":
        s_n, y = _wkv_chunk_scan(s0, r.float(), k.float(), v.float(), w, u,
                                 min(cfg.rwkv_chunk, s))
    else:
        y, s_n = rwkv_scan(r.float(), k.float(), v.float(), w, u, s0)

    y = y.reshape(b * s, d).to(x.dtype)
    y = layer_norm(y, params["ln_x_g"], params["ln_x_b"]).reshape(b, s, d)
    out = (y * g) @ params["w_o"]
    return out, s_n, xn[:, -1, :]


def rwkv_channel_mix(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     state: RwkvState | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV FFN.  Returns ``(out, new channel shift tail)``."""
    xn = rms_norm(x, params["cmix_norm"], cfg.norm_eps)
    prev = state.shift_c if state is not None else None
    xk = _token_shift(xn, params["cmix_mu_k"], prev)
    xr = _token_shift(xn, params["cmix_mu_r"], prev)
    k = torch.square(torch.relu(xk @ params["cmix_wk"]))
    out = torch.sigmoid(xr @ params["cmix_wr"]) * (k @ params["cmix_wv"])
    return out, xn[:, -1, :]


def rwkv_init_state(cfg: ModelConfig, batch: int,
                    device: torch.device) -> RwkvState:
    dtype = getattr(torch, cfg.dtype)
    h, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    return RwkvState(
        wkv=torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                        device=device),
        shift_t=torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),
        shift_c=torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device))
