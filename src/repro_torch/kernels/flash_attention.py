"""Streaming-softmax (flash) prefill attention: the CUDA kernel and its
plain PyTorch version.

:func:`flash_attention` is the port of ``repro.kernels.flash_attention``
(``flash_attention`` -> ``_kernel`` -> ``pl.pallas_call``): ``q [B,S,h,hd]``
over ``k/v [B,T,kv,hd]``, query head ``i`` reading kv head
``i // (h/kv)`` (GQA/MQA), optional causal and sliding-window masks on
index positions, an optional tanh softcap on the logits.  Logits are
float32 scaled by ``hd**-0.5``; the softmax keeps float32 ``m``/``l`` and
accumulator; ``p`` is cast to ``v``'s dtype before the PV product and the
denominator is clamped at ``1e-30``.  The output is ``[B,S,h,hd]`` in
``q``'s dtype.

* On a CUDA tensor the wrapper launches ``csrc/flash_attention.cu`` (one
  block per batch row, query head and 64-row query tile; see the source)
  and adds one to ``flash_attention.launches``.
* On a CPU tensor it runs :func:`flash_attention_plain`.

There is no fallback: a CUDA tensor launches the kernel or raises.  A row
with no live key (possible only without the causal mask) comes out 0
from both; the Pallas kernel gives it a mean of ``v`` instead (its ``m``
starts at ``-1e30``, not at minus infinity).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.checks import DTYPE_CODE, check_rows, no_backward

MAX_HEAD_DIM = 256


def check_head_dim(hd: int, name: str) -> None:
    """Both attention kernels take head dims that are multiples of 8 up
    to 256."""
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of 8 in "
                         f"8..{MAX_HEAD_DIM}")


def _check(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: needs q [B,S,h,hd] and k, v "
                         f"[B,T,kv,hd]; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError("flash_attention: GQA needs n_q_heads % "
                         "n_kv_heads == 0")
    check_head_dim(q.shape[3], "flash_attention")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")
    check_rows("flash_attention", q, k, v)


def live_mask(s: int, t: int, causal: bool, window: int | None,
              device) -> torch.Tensor:
    """``[S, T]`` bool: which (query, key) index pairs the masks keep."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    return mask


def flash_attention_cost(b: int, s: int, t: int, h: int, kv: int, hd: int,
                         dtype: torch.dtype, *, causal: bool = True,
                         window: int | None = None) -> dict:
    """Work of one call for the bound: ``4 * B * h * hd`` flops per live
    (query, key) pair (QK^T and PV, a multiply and an add each), and the
    bytes of q, k, v and the output, each moved once."""
    live = int(live_mask(s, t, causal, window, "cpu").sum())
    item = torch.empty((), dtype=dtype).element_size()
    return {"flops": float(4 * b * h * hd * live),
            "bytes_accessed": float(item * (2 * b * s * h * hd
                                            + 2 * b * t * kv * hd)),
            "live_pairs": live}


# --------------------------------------------------------------------- #
# Plain version                                                          #
# --------------------------------------------------------------------- #
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softcap: float | None = None) -> torch.Tensor:
    """The kernel's arithmetic on whole tensors: float32 logits, masked
    entries at minus infinity, ``p = exp(logits - rowmax)`` cast to
    ``v.dtype`` for the PV product, divided by ``max(sum p, 1e-30)``."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    qg = q.reshape(b, s, n_kv, g, hd).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~live_mask(s, t, causal, window, q.device),
                                float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1).clamp_min(1e-30)                     # [b,k,g,s]
    acc = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(),
                       v.float())
    out = acc / denom[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


# --------------------------------------------------------------------- #
# CUDA kernel                                                            #
# --------------------------------------------------------------------- #
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _library():
    """The built kernel library with its C signatures declared."""
    from repro_torch.kernels.build import load

    lib = load("flash_attention")
    if not getattr(lib, "_flash_attention_typed", False):
        lib.flash_attention_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _L, _L, _L,
            _I, _I, ctypes.c_float, ctypes.c_float, _I, _I, _P]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._flash_attention_typed = True
    return lib


def _launch(q, k, v, causal, window, softcap):
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if b and s and h:
        lib = _library()
        dev = q.device
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, n_kv, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), window or 0, softcap or 0.0,
            hd ** -0.5, DTYPE_CODE[q.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.flash_attention_error_string(rc).decode()
            raise RuntimeError(f"flash_attention launch failed: CUDA error "
                               f"{rc} ({msg})")
        flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """``q [B,S,h,hd]`` over ``k/v [B,T,kv,hd]`` -> ``[B,S,h,hd]``.

    The inputs are read through their strides (unit stride on ``hd``,
    16-byte aligned rows).  CPU tensors run :func:`flash_attention_plain`;
    CUDA tensors launch the kernel (and count the launch) or raise.
    Either way it raises while autograd would record the call
    (:func:`~repro_torch.kernels.checks.no_backward`).
    """
    no_backward("flash_attention", q, k, v)
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    return _launch(q, k, v, causal, window, softcap)


flash_attention.launches = 0
