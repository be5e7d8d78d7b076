"""Single-position decode attention over a KV cache: the CUDA kernel and
its plain PyTorch version.

:func:`decode_attention` is the port of ``repro.kernels.decode_attention``
(``decode_attention`` -> ``_kernel`` -> ``pl.pallas_call``): one query
position ``q [B,h,hd]`` over a cache ``k/v [B,S,kv,hd]`` whose positions
``< cache_len`` are live (and, with ``window``, only those
``>= cache_len - window``); ``cache_len`` is a scalar or per-row ``[B]``.
The ``g = h/kv`` query heads of a kv head share its cache.  float32
logits scaled by ``hd**-0.5``, float32 streaming softmax, ``p`` cast to
``v``'s dtype before the PV product, denominator clamped at ``1e-30``;
the output is ``[B,h,hd]`` in ``q``'s dtype.

* On a CUDA tensor the wrapper launches ``csrc/decode_attention.cu`` (one
  block per kv head and batch row, see the source) and adds one to
  ``decode_attention.launches``.  A Python int ``cache_len`` travels by
  value with the launch (no host-to-device copy); an int32 ``[B]`` tensor
  on the card is read by the kernel.
* On a CPU tensor it runs :func:`decode_attention_plain`.

There is no fallback: a CUDA tensor launches the kernel or raises.  Like
the Pallas kernel it has no logit softcap.  A row with no live position
comes out 0 (the Pallas kernel gives a mean of ``v``).
"""

from __future__ import annotations

import ctypes
import numbers

import numpy as np
import torch

from repro_torch.kernels.checks import DTYPE_CODE, check_rows
from repro_torch.kernels.flash_attention import check_head_dim


def _check(q, k, v, window) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[3]:
        raise ValueError(f"decode_attention: needs q [B,h,hd] and k, v "
                         f"[B,S,kv,hd]; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[1] % k.shape[2]:
        raise ValueError("decode_attention: GQA needs n_q_heads % "
                         "n_kv_heads == 0")
    check_head_dim(q.shape[2], "decode_attention")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    check_rows("decode_attention", q, k, v)


def _live_lengths(cache_len, b: int, s: int,
                 window: int | None) -> np.ndarray:
    """Live cache positions of each batch row, on the host."""
    lens = np.broadcast_to(np.asarray(
        cache_len.cpu() if isinstance(cache_len, torch.Tensor)
        else cache_len, dtype=np.int64).reshape(-1), (b,))
    hi = np.minimum(lens, s)
    lo = np.zeros_like(lens) if window is None else np.maximum(lens - window,
                                                               0)
    return np.maximum(hi - lo, 0)


def decode_attention_cost(b: int, s: int, h: int, kv: int, hd: int,
                          dtype: torch.dtype, cache_len,
                          window: int | None = None) -> dict:
    """Work of one call for the bound: ``4 * h * hd`` flops per live cache
    position of a row (QK and PV), and the bytes of q, the output and the
    live k and v rows, each moved once (dead positions are not read)."""
    live = int(_live_lengths(cache_len, b, s, window).sum())
    item = torch.empty((), dtype=dtype).element_size()
    return {"flops": float(4 * h * hd * live),
            "bytes_accessed": float(item * (2 * b * h * hd
                                            + 2 * kv * hd * live)),
            "live_positions": live}


# --------------------------------------------------------------------- #
# Plain version                                                          #
# --------------------------------------------------------------------- #
def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cache_len, *,
                           window: int | None = None) -> torch.Tensor:
    """The kernel's arithmetic on whole tensors: float32 logits, dead
    positions at minus infinity, ``p = exp(logits - max)`` cast to
    ``v.dtype`` for the PV product, divided by ``max(sum p, 1e-30)``."""
    b, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    qg = q.reshape(b, n_kv, g, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * hd ** -0.5
    pos = torch.arange(s, device=q.device)[None, :]
    live = pos < lens[:, None]
    if window is not None:
        live = live & (pos >= lens[:, None] - window)
    logits = logits.masked_fill(~live[:, None, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return (acc / denom).reshape(b, h, hd).to(q.dtype)


# --------------------------------------------------------------------- #
# CUDA kernel                                                            #
# --------------------------------------------------------------------- #
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _library():
    """The built kernel library with its C signatures declared."""
    from repro_torch.kernels.build import load

    lib = load("decode_attention")
    if not getattr(lib, "_decode_attention_typed", False):
        lib.decode_attention_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _L, _L,
            _P, _I, _I, ctypes.c_float, _I, _I, _P]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._decode_attention_typed = True
    return lib


def _lengths(cache_len, b: int, dev: torch.device):
    """(device pointer or None, value, array or None): a Python int
    travels by value, a tensor as an int32 ``[B]`` array on the card."""
    if isinstance(cache_len, numbers.Integral):
        if not -2 ** 31 <= cache_len < 2 ** 31:
            raise ValueError(f"decode_attention: cache_len {cache_len} "
                             f"outside the int32 range")
        return None, int(cache_len), None
    if not isinstance(cache_len, torch.Tensor) or cache_len.device != dev \
            or cache_len.dtype.is_floating_point or cache_len.is_complex() \
            or cache_len.numel() not in (1, b):
        raise ValueError(f"decode_attention: cache_len must be an int or an "
                         f"integer tensor of 1 or B={b} values on {dev}; got "
                         f"{cache_len!r}")
    lens = cache_len.reshape(-1).to(torch.int32).expand(b).contiguous()
    return lens.data_ptr(), 0, lens


def _launch(q, k, v, cache_len, window):
    b, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    dev = q.device
    ptr, value, lens = _lengths(cache_len, b, dev)  # lens: ptr's array
    out = torch.empty((b, h, hd), dtype=q.dtype, device=dev)
    if b:
        lib = _library()
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, n_kv, hd, *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            ptr, value, window or 0, hd ** -0.5, DTYPE_CODE[q.dtype],
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.decode_attention_error_string(rc).decode()
            raise RuntimeError(f"decode_attention launch failed: CUDA error "
                               f"{rc} ({msg})")
        decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len, *, window: int | None = None) -> torch.Tensor:
    """``q [B,h,hd]`` over the cache ``k/v [B,S,kv,hd]`` -> ``[B,h,hd]``.

    ``cache_len`` is an int or an integer tensor of ``1`` or ``B`` values.
    The inputs are read through their strides (unit stride on ``hd``,
    16-byte aligned rows).  CPU tensors run :func:`decode_attention_plain`;
    CUDA tensors launch the kernel (and count the launch) or raise.
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cache_len, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    return _launch(q, k, v, cache_len, window)


decode_attention.launches = 0
