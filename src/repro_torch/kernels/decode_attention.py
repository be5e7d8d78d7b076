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

* On a CUDA tensor the wrapper launches ``csrc/decode_attention.cu`` and
  adds one to ``decode_attention.launches`` per call.  :func:`decode_split_plan`
  cuts each row's live range into ``splits`` runs of 32-position tiles,
  from the shapes alone, so that the grid fills the card: with one split
  (the served shapes) that is one CUDA launch, one block per kv head and
  batch row; with more, the partials of every run go to a float32
  workspace (:func:`decode_attention_workspace_bytes`) and a second CUDA
  launch combines them, so a split call is two CUDA launches and one
  count.  A Python int ``cache_len`` travels by value with the launch (no
  host-to-device copy); an int32 ``[B]`` tensor on the card is read by
  the kernel, never by the host.
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

from repro_torch.kernels.checks import (DTYPE_CODE, check_rows, no_backward,
                                       sm_count)
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
# Split plan                                                             #
# --------------------------------------------------------------------- #
TILE = 32                # cache positions per tile (checked against the
                         # kernel's decode_attention_tile() on loading)
BLOCKS_PER_SM = 2        # the split plan aims at this many blocks per SM


def heads_per_block(g: int) -> int:
    """Query heads one block carries: ``g`` itself up to 2, else 4 (the
    launch passes it to the kernel)."""
    return g if g <= 2 else 4


def max_row_tiles(s: int, window: int | None) -> int:
    """Most ``TILE``-position tiles the live range of one row can touch:
    ``span = min(s, window)`` positions, one tile more where a window's
    range starts inside a tile."""
    full = -(-s // TILE)
    if window is None:
        return full
    return min(full, -(-min(s, window) // TILE) + 1)


def decode_split_plan(b: int, n_kv: int, g: int, s: int,
                      window: int | None, n_sm: int) -> tuple[int, int]:
    """``(splits, most tiles of one split)`` of one call, from the shapes
    alone.

    The one-split grid has ``base = b * n_kv * ceil(g / heads_per_block)``
    blocks; the plan takes ``ceil(BLOCKS_PER_SM * n_sm / base)`` splits, at
    most one per tile a row can touch, so ``base * splits`` lands at about
    ``BLOCKS_PER_SM`` blocks per SM (one wave where that many fit: 2 at
    gemma3-1b's hd 256), or at one split where ``base`` already fills the
    card or the cache is one tile.  Split ``j`` of a row whose live range
    touches ``n`` tiles takes tiles ``[j*n // splits, (j+1)*n // splits)``:
    whole tiles, ``ceil(n / splits)`` at most."""
    tiles = max(max_row_tiles(s, window), 1)
    base = b * n_kv * -(-g // heads_per_block(g))
    splits = max(1, min(tiles, -(-BLOCKS_PER_SM * n_sm // max(base, 1))))
    return splits, -(-tiles // splits)


def decode_attention_workspace_bytes(b: int, s: int, h: int, kv: int,
                                     hd: int, *, window: int | None = None,
                                     n_sm: int) -> int:
    """Bytes of the float32 workspace ``[B,h,splits,hd+2]`` one call
    allocates besides its output (0 with one split)."""
    splits, _ = decode_split_plan(b, kv, h // kv, s, window, n_sm)
    return 0 if splits == 1 else 4 * b * h * splits * (hd + 2)


# --------------------------------------------------------------------- #
# Plain versions                                                         #
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


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cache_len, *,
                                 window: int | None = None,
                                 splits: int) -> torch.Tensor:
    """The split kernel's arithmetic on whole tensors, for the tests: of
    the ``n`` tiles that a row's live range touches (counted from the tile
    holding its first live position), run ``j`` of ``splits`` takes tiles
    ``[j*n // splits, (j+1)*n // splits)`` and gives float32 partials
    ``acc``, ``m`` and ``l`` as :func:`decode_attention_plain` does over
    its positions (a run with none: ``m = -inf``, ``l = 0``); they combine
    with weights ``w_i = exp(m_i - max m)`` (0 where ``m_i = -inf``) into
    ``sum w_i acc_i / max(sum w_i l_i, 1e-30)``."""
    b, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    qg = q.reshape(b, n_kv, g, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * hd ** -0.5
    pos = torch.arange(s, device=q.device)[None, :]
    lo = (torch.zeros_like(lens) if window is None
          else (lens - window).clamp_min(0))[:, None]
    hi = lens.clamp(max=s)[:, None]
    live = (pos < hi) & (pos >= lo)
    n = torch.where(hi > lo, (hi + TILE - 1) // TILE - lo // TILE, 0)
    j = torch.arange(splits, device=q.device)[None, :, None]
    tile = (pos // TILE - lo // TILE)[:, None]                   # [b, 1, t]
    mine = live[:, None] & (tile >= j * n[:, None] // splits) \
        & (tile < (j + 1) * n[:, None] // splits)                # [b, j, t]
    x = logits[:, :, :, None].masked_fill(~mine[:, None, None],
                                          float("-inf"))         # bkgjt
    m = x.amax(dim=-1)
    p = torch.exp(x - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgjt,btkd->bkgjd", p.to(v.dtype).float(), v.float())
    w = torch.where(m == float("-inf"), 0.0,
                    torch.exp(m - m.amax(dim=-1, keepdim=True)))
    den = (w * l).sum(dim=-1).clamp_min(1e-30)
    out = (w[..., None] * acc).sum(dim=-2) / den[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


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
            _P, _I, _I, ctypes.c_float, _I, _P, _I, _I, _I, _P]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib.decode_attention_tile.restype = ctypes.c_int
        if lib.decode_attention_tile() != TILE:
            raise RuntimeError(f"decode_attention: the kernel's tiles hold "
                               f"{lib.decode_attention_tile()} positions, the "
                               f"split plan's {TILE}")
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
        g = h // n_kv
        splits, _ = decode_split_plan(b, n_kv, g, s, window, sm_count(dev))
        ws = None if splits == 1 else torch.empty(
            (b, h, splits, hd + 2), dtype=torch.float32, device=dev)
        lib = _library()
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, n_kv, hd, *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            ptr, value, window or 0, hd ** -0.5, splits,
            None if ws is None else ws.data_ptr(), heads_per_block(g),
            DTYPE_CODE[q.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
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
    CUDA tensors launch the kernel (and count the call once, though a
    split call is two CUDA launches) or raise.  Either way it raises
    while autograd would record the call
    (:func:`~repro_torch.kernels.checks.no_backward`).
    """
    no_backward("decode_attention", q, k, v)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cache_len, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    return _launch(q, k, v, cache_len, window)


decode_attention.launches = 0
