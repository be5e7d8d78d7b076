"""RWKV-6 recurrence: the CUDA kernel and its plain PyTorch version.

:func:`rwkv_scan` is the port of ``repro.kernels.rwkv_scan``
(``rwkv_scan`` -> ``_kernel`` -> ``pl.pallas_call``).  Per batch row and
head, with a float32 ``[hd, hd]`` state ``S`` that starts at ``s0``::

    y_t = r_t . (S + (u * k_t) v_t^T);    S <- diag(w_t) S + k_t v_t^T

``r/k/v/w [B,S,H,hd]`` are in one dtype (float32 or bf16) and read as
float32; ``u [H,hd]`` and ``s0 [B,H,hd,hd]`` are float32.  It returns
``y [B,S,H,hd]`` in ``r``'s dtype and the final state ``[B,H,hd,hd]`` in
float32.  Any ``S >= 1`` is taken: the Pallas kernel's ``chunk`` is its
own staging detail (its result does not depend on it), so there is none
here.

* On a CUDA tensor the wrapper launches ``csrc/rwkv_scan.cu`` (one block
  per batch row and head, one thread per state column; see the source)
  and adds one to ``rwkv_scan.launches``.
* On a CPU tensor it runs :func:`rwkv_scan_plain`.

There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.checks import DTYPE_CODE, check_rows

HEAD_DIMS = (16, 32, 64)


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        shapes = [tuple(t.shape) for t in (r, k, v, w)]
        raise ValueError(f"rwkv_scan: needs r, k, v, w [B,S,H,hd] of one "
                         f"shape; got {shapes}")
    b, s, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv_scan: head_dim {hd} not in {HEAD_DIMS}")
    if s < 1:
        raise ValueError("rwkv_scan: needs at least one token")
    if u.shape != (h, hd) or s0.shape != (b, h, hd, hd):
        raise ValueError(f"rwkv_scan: needs u [H,hd] = {(h, hd)} and s0 "
                         f"[B,H,hd,hd] = {(b, h, hd, hd)}; got u "
                         f"{tuple(u.shape)}, s0 {tuple(s0.shape)}")
    if u.dtype != torch.float32 or s0.dtype != torch.float32:
        raise ValueError(f"rwkv_scan: u and s0 must be float32, not "
                         f"{u.dtype} and {s0.dtype}")
    check_rows("rwkv_scan", r, k, v, w)
    if u.device != r.device or s0.device != r.device:
        raise ValueError("rwkv_scan: all inputs on one device")


def rwkv_scan_cost(b: int, s: int, h: int, hd: int, itemsize: int) -> dict:
    """Work of one call for the bound.  Per token and head: ``r^T S``
    (``2 hd^2`` flops), ``r . (u * k)`` and its ``v`` term (``4 hd``),
    ``diag(w) S + k v^T`` (``3 hd^2``: a multiply for ``k_i v_j``, a
    multiply-add).  Bytes: r, k, v, w and y at ``itemsize`` each, u, s0
    and the final state in float32, each moved once."""
    tokens = b * s * h
    return {"flops": float(tokens * (5 * hd * hd + 4 * hd)),
            "bytes_accessed": float(5 * tokens * hd * itemsize
                                    + 4 * h * hd + 2 * 4 * b * h * hd * hd)}


# --------------------------------------------------------------------- #
# Plain version                                                          #
# --------------------------------------------------------------------- #
def rwkv_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor,
                    s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``ref.rwkv_scan_ref``'s loop over tokens, in float32: at ``S == 1``
    the reference model's inline decode step."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., :, None]                           # [H, hd, 1]
    state = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # [B,H,hd,hd]
        ys.append(torch.matmul(rf[:, t, :, None, :],
                               state + uf * kv)[..., 0, :])
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


# --------------------------------------------------------------------- #
# CUDA kernel                                                            #
# --------------------------------------------------------------------- #
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _library():
    """The built kernel library with its C signatures declared."""
    from repro_torch.kernels.build import load

    lib = load("rwkv_scan")
    if not getattr(lib, "_rwkv_scan_typed", False):
        lib.rwkv_scan_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _P]
        lib.rwkv_scan_launch.restype = ctypes.c_int
        lib.rwkv_scan_error_string.argtypes = [ctypes.c_int]
        lib.rwkv_scan_error_string.restype = ctypes.c_char_p
        lib._rwkv_scan_typed = True
    return lib


def _launch(r, k, v, w, u, s0):
    b, s, h, hd = r.shape
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=r.device)
    s_final = torch.empty((b, h, hd, hd), dtype=torch.float32,
                          device=r.device)
    u, s0 = u.contiguous(), s0.contiguous()
    if b and h:
        lib = _library()
        dev = r.device
        rc = lib.rwkv_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            b, s, h, hd, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], DTYPE_CODE[r.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.rwkv_scan_error_string(rc).decode()
            raise RuntimeError(f"rwkv_scan launch failed: CUDA error {rc} "
                               f"({msg})")
        rwkv_scan.launches += 1
    return y, s_final


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``r/k/v/w [B,S,H,hd]``, ``u [H,hd]``, ``s0 [B,H,hd,hd]`` ->
    ``(y [B,S,H,hd], s_final [B,H,hd,hd] float32)``.

    r, k, v and w are read through their strides (unit stride on ``hd``,
    16-byte aligned rows), so views of ``[B,S,H*hd]`` work.  CPU tensors
    run :func:`rwkv_scan_plain`; CUDA tensors launch the kernel (and count
    the launch) or raise.
    """
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv_scan_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv_scan runs on CUDA or CPU tensors, not "
                         f"{r.device}")
    return _launch(r, k, v, w, u, s0)


rwkv_scan.launches = 0
