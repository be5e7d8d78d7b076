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

* On a CUDA tensor the wrapper launches ``csrc/rwkv_scan.cu`` v3 (the
  state held in registers as a 16-row by 4-column tile a thread; each
  sequence cut into the segments of :func:`rwkv_scan_plan`, see the
  source; a one-token call, the decode step, has a kernel of its own)
  and adds one to ``rwkv_scan.launches`` per call, whatever the
  segments.
* On a CPU tensor it runs :func:`rwkv_scan_plain`.

:func:`rwkv_scan_segments_plain` carries out the split kernel's three
steps in torch, for the tests.  There is no fallback: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.checks import (DTYPE_CODE, check_rows, no_backward,
                                       sm_count)

HEAD_DIMS = (16, 32, 64)
# The split plan's target: blocks of one wave per SM (a v3 block holds at
# most 33 KB of shared memory, so 6 fit on an H100 SM), and the shortest
# segment worth a second pass and two more launches.
BLOCKS_PER_SM = 4
MIN_SEGMENT = 64


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


def rwkv_scan_plan(b: int, s: int, h: int, n_sm: int) -> int:
    """Segments per ``(b, h)`` sequence of one call, from the shapes alone
    (no device read, so calls stay capturable in CUDA graphs).

    One block runs one segment; the plan takes ``ceil(BLOCKS_PER_SM *
    n_sm / (b * h))`` segments, so the states pass and the y pass each
    land at about ``BLOCKS_PER_SM`` blocks per SM, but no segment shorter
    than ``MIN_SEGMENT`` tokens: 1 where ``b * h`` already fills the card
    or the sequence is short (the served prefill and decode steps)."""
    base = max(b * h, 1)
    want = -(-BLOCKS_PER_SM * n_sm // base)
    return max(1, min(want, s // MIN_SEGMENT))


def segment_bounds(s: int, segments: int) -> list[tuple[int, int]]:
    """Token range ``[p*s // P, (p+1)*s // P)`` of each segment ``p``: the
    kernel's cut (segments differ by at most one token; with ``s < P``
    some are empty, never the last)."""
    return [(p * s // segments, (p + 1) * s // segments)
            for p in range(segments)]


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


def rwkv_scan_segments_plain(r, k, v, w, u, s0, segments: int):
    """The split kernel's three steps in torch, for the tests: (1) every
    segment but the last runs the recurrence from a zero state (the first
    from ``s0``), giving its end state ``A_p`` and its row decay ``D_p =
    prod_t w_t`` (token order); (2) the start states fold in segment order,
    ``S_{p+1} = diag(D_p) S_p + A_p``; (3) every segment runs from its start
    state, giving its ``y``, and the last the final state."""
    if segments < 1:
        raise ValueError(f"rwkv_scan: segments must be >= 1, not {segments}")
    bounds = segment_bounds(r.shape[1], segments)

    def run(state, t0, t1):
        if t0 == t1:
            return r[:, :0].clone(), state
        return rwkv_scan_plain(*(x[:, t0:t1] for x in (r, k, v, w)), u,
                               state)

    zero = torch.zeros_like(s0, dtype=torch.float32)
    starts = [s0.float()]
    for p, (t0, t1) in enumerate(bounds[:-1]):
        _, end = run(starts[0] if p == 0 else zero, t0, t1)
        if p == 0:
            starts.append(end)
            continue
        decay = torch.ones_like(end[..., 0])
        for t in range(t0, t1):
            decay = decay * w[:, t].float()
        starts.append(decay[..., None] * starts[p] + end)
    ys, state = [], None
    for p, (t0, t1) in enumerate(bounds):
        y_p, state = run(starts[p], t0, t1)
        ys.append(y_p)
    return torch.cat(ys, dim=1), state


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
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _P]
        lib.rwkv_scan_launch.restype = ctypes.c_int
        lib.rwkv_scan_error_string.argtypes = [ctypes.c_int]
        lib.rwkv_scan_error_string.restype = ctypes.c_char_p
        lib._rwkv_scan_typed = True
    return lib


def _launch(r, k, v, w, u, s0):
    b, s, h, hd = r.shape
    dev = r.device
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=dev)
    s_final = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    u, s0 = u.contiguous(), s0.contiguous()
    if s0.data_ptr() % 16:  # the tile reads s0 with 16-byte loads
        s0 = s0.clone()
    if not (b and h):
        return y, s_final
    segments = rwkv_scan_plan(b, s, h, sm_count(dev))
    ws_state = ws_decay = 0
    if segments > 1:
        n = (segments - 1) * b * h * hd
        ws = torch.empty(n * (hd + 1), dtype=torch.float32, device=dev)
        ws_state, ws_decay = ws.data_ptr(), ws[n * hd:].data_ptr()
    lib = _library()
    rc = lib.rwkv_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
        ws_state, ws_decay, b, s, h, hd, segments, *r.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        DTYPE_CODE[r.dtype], dev.index, torch.cuda.current_stream(
            dev).cuda_stream)
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
    run :func:`rwkv_scan_plain`; CUDA tensors launch the kernel in the
    segments of :func:`rwkv_scan_plan` (one to three kernels, counted as
    one launch) or raise.  Either way it raises while autograd would
    record the call (:func:`~repro_torch.kernels.checks.no_backward`).
    """
    no_backward("rwkv_scan", r, k, v, w, u, s0)
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv_scan_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv_scan runs on CUDA or CPU tensors, not "
                         f"{r.device}")
    return _launch(r, k, v, w, u, s0)


rwkv_scan.launches = 0
