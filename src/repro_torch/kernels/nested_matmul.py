"""Block-lower-triangular nested matmul: the CUDA kernel and its plain
PyTorch version (paper Section 4.2.1, width nesting).

:func:`nested_matmul` is the port of ``repro.kernels.nested_matmul``
(``nested_matmul`` -> ``_kernel`` -> ``pl.pallas_call``): ``x [M, K_in] @
w [K_in, N]`` where output stripe i reads only the input prefix
``in_spec.width(min(i, K_in levels))`` and ``level`` truncates the output
to ``out_spec.width(level)`` columns; float32 accumulation, output in
``x.dtype``.

* On a CUDA tensor the wrapper launches ``csrc/nested_matmul.cu`` and
  adds one to ``nested_matmul.launches``.  In bf16 with 16-byte aligned
  rows (the served path) that is the v3 kernel: 64-column output tiles
  whose k range is split across the blocks of one thread-block cluster
  (:func:`nested_split_plan`, from the shapes alone), bf16 tensor cores,
  and a fixed-order sum of the partials through distributed shared
  memory, so the result is deterministic; otherwise the CUDA-core kernel
  (v2).  Per-column k limits come from the stripe boundaries passed by
  value; x and w are read through their row strides.
* On a CPU tensor it runs :func:`nested_matmul_plain`, the port of
  ``repro.kernels.ref.nested_matmul_ref``.

There is no fallback: a CUDA tensor launches the kernel or raises.
:func:`tile_limits` and :func:`nested_matmul_flops` are the reference's
helpers of the same names (the Pallas grid's per-tile k limits and the
triangular FLOP count).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.nesting import StripeSpec
from repro_torch.kernels.checks import DTYPE_CODE, no_backward, sm_count

_MAX_LEVELS = 8          # NM_MAX_LEVELS of the source
TILE_N = 64              # NM3_BN: output columns of a v3 tile
STEP_K = 64              # NM3_KS: k rows of a v3 ring stage
MAX_SPLITS = 16          # NM3_MAX_SPLITS: largest cluster


def tile_limits(in_spec: StripeSpec, out_spec: StripeSpec, level: int,
                bn: int, bk: int) -> np.ndarray:
    """limits[n_tile] = number of k tiles the n-th output tile may read
    (the Pallas grid's scalar prefetch); raises where a ``bn`` tile spans
    an output stripe boundary or a stripe's input prefix is not a multiple
    of ``bk``.  The CUDA kernel limits per column instead and needs no
    such alignment."""
    n_cols = out_spec.width(level)
    lv = out_spec.level_of_channel()[:n_cols]
    lims = []
    for n0 in range(0, n_cols, bn):
        tile_levels = lv[n0:n0 + bn]
        if tile_levels.min() != tile_levels.max():
            raise ValueError(f"bn={bn} spans an output stripe boundary at "
                             f"column {n0}; choose bn dividing the stripe "
                             f"widths {out_spec.stripe_sizes()}")
        i = int(tile_levels[0])
        w_in = in_spec.width(min(i, in_spec.levels))
        if w_in % bk:
            raise ValueError(f"stripe boundary {w_in} not divisible by "
                             f"bk={bk}")
        lims.append(w_in // bk)
    return np.asarray(lims, np.int32)


def nested_matmul_flops(m: int, in_spec: StripeSpec, out_spec: StripeSpec,
                        level: int | None = None) -> int:
    """Analytic MACs*2 of the triangular product (vs 2*M*K*N dense)."""
    lvl = out_spec.levels if level is None else level
    total = 0
    for i in range(1, lvl + 1):
        sl = out_spec.stripe_slice(i)
        w_in = in_spec.width(min(i, in_spec.levels))
        total += 2 * m * w_in * (sl.stop - sl.start)
    return total


def nested_matmul_cost(m: int, in_spec: StripeSpec, out_spec: StripeSpec,
                       level: int | None, dtype: torch.dtype) -> dict:
    """Work of one call for the bound: the triangular FLOPs, and the bytes
    of the level-prefix ``x``, the live weight blocks and the output, each
    read or written once."""
    lvl = out_spec.levels if level is None else level
    flops = nested_matmul_flops(m, in_spec, out_spec, lvl)
    item = torch.empty((), dtype=dtype).element_size()
    x_cols = in_spec.width(min(lvl, in_spec.levels))
    n_cols = out_spec.width(lvl)
    live_w = nested_matmul_flops(1, in_spec, out_spec, lvl) // 2
    return {"flops": float(flops),
            "bytes_accessed": float(item * (m * x_cols + live_w
                                            + m * n_cols)),
            "live_weight_elements": live_w}


@functools.lru_cache(maxsize=None)
def nested_split_plan(m: int, n_cols: int, k_end: int,
                      n_sm: int) -> tuple[int, int, int]:
    """``(splits, row tiles, column tiles)`` of one v3 launch, from the
    shapes alone: ``TILE_N``-column tiles of 16 rows (``m <= 16``) or 32,
    and ``splits`` blocks per tile along k, enough for about 1.5 blocks per
    SM, at most ``MAX_SPLITS`` and at most one per ``STEP_K`` step of the
    longest k range (``k_end``, the last column's limit).  Where even one
    block per step leaves most SMs idle (tiles x steps <= n_sm / 4) each
    step gets its block; otherwise a block takes 1.5 steps or more: a
    sweep of the split count on the card found a block's fixed cost (its
    first load's latency, the cluster barrier) outweighing finer splits
    there.  A tile's ``n`` steps go to its blocks as runs
    ``[r*n // splits, (r+1)*n // splits)``."""
    m_tiles = -(-m // (16 if m <= 16 else 32))
    n_tiles = -(-n_cols // TILE_N)
    steps = max(-(-k_end // STEP_K), 1)
    base = max(m_tiles * n_tiles, 1)
    runs = steps if base * steps <= n_sm // 4 else -(-2 * steps // 3)
    splits = min(MAX_SPLITS, runs, -(-3 * n_sm // (2 * base)))
    return max(1, splits), m_tiles, n_tiles


# --------------------------------------------------------------------- #
# Plain version                                                          #
# --------------------------------------------------------------------- #
def nested_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        in_spec: StripeSpec, out_spec: StripeSpec,
                        level: int | None = None) -> torch.Tensor:
    """One float32 product per live output stripe over its input prefix,
    concatenated and cast to ``x.dtype`` (``nested_matmul_ref``)."""
    k_out = out_spec.levels if level is None else level
    outs = []
    for i in range(1, k_out + 1):
        sl = out_spec.stripe_slice(i)
        if sl.stop == sl.start:
            continue
        w_in = in_spec.width(min(i, in_spec.levels))
        outs.append(x[..., :w_in].float() @ w[:w_in, sl].float())
    return torch.cat(outs, dim=-1).to(x.dtype)


# --------------------------------------------------------------------- #
# CUDA kernel                                                            #
# --------------------------------------------------------------------- #
_P = ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)


def _library():
    """The built kernel library with its C signatures declared."""
    from repro_torch.kernels.build import load

    lib = load("nested_matmul")
    if not getattr(lib, "_nested_matmul_typed", False):
        lib.nested_matmul_launch.argtypes = [
            _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, _IP, ctypes.c_int, _IP, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.nested_matmul_launch.restype = ctypes.c_int
        lib.nested_matmul_error_string.argtypes = [ctypes.c_int]
        lib.nested_matmul_error_string.restype = ctypes.c_char_p
        lib._nested_matmul_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _geometry(in_spec: StripeSpec, out_spec: StripeSpec, level: int):
    """The launch's geometry for one (specs, level), made once: the C
    arrays of cumulative input widths and of output widths up to
    ``level``, the output width and the input prefix the level reads."""
    if not 1 <= level <= out_spec.levels:
        raise ValueError(f"level {level} outside 1..{out_spec.levels}")
    if max(in_spec.levels, level) > _MAX_LEVELS:
        raise ValueError(f"nested_matmul: the kernel takes at most "
                         f"{_MAX_LEVELS} levels")
    ib = (ctypes.c_int * (in_spec.levels + 1))(*in_spec.boundaries)
    ob = (ctypes.c_int * (level + 1))(*out_spec.boundaries[:level + 1])
    return (ib, ob, out_spec.width(level),
            in_spec.width(min(level, in_spec.levels)))


def _launch(x, w, in_spec, out_spec, level):
    ib, ob, n_cols, k_need = _geometry(in_spec, out_spec, level)
    dev = x.device
    code = DTYPE_CODE.get(x.dtype)
    if (x.dim() != 2 or w.dim() != 2 or w.device != dev or w.dtype != x.dtype
            or code is None or x.stride(1) != 1 or w.stride(1) != 1
            or x.shape[1] < k_need or w.shape[0] < k_need
            or w.shape[1] < n_cols):
        raise ValueError(
            f"nested_matmul: needs x [M, >={k_need}] and w [>={k_need}, "
            f">={n_cols}] on one CUDA device, both float32 or bfloat16 with "
            f"unit column stride; got x {x.dtype} {tuple(x.shape)} stride "
            f"{x.stride()} on {x.device}, w {w.dtype} {tuple(w.shape)} "
            f"stride {w.stride()} on {w.device}")
    m = x.shape[0]
    out = torch.empty((m, n_cols), dtype=x.dtype, device=dev)
    if m and n_cols:
        splits, _, _ = nested_split_plan(m, n_cols, k_need, sm_count(dev))
        lib = _library()
        rc = lib.nested_matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, x.stride(0),
            w.stride(0), n_cols, ib, in_spec.levels, ob, level, splits, code,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.nested_matmul_error_string(rc).decode()
            raise RuntimeError(f"nested_matmul launch failed: CUDA error "
                               f"{rc} ({msg})")
        nested_matmul.launches += 1
    return out


def nested_matmul(x: torch.Tensor, w: torch.Tensor, in_spec: StripeSpec,
                  out_spec: StripeSpec,
                  level: int | None = None) -> torch.Tensor:
    """``x [M, >= width_in(level)] @ w [>= width_in(level), >= N]`` under
    stripe nesting -> ``[M, out_spec.width(level)]`` in ``x.dtype``.

    ``x`` may be a level prefix and ``w`` the full weight: both are read
    through their row strides.  CPU tensors run
    :func:`nested_matmul_plain`; CUDA tensors launch the kernel (and count
    the launch) or raise.  Either way it raises while autograd would
    record the call (:func:`~repro_torch.kernels.checks.no_backward`).
    """
    no_backward("nested_matmul", x, w)
    lvl = out_spec.levels if level is None else level
    if x.device.type == "cpu":
        return nested_matmul_plain(x, w, in_spec, out_spec, lvl)
    if x.device.type != "cuda":
        raise ValueError(f"nested_matmul runs on CUDA or CPU tensors, "
                         f"not {x.device}")
    return _launch(x, w, in_spec, out_spec, lvl)


nested_matmul.launches = 0
