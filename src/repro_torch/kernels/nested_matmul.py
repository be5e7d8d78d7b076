"""Block-lower-triangular nested matmul: the CUDA kernel and its plain
PyTorch version (paper Section 4.2.1, width nesting).

:func:`nested_matmul` is the port of ``repro.kernels.nested_matmul``
(``nested_matmul`` -> ``_kernel`` -> ``pl.pallas_call``): ``x [M, K_in] @
w [K_in, N]`` where output stripe i reads only the input prefix
``in_spec.width(min(i, K_in levels))`` and ``level`` truncates the output
to ``out_spec.width(level)`` columns; float32 accumulation, output in
``x.dtype``.

* On a CUDA tensor the wrapper launches ``csrc/nested_matmul.cu`` and
  adds one to ``nested_matmul.launches``.  :func:`nested_path` picks the
  kernel from the operands' dtype, rows and shapes alone.  In bf16 with
  16-byte aligned rows, from ``WIDE_MIN_M`` rows on (the scoring
  prefill, bound by operations) that is v4, which also adds one to ``nested_matmul.v4_launches``: wgmma on
  256 or 128 x 128 tiles fed by TMA, the tiles walked longest k first and
  the long ones split in k across a cluster (:func:`nested_wide_plan`).
  Below it (the served decode and prefill, bound by bytes and latency)
  it is v3: 64-column output tiles whose k range is split across the
  blocks of one thread-block cluster (:func:`nested_split_plan`), bf16
  tensor cores.  Both sum split partials in a fixed order through
  distributed shared memory, so the result is deterministic.  Otherwise
  the CUDA-core kernel (v2).  Per-column k limits come from the stripe
  boundaries passed by value; x and w are read through their row
  strides.
* On a CPU tensor it runs :func:`nested_matmul_plain`, the port of
  ``repro.kernels.ref.nested_matmul_ref``.

There is no fallback: a CUDA tensor launches the kernel or raises.
:func:`tile_limits` and :func:`nested_matmul_flops` are the reference's
helpers of the same names (the Pallas grid's per-tile k limits and the
triangular FLOP count).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import itertools

import numpy as np
import torch

from repro_torch.core.nesting import StripeSpec
from repro_torch.kernels.checks import DTYPE_CODE, no_backward, sm_count

_MAX_LEVELS = 8          # NM_MAX_LEVELS of the source
TILE_N = 64              # NM3_BN: output columns of a v3 tile
STEP_K = 64              # NM3_KS: k rows of a v3 ring stage
MAX_SPLITS = 16          # NM3_MAX_SPLITS: largest cluster
WIDE_TILE_N = 128        # NM4_BN: output columns of a v4 tile
WIDE_STEP_K = 64         # NM4_BK: k rows of a v4 ring stage
WIDE_CLUSTERS = (1, 2, 4, 8)  # v4 cluster sizes (NM4_MAX_CLUSTER)
# The crossover: calls with at least this many rows take v4.  Measured by
# chip_smoke.py's nested_crossover on an H100 under this plan (PERF.md,
# run z6): summed over both models' geometries and levels, v4
# took 0.4187 ms against v3's 0.4186 at M = 64, 0.4215 against 0.5079 at
# M = 96 and 0.4272 against 0.6617 at M = 128, and led at every larger
# M; 128 keeps a margin.  At the anytime LM's 768-wide geometries alone
# v3 stayed faster at every call up to M = 256, where no caller runs.
WIDE_MIN_M = 128
# The v4 plan's cost model, in k steps of a 256-row tile (one is ~0.69
# us): a block's fixed cost (its launch, first loads and epilogue), a step
# of each tile height, and the trade of a whole 256-row partial through
# distributed shared memory (128 rows: half).  Fitted to the 464 launches
# of every tile height, cluster size and chunk cap at Mistral-7B's four
# geometries, M = 512, every level, timed on an H100 (PERF.md, run z4):
# 11 % rms, its picks within 8 % of the fastest launches in sum.  A fixed
# rule in its place (256-row tiles, the longest chunks halved while the
# launch stays within one block an SM) picked launches 19 % slower in the
# benchmark's mix of calls and served it 3-5 % slower end to end (run z6).
WIDE_BLOCK_STEPS = 8.64
WIDE_STEP_COST = {256: 1.0, 128: 0.68}
WIDE_REDUCE_STEPS = 14.76


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


def nested_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a CUDA call on ``x`` and ``w`` launches, from their
    dtype, rows and shapes alone: in bf16 with 16-byte aligned rows,
    ``"v4"`` (wgmma and TMA, :func:`nested_wide_plan`) from
    ``WIDE_MIN_M`` rows on, where the product is bound by operations,
    and ``"v3"`` (:func:`nested_split_plan`) below, where it is bound by
    the weight's bytes and by latency; otherwise ``"v2"``."""
    if x.dtype != torch.bfloat16 or not (_rows16(x) and _rows16(w)):
        return "v2"
    return "v4" if x.shape[0] >= WIDE_MIN_M else "v3"


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """One v4 launch: ``bm``-row tiles (``m_tiles`` of them) of
    ``WIDE_TILE_N`` columns, clusters of ``cluster`` blocks, ``blocks``
    blocks in all (the last cluster padded), and ``runs``: runs of column
    tiles that share one k limit, in launch order (the longest k first),
    each ``(first tile, tiles, splits, first block)``; a tile's
    ``splits`` chunks are neighbouring blocks of one cluster.
    ``makespan`` is the modelled time in k steps."""

    bm: int
    m_tiles: int
    cluster: int
    runs: tuple[tuple[int, int, int, int], ...]
    blocks: int
    makespan: float


def wide_tile_limits(in_bounds: tuple, out_bounds: tuple,
                     level: int) -> tuple[int, ...]:
    """k limit of each ``WIDE_TILE_N``-column tile of a call at ``level``:
    the input prefix of the tile's last column's stripe (limits rise with
    the column, so no column of the tile reads further)."""
    n_in = len(in_bounds) - 1
    n_cols = out_bounds[level]
    lims = []
    for n0 in range(0, n_cols, WIDE_TILE_N):
        last = min(n0 + WIDE_TILE_N, n_cols) - 1
        stripe = next(i for i in range(1, level + 1)
                      if last < out_bounds[i])
        lims.append(in_bounds[min(stripe, n_in)])
    return tuple(lims)


def _wide_makespan(blocks: list, cluster: int, slots: int) -> float:
    """Modelled end of a launch whose blocks, in launch order, each take
    ``blocks[i]`` = (k steps, rows of the tile, splits of the tile) (a
    pad block (0, 0, 1)): a cluster takes as long as its slowest block, a
    block ``WIDE_BLOCK_STEPS`` plus its steps at ``WIDE_STEP_COST`` of its
    tile height plus, in a tile split s ways, ``WIDE_REDUCE_STEPS`` times
    the (s - 1) / s of its partial that it trades; clusters go in order
    to ``slots`` places as they free up (the block scheduler's order)."""
    ends = [0.0] * max(1, slots)
    for i in range(0, len(blocks), cluster):
        span = max((WIDE_BLOCK_STEPS if bm else 0.0)
                   + steps * WIDE_STEP_COST.get(bm, 0.0)
                   + WIDE_REDUCE_STEPS * (s - 1) / s * bm / 256
                   for steps, bm, s in blocks[i:i + cluster])
        heapq.heappush(ends, heapq.heappop(ends) + span)
    return max(ends)


def wide_candidates(m: int, tile_limits: tuple,
                    n_sm: int) -> list[WidePlan]:
    """Every v4 launch :func:`nested_wide_plan` weighs for ``m`` rows and
    column tiles of k limits ``tile_limits`` on ``n_sm`` SMs (clusters
    of c blocks modelled ``n_sm // c`` at once): tiles of 128 rows, and of 256 where that
    pads M no more; for each cluster size, every cap on a chunk's k steps
    that a run's steps over a split give, a run's tiles split in 2, 4 or
    8 (at most the cluster) until their chunks fit the cap, where the
    largest split fills the cluster.  The runs of column tiles sharing
    one limit go longest k first."""
    runs = []                      # [first tile, tiles, k limit]
    for t, lim in enumerate(tile_limits):
        if runs and runs[-1][2] == lim:
            runs[-1][1] += 1
        else:
            runs.append([t, 1, lim])
    runs.reverse()                 # limits rise with the column
    steps = [-(-lim // WIDE_STEP_K) for _, _, lim in runs]
    heights = [128] + ([256] if -(-m // 256) * 2 == -(-m // 128) else [])
    found = []
    for bm, cluster in itertools.product(heights, WIDE_CLUSTERS):
        m_tiles = -(-m // bm)
        caps = {-(-n // s) for n in steps for s in WIDE_CLUSTERS
                if s <= cluster}
        for cap in sorted(caps):
            plan_runs, blocks = [], []
            for (t0, tiles, _), n in zip(runs, steps):
                s = 1
                while s < cluster and 2 * s <= n and -(-n // s) > cap:
                    s *= 2
                plan_runs.append((t0, tiles, s, len(blocks)))
                blocks += [(-(-n // s), bm, s)] * (tiles * m_tiles * s)
            if max(r[2] for r in plan_runs) != cluster:
                continue           # a smaller cluster runs the same splits
            blocks += [(0, 0, 1)] * (-len(blocks) % cluster)
            found.append(WidePlan(bm, m_tiles, cluster, tuple(plan_runs),
                                  len(blocks),
                                  _wide_makespan(blocks, cluster,
                                                 n_sm // cluster)))
    return found


@functools.lru_cache(maxsize=None)
def nested_wide_plan(m: int, tile_limits: tuple, n_sm: int) -> WidePlan:
    """The v4 launch for ``m`` rows and column tiles of k limits
    ``tile_limits`` (:func:`wide_tile_limits`) on ``n_sm`` SMs, from the
    shapes alone.

    The tiles of the wide stripes read up to 8x the k of the first
    stripe, so a run's tiles may be split in k into ``splits`` chunks (a
    power of 2, reduced in a fixed order through the cluster's shared
    memory).  Of :func:`wide_candidates`, the plan takes the one whose
    modelled makespan (:func:`_wide_makespan`) is least, and the fewest
    blocks within 1 % of it."""
    found = wide_candidates(m, tile_limits, n_sm)
    least = min(p.makespan for p in found)
    return min((p for p in found if p.makespan <= 1.01 * least),
               key=lambda p: (p.blocks, p.makespan))


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
        lib.nested_matmul_v4_launch.argtypes = [
            _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, _IP, ctypes.c_int, _IP,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _IP, ctypes.c_int, ctypes.c_int, _P]
        lib.nested_matmul_v4_launch.restype = ctypes.c_int
        lib.nested_matmul_error_string.argtypes = [ctypes.c_int]
        lib.nested_matmul_error_string.restype = ctypes.c_char_p
        lib._nested_matmul_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _geometry(in_spec: StripeSpec, out_spec: StripeSpec, level: int):
    """The launch's geometry for one (specs, level), made once: the C
    arrays of cumulative input widths and of output widths up to
    ``level``, the output width, the input prefix the level reads and
    the k limits of v4's column tiles."""
    if not 1 <= level <= out_spec.levels:
        raise ValueError(f"level {level} outside 1..{out_spec.levels}")
    if max(in_spec.levels, level) > _MAX_LEVELS:
        raise ValueError(f"nested_matmul: the kernel takes at most "
                         f"{_MAX_LEVELS} levels")
    ib = (ctypes.c_int * (in_spec.levels + 1))(*in_spec.boundaries)
    ob = (ctypes.c_int * (level + 1))(*out_spec.boundaries[:level + 1])
    return (ib, ob, out_spec.width(level),
            in_spec.width(min(level, in_spec.levels)),
            wide_tile_limits(tuple(in_spec.boundaries),
                             tuple(out_spec.boundaries), level))


@functools.lru_cache(maxsize=None)
def _c_runs(plan: WidePlan):
    """A v4 plan's runs as the C array the launch reads."""
    flat = [v for run in plan.runs for v in run]
    return (ctypes.c_int * len(flat))(*flat)


def _rows16(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` starts on a 16-byte boundary (what TMA
    and v3's 16-byte loads need)."""
    return t.data_ptr() % 16 == 0 and t.stride(0) * t.element_size() % 16 \
        == 0


def _launch(x, w, in_spec, out_spec, level):
    ib, ob, n_cols, k_need, tile_lims = _geometry(in_spec, out_spec, level)
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
        n_sm = sm_count(dev)
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        wide = nested_path(x, w) == "v4"
        if wide:
            plan = nested_wide_plan(m, tile_lims, n_sm)
            rc = lib.nested_matmul_v4_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, x.stride(0),
                w.stride(0), n_cols, k_need, ib, in_spec.levels, ob, level,
                plan.bm, plan.m_tiles, plan.cluster, plan.blocks,
                _c_runs(plan), len(plan.runs), dev.index, stream)
        else:
            splits, _, _ = nested_split_plan(m, n_cols, k_need, n_sm)
            rc = lib.nested_matmul_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, x.stride(0),
                w.stride(0), n_cols, ib, in_spec.levels, ob, level, splits,
                code, dev.index, stream)
        if rc != 0:
            msg = lib.nested_matmul_error_string(rc).decode()
            raise RuntimeError(f"nested_matmul launch failed: CUDA error "
                               f"{rc} ({msg})")
        nested_matmul.launches += 1
        nested_matmul.v4_launches += wide
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
nested_matmul.v4_launches = 0
