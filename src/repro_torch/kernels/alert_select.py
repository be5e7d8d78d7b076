"""Fused ALERT decision pass: the CUDA kernel and its plain PyTorch version.

:func:`alert_select` is the port of ``repro.kernels.alert_select``
(``alert_select`` -> ``_select_kernel`` -> ``pl.pallas_call``).  Per lane
it sanitises dead lanes, evaluates the Eq. 7 erf grid and the Eq. 10
staircase contraction, Eq. 9 energy, the Eq. 4/5 feasibility masks with
the Section 3.3 relaxation, the merged score and the first-occurrence
argmin over the K*L cells, and optionally gathers the pick's predictions.

* On a CUDA tensor the wrapper launches ``csrc/alert_select.cu`` (one
  thread per lane, tables in shared memory, no ``[S, K, L]`` tensor in
  device memory) and adds one to ``alert_select.launches``.
* On a CPU tensor it runs :func:`alert_select_plain`, a float64 twin of
  the reference's ``_select_hetero_impl`` + ``_estimate_impl``.  The plain
  version performs the kernel's arithmetic one elementwise op at a time
  (the staircase contraction is an explicit multiply-add loop over ``u``
  in ascending order, constant divisors are device tensors so no op
  turns a division into a reciprocal multiply), so on the card the two
  round at the same places.

There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.batched import (GOAL_MIN_ENERGY, RELAXED_ACCURACY,
                                      RELAXED_NONE, RELAXED_POWER)

F64 = torch.float64
I32 = torch.int32
_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

# Device-memory bytes per lane: 6 f64 + 2 i32 read, 3 f64 + 4 i32 written
# (the reference's formula counts the two i32 inputs as 8 B each: 104 B).
BYTES_PER_LANE = 6 * 8 + 2 * 4 + 3 * 8 + 4 * 4


# --------------------------------------------------------------------- #
# Plain version                                                          #
# --------------------------------------------------------------------- #
def estimate_grid(mu, sd, phi, t, *, latency, run_power, weights, q_fail,
                  paper_faithful_energy=True):
    """``[S]`` state (``t`` already overhead-adjusted) -> the ``[S, K, L]``
    grids ``(lat_mean, lat_std, accuracy, energy, p_finish)``: Eq. 7 finish
    CDF, Eq. 10 staircase accuracy and Eq. 9 energy."""
    sqrt2 = torch.tensor(_SQRT2, dtype=F64, device=mu.device)
    lat = latency[None]                                  # [1, K, L]
    t_ = t[:, None, None]                                # [S, 1, 1]
    lat_mean = mu[:, None, None] * lat
    lat_std = torch.clamp_min(sd[:, None, None] * lat, 1e-12)
    z = (t_ - lat_mean) / lat_std
    f = 0.5 * (1.0 + torch.erf(z / sqrt2))
    # Eq. 10: q_fail + sum_u W[k, u] * F[s, u, l], u ascending.
    acc_sum = weights[:, 0, None] * f[:, 0:1, :]
    for u in range(1, weights.shape[1]):
        acc_sum = acc_sum + weights[:, u, None] * f[:, u:u + 1, :]
    accuracy = q_fail + acc_sum
    caps = run_power[None]
    if paper_faithful_energy:
        t_run = torch.minimum(lat_mean, t_)
    else:
        pdf = torch.exp(-0.5 * (z * z)) * _INV_SQRT_2PI
        t_run = lat_mean * f + t_ * (1.0 - f) - lat_std * pdf
        t_run = torch.minimum(torch.clamp_min(t_run, 0.0), t_)
    phi_ = phi[:, None, None]
    energy = caps * t_run + phi_ * caps * torch.clamp_min(t_ - t_run, 0.0)
    return lat_mean, lat_std, accuracy, energy, f


def row_argmin(x):
    """First-occurrence argmin along the last axis (``_row_argmin``): ties
    go to the lowest index, and a row holding NaN returns its length."""
    c = x.shape[-1]
    mask = x == torch.amin(x, dim=-1, keepdim=True)
    rev = (c - torch.arange(c, device=x.device)).to(I32)
    return c - torch.amax(mask * rev, dim=-1)


def alert_select_plain(mu, sigma, phi, deadline, accuracy_goal, energy_goal,
                       goal_kind, active, *, latency, run_power, weights,
                       q_fail, overhead=0.0, paper_faithful_energy=True,
                       predictions=True):
    """The plain PyTorch version of the kernel (same arguments and
    outputs as :func:`alert_select`)."""
    act = active != 0
    mu = torch.where(act, mu, 1.0)
    sd = torch.where(act, sigma, 0.1)
    phi = torch.where(act, phi, 0.25)
    t = torch.where(act, deadline, 1.0)
    ag = torch.where(act, accuracy_goal, 0.0)
    eg = torch.where(act, energy_goal, 0.0)
    t_eff = torch.clamp_min(t - overhead, 1e-9)
    lat_mean, _, acc, energy, _ = estimate_grid(
        mu, sd, phi, t_eff, latency=latency, run_power=run_power,
        weights=weights, q_fail=q_fail,
        paper_faithful_energy=paper_faithful_energy)
    s = mu.shape[0]
    k, l = latency.shape
    kl = k * l
    acc_f = acc.reshape(s, kl)
    en_f = energy.reshape(s, kl)
    is_min = (goal_kind == GOAL_MIN_ENERGY)[:, None]
    feas = torch.where(is_min, acc_f >= ag[:, None], en_f <= eg[:, None])
    any_f = feas.any(dim=1)
    any_ = any_f[:, None]
    acc_use = torch.where(feas | ~any_, acc_f, -math.inf)
    best = torch.amax(acc_use, dim=1, keepdim=True)
    sc_a = torch.where(best - acc_use <= 1e-12, en_f, math.inf)
    sc_e = torch.where(any_, torch.where(feas, en_f, math.inf), -acc_f)
    pick = row_argmin(torch.where(is_min, sc_e, sc_a))
    relaxed = torch.where(any_f, RELAXED_NONE,
                          torch.where(is_min[:, 0], RELAXED_ACCURACY,
                                      RELAXED_POWER)).to(I32)
    pick = torch.where(act, pick, 0)
    any_f = any_f & act
    relaxed = torch.where(act, relaxed, RELAXED_NONE)
    if predictions:
        # One-hot select-and-sum: the picked cell's value, 0.0 for the
        # K*L "no cell" pick of a NaN row (as the reference's gather).
        onehot = torch.arange(kl, device=mu.device) == pick[:, None]

        def gather(a):
            picked = torch.where(onehot, a.reshape(s, kl), 0.0).sum(dim=1)
            return torch.where(act, picked, 0.0)

        lat_p, acc_p, en_p = gather(lat_mean), gather(acc), gather(energy)
    else:
        lat_p, acc_p, en_p = (torch.zeros(s, dtype=F64, device=mu.device)
                              for _ in range(3))
    return ((pick // l).to(I32), (pick % l).to(I32), lat_p, acc_p, en_p,
            any_f, relaxed)


# --------------------------------------------------------------------- #
# CUDA kernel                                                            #
# --------------------------------------------------------------------- #
_P = ctypes.c_void_p


def _library():
    """The built kernel library with its C signatures declared."""
    from repro_torch.kernels.build import load

    lib = load("alert_select")
    if not getattr(lib, "_alert_select_typed", False):
        lib.alert_select_launch.argtypes = (
            [_P] * 11 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [_P] * 7
            + [ctypes.c_int, _P])
        lib.alert_select_launch.restype = ctypes.c_int
        lib.alert_select_error_string.argtypes = [ctypes.c_int]
        lib.alert_select_error_string.restype = ctypes.c_char_p
        lib.alert_select_max_k.restype = ctypes.c_int
        lib.alert_select_max_kl.restype = ctypes.c_int
        lib._alert_select_typed = True
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"alert_select: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def _launch(mu, sigma, phi, deadline, accuracy_goal, energy_goal, goal_kind,
            active, latency, run_power, weights, q_fail, overhead,
            paper_faithful_energy, predictions):
    dev = mu.device
    s = mu.shape[0]
    k, l = latency.shape
    for name, x in (("mu", mu), ("sigma", sigma), ("phi", phi),
                    ("deadline", deadline),
                    ("accuracy_goal", accuracy_goal),
                    ("energy_goal", energy_goal)):
        _check(name, x, F64, (s,), dev)
    _check("goal_kind", goal_kind, I32, (s,), dev)
    _check("active", active, I32, (s,), dev)
    _check("latency", latency, F64, (k, l), dev)
    _check("run_power", run_power, F64, (k, l), dev)
    _check("weights", weights, F64, (k, k), dev)
    lib = _library()
    if k > lib.alert_select_max_k() or k * l > lib.alert_select_max_kl():
        raise ValueError(
            f"alert_select: a {k}x{l} table exceeds the kernel's limits "
            f"(K <= {lib.alert_select_max_k()}, "
            f"K*L <= {lib.alert_select_max_kl()})")
    i = torch.empty(s, dtype=I32, device=dev)
    j = torch.empty(s, dtype=I32, device=dev)
    lat_p = torch.empty(s, dtype=F64, device=dev)
    acc_p = torch.empty(s, dtype=F64, device=dev)
    en_p = torch.empty(s, dtype=F64, device=dev)
    feas = torch.empty(s, dtype=I32, device=dev)
    rel = torch.empty(s, dtype=I32, device=dev)
    if s:
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in (
            mu, sigma, phi, deadline, accuracy_goal, energy_goal, goal_kind,
            active, latency, run_power, weights)]
        outs = [x.data_ptr() for x in (i, j, lat_p, acc_p, en_p, feas, rel)]
        rc = lib.alert_select_launch(
            *ptrs, s, k, l, float(q_fail), float(overhead),
            int(bool(paper_faithful_energy)), int(bool(predictions)),
            _SQRT2, _INV_SQRT_2PI, *outs, dev.index or 0, stream)
        if rc != 0:
            msg = lib.alert_select_error_string(rc).decode()
            raise RuntimeError(f"alert_select launch failed: CUDA error "
                               f"{rc} ({msg})")
        alert_select.launches += 1
    return i, j, lat_p, acc_p, en_p, feas.bool(), rel


def alert_select(mu, sigma, phi, deadline, accuracy_goal, energy_goal,
                 goal_kind, active, *, latency, run_power, weights, q_fail,
                 overhead=0.0, paper_faithful_energy=True, predictions=True):
    """One fused decision per lane: ``[S]`` state in, picks out.

    ``mu``/``sigma``/``phi``/``deadline``/``accuracy_goal``/``energy_goal``
    are ``[S]`` float64 tensors (sigma already floored), ``goal_kind``
    and ``active`` ``[S]`` int32 (``GOAL_*`` codes; nonzero = live lane),
    ``latency``/``run_power`` the ``[K, L]`` tables and ``weights`` the
    ``[K, K]`` staircase matrix, all on one device.  Returns ``(i, j,
    predicted_latency, predicted_accuracy, predicted_energy, feasible,
    relaxed_code)``: int32, float64 x3, bool, int32.  With
    ``predictions=False`` the three predictions come back zero.

    CPU tensors run :func:`alert_select_plain`; CUDA tensors launch the
    kernel (and count the launch) or raise.
    """
    args = (mu, sigma, phi, deadline, accuracy_goal, energy_goal, goal_kind,
            active)
    if mu.device.type == "cpu":
        return alert_select_plain(
            *args, latency=latency, run_power=run_power, weights=weights,
            q_fail=q_fail, overhead=overhead,
            paper_faithful_energy=paper_faithful_energy,
            predictions=predictions)
    if mu.device.type != "cuda":
        raise ValueError(f"alert_select runs on CUDA or CPU tensors, "
                         f"not {mu.device}")
    return _launch(*args, latency, run_power, weights, q_fail, overhead,
                   paper_faithful_energy, predictions)


alert_select.launches = 0


def alert_select_cost(s: int, k: int, l: int, *,
                      predictions: bool = False) -> dict:
    """Work of one pass, counted as the reference's ``alert_select_cost``
    counts it: about 20 FP64 operations per ``[S, K, L]`` cell, the
    ``2*S*K*K*L`` staircase contraction, ``6*S*K*L`` more for the
    prediction gathers, and one erf per cell, counted as a transcendental
    and not as FP64 operations.  Bytes are the streamed ``[S]`` vectors,
    each read or written once (96 B per lane; the tables are a few KB)."""
    cells = s * k * l
    flops = cells * (12 + 8) + 2 * s * k * k * l
    if predictions:
        flops += 3 * s * k * l * 2
    bytes_io = s * BYTES_PER_LANE
    return {
        "flops": float(flops),
        "bytes_accessed": float(bytes_io),
        "transcendentals": float(cells),
        "arithmetic_intensity_flops_per_byte": flops / bytes_io,
    }
