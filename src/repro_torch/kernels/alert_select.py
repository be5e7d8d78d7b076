"""Fused ALERT decision pass: the CUDA kernel and its plain PyTorch version.

:func:`alert_select` is the port of ``repro.kernels.alert_select``
(``alert_select`` -> ``_select_kernel`` -> ``pl.pallas_call``).  Per lane
it sanitises dead lanes, evaluates the Eq. 7 erf grid and the Eq. 10
staircase contraction, Eq. 9 energy, the Eq. 4/5 feasibility masks with
the Section 3.3 relaxation, the merged score and the first-occurrence
argmin over the K*L cells, and optionally gathers the pick's predictions.

* On a CUDA tensor the wrapper launches ``csrc/alert_select.cu`` v2 (a
  warp per lane, or several lanes a warp for small tables; tables and
  each lane's F grid in shared memory, no ``[S, K, L]`` tensor in device
  memory) and adds one to ``alert_select.launches``.
* On a CPU tensor it runs :func:`alert_select_plain`, a float64 twin of
  the reference's ``_select_hetero_impl`` + ``_estimate_impl``.  The plain
  version performs the kernel's arithmetic one elementwise op at a time
  (the staircase contraction is an explicit multiply-add loop over ``u``
  in ascending order, constant divisors are device tensors so no op
  turns a division into a reciprocal multiply), so on the card the two
  round at the same places.  Its ``erf`` and ``exp`` are this module's
  (fdlibm's, as correctly rounded elementwise ops), not ``torch.erf`` /
  ``torch.exp``, whose float64 results differ between the CPU and CUDA in
  the last bit: the plain version on the CPU, on the card and the kernel
  give the same bits.

The kernel writes one int32 ``[4, S]`` and one float64 ``[3, S]`` buffer
(:func:`alert_select_packed`); :func:`alert_select` returns views of them
as the 7-tuple, so a caller that wants the results on the host copies two
buffers, not seven tensors.  There is no fallback: a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.core.batched import (GOAL_MIN_ENERGY, RELAXED_ACCURACY,
                                      RELAXED_NONE, RELAXED_POWER)

F64 = torch.float64
I32 = torch.int32
MAX_K = 32        # the kernel's limits (alert_select_max_k / _max_kl)
MAX_KL = 128
_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

# Device-memory bytes per lane: 6 f64 + 2 i32 read, 3 f64 + 4 i32 written
# (the reference's formula counts the two i32 inputs as 8 B each: 104 B).
BYTES_PER_LANE = 6 * 8 + 2 * 4 + 3 * 8 + 4 * 4


# --------------------------------------------------------------------- #
# erf and exp, one IEEE sequence on every device                         #
# --------------------------------------------------------------------- #
# fdlibm's s_erf.c and e_exp.c (both within 1 ulp), written as correctly
# rounded double additions, subtractions, multiplications and divisions,
# comparisons, selects and exact bit operations.  The kernel's
# alert_erf / alert_exp (csrc/alert_select.cu) run the same sequence with
# __dadd_rn and friends, so the CPU, the card's plain version and the
# kernel round at the same places.  The branches run on every element and
# a select keeps the right one.
def _bits(word: int) -> float:
    """The double whose IEEE bits are ``word``."""
    return struct.unpack("<d", struct.pack("<Q", word))[0]


_ERX = _bits(0x3FEB0AC160000000)
_EFX = _bits(0x3FC06EBA8214DB69)
_EFX8 = _bits(0x3FF06EBA8214DB69)
_PP = [_bits(w) for w in (0x3FC06EBA8214DB68, 0xBFD4CD7D691CB913,
                          0xBF9D2A51DBD7194F, 0xBF77A291236668E4,
                          0xBEF8EAD6120016AC)]
_QQ = [_bits(w) for w in (0x3FD97779CDDADC09, 0x3FB0A54C5536CEBA,
                          0x3F74D022C4D36B0F, 0x3F215DC9221C1A10,
                          0xBED09C4342A26120)]
_PA = [_bits(w) for w in (0xBF6359B8BEF77538, 0x3FDA8D00AD92B34D,
                          0xBFD7D240FBB8C3F1, 0x3FD45FCA805120E4,
                          0xBFBC63983D3E28EC, 0x3FA22A36599795EB,
                          0xBF61BF380A96073F)]
_QA = [_bits(w) for w in (0x3FBB3E6618EEE323, 0x3FE14AF092EB6F33,
                          0x3FB2635CD99FE9A7, 0x3FC02660E763351F,
                          0x3F8BEDC26B51DD1C, 0x3F888B545735151D)]
_RA = [_bits(w) for w in (0xBF843412600D6435, 0xBFE63416E4BA7360,
                          0xC0251E0441B0E726, 0xC04F300AE4CBA38D,
                          0xC0644CB184282266, 0xC067135CEBCCABB2,
                          0xC054526557E4D2F2, 0xC023A0EFC69AC25C)]
_SA = [_bits(w) for w in (0x4033A6B9BD707687, 0x4061350C526AE721,
                          0x407B290DD58A1A71, 0x40842B1921EC2868,
                          0x407AD02157700314, 0x405B28A3EE48AE2C,
                          0x401A47EF8E484A93, 0xBFAEEFF2EE749A62)]
_RB = [_bits(w) for w in (0xBF84341239E86F4A, 0xBFE993BA70C285DE,
                          0xC031C209555F995A, 0xC064145D43C5ED98,
                          0xC083EC881375F228, 0xC09004616A2E5992,
                          0xC07E384E9BDC383F)]
_SB = [_bits(w) for w in (0x403E568B261D5190, 0x40745CAE221B9F0A,
                          0x409802EB189D5118, 0x40A8FFB7688C246A,
                          0x40A3F219CEDF3BE6, 0x407DA874E79FE763,
                          0xC03670E242712D62)]
_LN2_HI = _bits(0x3FE62E42FEE00000)
_LN2_LO = _bits(0x3DEA39EF35793C76)
_INV_LN2 = _bits(0x3FF71547652B82FE)
_EXP_P = [_bits(w) for w in (0x3FC555555555553E, 0xBF66C16C16BEBD93,
                             0x3F11566AAF25DE2C, 0xBEBBBD41C5D26BF1,
                             0x3E66376972BEA4D0)]
_O_THRESHOLD = _bits(0x40862E42FEFA39EF)
_U_THRESHOLD = _bits(0xC0874910D52D3051)


def _hi_word(x):
    """The high 32 bits of ``|x|`` as int64 (fdlibm's ``__HI(x) &
    0x7fffffff``)."""
    return (x.contiguous().view(torch.int64) >> 32) & 0x7FFFFFFF


def _poly(s, coeffs):
    """``c0 + s*(c1 + s*(c2 + ... + s*cn))``, fdlibm's nesting."""
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = c + s * acc
    return acc


def _pow2(k):
    """``2**k`` exactly, for int64 ``k`` in [-1022, 1023], from its
    bits."""
    return ((k + 1023) << 52).view(torch.float64)


def exp(x):
    """Float64 ``exp`` of every element of ``x``: fdlibm's ``e_exp.c``
    (within 1 ulp), the same bits on the CPU and the card."""
    one = torch.ones((), dtype=F64, device=x.device)
    hx = _hi_word(x)
    neg = x < 0.0
    nan = x != x
    over = x > _O_THRESHOLD
    under = x < _U_THRESHOLD
    r = torch.where(nan | over | under, 0.0, x)
    sgn = torch.where(neg, -one, one)
    # Argument reduction: x = k ln2 + (hi - lo), |hi - lo| <= ln2 / 2.
    near = hx < 0x3FF0A2B2                       # |x| < 1.5 ln2
    k_far = torch.trunc(_INV_LN2 * r + sgn * 0.5)
    t = torch.where(near, sgn, k_far)
    hi = torch.where(near, r - sgn * _LN2_HI,
                     r - t * _LN2_HI)             # t * ln2_hi is exact
    lo = torch.where(near, sgn * _LN2_LO, t * _LN2_LO)
    reduce = hx > 0x3FD62E42                     # |x| > ln2 / 2
    k = torch.where(reduce, t, 0.0).to(torch.int64)
    xr = torch.where(reduce, hi - lo, r)
    tt = xr * xr
    c = xr - tt * _poly(tt, _EXP_P)
    y0 = 1.0 - (torch.div(xr * c, c - 2.0) - xr)
    y1 = 1.0 - ((lo - torch.div(xr * c, 2.0 - c)) - hi)
    # y1 * 2**k: exact in two power-of-two steps while the result is
    # normal; below that one rounding, by 2**-1000, as fdlibm does.
    half = torch.clamp(k, -1021, 1024) >> 1
    y1 = torch.where(k >= -1021,
                     y1 * _pow2(half) * _pow2(torch.clamp(k, -1021, 1024)
                                              - half),
                     y1 * _pow2(torch.clamp_min(k + 1000, -1021))
                     * _pow2(torch.full_like(k, -1000)))
    y = torch.where(reduce, y1, y0)
    y = torch.where(hx < 0x3E300000, one + r, y)  # |x| < 2**-28
    y = torch.where(under, 0.0, y)
    y = torch.where(over, math.inf, y)
    return torch.where(nan, x, y)


def erf(x):
    """Float64 ``erf`` of every element of ``x``: fdlibm's ``s_erf.c``
    (within 1 ulp), its tail's ``exp`` as :func:`exp`, the same bits on
    the CPU and the card."""
    one = torch.ones((), dtype=F64, device=x.device)
    ix = _hi_word(x)
    ax = torch.abs(x)
    neg = x < 0.0
    # |x| < 0.84375
    z = x * x
    r = _poly(z, _PP)
    s = 1.0 + z * _poly(z, _QQ)
    small = x + x * torch.div(r, s)
    tiny = torch.where(ix < 0x00800000, 0.125 * (8.0 * x + _EFX8 * x),
                       x + _EFX * x)
    small = torch.where(ix < 0x3E300000, tiny, small)
    # 0.84375 <= |x| < 1.25
    s1 = ax - 1.0
    p = _poly(s1, _PA)
    q = 1.0 + s1 * _poly(s1, _QA)
    pq = torch.div(p, q)
    mid = torch.where(neg, -_ERX - pq, _ERX + pq)
    # 1.25 <= |x| < 6: erfc from R/S and two exps
    big = (ix >= 0x3FF40000) & (ix < 0x40180000)
    xt = torch.where(big, ax, 2.0)
    st = torch.div(one, xt * xt)
    near = ix < 0x4006DB6E                      # |x| < 1/0.35
    rr = torch.where(near, _poly(st, _RA), _poly(st, _RB))
    ss = 1.0 + st * torch.where(near, _poly(st, _SA), _poly(st, _SB))
    zt = (xt.contiguous().view(torch.int64)
          & ~0xFFFFFFFF).view(torch.float64)   # low word cleared
    e = exp(-zt * zt - 0.5625) * exp((zt - xt) * (zt + xt)
                                     + torch.div(rr, ss))
    tail = torch.where(neg, torch.div(e, xt) - 1.0, 1.0 - torch.div(e, xt))
    out = torch.where(ix < 0x3FEB0000, small,
                      torch.where(ix < 0x3FF40000, mid, tail))
    out = torch.where(ix >= 0x40180000, torch.where(neg, -one, one),
                      out)
    return torch.where(x != x, x, out)


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
    f = 0.5 * (1.0 + erf(z / sqrt2))
    # Eq. 10: q_fail + sum_u W[k, u] * F[s, u, l], u ascending.
    acc_sum = weights[:, 0, None] * f[:, 0:1, :]
    for u in range(1, weights.shape[1]):
        acc_sum = acc_sum + weights[:, u, None] * f[:, u:u + 1, :]
    accuracy = q_fail + acc_sum
    caps = run_power[None]
    if paper_faithful_energy:
        t_run = torch.minimum(lat_mean, t_)
    else:
        pdf = exp(-0.5 * (z * z)) * _INV_SQRT_2PI
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
            + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [_P] * 2
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


def check_tables(latency, run_power, weights) -> None:
    """The ``[K, L]`` latency and power tables and the ``[K, K]`` weights:
    contiguous float64 on one device, within the kernel's limits.  The
    scoring engine checks its tables once, when it is built; a direct
    call of :func:`alert_select` checks them every time."""
    k, l = latency.shape
    dev = latency.device
    _check("latency", latency, F64, (k, l), dev)
    _check("run_power", run_power, F64, (k, l), dev)
    _check("weights", weights, F64, (k, k), dev)
    if k > MAX_K or k * l > MAX_KL:
        raise ValueError(
            f"alert_select: a {k}x{l} table exceeds the kernel's limits "
            f"(K <= {MAX_K}, K*L <= {MAX_KL})")


_LANE_NAMES = ("mu", "sigma", "phi", "deadline", "accuracy_goal",
               "energy_goal", "goal_kind", "active")


def _launch(lanes, latency, run_power, weights, q_fail, overhead,
            paper_faithful_energy, predictions):
    dev = latency.device
    s = lanes[0].shape[0]
    k, l = latency.shape
    for n, (name, x) in enumerate(zip(_LANE_NAMES, lanes)):
        _check(name, x, F64 if n < 6 else I32, (s,), dev)
    ints = torch.empty((4, s), dtype=I32, device=dev)
    f64 = torch.empty((3, s), dtype=F64, device=dev)
    if s:
        lib = _library()
        rc = lib.alert_select_launch(
            *(x.data_ptr() for x in lanes), latency.data_ptr(),
            run_power.data_ptr(), weights.data_ptr(), s, k, l,
            float(q_fail), float(overhead), int(bool(paper_faithful_energy)),
            int(bool(predictions)), _SQRT2, _INV_SQRT_2PI, ints.data_ptr(),
            f64.data_ptr(), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.alert_select_error_string(rc).decode()
            raise RuntimeError(f"alert_select launch failed: CUDA error "
                               f"{rc} ({msg})")
        alert_select.launches += 1
    return ints, f64


def alert_select_packed(mu, sigma, phi, deadline, accuracy_goal,
                        energy_goal, goal_kind, active, *, latency,
                        run_power, weights, q_fail, overhead=0.0,
                        paper_faithful_energy=True, predictions=True):
    """:func:`alert_select`'s results in two buffers: int32 ``[4, S]``
    (model index, power index, feasible as 0/1, relaxed code) and float64
    ``[3, S]`` (predicted latency, accuracy, energy).  The tables must
    have passed :func:`check_tables` (the scoring engine checks its own
    once, when it is built); the lane vectors are checked on every call.
    CPU tensors run :func:`alert_select_plain`; CUDA tensors launch the
    kernel (and count the launch) or raise."""
    lanes = (mu, sigma, phi, deadline, accuracy_goal, energy_goal,
             goal_kind, active)
    if mu.device.type == "cpu":
        i, j, lat_p, acc_p, en_p, feas, rel = alert_select_plain(
            *lanes, latency=latency, run_power=run_power, weights=weights,
            q_fail=q_fail, overhead=overhead,
            paper_faithful_energy=paper_faithful_energy,
            predictions=predictions)
        return (torch.stack([i, j, feas.to(I32), rel]),
                torch.stack([lat_p, acc_p, en_p]))
    if mu.device.type != "cuda":
        raise ValueError(f"alert_select runs on CUDA or CPU tensors, "
                         f"not {mu.device}")
    return _launch(lanes, latency, run_power, weights, q_fail, overhead,
                   paper_faithful_energy, predictions)


def unpack(ints, f64):
    """The 7-tuple of :func:`alert_select` as views of the two buffers:
    ``feasible`` is a bool view of the low byte of each int32 0/1 (every
    host and device the port runs on is little-endian)."""
    feas = ints[2:3].view(torch.bool)[0, ::4]
    return ints[0], ints[1], f64[0], f64[1], f64[2], feas, ints[3]


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
    kernel (and count the launch) or raise.  On the card the seven are
    views of :func:`alert_select_packed`'s two buffers.
    """
    args = (mu, sigma, phi, deadline, accuracy_goal, energy_goal, goal_kind,
            active)
    kw = dict(latency=latency, run_power=run_power, weights=weights,
              q_fail=q_fail, overhead=overhead,
              paper_faithful_energy=paper_faithful_energy,
              predictions=predictions)
    if mu.device.type == "cpu":
        return alert_select_plain(*args, **kw)
    if mu.device.type == "cuda":
        check_tables(latency, run_power, weights)
    return unpack(*alert_select_packed(*args, **kw))


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
