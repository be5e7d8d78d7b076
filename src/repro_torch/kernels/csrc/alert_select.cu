// alert_select v2: the fused ALERT decision pass, a warp per lane (sm_90a).
//
// Replaces the TPU kernel repro/kernels/alert_select.py::alert_select
// (body _select_kernel, tie-break _block_argmin).  Per lane it computes
// what that kernel computes, in float64:
//   sanitise dead lanes -> t_eff = max(T - overhead, 1e-9)
//   Eq. 7 finish CDF F[u, l] = 0.5 * (1 + erf(z / sqrt2)) over the [K, L] grid
//   Eq. 10 staircase accuracy acc[k, l] = q_fail + sum_u W[k, u] * F[u, l]
//   Eq. 9 energy (paper-faithful min(t, T) or E[min(t, T)])
//   Eq. 4 / Eq. 5 feasibility, Section 3.3 relaxation, merged score
//   first-occurrence argmin over the K*L cells (a NaN score gives K*L)
//   optional gathers of the pick's latency / accuracy / energy.
//
// What bounds it on an H100: per lane it reads 6 f64 + 2 i32 and writes
// 3 f64 + 4 i32 (104 B), while it does O(K*L) erf evaluations, two
// divisions a cell and an O(K*K*L) contraction in FP64; it is bound by FP64
// instructions (erf, exp and the divisions are dozens each), not by device
// memory (alert_select_cost in the Python module).
//
// Design: a group of TPL threads takes one lane, TPL = the power of two at
// or above K*L, at most 32: a warp per lane at the 12 x 8 table, several
// lanes a warp where K*L <= 16.  Cell c of the lane belongs to thread
// c mod TPL (c = thread + TPL * m, at most 4 cells a thread).  Each thread
// writes its cells' Eq. 7 CDF to the lane's F grid in shared memory, then
// keeps its cells' accuracy and energy in registers, so nothing is
// indexed at run time in local memory.  The group reduces with shuffles:
// feasibility with a ballot, the Eq. 5 best accuracy with a NaN-
// propagating max, the argmin over (score, cell) pairs keeping the lower
// cell on equal scores (-0.0 and +0.0 are equal) and giving K*L when any
// score is NaN, as the first-occurrence scan of v1 and row_argmin do;
// the pick's accuracy and energy ride along in the reduction, so the
// group's first thread writes every output of the lane.
// The [K, L] tables and the [K, K] weights are staged in shared memory
// by each block (ALERT_THREADS / TPL lanes).  Outputs
// go to one int32 [4, S] buffer (i, j, feasible, relaxed code) and one
// float64 [3, S] buffer (latency, accuracy, energy), so the host copies
// each back once.
//
// Rounding: every add / sub / mul / div of this file goes through
// __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, which are never merged
// into a fused multiply-add, erf / exp are alert_erf / alert_exp below
// (fdlibm's, written with those operations), and the Eq. 10 sum runs over
// u in ascending order.  The plain PyTorch
// version performs the same operations one elementwise op at a time, so
// the two round at the same places and agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#define ALERT_MAX_K 32
#define ALERT_MAX_KL 128
#define ALERT_THREADS 256
#define ALERT_CELLS 4      // cells per thread at most: ALERT_MAX_KL / 32

#define GOAL_MIN_ENERGY 0
#define RELAXED_NONE 0
#define RELAXED_ACCURACY 1
#define RELAXED_POWER 2

// NaN-propagating max / min (jnp.maximum / torch.maximum semantics).
__device__ __forceinline__ double max_nan(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ double min_nan(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// erf and exp: fdlibm's s_erf.c and e_exp.c (both within 1 ulp), op for
// op the sequence of erf / exp in kernels/alert_select.py, every operation
// correctly rounded, so the kernel, the plain version on the card and the
// plain version on the CPU give the same bits.  fdlibm's constants, as
// hexadecimal literals; polynomials c0 + s*(c1 + s*(... + s*cn)).
#define ERF_ERX 0x1.b0ac160000000p-1
#define ERF_EFX 0x1.06eba8214db69p-3
#define ERF_EFX8 0x1.06eba8214db69p+0
#define EXP_LN2_HI 0x1.62e42fee00000p-1
#define EXP_LN2_LO 0x1.a39ef35793c76p-33
#define EXP_INV_LN2 0x1.71547652b82fep+0
#define EXP_O_THRESHOLD 0x1.62e42fefa39efp+9
#define EXP_U_THRESHOLD -0x1.74910d52d3051p+9

__device__ __forceinline__ double erf_pp(double s) {
  double a = -0x1.8ead6120016acp-16;
  a = __dadd_rn(-0x1.7a291236668e4p-8, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.d2a51dbd7194fp-6, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.4cd7d691cb913p-2, __dmul_rn(s, a));
  a = __dadd_rn(0x1.06eba8214db68p-3, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double erf_qq(double s) {
  double a = -0x1.09c4342a26120p-18;
  a = __dadd_rn(0x1.15dc9221c1a10p-13, __dmul_rn(s, a));
  a = __dadd_rn(0x1.4d022c4d36b0fp-8, __dmul_rn(s, a));
  a = __dadd_rn(0x1.0a54c5536cebap-4, __dmul_rn(s, a));
  a = __dadd_rn(0x1.97779cddadc09p-2, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double erf_pa(double s) {
  double a = -0x1.1bf380a96073fp-9;
  a = __dadd_rn(0x1.22a36599795ebp-5, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.c63983d3e28ecp-4, __dmul_rn(s, a));
  a = __dadd_rn(0x1.45fca805120e4p-2, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.7d240fbb8c3f1p-2, __dmul_rn(s, a));
  a = __dadd_rn(0x1.a8d00ad92b34dp-2, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.359b8bef77538p-9, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double erf_qa(double s) {
  double a = 0x1.88b545735151dp-7;
  a = __dadd_rn(0x1.bedc26b51dd1cp-7, __dmul_rn(s, a));
  a = __dadd_rn(0x1.02660e763351fp-3, __dmul_rn(s, a));
  a = __dadd_rn(0x1.2635cd99fe9a7p-4, __dmul_rn(s, a));
  a = __dadd_rn(0x1.14af092eb6f33p-1, __dmul_rn(s, a));
  a = __dadd_rn(0x1.b3e6618eee323p-4, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double erf_ra(double s) {
  double a = -0x1.3a0efc69ac25cp+3;
  a = __dadd_rn(-0x1.4526557e4d2f2p+6, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.7135cebccabb2p+7, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.44cb184282266p+7, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.f300ae4cba38dp+5, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.51e0441b0e726p+3, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.63416e4ba7360p-1, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.43412600d6435p-7, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double erf_sa(double s) {
  double a = -0x1.eeff2ee749a62p-5;
  a = __dadd_rn(0x1.a47ef8e484a93p+2, __dmul_rn(s, a));
  a = __dadd_rn(0x1.b28a3ee48ae2cp+6, __dmul_rn(s, a));
  a = __dadd_rn(0x1.ad02157700314p+8, __dmul_rn(s, a));
  a = __dadd_rn(0x1.42b1921ec2868p+9, __dmul_rn(s, a));
  a = __dadd_rn(0x1.b290dd58a1a71p+8, __dmul_rn(s, a));
  a = __dadd_rn(0x1.1350c526ae721p+7, __dmul_rn(s, a));
  a = __dadd_rn(0x1.3a6b9bd707687p+4, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double erf_rb(double s) {
  double a = -0x1.e384e9bdc383fp+8;
  a = __dadd_rn(-0x1.004616a2e5992p+10, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.3ec881375f228p+9, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.4145d43c5ed98p+7, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.1c209555f995ap+4, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.993ba70c285dep-1, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.4341239e86f4ap-7, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double erf_sb(double s) {
  double a = -0x1.670e242712d62p+4;
  a = __dadd_rn(0x1.da874e79fe763p+8, __dmul_rn(s, a));
  a = __dadd_rn(0x1.3f219cedf3be6p+11, __dmul_rn(s, a));
  a = __dadd_rn(0x1.8ffb7688c246ap+11, __dmul_rn(s, a));
  a = __dadd_rn(0x1.802eb189d5118p+10, __dmul_rn(s, a));
  a = __dadd_rn(0x1.45cae221b9f0ap+8, __dmul_rn(s, a));
  a = __dadd_rn(0x1.e568b261d5190p+4, __dmul_rn(s, a));
  return a;
}

__device__ __forceinline__ double exp_p(double s) {
  double a = 0x1.6376972bea4d0p-25;
  a = __dadd_rn(-0x1.bbd41c5d26bf1p-20, __dmul_rn(s, a));
  a = __dadd_rn(0x1.1566aaf25de2cp-14, __dmul_rn(s, a));
  a = __dadd_rn(-0x1.6c16c16bebd93p-9, __dmul_rn(s, a));
  a = __dadd_rn(0x1.555555555553ep-3, __dmul_rn(s, a));
  return a;
}

// The high 32 bits of |x| (fdlibm's __HI(x) & 0x7fffffff).
__device__ __forceinline__ int hi_word(double x) {
  return __double2hiint(x) & 0x7fffffff;
}

// 2**n exactly, for n in [-1022, 1023], from its bits.
__device__ __forceinline__ double pow2(int n) {
  return __longlong_as_double(static_cast<long long>(n + 1023) << 52);
}

__device__ __forceinline__ double alert_exp(double x) {
  if (x != x) return x;
  if (x > EXP_O_THRESHOLD) return INFINITY;
  if (x < EXP_U_THRESHOLD) return 0.0;
  const int hx = hi_word(x);
  const double sgn = x < 0.0 ? -1.0 : 1.0;
  if (hx <= 0x3fd62e42) {  // |x| <= ln2 / 2: no reduction
    if (hx < 0x3e300000) return __dadd_rn(1.0, x);
    const double tt = __dmul_rn(x, x);
    const double c = __dsub_rn(x, __dmul_rn(tt, exp_p(tt)));
    return __dsub_rn(
        1.0, __dsub_rn(__ddiv_rn(__dmul_rn(x, c), __dsub_rn(c, 2.0)), x));
  }
  // x = k ln2 + (hi - lo), |hi - lo| <= ln2 / 2; t * ln2_hi is exact.
  double t, hi, lo;
  if (hx < 0x3ff0a2b2) {  // |x| < 1.5 ln2
    t = sgn;
    hi = __dsub_rn(x, __dmul_rn(sgn, EXP_LN2_HI));
    lo = __dmul_rn(sgn, EXP_LN2_LO);
  } else {
    t = trunc(__dadd_rn(__dmul_rn(EXP_INV_LN2, x), __dmul_rn(sgn, 0.5)));
    hi = __dsub_rn(x, __dmul_rn(t, EXP_LN2_HI));
    lo = __dmul_rn(t, EXP_LN2_LO);
  }
  const int k = static_cast<int>(t);
  const double r = __dsub_rn(hi, lo);
  const double tt = __dmul_rn(r, r);
  const double c = __dsub_rn(r, __dmul_rn(tt, exp_p(tt)));
  const double y = __dsub_rn(
      1.0, __dsub_rn(__dsub_rn(lo, __ddiv_rn(__dmul_rn(r, c),
                                             __dsub_rn(2.0, c))),
                     hi));
  // y * 2**k: exact in two power-of-two steps while the result is normal;
  // below that one rounding, by 2**-1000.
  if (k >= -1021) {
    const int half = k >> 1;
    return __dmul_rn(__dmul_rn(y, pow2(half)), pow2(k - half));
  }
  return __dmul_rn(__dmul_rn(y, pow2(k + 1000)), pow2(-1000));
}

__device__ __forceinline__ double alert_erf(double x) {
  if (x != x) return x;
  const int ix = hi_word(x);
  const bool neg = x < 0.0;
  if (ix >= 0x40180000) return neg ? -1.0 : 1.0;  // |x| >= 6
  if (ix < 0x3feb0000) {                          // |x| < 0.84375
    if (ix < 0x3e300000) {                        // |x| < 2**-28
      if (ix < 0x00800000)
        return __dmul_rn(0.125, __dadd_rn(__dmul_rn(8.0, x),
                                          __dmul_rn(ERF_EFX8, x)));
      return __dadd_rn(x, __dmul_rn(ERF_EFX, x));
    }
    const double z = __dmul_rn(x, x);
    const double s = __dadd_rn(1.0, __dmul_rn(z, erf_qq(z)));
    return __dadd_rn(x, __dmul_rn(x, __ddiv_rn(erf_pp(z), s)));
  }
  const double ax = fabs(x);
  if (ix < 0x3ff40000) {                          // |x| < 1.25
    const double s = __dsub_rn(ax, 1.0);
    const double q = __dadd_rn(1.0, __dmul_rn(s, erf_qa(s)));
    const double pq = __ddiv_rn(erf_pa(s), q);
    return neg ? __dsub_rn(-ERF_ERX, pq) : __dadd_rn(ERF_ERX, pq);
  }
  const double s = __ddiv_rn(1.0, __dmul_rn(ax, ax));
  double rr, ss;
  if (ix < 0x4006db6e) {                          // |x| < 1 / 0.35
    rr = erf_ra(s);
    ss = __dadd_rn(1.0, __dmul_rn(s, erf_sa(s)));
  } else {
    rr = erf_rb(s);
    ss = __dadd_rn(1.0, __dmul_rn(s, erf_sb(s)));
  }
  const double z = __hiloint2double(__double2hiint(ax), 0);
  const double e = __dmul_rn(
      alert_exp(__dsub_rn(__dmul_rn(-z, z), 0.5625)),
      alert_exp(__dadd_rn(__dmul_rn(__dsub_rn(z, ax), __dadd_rn(z, ax)),
                          __ddiv_rn(rr, ss))));
  return neg ? __dsub_rn(__ddiv_rn(e, ax), 1.0)
             : __dsub_rn(1.0, __ddiv_rn(e, ax));
}

struct Lanes {
  const double *mu, *sd, *phi, *t, *ag, *eg;
  const int *gk, *act;
};

__global__ void __launch_bounds__(ALERT_THREADS) alert_select_kernel(
    const Lanes in, const double* __restrict__ lat_tab,
    const double* __restrict__ pw_tab, const double* __restrict__ w_tab,
    int s, int k, int l, int tpl, double q_fail, double overhead,
    int paper_faithful, int predictions, double sqrt2, double inv_sqrt_2pi,
    int* __restrict__ ints_out, double* __restrict__ f64_out) {
  extern __shared__ double smem[];
  const int kl = k * l;
  const int lanes_per_block = ALERT_THREADS / tpl;
  double* s_lat = smem;
  double* s_pw = smem + kl;
  double* s_w = smem + 2 * kl;
  for (int x = threadIdx.x; x < kl; x += blockDim.x) {
    s_lat[x] = lat_tab[x];
    s_pw[x] = pw_tab[x];
  }
  for (int x = threadIdx.x; x < k * k; x += blockDim.x) s_w[x] = w_tab[x];

  const int sub = threadIdx.x & (tpl - 1);
  const int slot = threadIdx.x / tpl;
  const unsigned full = 0xffffffffu;
  const unsigned group =
      tpl == 32 ? full
                : ((1u << tpl) - 1u) << ((threadIdx.x & 31) & ~(tpl - 1));
  double* F = smem + 2 * kl + k * k + slot * kl;  // this lane's F grid
  __syncthreads();

  // Threads of lanes past S compute lane S-1 (every thread of a warp
  // takes part in its shuffles) and store nothing.
  const int lane = blockIdx.x * lanes_per_block + slot;
  const bool valid = lane < s;
  const int li = valid ? lane : s - 1;

  // Dead-lane sanitisation comes before any arithmetic.
  const bool act = in.act[li] != 0;
  const double mu = act ? in.mu[li] : 1.0;
  const double sd = act ? in.sd[li] : 0.1;
  const double phi = act ? in.phi[li] : 0.25;
  const double t = act ? in.t[li] : 1.0;
  const double ag = act ? in.ag[li] : 0.0;
  const double eg = act ? in.eg[li] : 0.0;
  const bool is_min = in.gk[li] == GOAL_MIN_ENERGY;
  const double te = max_nan(__dsub_rn(t, overhead), 1e-9);

  // Eq. 7: finish CDF of this thread's cells.
#pragma unroll
  for (int m = 0; m < ALERT_CELLS; ++m) {
    const int c = sub + tpl * m;
    if (c < kl) {
      const double lm = __dmul_rn(mu, s_lat[c]);
      const double ls = max_nan(__dmul_rn(sd, s_lat[c]), 1e-12);
      const double z = __ddiv_rn(__dsub_rn(te, lm), ls);
      F[c] = __dmul_rn(0.5,
                       __dadd_rn(1.0, alert_erf(__ddiv_rn(z, sqrt2))));
    }
  }
  __syncwarp();

  // Eq. 10 staircase accuracy + Eq. 9 energy per cell; Eq. 4/5
  // feasibility.
  double ACC[ALERT_CELLS], EN[ALERT_CELLS];
  bool mine = false;
#pragma unroll
  for (int m = 0; m < ALERT_CELLS; ++m) {
    const int c = sub + tpl * m;
    ACC[m] = 0.0;
    EN[m] = 0.0;
    if (c < kl) {
      const int kk = c / l, col = c - kk * l;
      double sum = __dmul_rn(s_w[kk * k], F[col]);
      for (int u = 1; u < k; ++u)
        sum = __dadd_rn(sum, __dmul_rn(s_w[kk * k + u], F[u * l + col]));
      const double acc = __dadd_rn(q_fail, sum);
      const double lm = __dmul_rn(mu, s_lat[c]);
      double t_run;
      if (paper_faithful) {
        t_run = min_nan(lm, te);
      } else {
        const double ls = max_nan(__dmul_rn(sd, s_lat[c]), 1e-12);
        const double z = __ddiv_rn(__dsub_rn(te, lm), ls);
        const double pdf = __dmul_rn(
            alert_exp(__dmul_rn(-0.5, __dmul_rn(z, z))), inv_sqrt_2pi);
        const double f = F[c];
        t_run = __dsub_rn(
            __dadd_rn(__dmul_rn(lm, f), __dmul_rn(te, __dsub_rn(1.0, f))),
            __dmul_rn(ls, pdf));
        t_run = min_nan(max_nan(t_run, 0.0), te);
      }
      const double caps = s_pw[c];
      const double idle = __dmul_rn(__dmul_rn(phi, caps),
                                    max_nan(__dsub_rn(te, t_run), 0.0));
      ACC[m] = acc;
      EN[m] = __dadd_rn(__dmul_rn(caps, t_run), idle);
      mine |= is_min ? (acc >= ag) : (EN[m] <= eg);
    }
  }
  bool any_f = (__ballot_sync(full, mine) & group) != 0;

  // Eq. 5 lexicographic stage: best accuracy among the usable cells.
  double best = -INFINITY;
#pragma unroll
  for (int m = 0; m < ALERT_CELLS; ++m) {
    if (sub + tpl * m < kl) {
      const bool feas = is_min ? (ACC[m] >= ag) : (EN[m] <= eg);
      best = max_nan(best, (feas || !any_f) ? ACC[m] : -INFINITY);
    }
  }
  for (int off = tpl >> 1; off > 0; off >>= 1)
    best = max_nan(best, __shfl_xor_sync(full, best, off));

  // Merged score; argmin over (score, cell), the lower cell on equal
  // scores, carrying the cell's accuracy and energy for the gathers
  // (so no register array is indexed at run time); a NaN score anywhere
  // gives K*L.
  double b_sc = INFINITY, b_acc = 0.0, b_en = 0.0;
  int b_c = ALERT_MAX_KL;
  bool nan_here = false;
#pragma unroll
  for (int m = 0; m < ALERT_CELLS; ++m) {
    const int c = sub + tpl * m;
    if (c < kl) {
      const bool feas = is_min ? (ACC[m] >= ag) : (EN[m] <= eg);
      double sc;
      if (is_min) {
        sc = any_f ? (feas ? EN[m] : INFINITY) : -ACC[m];
      } else {
        const double use = (feas || !any_f) ? ACC[m] : -INFINITY;
        sc = (__dsub_rn(best, use) <= 1e-12) ? EN[m] : INFINITY;
      }
      nan_here |= sc != sc;
      if (sc < b_sc || (sc == b_sc && c < b_c)) {
        b_sc = sc;
        b_c = c;
        b_acc = ACC[m];
        b_en = EN[m];
      }
    }
  }
  for (int off = tpl >> 1; off > 0; off >>= 1) {
    const double o_sc = __shfl_xor_sync(full, b_sc, off);
    const int o_c = __shfl_xor_sync(full, b_c, off);
    const double o_acc = __shfl_xor_sync(full, b_acc, off);
    const double o_en = __shfl_xor_sync(full, b_en, off);
    if (o_sc < b_sc || (o_sc == b_sc && o_c < b_c)) {
      b_sc = o_sc;
      b_c = o_c;
      b_acc = o_acc;
      b_en = o_en;
    }
  }
  int pick = (__ballot_sync(full, nan_here) & group) ? kl : b_c;
  int relaxed = any_f ? RELAXED_NONE
                      : (is_min ? RELAXED_ACCURACY : RELAXED_POWER);
  if (!act) {
    pick = 0;
    any_f = false;
    relaxed = RELAXED_NONE;
  }
  if (!valid || sub != 0) return;
  ints_out[lane] = pick / l;
  ints_out[s + lane] = pick % l;
  ints_out[2 * s + lane] = any_f ? 1 : 0;
  ints_out[3 * s + lane] = relaxed;

  // Gathers: the picked cell's values, each plus 0.0 as the plain
  // version's one-hot sum adds the other cells' +0.0 (a -0.0 comes back
  // +0.0); 0.0 for the K*L "no cell" pick of a NaN row and for dead
  // lanes.
  const bool gather = predictions && act && pick < kl;
  f64_out[lane] =
      gather ? __dadd_rn(__dmul_rn(mu, s_lat[pick]), 0.0) : 0.0;
  f64_out[s + lane] = gather ? __dadd_rn(b_acc, 0.0) : 0.0;
  f64_out[2 * s + lane] = gather ? __dadd_rn(b_en, 0.0) : 0.0;
}

extern "C" {

int alert_select_max_k() { return ALERT_MAX_K; }
int alert_select_max_kl() { return ALERT_MAX_KL; }

const char* alert_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One decision per lane for lanes mu .. active ([S] each; float64, then
// int32 goal codes and lane mask), into ints_out [4, S] int32 (model
// index, power index, feasible, relaxed code) and f64_out [3, S] float64
// (predicted latency, accuracy, energy), on `stream` of `device`.
// Returns cudaGetLastError() after the launch.
int alert_select_launch(const double* mu, const double* sd, const double* phi,
                        const double* t, const double* ag, const double* eg,
                        const int* gk, const int* act, const double* lat_tab,
                        const double* pw_tab, const double* w_tab, int s,
                        int k, int l, double q_fail, double overhead,
                        int paper_faithful, int predictions, double sqrt2,
                        double inv_sqrt_2pi, int* ints_out, double* f64_out,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > ALERT_MAX_K || k * l > ALERT_MAX_KL || l < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s <= 0) return 0;
  const int kl = k * l;
  int tpl = 1;
  while (tpl < kl && tpl < 32) tpl <<= 1;
  const int lanes_per_block = ALERT_THREADS / tpl;
  const long long blocks = (static_cast<long long>(s) + lanes_per_block - 1) /
                           lanes_per_block;
  const size_t shmem =
      sizeof(double) * (2 * kl + k * k + lanes_per_block * kl);
  const Lanes in = {mu, sd, phi, t, ag, eg, gk, act};
  alert_select_kernel<<<static_cast<unsigned>(blocks), ALERT_THREADS, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      in, lat_tab, pw_tab, w_tab, s, k, l, tpl, q_fail, overhead,
      paper_faithful, predictions, sqrt2, inv_sqrt_2pi, ints_out, f64_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
