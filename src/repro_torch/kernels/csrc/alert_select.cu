// alert_select: the fused ALERT decision pass, one thread per lane (sm_90a).
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
// 3 f64 + 4 i32 (104 B), while it does O(K*L) erf evaluations and an
// O(K*K*L) contraction in FP64; it is bound by FP64 operations and erf,
// not by device memory (alert_select_cost in the Python module).
//
// Design, correctness first: one thread per lane, lanes padded to the
// block inside the launch (threads past S return); the [K, L] latency and
// power tables and the [K, K] weights are staged in shared memory; the
// lane's F grid and its per-cell accuracy / energy live in thread-local
// arrays, so no [S, K, L] tensor ever reaches device memory.  The cells
// are scored in passes: feasibility, then the Eq. 5 best accuracy, then
// the score with the `best - acc <= 1e-12` tie and a strict-< running
// argmin in ascending k*L + l order (= _block_argmin's first occurrence).
//
// Rounding: every add / sub / mul / div of this file goes through
// __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, which are never merged
// into a fused multiply-add, and erf / exp are CUDA's double functions.
// The plain PyTorch version performs the same operations one elementwise
// op at a time, so the two round at the same places.
//
// Speed (warp-per-lane, cp.async, tables in constant memory) is later work.

#include <cuda_runtime.h>
#include <math.h>

#define ALERT_MAX_K 32
#define ALERT_MAX_KL 128
#define ALERT_THREADS 128

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

__global__ void alert_select_kernel(
    const double* __restrict__ mu_in, const double* __restrict__ sd_in,
    const double* __restrict__ phi_in, const double* __restrict__ t_in,
    const double* __restrict__ ag_in, const double* __restrict__ eg_in,
    const int* __restrict__ gk_in, const int* __restrict__ act_in,
    const double* __restrict__ lat_tab, const double* __restrict__ pw_tab,
    const double* __restrict__ w_tab, int s, int k, int l, double q_fail,
    double overhead, int paper_faithful, int predictions, double sqrt2,
    double inv_sqrt_2pi, int* __restrict__ i_out, int* __restrict__ j_out,
    double* __restrict__ lat_out, double* __restrict__ acc_out,
    double* __restrict__ en_out, int* __restrict__ feas_out,
    int* __restrict__ rel_out) {
  extern __shared__ double smem[];
  const int kl = k * l;
  double* s_lat = smem;
  double* s_pw = smem + kl;
  double* s_w = smem + 2 * kl;
  for (int x = threadIdx.x; x < kl; x += blockDim.x) {
    s_lat[x] = lat_tab[x];
    s_pw[x] = pw_tab[x];
  }
  for (int x = threadIdx.x; x < k * k; x += blockDim.x) s_w[x] = w_tab[x];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= s) return;

  // Dead-lane sanitisation comes before any arithmetic.
  const bool act = act_in[lane] != 0;
  const double mu = act ? mu_in[lane] : 1.0;
  const double sd = act ? sd_in[lane] : 0.1;
  const double phi = act ? phi_in[lane] : 0.25;
  const double t = act ? t_in[lane] : 1.0;
  const double ag = act ? ag_in[lane] : 0.0;
  const double eg = act ? eg_in[lane] : 0.0;
  const bool is_min = gk_in[lane] == GOAL_MIN_ENERGY;
  const double te = max_nan(__dsub_rn(t, overhead), 1e-9);

  // Eq. 7: finish CDF of every candidate row u at every power bucket.
  double F[ALERT_MAX_KL];
  for (int c = 0; c < kl; ++c) {
    const double lm = __dmul_rn(mu, s_lat[c]);
    const double ls = max_nan(__dmul_rn(sd, s_lat[c]), 1e-12);
    const double z = __ddiv_rn(__dsub_rn(te, lm), ls);
    F[c] = __dmul_rn(0.5, __dadd_rn(1.0, erf(__ddiv_rn(z, sqrt2))));
  }

  // Eq. 10 staircase accuracy + Eq. 9 energy per cell; Eq. 4/5 feasibility.
  double ACC[ALERT_MAX_KL];
  double EN[ALERT_MAX_KL];
  bool any_f = false;
  for (int kk = 0; kk < k; ++kk) {
    for (int c = 0; c < l; ++c) {
      const int idx = kk * l + c;
      double sum = __dmul_rn(s_w[kk * k], F[c]);
      for (int u = 1; u < k; ++u)
        sum = __dadd_rn(sum, __dmul_rn(s_w[kk * k + u], F[u * l + c]));
      const double acc = __dadd_rn(q_fail, sum);
      const double lm = __dmul_rn(mu, s_lat[idx]);
      double t_run;
      if (paper_faithful) {
        t_run = min_nan(lm, te);
      } else {
        const double ls = max_nan(__dmul_rn(sd, s_lat[idx]), 1e-12);
        const double z = __ddiv_rn(__dsub_rn(te, lm), ls);
        const double pdf =
            __dmul_rn(exp(__dmul_rn(-0.5, __dmul_rn(z, z))), inv_sqrt_2pi);
        const double f = F[idx];
        t_run = __dsub_rn(
            __dadd_rn(__dmul_rn(lm, f), __dmul_rn(te, __dsub_rn(1.0, f))),
            __dmul_rn(ls, pdf));
        t_run = min_nan(max_nan(t_run, 0.0), te);
      }
      const double caps = s_pw[idx];
      const double idle = __dmul_rn(__dmul_rn(phi, caps),
                                    max_nan(__dsub_rn(te, t_run), 0.0));
      const double en = __dadd_rn(__dmul_rn(caps, t_run), idle);
      ACC[idx] = acc;
      EN[idx] = en;
      any_f |= is_min ? (acc >= ag) : (en <= eg);
    }
  }

  // Eq. 5 lexicographic stage: best accuracy among the usable cells.
  double best = -INFINITY;
  for (int c = 0; c < kl; ++c) {
    const bool feas = is_min ? (ACC[c] >= ag) : (EN[c] <= eg);
    best = max_nan(best, (feas || !any_f) ? ACC[c] : -INFINITY);
  }

  // Merged score + first-occurrence argmin (NaN anywhere -> K*L).
  int pick = 0;
  double best_sc = 0.0;
  bool nan_seen = false;
  for (int c = 0; c < kl; ++c) {
    const bool feas = is_min ? (ACC[c] >= ag) : (EN[c] <= eg);
    double sc;
    if (is_min) {
      sc = any_f ? (feas ? EN[c] : INFINITY) : -ACC[c];
    } else {
      const double use = (feas || !any_f) ? ACC[c] : -INFINITY;
      sc = (__dsub_rn(best, use) <= 1e-12) ? EN[c] : INFINITY;
    }
    if (sc != sc) nan_seen = true;
    if (c == 0 || sc < best_sc) {
      best_sc = sc;
      pick = c;
    }
  }
  if (nan_seen) pick = kl;
  int relaxed = any_f ? RELAXED_NONE
                      : (is_min ? RELAXED_ACCURACY : RELAXED_POWER);
  if (!act) {
    pick = 0;
    any_f = false;
    relaxed = RELAXED_NONE;
  }
  i_out[lane] = pick / l;
  j_out[lane] = pick % l;
  feas_out[lane] = any_f ? 1 : 0;
  rel_out[lane] = relaxed;

  // Gathers: the picked cell's values; 0.0 for the K*L "no cell" pick of
  // a NaN row and for dead lanes.
  double g_lat = 0.0, g_acc = 0.0, g_en = 0.0;
  if (predictions && act && pick < kl) {
    g_lat = __dmul_rn(mu, s_lat[pick]);
    g_acc = ACC[pick];
    g_en = EN[pick];
  }
  lat_out[lane] = g_lat;
  acc_out[lane] = g_acc;
  en_out[lane] = g_en;
}

extern "C" {

int alert_select_max_k() { return ALERT_MAX_K; }
int alert_select_max_kl() { return ALERT_MAX_KL; }

const char* alert_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream` of `device`; returns cudaGetLastError() after launch.
int alert_select_launch(const double* mu, const double* sd, const double* phi,
                        const double* t, const double* ag, const double* eg,
                        const int* gk, const int* act, const double* lat_tab,
                        const double* pw_tab, const double* w_tab, int s,
                        int k, int l, double q_fail, double overhead,
                        int paper_faithful, int predictions, double sqrt2,
                        double inv_sqrt_2pi, int* i_out, int* j_out,
                        double* lat_out, double* acc_out, double* en_out,
                        int* feas_out, int* rel_out, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > ALERT_MAX_K || k * l > ALERT_MAX_KL || l < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s <= 0) return 0;
  const int blocks = (s + ALERT_THREADS - 1) / ALERT_THREADS;
  const size_t shmem = sizeof(double) * (2 * k * l + k * k);
  alert_select_kernel<<<blocks, ALERT_THREADS, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      mu, sd, phi, t, ag, eg, gk, act, lat_tab, pw_tab, w_tab, s, k, l,
      q_fail, overhead, paper_faithful, predictions, sqrt2, inv_sqrt_2pi,
      i_out, j_out, lat_out, acc_out, en_out, feas_out, rel_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
