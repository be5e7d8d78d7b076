// nested_matmul: block-lower-triangular nested matmul under width
// nesting (paper Section 4.2.1), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/nested_matmul.py::nested_matmul
// (body _kernel, per-tile k limits from tile_limits).  It computes
//   out[:, c] = x[:, :K(c)] @ w[:K(c), c]      for c < out_bounds[level]
// with K(c) = in_bounds[min(i, n_in)] and i the output stripe of column c,
// accumulated in float32 and written once in the input type.
//
// What bounds it on an H100: the anytime LM calls it with M = 4 (decode)
// or M = 32 (prefill) rows against a 768x768 .. 3072x768 weight, so it
// does 2*M flops per weight element read: about 32 FLOP/B in bf16 at
// M=32, far under the ~295 FLOP/B where the tensor cores would be the
// limit.  It is bound by the bytes of the live weight blocks
// (nested_matmul_cost in the Python module), and at these sizes by the
// launch itself.
//
// Design: one block of 8 warps per output tile of 32 columns and BM
// rows (BM = 8 for decode-sized M, else 32).  Lane = output column; the
// 8 warps split each 128-wide k step 16 apiece, so a block runs 8 short
// dependent chains instead of one long one, and one cross-warp sum in
// shared memory at the end.  Each step the x tile [BM, 128] is staged
// in shared memory as float32 and read back as float4 broadcasts; a
// lane's 16 weights come straight from global memory, coalesced across
// the warp.  The next step's x and w are loaded into registers while the
// current step computes.  The limit is per column, computed in the
// kernel from the stripe boundaries that arrive by value, so no stripe
// width needs to be a multiple of the tile: a w element past its
// column's limit is loaded as 0, and the block's k loop stops at the
// limit of its last column (limits rise with the column).  Rows past M
// and columns past width(level) are guarded.  x and w are read through
// their row strides, so a level prefix of x or the full weight of a
// truncated level needs no copy.
//
// Speed (wgmma on TMA-loaded tiles, split-k across blocks for the narrow
// d->d projection, 16 B weight loads) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NM_MAX_LEVELS 8
#define NM_BN 32                       // columns per block: one per lane
#define NM_WARPS 8                     // warps per block, splitting k
#define NM_KW 16                       // k per warp per step
#define NM_KC (NM_WARPS * NM_KW)       // k per step: 128
#define NM_THREADS (NM_WARPS * 32)
#define NM_SMEM_FLOATS (NM_WARPS * 32 * NM_BN)  // cross-warp sum at BM=32

#define NM_FLOAT32 0
#define NM_BFLOAT16 1

struct Bounds {
  int b[NM_MAX_LEVELS + 1];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Input prefix read by output column c: the width of input level
// min(i, n_in), with i the 1-based output stripe holding c.
__device__ __forceinline__ int column_limit(int c, const Bounds& ob,
                                            int n_out, const Bounds& ib,
                                            int n_in) {
  int i = 1;
  while (i < n_out && c >= ob.b[i]) ++i;
  return ib.b[i < n_in ? i : n_in];
}

// Registers <- step k0's x elements (thread element e = tid + i * THREADS
// is row e % BM, k e / BM of the tile) and this lane's NM_KW weights of
// its warp's share of the step; zero past the limits.
template <typename T, int BM>
__device__ __forceinline__ void load_step(
    const T* __restrict__ x, const T* __restrict__ w_col, long long ldx,
    long long ldw, int m, int m0, int k0, int k_end, int my_lim, int warp,
    float (&xr)[NM_KC * BM / NM_THREADS], float (&wr)[NM_KW]) {
#pragma unroll
  for (int i = 0; i < NM_KC * BM / NM_THREADS; ++i) {
    const int e = threadIdx.x + i * NM_THREADS;
    const int row = m0 + e % BM, k = k0 + e / BM;
    xr[i] = (row < m && k < k_end)
                ? to_f32(x[static_cast<long long>(row) * ldx + k])
                : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < NM_KW; ++t) {
    const int k = k0 + warp * NM_KW + t;
    wr[t] = k < my_lim ? to_f32(w_col[static_cast<long long>(k) * ldw])
                       : 0.0f;
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(NM_THREADS) nested_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int m, long long ldx, long long ldw, int n_cols, Bounds ib, int n_in,
    Bounds ob, int n_out) {
  constexpr int XR = NM_KC * BM / NM_THREADS;  // x elements per thread
  // The x tile of one step ([NM_KC][BM]), then the partial sums of the
  // warps ([NM_WARPS][BM][NM_BN]).
  __shared__ __align__(16) float smem[NM_SMEM_FLOATS];
  __shared__ int lim[NM_BN];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * NM_BN;
  if (threadIdx.x < NM_BN) {
    const int c = n0 + threadIdx.x;
    lim[threadIdx.x] = c < n_cols ? column_limit(c, ob, n_out, ib, n_in) : 0;
  }
  __syncthreads();
  const int k_end = lim[min(n0 + NM_BN, n_cols) - 1 - n0];
  const int my_lim = lim[lane];
  const T* w_col = w + n0 + lane;

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.0f;
  float xr[XR], wr[NM_KW];

  if (k_end > 0)
    load_step<T, BM>(x, w_col, ldx, ldw, m, m0, 0, k_end, my_lim, warp, xr,
                     wr);
  for (int k0 = 0; k0 < k_end; k0 += NM_KC) {
    __syncthreads();  // the previous step's readers are done with smem
#pragma unroll
    for (int i = 0; i < XR; ++i) smem[threadIdx.x + i * NM_THREADS] = xr[i];
    float wc[NM_KW];
#pragma unroll
    for (int t = 0; t < NM_KW; ++t) wc[t] = wr[t];
    __syncthreads();
    if (k0 + NM_KC < k_end)  // the next step's loads overlap this compute
      load_step<T, BM>(x, w_col, ldx, ldw, m, m0, k0 + NM_KC, k_end, my_lim,
                       warp, xr, wr);
#pragma unroll
    for (int t = 0; t < NM_KW; ++t) {
      const float4* xv =
          reinterpret_cast<const float4*>(smem + (warp * NM_KW + t) * BM);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 v = xv[q];
        acc[4 * q + 0] = fmaf(v.x, wc[t], acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v.y, wc[t], acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, wc[t], acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, wc[t], acc[4 * q + 3]);
      }
    }
  }

  // Sum the warps' partial tiles: smem[warp][r][lane], then each thread
  // adds up outputs over the warps in warp order.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BM; ++r) smem[(warp * BM + r) * NM_BN + lane] = acc[r];
  __syncthreads();
  for (int o = threadIdx.x; o < BM * NM_BN; o += NM_THREADS) {
    const int r = o / NM_BN, cc = o % NM_BN;
    const int row = m0 + r, col = n0 + cc;
    if (row >= m || col >= n_cols) continue;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NM_WARPS; ++j) s += smem[(j * BM + r) * NM_BN + cc];
    out[static_cast<long long>(row) * n_cols + col] = from_f32<T>(s);
  }
}

template <typename T, int BM>
static void launch(const void* x, const void* w, void* out, int m,
                   long long ldx, long long ldw, int n_cols, const Bounds& ib,
                   int n_in, const Bounds& ob, int n_out,
                   cudaStream_t stream) {
  const dim3 grid((n_cols + NM_BN - 1) / NM_BN, (m + BM - 1) / BM);
  nested_matmul_kernel<T, BM><<<grid, NM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), m, ldx, ldw, n_cols, ib, n_in, ob, n_out);
}

template <typename T>
static void launch_rows(const void* x, const void* w, void* out, int m,
                        long long ldx, long long ldw, int n_cols,
                        const Bounds& ib, int n_in, const Bounds& ob,
                        int n_out, cudaStream_t stream) {
  if (m <= 8)
    launch<T, 8>(x, w, out, m, ldx, ldw, n_cols, ib, n_in, ob, n_out,
                 stream);
  else
    launch<T, 32>(x, w, out, m, ldx, ldw, n_cols, ib, n_in, ob, n_out,
                  stream);
}

extern "C" {

const char* nested_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[m, n_cols] = nested x[m, :] @ w[:, :n_cols] on `stream` of `device`.
// in_bounds holds n_in + 1 cumulative input widths, out_bounds n_out + 1
// cumulative output widths (n_out = the level; n_cols = out_bounds[n_out]).
// Returns cudaGetLastError() after the launch.
int nested_matmul_launch(const void* x, const void* w, void* out, int m,
                         long long ldx, long long ldw, int n_cols,
                         const int* in_bounds, int n_in,
                         const int* out_bounds, int n_out, int dtype,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_in < 1 || n_in > NM_MAX_LEVELS || n_out < 1 ||
      n_out > NM_MAX_LEVELS || n_cols != out_bounds[n_out] || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n_cols == 0) return 0;
  Bounds ib = {}, ob = {};
  for (int i = 0; i <= n_in; ++i) ib.b[i] = in_bounds[i];
  for (int i = 0; i <= n_out; ++i) ob.b[i] = out_bounds[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == NM_FLOAT32)
    launch_rows<float>(x, w, out, m, ldx, ldw, n_cols, ib, n_in, ob, n_out,
                       s);
  else if (dtype == NM_BFLOAT16)
    launch_rows<__nv_bfloat16>(x, w, out, m, ldx, ldw, n_cols, ib, n_in, ob,
                               n_out, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
