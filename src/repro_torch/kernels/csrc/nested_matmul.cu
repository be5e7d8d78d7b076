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
// (nested_matmul_cost in the Python module): 0.3-3.2 MB per call, which
// the card streams in about a microsecond only with most of them in
// flight at once, so at these sizes the limit is latency and the launch.
//
// v3 (bf16 with 16-byte aligned rows; the served path):
// * Work over the live triangle, split in k.  An output tile is 64
//   columns by BM rows (BM = 16 for M <= 16, else 32); its k range ends
//   at the limit of its last column (limits rise with the column).  The
//   range is cut into `splits` runs of whole 64-row steps, one block per
//   run, and the `splits` blocks of a tile form one thread-block cluster
//   (up to 16, a non-portable size above 8).  The wrapper sizes `splits`
//   from the shapes alone (nested_split_plan).
// * Bytes in flight.  Each block streams its run through a 4-stage
//   cp.async ring in dynamic shared memory: per stage 64 weight rows of
//   128 B (16 bytes a thread, 8 threads a row, so a warp reads whole
//   128-byte lines) and the BM x 64 slice of x; rows past M, k past the
//   tile's limit and columns past the level are zero-filled.
// * Tensor cores.  mma.sync m16n8k16 bf16 -> float32.  x through
//   ldmatrix and the weight through ldmatrix.trans, from rows padded to
//   144 B (conflict-free); every fragment of a stage is loaded before its
//   MMAs, so the shared-memory loads overlap.  Each of the 4 warps owns
//   16 columns.  A weight element past its column's limit is zeroed in
//   the fragment register, so no stripe width needs to be a multiple of
//   the tile or of a step.
// * Deterministic split-k.  Each block sends each share of its float32
//   partial tile to the block that owns that share, with remote stores
//   into distributed shared memory (which do not wait for a reply); after
//   one cluster barrier each owner sums its slots in rank order
//   0..splits-1 and writes the result.  A block may store into another's
//   shared memory only once that block has started: every block arrives
//   at a cluster barrier on entry and waits on it before its first
//   remote store, so the wait overlaps the main loop.  No atomics: two calls, and a call
//   replayed from a CUDA graph, give the same bits.  A tile of one split
//   is written from the registers.
//
// The CUDA-core kernel (v2) serves float32, and bf16 whose pointers or
// row strides are not 16-byte aligned: one block of 8 warps per 32-column
// tile, lane = output column, the 8 warps splitting each 128-wide k step,
// register prefetch of the next step, one cross-warp sum in shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NM_MAX_LEVELS 8
#define NM_BN 32                       // columns per block: one per lane
#define NM_WARPS 8                     // warps per block, splitting k
#define NM_KW 16                       // k per warp per step
#define NM_KC (NM_WARPS * NM_KW)       // k per step: 128
#define NM_THREADS (NM_WARPS * 32)
#define NM_SMEM_FLOATS (NM_WARPS * 32 * NM_BN)  // cross-warp sum at BM=32

#define NM3_BN 64                      // output columns per tile
#define NM3_KS 64                      // weight rows per ring stage
#define NM3_STAGES 4                   // ring depth
#define NM3_THREADS (NM3_BN * 2)       // one warp per 16 columns
#define NM3_WPITCH (NM3_BN + 8)        // smem weight row: 144 B
#define NM3_XPITCH (NM3_KS + 8)        // smem x row: 144 B
#define NM3_MAX_SPLITS 16

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

// ------------------------------------------------------------------ //
// CUDA-core kernel (v2): float32, and unaligned bf16                  //
// ------------------------------------------------------------------ //

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
static cudaError_t launch_v2(const void* x, const void* w, void* out, int m,
                             long long ldx, long long ldw, int n_cols,
                             const Bounds& ib, int n_in, const Bounds& ob,
                             int n_out, cudaStream_t stream) {
  const dim3 grid((n_cols + NM_BN - 1) / NM_BN, (m + BM - 1) / BM);
  nested_matmul_kernel<T, BM><<<grid, NM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), m, ldx, ldw, n_cols, ib, n_in, ob, n_out);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ //
// Tensor-core split-k kernel (v3): bf16, 16-byte aligned rows          //
// ------------------------------------------------------------------ //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past `src_bytes` are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split phases of a cluster barrier: arrive (relaxed: it orders no
// memory, it only says that this block has started) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int BM>
struct V3Smem {
  static constexpr int W_STAGE = NM3_KS * NM3_WPITCH;  // bf16 elements
  static constexpr int X_STAGE = BM * NM3_XPITCH;
  static constexpr int STAGE = W_STAGE + X_STAGE;
  static constexpr int RING = NM3_STAGES * STAGE;
  static constexpr int GROUPS = BM * NM3_BN / 4;  // float4 groups of a tile
  static constexpr int BYTES = RING * 2 + (GROUPS + NM3_MAX_SPLITS) * 16;
};

// One ring stage <- the weight rows [k0, k0 + NM3_KS) of the tile's 64
// columns and the matching BM x NM3_KS slice of x; zero past k_end, past
// n_cols and past row m.
template <int BM>
__device__ __forceinline__ void v3_load(
    __nv_bfloat16* ws, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, long long ldx, long long ldw, int m,
    int m0, int n0, int n_cols, int k0, int k_end) {
  __nv_bfloat16* xs = ws + V3Smem<BM>::W_STAGE;
#pragma unroll
  for (int i = threadIdx.x; i < NM3_KS * (NM3_BN / 8); i += NM3_THREADS) {
    const int r = i / (NM3_BN / 8), seg = i % (NM3_BN / 8);
    const int k = k0 + r, c = n0 + seg * 8;
    const int n = k < k_end ? max(0, min(8, n_cols - c)) : 0;
    const __nv_bfloat16* src = n ? w + static_cast<long long>(k) * ldw + c : w;
    cp_async16(smem_u32(ws + r * NM3_WPITCH + seg * 8), src, 2 * n);
  }
#pragma unroll
  for (int i = threadIdx.x; i < BM * (NM3_KS / 8); i += NM3_THREADS) {
    const int r = i / (NM3_KS / 8), seg = i % (NM3_KS / 8);
    const int row = m0 + r, k = k0 + seg * 8;
    const int n = row < m ? max(0, min(8, k_end - k)) : 0;
    const __nv_bfloat16* src =
        n ? x + static_cast<long long>(row) * ldx + k : x;
    cp_async16(smem_u32(xs + r * NM3_XPITCH + seg * 8), src, 2 * n);
  }
}

// acc += the stage's x slice @ this warp's 16 columns of its weight rows
// (rows k0 ..), with each weight element past its column's limit zeroed.
template <int BM>
__device__ __forceinline__ void v3_compute(float (&acc)[BM / 16][2][4],
                                           const __nv_bfloat16* ws, int k0,
                                           int nw, int lim0, int lim1,
                                           int warp_min_lim) {
  constexpr int KH = NM3_KS / 16;  // k16 slices of a stage
  const __nv_bfloat16* xs = ws + V3Smem<BM>::W_STAGE;
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  // Every fragment of the stage first, so the shared-memory loads
  // overlap, then the MMAs.
  uint32_t a[KH][BM / 16][4], b[KH][4];
#pragma unroll
  for (int h = 0; h < KH; ++h) {
#pragma unroll
    for (int mf = 0; mf < BM / 16; ++mf)
      ldmatrix_x4(a[h][mf], smem_u32(xs + (mf * 16 + (j & 1) * 8 + r) *
                                              NM3_XPITCH +
                                     h * 16 + (j >> 1) * 8));
    ldmatrix_x4_trans(b[h], smem_u32(ws + (h * 16 + (j & 1) * 8 + r) *
                                              NM3_WPITCH +
                                     nw + (j >> 1) * 8));
  }
  if (k0 + NM3_KS > warp_min_lim) {  // some element lies past its limit
#pragma unroll
    for (int h = 0; h < KH; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // q = 2 * fragment + k half
        const int lim = q < 2 ? lim0 : lim1;
        const int k = k0 + h * 16 + (q & 1) * 8 + 2 * (lane & 3);
        b[h][q] &= (k < lim ? 0x0000FFFFu : 0u) |
                   (k + 1 < lim ? 0xFFFF0000u : 0u);
      }
  }
#pragma unroll
  for (int h = 0; h < KH; ++h)
#pragma unroll
    for (int mf = 0; mf < BM / 16; ++mf)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
        mma_bf16(acc[mf][nf], a[h][mf], b[h][nf * 2], b[h][nf * 2 + 1]);
}

template <int BM>
__global__ void __launch_bounds__(NM3_THREADS) nested_matmul_v3_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, int m, long long ldx, long long ldw,
    int n_cols, Bounds ib, int n_in, Bounds ob, int n_out) {
  using S = V3Smem<BM>;
  constexpr int MF = BM / 16;  // m16 fragments
  static_assert(BM * NM3_BN * 4 <= S::RING * 2, "the partial fits the ring");
  // Dynamic shared memory (S::BYTES): the ring (its first BM * NM3_BN
  // floats hold this block's partial once the ring is drained), then the
  // partials the cluster's blocks send to this block: `splits` slots of
  // ceil(GROUPS / splits) float4 groups.
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float4* recv = reinterpret_cast<float4*>(smem_raw + S::RING * 2);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;  // the cluster spans gridDim.x
  const int split = blockIdx.x;
  const int n0 = blockIdx.y * NM3_BN;
  const int m0 = blockIdx.z * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = warp * 16;  // this warp's first column in the tile

  const int k_end = column_limit(min(n0 + NM3_BN, n_cols) - 1, ob, n_out,
                                 ib, n_in);
  const int n_steps = (k_end + NM3_KS - 1) / NM3_KS;
  const int s_lo = split * n_steps / splits;
  const int my_steps = (split + 1) * n_steps / splits - s_lo;
  const int c0 = n0 + nw + lane / 4;  // this thread's fragment columns
  const int lim0 = c0 < n_cols ? column_limit(c0, ob, n_out, ib, n_in) : 0;
  const int lim1 =
      c0 + 8 < n_cols ? column_limit(c0 + 8, ob, n_out, ib, n_in) : 0;
  const int warp_min_lim =
      n0 + nw < n_cols ? column_limit(n0 + nw, ob, n_out, ib, n_in) : 0;
  if (splits > 1) cluster_arrive_relaxed();  // this block has started

  float acc[MF][2][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.0f;

  // The ring: NM3_STAGES - 1 steps in flight ahead of the one computed.
#pragma unroll
  for (int st = 0; st < NM3_STAGES - 1; ++st) {
    if (st < my_steps)
      v3_load<BM>(ring + st * S::STAGE, x, w, ldx, ldw, m, m0, n0, n_cols,
                  (s_lo + st) * NM3_KS, k_end);
    cp_async_commit();
  }
  for (int i = 0; i < my_steps; ++i) {
    cp_async_wait<NM3_STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with step i - 1
    const int next = i + NM3_STAGES - 1;
    if (next < my_steps)
      v3_load<BM>(ring + (next % NM3_STAGES) * S::STAGE, x, w, ldx, ldw, m,
                  m0, n0, n_cols, (s_lo + next) * NM3_KS, k_end);
    cp_async_commit();
    v3_compute<BM>(acc, ring + (i % NM3_STAGES) * S::STAGE,
                   (s_lo + i) * NM3_KS, nw, lim0, lim1, warp_min_lim);
  }
  cp_async_wait<0>();
  if (splits == 1) {  // the whole k range: write the tile from registers
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + mf * 16 + lane / 4 + (e >> 1) * 8;
          const int col = n0 + nw + nf * 8 + 2 * (lane & 3) + (e & 1);
          if (row < m && col < n_cols)
            out[static_cast<long long>(row) * n_cols + col] =
                __float2bfloat16_rn(acc[mf][nf][e]);
        }
    return;
  }
  __syncthreads();

  // This block's float32 partial tile [BM][NM3_BN], over the drained ring.
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
      const int row = mf * 16 + lane / 4;
      const int col = nw + nf * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(part + row * NM3_BN + col) =
          make_float2(acc[mf][nf][0], acc[mf][nf][1]);
      *reinterpret_cast<float2*>(part + (row + 8) * NM3_BN + col) =
          make_float2(acc[mf][nf][2], acc[mf][nf][3]);
    }
  __syncthreads();
  // Block j owns the float4 groups [j*G/splits, (j+1)*G/splits) of the
  // tile: send each group of the partial to its owner's slot `split`
  // (remote stores, which do not wait for a reply).
  const int slot = (S::GROUPS + splits - 1) / splits;
  cluster_wait();  // every block of the cluster has started
  for (int g = threadIdx.x; g < S::GROUPS; g += NM3_THREADS) {
    const int owner = ((g + 1) * splits - 1) / S::GROUPS;
    float4* dst = cluster.map_shared_rank(recv, owner);
    dst[split * slot + g - owner * S::GROUPS / splits] =
        reinterpret_cast<const float4*>(part)[g];
  }
  cluster.sync();  // every partial has arrived; none is sent after this

  // Sum the owned groups over the slots in rank order and write them.
  const int g_lo = split * S::GROUPS / splits;
  const int g_hi = (split + 1) * S::GROUPS / splits;
  for (int g = g_lo + threadIdx.x; g < g_hi; g += NM3_THREADS) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int rank = 0; rank < splits; ++rank) {
      const float4 v = recv[rank * slot + g - g_lo];
      s[0] += v.x;
      s[1] += v.y;
      s[2] += v.z;
      s[3] += v.w;
    }
    const int row = m0 + g * 4 / NM3_BN, col = n0 + g * 4 % NM3_BN;
    if (row >= m) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < n_cols)
        out[static_cast<long long>(row) * n_cols + col + e] =
            __float2bfloat16_rn(s[e]);
  }
}

template <int BM>
static cudaError_t launch_v3(const void* x, const void* w, void* out, int m,
                             long long ldx, long long ldw, int n_cols,
                             const Bounds& ib, int n_in, const Bounds& ob,
                             int n_out, int splits, cudaStream_t stream) {
  static bool configured = false;  // the attributes, set once
  auto kernel = nested_matmul_v3_kernel<BM>;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        V3Smem<BM>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n_cols + NM3_BN - 1) / NM3_BN, (m + BM - 1) / BM);
  cfg.blockDim = dim3(NM3_THREADS);
  cfg.dynamicSmemBytes = V3Smem<BM>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      m, ldx, ldw, n_cols, ib, n_in, ob, n_out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

static bool aligned16(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

extern "C" {

const char* nested_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[m, n_cols] = nested x[m, :] @ w[:, :n_cols] on `stream` of `device`.
// in_bounds holds n_in + 1 cumulative input widths, out_bounds n_out + 1
// cumulative output widths (n_out = the level; n_cols = out_bounds[n_out]).
// `splits` is the v3 kernel's split of each tile's k range (1..16; the
// CUDA-core kernel ignores it).  Returns the launch's error code.
int nested_matmul_launch(const void* x, const void* w, void* out, int m,
                         long long ldx, long long ldw, int n_cols,
                         const int* in_bounds, int n_in,
                         const int* out_bounds, int n_out, int splits,
                         int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_in < 1 || n_in > NM_MAX_LEVELS || n_out < 1 ||
      n_out > NM_MAX_LEVELS || n_cols != out_bounds[n_out] || m < 0 ||
      splits < 1 || splits > NM3_MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n_cols == 0) return 0;
  Bounds ib = {}, ob = {};
  for (int i = 0; i <= n_in; ++i) ib.b[i] = in_bounds[i];
  for (int i = 0; i <= n_out; ++i) ob.b[i] = out_bounds[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == NM_BFLOAT16 && aligned16(x, ldx) && aligned16(w, ldw))
    err = m <= 16 ? launch_v3<16>(x, w, out, m, ldx, ldw, n_cols, ib, n_in,
                                  ob, n_out, splits, s)
                  : launch_v3<32>(x, w, out, m, ldx, ldw, n_cols, ib, n_in,
                                  ob, n_out, splits, s);
  else if (dtype == NM_BFLOAT16)
    err = m <= 8 ? launch_v2<__nv_bfloat16, 8>(x, w, out, m, ldx, ldw, n_cols,
                                              ib, n_in, ob, n_out, s)
                 : launch_v2<__nv_bfloat16, 32>(x, w, out, m, ldx, ldw,
                                               n_cols, ib, n_in, ob, n_out, s);
  else if (dtype == NM_FLOAT32)
    err = m <= 8 ? launch_v2<float, 8>(x, w, out, m, ldx, ldw, n_cols, ib,
                                       n_in, ob, n_out, s)
                 : launch_v2<float, 32>(x, w, out, m, ldx, ldw, n_cols, ib,
                                        n_in, ob, n_out, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // extern "C"
