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
// v3 (bf16 with 16-byte aligned rows, M below the crossover; the served
// path):
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
// v4 (bf16 with 16-byte aligned rows, M >= the crossover; the scoring
// prefill): at M = 512 the product does 2 * 512 flops per weight element,
// about 512 FLOP/B, above the card's ~295 FLOP/B line, so it is bound by
// the tensor cores, and by how evenly the triangle's work fills the SMs.
// v3's 32 x 64 mma.sync tiles read each weight element 16 times and reach
// ~8 % of the bound there.  v4:
// * wgmma on large tiles.  A block computes a 256 x 128 tile (128 x 128
//   where that pads M less): two consumer warpgroups, each 64 * MI rows as
//   MI m64n128k16 wgmmas a 16-deep k step, float32 accumulators in
//   registers; x K-major, w read as stored (MN-major, transposed by the
//   instruction).  One producer warp keeps TMA loads of 64-deep k stages
//   in flight through a 4-stage (6 at 128 rows) ring of mbarriers in
//   128-byte swizzled shared memory; setmaxnreg moves the producer's
//   registers to the consumers.  Tensor maps, which TMA reads, are cached
//   by pointer, shape and stride on the host.
// * The triangle, exactly.  A tile's k range ends at its last column's
//   limit; a stage into which some column's limit falls has the weight
//   elements past their limits zeroed in shared memory before the
//   wgmmas, so any stripe layout is right.  At the benchmark's widths
//   every stripe is a multiple of 128 and every prefix of 64, and no
//   stage is masked.
// * Balance.  The wide stripe's tiles read up to 8x the k of the first.
//   Blocks run longest k first (the launch order of the plan, from the
//   shapes alone: nested_wide_plan), and long tiles are split in k into
//   2-8 chunks on neighbouring blocks of one cluster, as far as that
//   evens the waves in the plan's model.  Each chunk's block sends the
//   rows that another owns through distributed shared memory (into its
//   drained ring) between two cluster barriers; the owner sums the slots
//   in chunk order and writes bf16 once.  No atomics: two calls, and a
//   replay from a CUDA graph, give the same bits.
//
// The CUDA-core kernel (v2) serves float32, and bf16 whose pointers or
// row strides are not 16-byte aligned: one block of 8 warps per 32-column
// tile, lane = output column, the 8 warps splitting each 128-wide k step,
// register prefetch of the next step, one cross-warp sum in shared memory.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the library links no driver)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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
                             int n_out, int splits, int device,
                             cudaStream_t stream) {
  static int configured = -1;  // device whose attributes are set
  auto kernel = nested_matmul_v3_kernel<BM>;
  if (configured != device) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        V3Smem<BM>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = device;
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

// ------------------------------------------------------------------ //
// Hopper kernel (v4): wgmma fed by TMA, for M at or past the crossover //
// ------------------------------------------------------------------ //

#define NM4_BN 128                     // output columns of a tile
#define NM4_BK 64                      // k rows of a stage: 128 B of bf16
#define NM4_THREADS 384                // 2 consumer warpgroups, 1 producer
#define NM4_MAX_CLUSTER 8
#define NM4_RPITCH (NM4_BN + 8)        // float row of the split-k slots

// The launch order of the column tiles: runs of tiles with one k limit,
// the longest first, each with its k split.  Block u of the 1-D grid
// takes run g with unit0[g] <= u, then (tile, row tile, chunk) with the
// chunk fastest, so a tile's chunks are neighbours in one cluster and
// the row tiles that share a weight block run side by side.
struct V4Runs {
  int n;
  int tile0[NM_MAX_LEVELS];   // first column tile of the run
  int tiles[NM_MAX_LEVELS];   // column tiles in the run
  int splits[NM_MAX_LEVELS];  // k chunks a tile (a power of 2)
  int unit0[NM_MAX_LEVELS];   // first block of the run
};

template <int MI>  // m64 blocks a consumer warpgroup: BM = 128 * MI rows
struct V4Smem {
  static constexpr int BM = 128 * MI;
  static constexpr int STAGES = MI == 2 ? 4 : 6;
  static constexpr int A_BYTES = BM * NM4_BK * 2;
  static constexpr int B_BYTES = NM4_BK * NM4_BN * 2;  // two 64-col boxes
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  // the ring, 1024-aligned by hand, then the full and empty barriers
  static constexpr int BYTES = RING + 1024 + 2 * STAGES * 8;
  static_assert(BM * NM4_RPITCH * 4 <= RING, "the split-k slots fit");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Spin until the barrier's phase of parity `parity` has completed.  A
// wait of 2^35 cycles (over 15 s) outlasts any call's work: it is a fault,
// and the kernel traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// TMA: the box at (c0 inner, c1 outer) of `map` -> shared memory, its
// bytes counted on `bar`; the box's part outside the tensor reads zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma descriptor of a tile stored with the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups of 128-byte rows, 1 KB each.
// For x (K-major) SBO is the 1 KB group stride and LBO is unused; for w
// (MN-major: 64 columns of a row contiguous) LBO is the stride of the
// next 64 columns and SBO the next 8 k rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1)
                                                     << 62;
}

#define NM4_R8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] += x[64x16] (K-major) @ w[16x128] (MN-major), both in shared
// memory: thread t of the warpgroup holds d[i] at row 16 * (t / 32) +
// (t % 32) / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (t % 4) +
// i % 2.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : NM4_R8(d, 0), NM4_R8(d, 8), NM4_R8(d, 16), NM4_R8(d, 24),
        NM4_R8(d, 32), NM4_R8(d, 40), NM4_R8(d, 48), NM4_R8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A cluster barrier's arrive with release semantics (the partials
// written before it are seen by the blocks that wait on it).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {  // the 256 consumers
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Zero the weight elements of a landed stage (k rows k0 .., the tile's
// columns n0 ..) that lie at or past their column's limit.  A column's
// 8-element chunk c of row r sits at chunk c ^ (r % 8) of its 64-column
// box's 128-byte row.
__device__ __forceinline__ void v4_mask(unsigned char* b, int k0, int n0,
                                     int n_cols, const Bounds& ob, int n_out,
                                     const Bounds& ib, int n_in) {
  for (int q = threadIdx.x; q < NM4_BK * NM4_BN / 8; q += 256) {
    const int box = q / (NM4_BK * 8), r = q / 8 % NM4_BK, p = q % 8;
    const int c = n0 + box * 64 + (p ^ (r & 7)) * 8;
    uint4* at = reinterpret_cast<uint4*>(b + box * (NM4_BK * 128) + r * 128 +
                                         p * 16);
    uint32_t v[4] = {at->x, at->y, at->z, at->w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = c + e;
      const int lim =
          col < n_cols ? column_limit(col, ob, n_out, ib, n_in) : 0;
      if (k0 + r >= lim) v[e / 2] &= (e & 1) ? 0x0000FFFFu : 0xFFFF0000u;
    }
    *at = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int MI>
__global__ void __launch_bounds__(NM4_THREADS, 1) nested_matmul_v4_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    __nv_bfloat16* __restrict__ out, int m, int n_cols, Bounds ib, int n_in,
    Bounds ob, int n_out, V4Runs runs, int m_tiles) {
  using S = V4Smem<MI>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* empty = full + S::STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());

  // This block's unit of work (nothing past the last run: a pad block).
  const int u = blockIdx.x;
  int g = 0;
  while (g + 1 < runs.n && u >= runs.unit0[g + 1]) ++g;
  const int splits = runs.splits[g];
  const int v = u - runs.unit0[g];
  const bool live = v < runs.tiles[g] * m_tiles * splits;
  const int chunk = v % splits, t = v / splits;
  const int m0 = (t % m_tiles) * S::BM;
  const int n0 = (runs.tile0[g] + t / m_tiles) * NM4_BN;
  const int k_end =
      live ? column_limit(min(n0 + NM4_BN, n_cols) - 1, ob, n_out, ib, n_in)
           : 0;
  const int lim_min = live ? column_limit(n0, ob, n_out, ib, n_in) : 0;
  const int n_steps = (k_end + NM4_BK - 1) / NM4_BK;
  const int s_lo = chunk * n_steps / splits;
  const int my_steps = (chunk + 1) * n_steps / splits - s_lo;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S::STAGES; ++st) {
      mbar_init(&full[st], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[st], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      for (int i = 0; i < my_steps; ++i) {
        const int st = i % S::STAGES;
        if (i >= S::STAGES) mbar_wait(&empty[st], (i / S::STAGES - 1) & 1);
        unsigned char* a = ring + st * S::STAGE;
        unsigned char* b = a + S::A_BYTES;
        const int k0 = (s_lo + i) * NM4_BK;
        mbar_expect_tx(&full[st], S::STAGE);
        tma_load_2d(a, &map_x, &full[st], k0, m0);
        tma_load_2d(b, &map_w, &full[st], n0, k0);
        tma_load_2d(b + NM4_BK * 128, &map_w, &full[st], n0 + 64, k0);
      }
    }
    __syncwarp();
    if (csize > 1) {  // the consumers' two cluster barriers, matched
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
  } else {
    // ---- consumer warpgroups: rows 64 * MI * wg .. of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
    const int lane = tw % 32, warp = tw / 32;
    float acc[MI][64];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mi][i] = 0.0f;

    for (int i = 0; i < my_steps; ++i) {
      const int st = i % S::STAGES;
      unsigned char* a = ring + st * S::STAGE;
      unsigned char* b = a + S::A_BYTES;
      const int k0 = (s_lo + i) * NM4_BK;
      mbar_wait(&full[st], (i / S::STAGES) & 1);
      if (k0 + NM4_BK > lim_min) {  // a column's limit falls in this stage
        v4_mask(b, k0, n0, n_cols, ob, n_out, ib, n_in);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
      }
      // Descriptors first: an instruction between the fence and the
      // commit that writes a wgmma input serializes the wgmmas.
      uint64_t da[4][MI], db[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          da[kk][mi] = sw128_desc(a + (wg * MI + mi) * 64 * 128 + kk * 32,
                                  16, 1024);
        db[kk] = sw128_desc(b + kk * 16 * 128, NM4_BK * 128, 1024);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) wgmma_n128(acc[mi], da[kk][mi], db[kk]);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
      // The previous stage's products are done: hand its slot back.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0 && tw == 0) mbar_arrive(&empty[(i - 1) % S::STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);

    const int rbase = wg * MI * 64 + warp * 16 + lane / 4;  // tile row
    const int cbase = 2 * (lane % 4);                       // tile column
    if (live && splits == 1) {  // the whole k range: write from registers
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int row = m0 + rbase + mi * 64 + 8 * ((i / 2) % 2);
          const int col = n0 + 8 * (i / 4) + cbase;
          if (row >= m) continue;
          __nv_bfloat16* o = out + static_cast<long long>(row) * n_cols + col;
          if (col + 1 < n_cols && n_cols % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(acc[mi][i], acc[mi][i + 1]);
          } else {
            if (col < n_cols) o[0] = __float2bfloat16_rn(acc[mi][i]);
            if (col + 1 < n_cols) o[1] = __float2bfloat16_rn(acc[mi][i + 1]);
          }
        }
    }
    if (csize > 1) {
      // Every block of the cluster is past its main loop, so its ring is
      // free to take the partials (and every block has started).
      cluster_arrive();
      cluster_wait();
      const int band = S::BM / splits;  // rows each chunk's block sums
      const int first = static_cast<int>(cluster.block_rank()) - chunk;
      if (live && splits > 1) {
        // Rows [r * band, (r + 1) * band) go to the tile's block r, into
        // its slot `chunk`: [splits][band][NM4_RPITCH] floats.  Lanes l
        // and l ^ 1 trade halves so that each sends 4 columns of one row
        // (the even lane row r, the odd one row r + 8) in one 16-byte
        // store.
        const bool odd = lane & 1;
        const int row_off = odd ? 8 : 0, col_off = odd ? -2 : 0;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float d0 = acc[mi][4 * j], d1 = acc[mi][4 * j + 1];
            const float d2 = acc[mi][4 * j + 2], d3 = acc[mi][4 * j + 3];
            const float a = __shfl_xor_sync(0xffffffffu, odd ? d0 : d2, 1);
            const float b = __shfl_xor_sync(0xffffffffu, odd ? d1 : d3, 1);
            const float4 v = odd ? make_float4(a, b, d2, d3)
                                 : make_float4(d0, d1, a, b);
            const int r = rbase + mi * 64 + row_off;
            const int owner = r / band;
            float* slots = cluster.map_shared_rank(
                reinterpret_cast<float*>(ring), first + owner);
            *reinterpret_cast<float4*>(
                slots + (chunk * band + r - owner * band) * NM4_RPITCH +
                8 * j + cbase + col_off) = v;
          }
      }
      cluster_arrive();  // release: the partials are written
      cluster_wait();    // acquire: every partial has arrived
      if (live && splits > 1) {
        // Sum this block's band over the slots in chunk order, write it.
        const float* slots = reinterpret_cast<const float*>(ring);
        for (int q = threadIdx.x; q < band * NM4_BN / 4; q += 256) {
          const int r = q / (NM4_BN / 4), c = q % (NM4_BN / 4) * 4;
          float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int j = 0; j < splits; ++j) {
            const float4 p = *reinterpret_cast<const float4*>(
                slots + (j * band + r) * NM4_RPITCH + c);
            s[0] += p.x;
            s[1] += p.y;
            s[2] += p.z;
            s[3] += p.w;
          }
          const int row = m0 + chunk * band + r, col = n0 + c;
          if (row >= m) continue;
          __nv_bfloat16* o = out + static_cast<long long>(row) * n_cols + col;
          if (col + 3 < n_cols && n_cols % 4 == 0) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(s[0], s[1]);
            __nv_bfloat162 hi = __floats2bfloat162_rn(s[2], s[3]);
            uint2 w2;
            w2.x = *reinterpret_cast<uint32_t*>(&lo);
            w2.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(o) = w2;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < n_cols) o[e] = __float2bfloat16_rn(s[e]);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link to the driver.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Tensor maps, cached by everything that they encode: a weight's map is
// made once, and an eager call on new activations costs one encode.
struct MapKey {
  const void* p;
  uint64_t inner, outer, ld;
  uint32_t box_outer;
  bool operator==(const MapKey& o) const {
    return p == o.p && inner == o.inner && outer == o.outer && ld == o.ld &&
           box_outer == o.box_outer;
  }
};
#define NM4_MAP_CACHE 512
static MapKey g_map_keys[NM4_MAP_CACHE];
static CUtensorMap g_maps[NM4_MAP_CACHE];
static bool g_map_used[NM4_MAP_CACHE];
static std::mutex g_map_mutex;

// The bf16 matrix [outer][inner] at p with row stride ld (elements), read
// in boxes of 64 inner x box_outer with the 128-byte swizzle; zeros past
// the edges.
static cudaError_t tensor_map(CUtensorMap* map, const void* p, uint64_t inner,
                              uint64_t outer, uint64_t ld,
                              uint32_t box_outer) {
  static EncodeTiledFn encode = nullptr;
  const MapKey key = {p, inner, outer, ld, box_outer};
  const size_t h = (reinterpret_cast<uintptr_t>(p) >> 4 ^ inner * 40503u ^
                    outer * 9973u ^ ld * 131u ^ box_outer) %
                   NM4_MAP_CACHE;
  std::lock_guard<std::mutex> lock(g_map_mutex);
  if (g_map_used[h] && g_map_keys[h] == key) {
    *map = g_maps[h];
    return cudaSuccess;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {64, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  g_map_keys[h] = key;
  g_maps[h] = *map;
  g_map_used[h] = true;
  return cudaSuccess;
}

// The v4 kernel of MI with its shared memory allowed, and a launch of
// `blocks` blocks in clusters of `csize` (the attribute points at *attr).
template <int MI>
static cudaError_t v4_config(cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr, int blocks,
                             int csize, int device,
                             cudaStream_t stream) {
  static int configured = -1;  // device whose shared-memory limit is set
  if (configured != device) {
    const cudaError_t err = cudaFuncSetAttribute(
        nested_matmul_v4_kernel<MI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, V4Smem<MI>::BYTES);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(NM4_THREADS);
  cfg->dynamicSmemBytes = V4Smem<MI>::BYTES;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int MI>
static cudaError_t launch_v4(const void* x, const void* w, void* out, int m,
                             long long ldx, long long ldw, int n_cols,
                             int k_need, const Bounds& ib, int n_in,
                             const Bounds& ob, int n_out, const V4Runs& runs,
                             int m_tiles, int blocks, int csize, int device,
                             cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  cudaError_t err = tensor_map(&map_x, x, k_need, m, ldx, V4Smem<MI>::BM);
  if (err == cudaSuccess) err = tensor_map(&map_w, w, n_cols, k_need, ldw,
                                           NM4_BK);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (err == cudaSuccess) err = v4_config<MI>(&cfg, &attr, blocks, csize,
                                              device, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, nested_matmul_v4_kernel<MI>, map_x, map_w,
                           static_cast<__nv_bfloat16*>(out), m, n_cols, ib,
                           n_in, ob, n_out, runs, m_tiles);
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
                                  ob, n_out, splits, device, s)
                  : launch_v3<32>(x, w, out, m, ldx, ldw, n_cols, ib, n_in,
                                  ob, n_out, splits, device, s);
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


// out[m, n_cols] = nested x @ w by the v4 kernel: bf16 x [m, >= k_need]
// and w [>= k_need, >= n_cols], 16-byte aligned rows.  The plan
// (nested_wide_plan in the Python module): bm = 128 or 256 rows a tile,
// m_tiles row tiles, `cluster` blocks a cluster (1, 2, 4 or 8), `blocks`
// blocks in all, and n_runs runs of column tiles in launch order, each
// (first tile, tiles, splits, first block).  Returns the launch's error
// code.
int nested_matmul_v4_launch(const void* x, const void* w, void* out, int m,
                            long long ldx, long long ldw, int n_cols,
                            int k_need, const int* in_bounds, int n_in,
                            const int* out_bounds, int n_out, int bm,
                            int m_tiles, int cluster, int blocks,
                            const int* runs, int n_runs, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n_in < 1 || n_in > NM_MAX_LEVELS || n_out < 1 ||
      n_out > NM_MAX_LEVELS || n_cols != out_bounds[n_out] || m < 1 ||
      n_cols < 1 || k_need < 1 || (bm != 128 && bm != 256) ||
      m_tiles != (m + bm - 1) / bm || cluster < 1 ||
      cluster > NM4_MAX_CLUSTER || (cluster & (cluster - 1)) != 0 ||
      blocks < 1 || blocks % cluster != 0 || n_runs < 1 ||
      n_runs > NM_MAX_LEVELS || !aligned16(x, ldx) || !aligned16(w, ldw))
    return invalid;
  Bounds ib = {}, ob = {};
  for (int i = 0; i <= n_in; ++i) ib.b[i] = in_bounds[i];
  for (int i = 0; i <= n_out; ++i) ob.b[i] = out_bounds[i];
  V4Runs r = {};
  r.n = n_runs;
  for (int g = 0; g < n_runs; ++g) {
    r.tile0[g] = runs[4 * g];
    r.tiles[g] = runs[4 * g + 1];
    r.splits[g] = runs[4 * g + 2];
    r.unit0[g] = runs[4 * g + 3];
    const int s = r.splits[g];
    if (s < 1 || s > cluster || (s & (s - 1)) != 0 || r.unit0[g] % s != 0 ||
        (g > 0 && r.unit0[g] != r.unit0[g - 1] +
                                    r.tiles[g - 1] * m_tiles *
                                        r.splits[g - 1]))
      return invalid;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bm == 256 ? launch_v4<2>(x, w, out, m, ldx, ldw, n_cols, k_need, ib,
                                 n_in, ob, n_out, r, m_tiles, blocks, cluster,
                                 device, s)
                  : launch_v4<1>(x, w, out, m, ldx, ldw, n_cols, k_need, ib,
                                 n_in, ob, n_out, r, m_tiles, blocks, cluster,
                                 device, s);
  return static_cast<int>(err);
}

}  // extern "C"
