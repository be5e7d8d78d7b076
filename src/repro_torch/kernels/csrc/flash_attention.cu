// flash_attention: streaming-softmax prefill attention for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel).  It computes, for q [B,S,h,hd] over k, v [B,T,kv,hd],
//   out[b,i,n] = sum_j p_ij v[b,j,n/g] / max(sum_j p_ij, 1e-30)
// with g = h/kv, logits x_ij = (q_i . k_j) * hd^-0.5 in float32, an optional
// softcap * tanh(x / softcap), the causal (i >= j) and window (i - j <
// window) masks on index positions, and p_ij = exp(x_ij - m_i) rounded to
// the input type before the PV product (the Pallas kernel's
// p.astype(v.dtype)); m, l and the accumulator are float32.
//
// What bounds it on an H100: 4*hd flops per live (query, key) pair against
// 2*hd*itemsize bytes per query row and key row, so at the model's
// 2048-token prompt it is bound by operations (about 26 GFLOP causal;
// flash_attention_cost in the Python module), and at the served path's
// 8-token prompts by the launch itself.  Operations at that rate exist
// only on the tensor cores, so the two types take two kernels:
//
// bfloat16 (the served type): flash_attention_bf16_kernel, FlashAttention-
// 2's design on this card's mma.sync tensor-core instructions (and, for
// the served head dim 96 past one key tile, flash_attention_wgmma_kernel:
// the same algorithm with both products on wgmma, see below).  One block
// of 4 warps per (64-row query tile, query head, batch row); each warp
// owns 16 query rows.  k/v tiles (BK = 64 keys, 32 above hd 128) stay
// bf16 in shared memory, brought by a 2-stage cp.async ring (tile n+1 is
// on its way while tile n is computed).  Rows are padded by 16 bytes, so
// the 8 rows an ldmatrix reads fall in 8 different 16-byte bank groups
// (hd 96 is a 192-byte row, 4-way conflicted unpadded).  QK^T is
// mma.sync.m16n8k16 bf16 -> float32 with Q (in registers, or reread from
// shared memory where registers are short: see launch_bf16_hd) and K
// from ldmatrix; then scale, the optional softcap, the
// causal and window masks (elementwise only on tiles that cross a mask's
// edge or the end of k) and the online softmax in base 2, each row's max
// and sum across the 4 lanes of a quad.  p is rounded to bf16 in
// registers and reused as the A operand of PV, with V read by
// ldmatrix.trans; the accumulator, m and l are float32, and the epilogue
// is acc / max(l, 1e-30).  A head dim below an instance's width (a
// multiple of 8 but not of 16, or between the instances 32, 64, 96, 128,
// 192, 256) is zero-padded in shared memory.  Query tiles are issued
// longest first (the last causal tile first), so the causal tail does not
// straggle.
//
// float32: flash_attention_kernel, the CUDA cores' float32 FMAs (67
// TFLOP/s).  The tensor cores take float32 only as TF32 (10-bit
// mantissa), which cannot meet the 1e-5 tolerance float32 is held to.
// One block of 256 threads per (64-row query tile, query head, batch
// row): the query tile is staged in shared memory as float32 once; the
// block walks the 64-key tiles that the causal and window masks leave
// live, staging each k and v tile as float32 (16-byte loads, rows read
// through their strides).  Thread (ty, tx) of a 16 x 16 grid owns query
// rows 4*ty..4*ty+3, key columns tx + 16*j of the logit tile and head-dim
// columns tx + 16*c of the output, so a row's max and sum are shuffles
// across 16 lanes.  Shared rows are padded by 4 floats so the float4
// reads of 8 neighbouring rows fall in different banks.
//
// Both: whole dead key tiles are never loaded.  Masked logits are minus
// infinity and a row that has seen no live key keeps m = -inf and p = 0
// (the Pallas kernel starts m at -1e30 instead, so a fully masked row of
// a live tile adds p = 1 until a later tile wipes it); rows of q past S
// and of k/v past T are zero and masked.  Above 48 KB the shared memory
// is dynamic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_PLD (FA_BK + 4)  // row stride of the p tile
#define FA_FLOAT32 0
#define FA_BFLOAT16 1

// Rows row0 .. row0+63 of one head of an operand (base already at the
// batch row and head, row stride rs elements) -> dst [64][ld]; rows at or
// past n_valid are zero.
__device__ __forceinline__ void load_tile(const float* __restrict__ base,
                                          long long rs, int row0,
                                          int n_valid, int hd, float* dst,
                                          int ld) {
  const int cpr = hd / 4;
  for (int idx = threadIdx.x; idx < 64 * cpr; idx += FA_THREADS) {
    const int r = idx / cpr, c = (idx - r * cpr) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        r < n_valid ? *reinterpret_cast<const float4*>(
                          base + static_cast<long long>(row0 + r) * rs + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int NC>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int Tk, int H,
    int G, int hd, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, float softcap,
    float scale) {
  constexpr int VLD = 16 * NC;  // v rows: the output columns this NC covers
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* Qs = smem;               // [FA_BQ][ld]
  float* Ks = Qs + FA_BQ * ld;    // [FA_BK][ld]
  float* Vs = Ks + FA_BK * ld;    // [FA_BK][VLD]
  float* Ps = Vs + FA_BK * VLD;   // [FA_BQ][FA_PLD]

  const int head = blockIdx.y, bi = blockIdx.z;
  const int q0 = blockIdx.x * FA_BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qb = q + bi * qsb + head * qsh;
  const float* kb = k + bi * ksb + (head / G) * ksh;
  const float* vb = v + bi * vsb + (head / G) * vsh;

  // Live key tiles: causal keeps keys <= the tile's last query row, the
  // window keys >= its first query row - window + 1.
  const int q_last = min(q0 + FA_BQ, S) - 1;
  int kt_lo = 0, kt_hi = (Tk + FA_BK - 1) / FA_BK;
  if (causal) kt_hi = min(kt_hi, q_last / FA_BK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / FA_BK;

  load_tile(qb, qss, q0, S - q0, hd, Qs, ld);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(kb, kss, k0, Tk - k0, hd, Ks, ld);
    load_tile(vb, vss, k0, Tk - k0, hd, Vs, VLD);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool live = kp < Tk && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        s[i][j] = live ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - mu);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mu);
        rs += p;
        Ps[(ty * 4 + i) * FA_PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < FA_BK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * FA_PLD + j);
        p[i][0] = p4.x;
        p[i][1] = p4.y;
        p[i][2] = p4.z;
        p[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = Vs[(j + jj) * VLD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][c] = fmaf(p[i][jj], vv, acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + ((static_cast<long long>(bi) * S + row) * H + head) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o[d] = acc[i][c] / den;
    }
  }
}

template <int NC>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int Tk, int H, int KV,
                          int hd, const long long* st, int causal,
                          int window, float softcap, float scale, int device,
                          cudaStream_t stream) {
  static int configured = -1;  // device whose shared-memory limit is set
  auto kern = flash_attention_kernel<NC>;
  if (configured != device) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  const int ld = hd + 4;
  const size_t smem = sizeof(float) * static_cast<size_t>(
      FA_BQ * ld + FA_BK * ld + FA_BK * 16 * NC + FA_BQ * FA_PLD);
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Tk, H,
      H / KV, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, softcap, scale);
  return cudaGetLastError();
}

static cudaError_t launch_hd(const void* q, const void* k, const void* v,
                             void* out, int B, int S, int Tk, int H, int KV,
                             int hd, const long long* st, int causal,
                             int window, float softcap, float scale,
                             int device, cudaStream_t s) {
  // NC output columns per thread cover hd <= 16 * NC.
  if (hd <= 32)
    return launch<2>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  if (hd <= 64)
    return launch<4>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  if (hd <= 96)
    return launch<6>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  if (hd <= 128)
    return launch<8>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  return launch<16>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                       window, softcap, scale, device, s);
}

// --------------------------------------------------------------------- //
// bfloat16: mma.sync tensor-core kernel                                  //
// --------------------------------------------------------------------- //
#define FB_BQ 64
#define FB_THREADS 128
#define FB_LOG2E 1.4426950408889634f

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c[16x8] += a[16x16] b[16x8], bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Rows row0 .. row0+ROWS-1 of one head of an operand (base at the batch
// row and head, row stride rs) -> dst [ROWS][HDP + 8] by cp.async, the
// 16-byte chunks below hd (the rest is padding, zeroed once); rows at or
// past n_valid are zeroed instead.  The chunk walk is unrolled at compile
// time, so nothing is divided at run time.
template <int ROWS, int HDP>
__device__ __forceinline__ void fetch_rows(
    const __nv_bfloat16* __restrict__ base, long long rs, int row0,
    int n_valid, int hd, __nv_bfloat16* dst) {
  constexpr int CPR = HDP / 8;
  static_assert(ROWS * CPR % FB_THREADS == 0, "whole chunk rounds");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / FB_THREADS; ++i) {
    const int idx = threadIdx.x + i * FB_THREADS;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    if (c >= hd) continue;
    __nv_bfloat16* d = dst + r * (HDP + 8) + c;
    if (r < n_valid)
      cp_async16(d, base + static_cast<long long>(row0 + r) * rs + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// HDP: the instance's head-dim width (a multiple of 16, hd <= HDP), BK:
// keys per tile, QREG: the warp's Q fragments stay in registers, MINB:
// blocks per SM that the registers must allow.  blockIdx.x = head + H *
// (batch row + B * i), query tile nqt - 1 - i.
template <int HDP, int BK, bool QREG, int MINB>
__global__ void __launch_bounds__(FB_THREADS, MINB)
    flash_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int B, int S, int Tk, int H, int G, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float softcap, float scale) {
  constexpr int LD = HDP + 8;  // row stride: 16 bytes of padding
  constexpr int KS = HDP / 16;  // k-steps of QK^T
  constexpr int NO = HDP / 8;   // 8-column tiles of the output
  constexpr int NS = BK / 8;    // 8-key tiles of the logits
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + FB_BQ * LD;  // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  const int nqt = (S + FB_BQ - 1) / FB_BQ;
  int idx = blockIdx.x;
  const int head = idx % H;
  idx /= H;
  const int bi = idx % B;
  const int q0 = (nqt - 1 - idx / B) * FB_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tc = lane % 4;  // fragment row and column pair
  const __nv_bfloat16* qb = q + bi * qsb + head * qsh;
  const __nv_bfloat16* kb = k + bi * ksb + (head / G) * ksh;
  const __nv_bfloat16* vb = v + bi * vsb + (head / G) * vsh;

  const int q_last = min(q0 + FB_BQ, S) - 1;
  int kt_lo = 0, kt_hi = (Tk + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;
  const int n = max(kt_hi - kt_lo, 0);

  if (hd < HDP) {  // zero the padding columns of every row once
    const int pc = (HDP - hd) / 8;
    for (int i = threadIdx.x; i < (FB_BQ + 4 * BK) * pc; i += FB_THREADS) {
      const int r = i / pc;
      *reinterpret_cast<uint4*>(Qs + r * LD + hd + (i - r * pc) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (n > 0) {
    const int k0 = kt_lo * BK;
    fetch_rows<FB_BQ, HDP>(qb, qss, q0, S - q0, hd, Qs);
    fetch_rows<BK, HDP>(kb, kss, k0, Tk - k0, hd, Ks);
    fetch_rows<BK, HDP>(vb, vss, k0, Tk - k0, hd, Vs);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows gr, +8
  unsigned qf[QREG ? KS : 1][4];
  const int row0 = q0 + warp * 16 + gr;
  const float sl2 = scale * FB_LOG2E;
  const __nv_bfloat16* q_lane =
      Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int k_lane = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int v_lane = ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  for (int it = 0; it < n; ++it) {
    const int k0 = (kt_lo + it) * BK;
    if (it + 1 < n) {
      const int k1 = k0 + BK, st = (it + 1) & 1;
      fetch_rows<BK, HDP>(kb, kss, k1, Tk - k1, hd, Ks + st * BK * LD);
      fetch_rows<BK, HDP>(vb, vss, k1, Tk - k1, hd, Vs + st * BK * LD);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (it & 1) * BK * LD;
    const __nv_bfloat16* Vt = Vs + (it & 1) * BK * LD;
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_lane + kk * 16);
      }
    }

    // Logits of the warp's 16 rows x BK keys.
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_lane + kk * 16);
      }
#pragma unroll
      for (int j2 = 0; j2 < BK / 16; ++j2) {
        unsigned b[4];
        ldsm_x4(b, Kt + j2 * 16 * LD + k_lane + kk * 16);
        mma_bf16(sc[2 * j2], a, b[0], b[1]);
        mma_bf16(sc[2 * j2 + 1], a, b[2], b[3]);
      }
    }

    // Scale (base 2), softcap, masks on tiles that cross an edge.
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + FB_BQ - 1 - k0 >= window);
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = softcap * tanhf(sc[j][e] * scale / softcap) * FB_LOG2E;
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= sl2;
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = row0 + (e >= 2 ? 8 : 0);
          const int kp = k0 + 8 * j + 2 * tc + (e & 1);
          const bool live = kp < Tk && (!causal || qp >= kp) &&
                            (window <= 0 || qp - kp < window);
          if (!live) sc[j][e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }
    // p in bf16 as the A operand of PV: keys 16*kk2 .. +15 are logit
    // tiles 2*kk2 (a0, a1) and 2*kk2 + 1 (a2, a3).
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(sc[j][0] - mu0), p1 = exp2f(sc[j][1] - mu0);
      const float p2 = exp2f(sc[j][2] - mu1), p3 = exp2f(sc[j][3] - mu1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
#pragma unroll
      for (int n2 = 0; n2 < HDP / 16; ++n2) {
        unsigned b[4];
        ldsm_x4_trans(b, Vt + kk2 * 16 * LD + v_lane + n2 * 16);
        mma_bf16(acc[2 * n2], pa[kk2], b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], pa[kk2], b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the fetch two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    const float den = half ? d1 : d0;
    __nv_bfloat16* o =
        out + ((static_cast<long long>(bi) * S + row) * H + head) * hd;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      if (8 * i < hd)
        *reinterpret_cast<unsigned*>(o + 8 * i + 2 * tc) = pack_bf16(
            acc[i][2 * half] / den, acc[i][2 * half + 1] / den);
    }
  }
}

template <int HDP, int BK, bool QREG, int MINB>
static cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Tk, int H,
                               int KV, int hd, const long long* st,
                               int causal, int window, float softcap,
                               float scale, int device, cudaStream_t stream) {
  static int configured = -1;  // device whose shared-memory limit is set
  auto kern = flash_attention_bf16_kernel<HDP, BK, QREG, MINB>;
  if (configured != device) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  const size_t smem =
      sizeof(__nv_bfloat16) * (FB_BQ + 4 * BK) * (HDP + 8);
  const long long blocks =
      static_cast<long long>((S + FB_BQ - 1) / FB_BQ) * H * B;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), FB_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), B, S, Tk, H, H / KV, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      softcap, scale);
  return cudaGetLastError();
}

// --------------------------------------------------------------------- //
// bfloat16 on wgmma: one warpgroup per (64-row query tile, head, row)    //
// --------------------------------------------------------------------- //
// Q, K and V tiles sit in shared memory in the layout wgmma reads with
// the 64-byte swizzle: a [rows][HDP] tile is HDP / 32 regions of
// [rows][32] elements (64-byte rows), 16-byte chunk c of row r stored at
// chunk c ^ ((r >> 1) & 3), the regions 512-byte aligned.  For Q and K
// (K-major operands of QK^T) a k-step of 16 is a region and a 32-byte
// offset, and a descriptor's 8-row stride (SBO) is 512 bytes; V, read
// transposed as the B operand of PV, keeps the same layout, its
// descriptor stepping 16 keys by 1 KB with LBO the region stride (the
// next 32 output columns) and SBO 512.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(2) << 62;  // the 64-byte swizzle
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_R8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// s[64x64] += A[64x16] B[16x64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_R8(d, 0), WG_R8(d, 8), WG_R8(d, 16), WG_R8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}
// o[64x96] += A[64x16] (registers) B[16x96] (shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}, "
      "{%48,%49,%50,%51}, %52, p, 1, 1, 1;\n}\n"
      : WG_R8(d, 0), WG_R8(d, 8), WG_R8(d, 16), WG_R8(d, 24), WG_R8(d, 32),
        WG_R8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Rows row0 .. row0+ROWS-1 -> HDP / 32 regions of [ROWS][32] elements
// (64-byte rows), 16-byte chunk c of row r at c ^ ((r >> 1) & 3) (the
// 64-byte swizzle), by cp.async, chunks below hd; rows at or past n_valid
// are zeroed instead.
template <int ROWS, int HDP>
__device__ __forceinline__ void fetch_sw(
    const __nv_bfloat16* __restrict__ base, long long rs, int row0,
    int n_valid, int hd, __nv_bfloat16* dst) {
  constexpr int CPR = HDP / 8;
  static_assert(ROWS * CPR % FB_THREADS == 0, "whole chunk rounds");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / FB_THREADS; ++i) {
    const int idx = threadIdx.x + i * FB_THREADS;
    const int r = idx / CPR, c8 = idx % CPR;
    if (c8 * 8 >= hd) continue;
    char* d = reinterpret_cast<char*>(dst) + (c8 / 4) * (ROWS * 64) + r * 64 +
              ((c8 % 4) ^ ((r >> 1) & 3)) * 16;
    if (r < n_valid)
      cp_async16(d, base + static_cast<long long>(row0 + r) * rs + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The QK^T and PV products as wgmma from shared memory (P from registers),
// synchronous (each product waited for before the softmax or the next
// tile), k/v through a 2-stage cp.async ring; softmax, masks and
// epilogue as in flash_attention_bf16_kernel.
template <int HDP, int BK>
__global__ void __launch_bounds__(FB_THREADS) flash_attention_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int B, int S, int Tk, int H, int G, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float softcap, float scale) {
  static_assert(BK == 64 && HDP == 96, "one instance: n64 logits, n96 PV");
  constexpr int KS = HDP / 16, NO = HDP / 8, NS = BK / 8, STAGES = 2;
  constexpr int TILE = BK * HDP;  // elements of one k or v stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 511) & ~uintptr_t(511));
  __nv_bfloat16* Ks = Qs + FB_BQ * HDP;        // [STAGES][TILE]
  __nv_bfloat16* Vs = Ks + STAGES * TILE;      // [STAGES][TILE]

  const int nqt = (S + FB_BQ - 1) / FB_BQ;
  int idx = blockIdx.x;
  const int head = idx % H;
  idx /= H;
  const int bi = idx % B;
  const int q0 = (nqt - 1 - idx / B) * FB_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tc = lane % 4;
  const __nv_bfloat16* qb = q + bi * qsb + head * qsh;
  const __nv_bfloat16* kb = k + bi * ksb + (head / G) * ksh;
  const __nv_bfloat16* vb = v + bi * vsb + (head / G) * vsh;

  const int q_last = min(q0 + FB_BQ, S) - 1;
  int kt_lo = 0, kt_hi = (Tk + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;
  const int n = max(kt_hi - kt_lo, 0);

  if (hd < HDP) {  // zero every tile once: the padding is never loaded
    for (int i = threadIdx.x; i < (FB_BQ + 2 * STAGES * BK) * HDP / 8;
         i += FB_THREADS)
      *reinterpret_cast<uint4*>(Qs + i * 8) = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  if (n > 0) fetch_sw<FB_BQ, HDP>(qb, qss, q0, S - q0, hd, Qs);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n) {
      const int k0 = (kt_lo + st) * BK;
      fetch_sw<BK, HDP>(kb, kss, k0, Tk - k0, hd, Ks + st * TILE);
      fetch_sw<BK, HDP>(vb, vss, k0, Tk - k0, hd, Vs + st * TILE);
    }
    cp_async_commit();
  }

  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + gr;
  const float sl2 = scale * FB_LOG2E;

  for (int it = 0; it < n; ++it) {
    const int k0 = (kt_lo + it) * BK, st = it % STAGES;
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile it landed; every warp is past tile it-1's PV
    {
      const int nxt = it + STAGES - 1;
      if (nxt < n) {
        const int k1 = (kt_lo + nxt) * BK, s1 = nxt % STAGES;
        fetch_sw<BK, HDP>(kb, kss, k1, Tk - k1, hd, Ks + s1 * TILE);
        fetch_sw<BK, HDP>(vb, vss, k1, Tk - k1, hd, Vs + s1 * TILE);
      }
      cp_async_commit();
    }
    // Descriptors are made before the fence: an instruction between fence
    // and commit that writes a wgmma input serializes the wgmmas.
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
    uint64_t dq[KS], dk[KS];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int off = (kk / 2) * 32 * FB_BQ + (kk % 2) * 16;  // elements
      const int koff = (kk / 2) * 32 * BK + (kk % 2) * 16;
      dq[kk] = wg_desc(Qs + off, 16, 512);
      dk[kk] = wg_desc(Ks + st * TILE + koff, 16, 512);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, dq[kk], dk[kk]);
    wg_commit();
    wg_wait0();

    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < NS * 4; ++i)
        s[i] = softcap * tanhf(s[i] * scale / softcap) * FB_LOG2E;
    } else {
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) s[i] *= sl2;
    }
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + FB_BQ - 1 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) {
        const int qp = row0 + (i % 4 >= 2 ? 8 : 0);
        const int kp = k0 + 8 * (i / 4) + 2 * tc + (i & 1);
        const bool live = kp < Tk && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        if (!live) s[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[4 * i] *= al0;
      acc[4 * i + 1] *= al0;
      acc[4 * i + 2] *= al1;
      acc[4 * i + 3] *= al1;
    }
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(s[4 * j] - mu0), p1 = exp2f(s[4 * j + 1] - mu0);
      const float p2 = exp2f(s[4 * j + 2] - mu1);
      const float p3 = exp2f(s[4 * j + 3] - mu1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    uint64_t dv[BK / 16];
#pragma unroll
    for (int kk2 = 0; kk2 < BK / 16; ++kk2)
      dv[kk2] = wg_desc(Vs + st * TILE + kk2 * 16 * 32, BK * 64, 512);
    wg_fence();
#pragma unroll
    for (int kk2 = 0; kk2 < BK / 16; ++kk2) wgmma_rs_n96(acc, pa[kk2], dv[kk2]);
    wg_commit();
    wg_wait0();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    const float den = half ? d1 : d0;
    __nv_bfloat16* o =
        out + ((static_cast<long long>(bi) * S + row) * H + head) * hd;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      if (8 * i < hd)
        *reinterpret_cast<unsigned*>(o + 8 * i + 2 * tc) = pack_bf16(
            acc[4 * i + 2 * half] / den, acc[4 * i + 2 * half + 1] / den);
    }
  }
}

template <int HDP, int BK>
static cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int Tk, int H,
                                int KV, int hd, const long long* st,
                                int causal, int window, float softcap,
                                float scale, int device, cudaStream_t stream) {
  static int configured = -1;  // device whose shared-memory limit is set
  auto kern = flash_attention_wgmma_kernel<HDP, BK>;
  constexpr int STAGES = 2;
  if (configured != device) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  const size_t smem =
      sizeof(__nv_bfloat16) * (FB_BQ + 2 * STAGES * BK) * HDP +
      512;  // room to align the tiles to 512 bytes
  const long long blocks =
      static_cast<long long>((S + FB_BQ - 1) / FB_BQ) * H * B;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), FB_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), B, S, Tk, H, H / KV, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      softcap, scale);
  return cudaGetLastError();
}

// The bf16 instances, each with the blocks per SM that its shared memory
// allows (4 at 32, 3 at 64 and 96, 2 above): head-dim widths 32, 64 and
// 128 keep Q in registers; 96 rereads it from shared memory, which fits
// 3 blocks in 168 registers without spills (faster than 2 blocks with Q
// in 180 registers, and than Q in registers spilling at 3); 192 and 256
// reread it too and take 32-key tiles (the accumulator alone is 96 and
// 128 registers).  Head dims 72-96 with more than one key tile (the
// served model's long prompts) take the wgmma kernel, faster there; one
// key tile (the served 8-token prompts) keeps mma.sync, whose shorter
// chain of dependent steps is faster there.
static cudaError_t launch_bf16_hd(const void* q, const void* k,
                                  const void* v, void* out, int B, int S,
                                  int Tk, int H, int KV, int hd,
                                  const long long* st, int causal,
                                  int window, float softcap, float scale,
                                  int device, cudaStream_t s) {
  if (hd <= 32)
    return launch_bf16<32, 64, true, 4>(q, k, v, out, B, S, Tk, H, KV, hd, st,
                                     causal, window, softcap, scale, device,
                                     s);
  if (hd <= 64)
    return launch_bf16<64, 64, true, 3>(q, k, v, out, B, S, Tk, H, KV, hd, st,
                                     causal, window, softcap, scale, device,
                                     s);
  if (hd <= 96 && Tk > 64)
    return launch_wgmma<96, 64>(q, k, v, out, B, S, Tk, H, KV, hd, st,
                                causal, window, softcap, scale, device, s);
  if (hd <= 96)
    return launch_bf16<96, 64, false, 3>(q, k, v, out, B, S, Tk, H, KV, hd, st,
                                     causal, window, softcap, scale, device,
                                     s);
  if (hd <= 128)
    return launch_bf16<128, 64, true, 2>(q, k, v, out, B, S, Tk, H, KV, hd, st,
                                      causal, window, softcap, scale, device,
                                      s);
  if (hd <= 192)
    return launch_bf16<192, 32, false, 2>(q, k, v, out, B, S, Tk, H, KV, hd,
                                       st, causal, window, softcap, scale,
                                       device, s);
  return launch_bf16<256, 32, false, 2>(q, k, v, out, B, S, Tk, H, KV, hd, st,
                                     causal, window, softcap, scale, device,
                                     s);
}

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [B,S,H,hd] (contiguous) = attention of q over k, v on `stream` of
// `device`.  Strides are in elements: q's batch, position and head
// strides, then k's, then v's; the head dim has unit stride and every row
// is 16-byte aligned.  window 0 = none, softcap 0 = none.  Returns
// cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int Tk, int H, int KV,
                           int hd, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, int causal, int window,
                           float softcap, float scale, int dtype,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || S < 0 || Tk < 0 || H < 1 || KV < 1 || H % KV ||
      hd % 8 || hd < 8 || hd > 256 || window < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FA_FLOAT32)
    return static_cast<int>(launch_hd(q, k, v, out, B, S, Tk, H, KV,
                                             hd, st, causal, window, softcap,
                                             scale, device, s));
  if (dtype == FA_BFLOAT16)
    return static_cast<int>(launch_bf16_hd(q, k, v, out, B, S, Tk, H, KV,
                                           hd, st, causal, window, softcap,
                                           scale, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
