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
// 8-token prompts by the launch itself.  This first version runs its
// products as float32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor
// cores' 989), so it cannot come near the bound; it is right first.
//
// Design: one block of 256 threads per (64-row query tile, query head,
// batch row).  The query tile is staged in shared memory as float32 once;
// the block walks the 64-key tiles that the causal and window masks leave
// live (whole dead tiles are never loaded), staging each k and v tile as
// float32 (16-byte loads, rows read through their strides).  Thread
// (ty, tx) of a 16 x 16 grid owns query rows 4*ty..4*ty+3, key columns
// tx + 16*j of the logit tile and head-dim columns tx + 16*c of the
// output, so a row's max and sum are shuffles across 16 lanes.  Masked
// logits are minus infinity and a row that has seen no live key keeps
// m = -inf and p = 0 (the Pallas kernel starts m at -1e30 instead, so a
// fully masked row of a live tile adds p = 1 until a later tile wipes it).
// Rows of q past S and of k/v past T are zero and masked; shared rows are
// padded by 4 floats so the float4 reads of 8 neighbouring rows fall in
// different banks.  Above 48 KB the shared memory is dynamic (hd = 256
// needs 211 KB).
//
// Speed (wgmma on bf16 tiles loaded by TMA, a pipelined k/v ring, several
// query heads of a kv head per block) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_PLD (FA_BK + 4)  // row stride of the p tile
#define FA_FLOAT32 0
#define FA_BFLOAT16 1

// 16 bytes of the input type -> float32 in shared memory.
__device__ __forceinline__ void chunk_to_f32(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void chunk_to_f32(const __nv_bfloat16* src,
                                             float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// Rows row0 .. row0+63 of one head of an operand (base already at the
// batch row and head, row stride rs elements) -> dst [64][ld] float32;
// rows at or past n_valid are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          long long rs, int row0,
                                          int n_valid, int hd, float* dst,
                                          int ld) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = hd / E;
  for (int idx = threadIdx.x; idx < 64 * cpr; idx += FA_THREADS) {
    const int r = idx / cpr, c = (idx - r * cpr) * E;
    float* d = dst + r * ld + c;
    if (r < n_valid) {
      chunk_to_f32(base + static_cast<long long>(row0 + r) * rs + c, d);
    } else {
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int Tk, int H,
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
  const T* qb = q + bi * qsb + head * qsh;
  const T* kb = k + bi * ksb + (head / G) * ksh;
  const T* vb = v + bi * vsb + (head / G) * vsh;

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
        Ps[(ty * 4 + i) * FA_PLD + tx + 16 * j] = round_to<T>(p);
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
    T* o = out + ((static_cast<long long>(bi) * S + row) * H + head) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o[d] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int Tk, int H, int KV,
                          int hd, const long long* st, int causal,
                          int window, float softcap, float scale, int device,
                          cudaStream_t stream) {
  static int configured = -1;  // device whose shared-memory limit is set
  auto kern = flash_attention_kernel<T, NC>;
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
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, H / KV, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(const void* q, const void* k, const void* v,
                             void* out, int B, int S, int Tk, int H, int KV,
                             int hd, const long long* st, int causal,
                             int window, float softcap, float scale,
                             int device, cudaStream_t s) {
  // NC output columns per thread cover hd <= 16 * NC.
  if (hd <= 32)
    return launch<T, 2>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  if (hd <= 64)
    return launch<T, 4>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  if (hd <= 96)
    return launch<T, 6>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                        window, softcap, scale, device, s);
  return launch<T, 16>(q, k, v, out, B, S, Tk, H, KV, hd, st, causal,
                       window, softcap, scale, device, s);
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
    return static_cast<int>(launch_hd<float>(q, k, v, out, B, S, Tk, H, KV,
                                             hd, st, causal, window, softcap,
                                             scale, device, s));
  if (dtype == FA_BFLOAT16)
    return static_cast<int>(launch_hd<__nv_bfloat16>(
        q, k, v, out, B, S, Tk, H, KV, hd, st, causal, window, softcap,
        scale, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
