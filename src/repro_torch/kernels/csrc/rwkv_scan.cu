// rwkv_scan: the RWKV-6 recurrence over a sequence, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rwkv_scan.py::rwkv_scan (body
// _kernel).  Per batch row b and head h, with a float32 [hd, hd] state S
// that starts at s0[b,h]:
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// for t = 0 .. S_len-1; r, k, v, w [B,S,H,hd] in float32 or bf16 (read
// as float32), u [H,hd] and s0 [B,H,hd,hd] float32.  Writes y [B,S,H,hd]
// (contiguous, input type) and the final state [B,H,hd,hd] (float32).
//
// What bounds it on an H100: per token and head it moves 5 hd values
// (r, k, v, w in, y out) and does about 5 hd^2 float32 flops on the state,
// about hd/4 flops per float32 byte, so at hd = 64 the bytes and the
// float32 rate (67 TFLOP/s) give bounds of the same size
// (rwkv_scan_cost in the Python module).  What keeps it far from either is
// the recurrence: the tokens of one (b, h) run one after another, and
// there are only B * H blocks (160 at the served B=4, H=40; 40 at B=1).
//
// Design: one block per (head, batch row), HD threads; thread j owns
// column j of the state (HD floats) in registers for the whole sequence.
// A chunk of RS_CH tokens of r, k, v, w (and u * k) is staged in shared
// memory as float32 with 16-byte loads (unrolled so that several loads of
// a thread are in flight at once), then every thread walks the chunk's
// tokens reading r, k, u * k and w as broadcasts, so no thread waits on
// another inside a token; y_j's sum over i runs in 4 interleaved partial
// sums.  Two other layouts were measured on an H100 and dropped, both
// slower at every shape: a quarter of a column per thread (4x the threads,
// y summed by shuffles) and a 4-column x 16-row tile per thread.  What
// bounds this one is the serial work of a token within one block (one or
// two warps per SM) and the staging stall between chunks; splitting the
// columns of a head over several blocks, a cp.async ring, and the chunked
// matrix form of the recurrence on the tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RS_CH 32          // tokens per staged chunk
#define RS_FLOAT32 0
#define RS_BFLOAT16 1

// 16 bytes of the input type -> float32.
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
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

// Strides in elements: [0..2] r's batch, token, head; then k's, v's, w's.
struct Strides {
  long long s[12];
};

template <typename T, int HD>
__global__ void __launch_bounds__(HD) rwkv_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ s_final, int S, int H,
    Strides st) {
  constexpr int E = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int CPR = HD / E;             // 16-byte loads per row
  constexpr int LOADS = RS_CH * CPR / HD; // per thread per array and chunk
  __shared__ __align__(16) float Rs[RS_CH][HD];
  __shared__ __align__(16) float Ks[RS_CH][HD];
  __shared__ __align__(16) float UKs[RS_CH][HD];
  __shared__ __align__(16) float Vs[RS_CH][HD];
  __shared__ __align__(16) float Ws[RS_CH][HD];
  __shared__ float Us[HD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int j = threadIdx.x;
  const long long bh = static_cast<long long>(b) * H + h;

  Us[j] = u[static_cast<long long>(h) * HD + j];
  float sreg[HD];  // column j of the state
  const float* s0p = s0 + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) sreg[i] = s0p[i * HD + j];

  const T* rb = r + b * st.s[0] + h * st.s[2];
  const T* kb = k + b * st.s[3] + h * st.s[5];
  const T* vb = v + b * st.s[6] + h * st.s[8];
  const T* wb = w + b * st.s[9] + h * st.s[11];
  T* yb = y + static_cast<long long>(b) * S * H * HD +
          static_cast<long long>(h) * HD;
  const long long ys = static_cast<long long>(H) * HD;
  __syncthreads();  // Us

  for (int t0 = 0; t0 < S; t0 += RS_CH) {
    const int nt = min(RS_CH, S - t0);
#pragma unroll 2
    for (int it = 0; it < LOADS; ++it) {
      const int idx = it * HD + j;
      const int tt = idx / CPR, col = (idx - tt * CPR) * E;
      if (tt >= nt) break;
      const long long tok = t0 + tt;
      float fr[E], fk[E], fv[E], fw[E];
      load16(rb + tok * st.s[1] + col, fr);
      load16(kb + tok * st.s[4] + col, fk);
      load16(vb + tok * st.s[7] + col, fv);
      load16(wb + tok * st.s[10] + col, fw);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        Rs[tt][col + e] = fr[e];
        Ks[tt][col + e] = fk[e];
        UKs[tt][col + e] = Us[col + e] * fk[e];
        Vs[tt][col + e] = fv[e];
        Ws[tt][col + e] = fw[e];
      }
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float vj = Vs[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i0 = 0; i0 < HD; i0 += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&Rs[tt][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&Ks[tt][i0]);
        const float4 uk4 = *reinterpret_cast<const float4*>(&UKs[tt][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&Ws[tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float uk[4] = {uk4.x, uk4.y, uk4.z, uk4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& sv = sreg[i0 + e];
          acc[e] = fmaf(rr[e], fmaf(uk[e], vj, sv), acc[e]);
          sv = fmaf(ww[e], sv, kk[e] * vj);
        }
      }
      yb[(t0 + tt) * ys + j] =
          from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    __syncthreads();  // the chunk's buffers are free for the next one
  }

  float* sfp = s_final + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) sfp[i * HD + j] = sreg[i];
}

template <typename T, int HD>
static cudaError_t launch(const void* r, const void* k, const void* v,
                          const void* w, const float* u, const float* s0,
                          void* y, float* s_final, int B, int S, int H,
                          const Strides& st, cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv_scan_kernel<T, HD><<<grid, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(y), s_final, S, H, st);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(int hd, const void* r, const void* k,
                             const void* v, const void* w, const float* u,
                             const float* s0, void* y, float* s_final, int B,
                             int S, int H, const Strides& st,
                             cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, y, s_final, B, S, H, st,
                           stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, s_final, B, S, H, st,
                           stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, s_final, B, S, H, st,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" {

const char* rwkv_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y [B,S,H,hd] (contiguous) and s_final [B,H,hd,hd] from r, k, v, w
// [B,S,H,hd] (strides in elements: batch, token, head of each; unit
// stride on hd, rows 16-byte aligned), u [H,hd] and s0 [B,H,hd,hd]
// (contiguous float32), on `stream` of `device`.  hd is 16, 32 or 64.
// Returns cudaGetLastError() after the launch.
int rwkv_scan_launch(const void* r, const void* k, const void* v,
                     const void* w, const float* u, const float* s0,
                     void* y, float* s_final, int B, int S, int H, int hd,
                     long long rsb, long long rss, long long rsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long wsb, long long wss, long long wsh, int dtype,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || S < 1 || H < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Strides st = {{rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb,
                       wss, wsh}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RS_FLOAT32)
    return static_cast<int>(launch_hd<float>(hd, r, k, v, w, u, s0, y,
                                             s_final, B, S, H, st, s));
  if (dtype == RS_BFLOAT16)
    return static_cast<int>(launch_hd<__nv_bfloat16>(
        hd, r, k, v, w, u, s0, y, s_final, B, S, H, st, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
