// rwkv_scan v3: the RWKV-6 recurrence over a sequence, for sm_90a.
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
// B * H is small (160 at B=4, H=40; 40 at B=1) beside the 132 SMs.
//
// Design.  A block of HD threads runs one segment of one (b, h) sequence
// and holds the [HD, HD] state in registers, a tile of HD / 4 rows by 4
// columns a thread.  Chunks of RS_CH tokens of r, k, v, w are copied into
// a two-stage shared-memory ring with 16-byte cp.async, so the next
// chunk's loads are in flight while the current chunk's tokens run.  Per
// token and state element a thread does 3 float32 operations (y's
// multiply-add, k_i v_j, the decayed update): y_j is sum_i r_i S_ij +
// v_j c_t, where c_t = sum_i r_i u_i k_i is one scalar per token, summed
// once per chunk before the tokens run, and the partial sums of y over a
// thread's rows meet in a shuffle butterfly.  The tile matters as much
// as the split: with one column a thread (as in v2) every thread reads
// every row of r, k and w from shared memory for its one column (48
// 16-byte loads a token at hd 64), and on an H100 the shared-memory pipe,
// not the arithmetic, bounded that layout, so more blocks barely helped
// it; a 16 x 4 tile reads 12 for r, k and w and 1 for v.  bf16 inputs
// are converted once per chunk into a float32 buffer.
//
// The decode step (one token, one segment) has a kernel of its own,
// rwkv_scan_decode: thread j owns column j of the state (HD registers, as
// in v2), the token's r, k, v, w and u * k go through shared memory once,
// and no ring, chunk loop or tile shuffle runs for its one token.
//
// The sequence split.  The columns of the state are independent and the
// recurrence is linear in the state, so the rwkv_scan_plan in the Python
// module cuts each (b, h) sequence into P segments (P = 1 where B * H
// fills the card or the sequence is short; then one launch of
// rwkv_scan_kernel, grid (H, B, 1), or of rwkv_scan_decode, grid (H, B),
// for one token).  With P > 1 a call runs three
// kernels in order:
//   1. rwkv_scan_states, grid (H, B, P-1): segment p runs the state update
//      alone (no y), from s0 for p = 0 and from a zero state otherwise,
//      and writes its end state A_p and its row decay D_p[i] = prod_t
//      w_t[i] (token order) to the workspace.
//   2. rwkv_scan_fold, grid (H, B): S_1 = A_0 and S_{p+1} = diag(D_p) S_p
//      + A_p in segment order, in place, so A_p becomes segment p+1's
//      start state.
//   3. rwkv_scan_kernel, grid (H, B, P): every segment reruns its tokens
//      from its true start state and writes y; the last writes the final
//      state.
// Every sum runs in a fixed order, so a call is deterministic.  Rerunning
// a segment costs a second pass over its tokens, but the first pass
// skips y (one of the 3 operations per state element, and r's loads) and
// both passes keep the per-token float32 arithmetic of one sequential
// scan; the chunked matrix form on the tensor cores would need ratios of
// cumulative decays, which leave the float32 range for w in (0, 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RS_CH 16          // tokens per staged chunk
#define RS_STAGES 2       // chunks in the shared-memory ring
#define RS_FLOAT32 0
#define RS_BFLOAT16 1

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One call's arguments.  Strides in elements: [0..2] r's batch, token,
// head; then k's, v's, w's.  ws_state [P-1, B, H, HD, HD] and ws_decay
// [P-1, B, H, HD] are the workspace of a split call (unused when P = 1).
struct Args {
  const void* x[4];  // r, k, v, w
  long long st[12];
  const float* u;
  const float* s0;
  void* y;
  float* s_final;
  float* ws_state;
  float* ws_decay;
  int S, H, B, P;
};

// 4 values of the input type at p (16-byte aligned for float32, 8 for
// bf16) as float32; load16: the 16 bytes at p (4 float32 or 8 bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 a = load4(p);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(x[i]);
    f[2 * i] = y.x;
    f[2 * i + 1] = y.y;
  }
}

// One token on a thread's state tile (rows 16 m + 4 rg + e, 4 columns;
// rr, kr and wr point at row 4 rg of r, k and w in shared memory): S <-
// diag(w) S + k v^T and, with FULL, part[q] = sum over the tile's rows of
// r_i S_iq (the state before the update), in two interleaved sums per
// column.
template <bool FULL, int MR>
__device__ __forceinline__ void token_step(float (&st)[MR][4][4],
                                           const float* rr, const float* kr,
                                           const float* wr,
                                           const float (&v)[4],
                                           float (&part)[4]) {
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float4 k4 = load4(kr + 16 * m);
    const float4 w4 = load4(wr + 16 * m);
    const float k_[4] = {k4.x, k4.y, k4.z, k4.w};
    const float w_[4] = {w4.x, w4.y, w4.z, w4.w};
    float r_[4] = {0.f, 0.f, 0.f, 0.f};
    if (FULL) {
      const float4 r4 = load4(rr + 16 * m);
      r_[0] = r4.x;
      r_[1] = r4.y;
      r_[2] = r4.z;
      r_[3] = r4.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float& sv = st[m][e][q];
        if (FULL) acc[e & 1][q] = fmaf(r_[e], sv, acc[e & 1][q]);
        sv = fmaf(w_[e], sv, k_[e] * v[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) part[q] = acc[0][q] + acc[1][q];
}

// The sum of part[q] over the 4 row groups of a column group (lanes
// 4 cg .. 4 cg + 3), for column q = rg: the high bit of rg keeps columns
// {2, 3} or {0, 1}, the low bit one of the two.
__device__ __forceinline__ float column_sum(const float (&part)[4], int rg,
                                            unsigned mask) {
  const bool hi = rg & 2, lo = rg & 1;
  float keep0 = hi ? part[2] : part[0], keep1 = hi ? part[3] : part[1];
  keep0 += __shfl_xor_sync(mask, hi ? part[0] : part[2], 2);
  keep1 += __shfl_xor_sync(mask, hi ? part[1] : part[3], 2);
  const float sum = lo ? keep1 : keep0;
  return sum + __shfl_xor_sync(mask, lo ? keep0 : keep1, 1);
}

// One segment of one (b, h): blockIdx = (h, b, segment).  FULL: the
// token recurrence with y, from s0 (segment 0) or the folded start state
// in ws_state[p-1]; the last segment writes s_final.  !FULL: the state
// update alone, from s0 (segment 0) or zero, writing the end state and
// the row decay to ws_state[p] and ws_decay[p].
//
// Thread tid = 4 * cg + rg owns the state tile of columns 4 cg .. 4 cg + 3
// and rows 16 m + 4 rg + e (m < HD / 16, e < 4): HD floats in registers.
// Per token it reads its HD / 4 rows of r, k and w and its 4 columns of v
// (shared-memory loads of 16 bytes, each shared by the threads of one row
// group), and the 4 threads of a column group add their partial y's in a
// two-step shuffle butterfly that leaves column 4 cg + rg's sum on thread
// rg.
template <typename T, int HD, bool FULL>
__device__ __forceinline__ void scan_segment(const Args& a) {
  constexpr int E = 16 / sizeof(T);         // elements per 16-byte copy
  constexpr int CPR = HD / E;               // copies per row
  constexpr int COPIES = RS_CH * CPR / HD;  // per thread, array and chunk
  constexpr bool CVT = sizeof(T) != 4;      // bf16: convert once a chunk
  constexpr int TPT = HD / RS_CH;           // threads per token for c_t
  constexpr int MR = HD / 16;               // row quads per thread
  constexpr unsigned MASK = HD >= 32 ? 0xffffffffu : (1u << HD) - 1u;
  static_assert(HD % RS_CH == 0 && COPIES * HD == RS_CH * CPR, "shape");
  __shared__ __align__(16) T ring[RS_STAGES][4][RS_CH][HD];
  __shared__ __align__(16) float cvt[CVT ? 3 : 1][CVT ? RS_CH : 1][HD];
  __shared__ float Us[HD];
  __shared__ float Cs[RS_CH];

  const int h = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, cg = tid >> 2, rg = tid & 3;
  const int H = a.H, S = a.S;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long bhn = static_cast<long long>(a.B) * H;
  const int t_begin = static_cast<int>(static_cast<long long>(p) * S / a.P);
  const int t_end =
      static_cast<int>(static_cast<long long>(p + 1) * S / a.P);
  const int n_chunks = (t_end - t_begin + RS_CH - 1) / RS_CH;

  const T* base[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    base[q] = static_cast<const T*>(a.x[q]) + b * a.st[3 * q] +
              h * a.st[3 * q + 2];
  constexpr int FIRST = FULL ? 0 : 1;  // the state update needs no r

  auto stage_chunk = [&](int c, int stage) {
    const int t0 = t_begin + c * RS_CH;
    const int nt = min(RS_CH, t_end - t0);
#pragma unroll
    for (int q = FIRST; q < 4; ++q) {
#pragma unroll
      for (int it = 0; it < COPIES; ++it) {
        const int idx = it * HD + tid;
        const int tt = idx / CPR, col = (idx - tt * CPR) * E;
        if (tt < nt)
          cp_async16(&ring[stage][q][tt][col],
                     base[q] + (t0 + tt) * a.st[3 * q + 1] + col);
      }
    }
    cp_async_commit();
  };
  // The state first (it is needed last), then u and the first chunk, so
  // that the round trips to memory overlap; the store of u waits for its
  // load, after every load is in flight.
  float st[MR][4][4];  // [row quad m][row e][column]
  const float* start = nullptr;
  if (p == 0)
    start = a.s0 + bh * HD * HD;
  else if (FULL)
    start = a.ws_state + ((p - 1) * bhn + bh) * HD * HD;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = start ? load4(start + (16 * m + 4 * rg + e) * HD +
                                     4 * cg)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      st[m][e][0] = x.x;
      st[m][e][1] = x.y;
      st[m][e][2] = x.z;
      st[m][e][3] = x.w;
    }
  }
  T* yb = static_cast<T*>(a.y) + static_cast<long long>(b) * S * H * HD +
          static_cast<long long>(h) * HD;
  const long long ys = static_cast<long long>(H) * HD;
  const float* uh = a.u + static_cast<long long>(h) * HD;
  const float u_tid = n_chunks > 0 && FULL ? uh[tid] : 0.f;
  if (n_chunks > 0) {
    stage_chunk(0, 0);
    if (FULL) Us[tid] = u_tid;
  }
  float decay = 1.f;  // !FULL: prod_t w_t[tid], row tid's decay

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    const int t0 = t_begin + c * RS_CH;
    const int nt = min(RS_CH, t_end - t0);
    if (c + 1 < n_chunks) {
      stage_chunk(c + 1, stage ^ 1);  // freed by the last sync of c - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and Us) visible to every thread

    if (FULL) {
      // c_t = sum_i r_i u_i k_i: TPT threads per token, RS_CH rows each,
      // rows rotated by token so the warp's reads fall on distinct banks.
      const int tt = tid / TPT, part = tid - tt * TPT;
      float cs = 0.f;
#pragma unroll
      for (int ii = 0; ii < RS_CH; ++ii) {
        const int i = part + TPT * ((ii + tt) % RS_CH);
        cs = fmaf(to_f32(ring[stage][0][tt][i]),
                  Us[i] * to_f32(ring[stage][1][tt][i]), cs);
      }
#pragma unroll
      for (int off = 1; off < TPT; off <<= 1)
        cs += __shfl_xor_sync(MASK, cs, off);
      if (part == 0) Cs[tt] = cs;
    }
    if (CVT) {
#pragma unroll
      for (int tt = 0; tt < RS_CH; ++tt) {
        if (FULL) cvt[0][tt][tid] = to_f32(ring[stage][0][tt][tid]);
        cvt[1][tt][tid] = to_f32(ring[stage][1][tt][tid]);
        cvt[2][tt][tid] = to_f32(ring[stage][3][tt][tid]);
      }
    }
    if (FULL || CVT) __syncthreads();

    // float32 rows of r, k and w: the ring itself, or the bf16 conversion
    const float* Rf = CVT ? &cvt[0][0][0]
                          : reinterpret_cast<const float*>(
                                &ring[stage][0][0][0]);
    const float* Kf = CVT ? &cvt[1][0][0]
                          : reinterpret_cast<const float*>(
                                &ring[stage][1][0][0]);
    const float* Wf = CVT ? &cvt[2][0][0]
                          : reinterpret_cast<const float*>(
                                &ring[stage][3][0][0]);
    for (int tt = 0; tt < nt; ++tt) {
      const float4 v4 = load4(&ring[stage][2][tt][4 * cg]);
      const float v_[4] = {v4.x, v4.y, v4.z, v4.w};
      float part[4];
      token_step<FULL>(st, Rf + tt * HD + 4 * rg, Kf + tt * HD + 4 * rg,
                       Wf + tt * HD + 4 * rg, v_, part);
      if (FULL) {
        const float y = column_sum(part, rg, MASK);
        const float vj = to_f32(ring[stage][2][tt][tid]);
        yb[(t0 + tt) * ys + tid] = from_f32<T>(fmaf(vj, Cs[tt], y));
      } else {
        decay *= Wf[tt * HD + tid];
      }
    }
    __syncthreads();  // the chunk's stage and buffers are free again
  }

  float* out;
  if (FULL) {
    if (p != a.P - 1) return;
    out = a.s_final + bh * HD * HD;
  } else {
    out = a.ws_state + (p * bhn + bh) * HD * HD;
    a.ws_decay[(p * bhn + bh) * HD + tid] = decay;
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(out + (16 * m + 4 * rg + e) * HD + 4 * cg) =
          make_float4(st[m][e][0], st[m][e][1], st[m][e][2], st[m][e][3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD) rwkv_scan_kernel(const Args a) {
  scan_segment<T, HD, true>(a);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD) rwkv_scan_states(const Args a) {
  scan_segment<T, HD, false>(a);
}

// The decode step: one token, one segment; blockIdx = (h, b), HD threads,
// thread j owns column j of the state (HD floats in registers).  The
// first HD / E threads copy the token's r, k, v, w (and u * k) into shared
// memory with 16-byte loads; after one barrier each thread runs the
// token on its column: y_j = sum_i r_i (S_ij + u_i k_i v_j) in 4
// interleaved sums, S_ij <- w_i S_ij + k_i v_j.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) rwkv_scan_decode(const Args a) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(16) float Rs[HD];
  __shared__ __align__(16) float Ks[HD];
  __shared__ __align__(16) float UKs[HD];
  __shared__ __align__(16) float Vs[HD];
  __shared__ __align__(16) float Ws[HD];
  __shared__ float Us[HD];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long long bh = static_cast<long long>(b) * a.H + h;
  Us[j] = a.u[static_cast<long long>(h) * HD + j];
  float sreg[HD];  // column j of the state
  const float* s0p = a.s0 + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) sreg[i] = s0p[i * HD + j];
  __syncthreads();  // Us

  if (j < HD / E) {
    const int col = j * E;
    float f[4][E];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      load16(static_cast<const T*>(a.x[q]) + b * a.st[3 * q] +
                 h * a.st[3 * q + 2] + col,
             f[q]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      Rs[col + e] = f[0][e];
      Ks[col + e] = f[1][e];
      UKs[col + e] = Us[col + e] * f[1][e];
      Vs[col + e] = f[2][e];
      Ws[col + e] = f[3][e];
    }
  }
  __syncthreads();

  const float vj = Vs[j];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i0 = 0; i0 < HD; i0 += 4) {
    const float4 r4 = load4(&Rs[i0]), k4 = load4(&Ks[i0]);
    const float4 uk4 = load4(&UKs[i0]), w4 = load4(&Ws[i0]);
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
  static_cast<T*>(a.y)[bh * HD + j] =
      from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
  float* sfp = a.s_final + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) sfp[i * HD + j] = sreg[i];
}

// Step 2: for every (b, h) and state element, in segment order,
// ws_state[p] <- ws_decay[p][i] * ws_state[p-1] + ws_state[p] for
// p = 1 .. P-2.  blockIdx = (h, b); HD * HD / 4 threads, 4 elements each.
template <int HD>
__global__ void __launch_bounds__(HD * HD / 4) rwkv_scan_fold(const Args a) {
  const long long bhn = static_cast<long long>(a.B) * a.H;
  const long long bh = static_cast<long long>(blockIdx.y) * a.H + blockIdx.x;
  const int e0 = threadIdx.x * 4, i = e0 / HD;
  float4* st = reinterpret_cast<float4*>(a.ws_state);
  const long long step = bhn * HD * HD / 4;
  long long at = (bh * HD * HD + e0) / 4;
  float4 s = st[at];
  for (int p = 1; p < a.P - 1; ++p) {
    at += step;
    const float4 x = st[at];
    const float d = a.ws_decay[(p * bhn + bh) * HD + i];
    s = make_float4(fmaf(d, s.x, x.x), fmaf(d, s.y, x.y), fmaf(d, s.z, x.z),
                    fmaf(d, s.w, x.w));
    st[at] = s;
  }
}

template <typename T, int HD>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.P > 1) {
    rwkv_scan_states<T, HD><<<dim3(a.H, a.B, a.P - 1), HD, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rwkv_scan_fold<HD><<<dim3(a.H, a.B), HD * HD / 4, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.P == 1 && a.S == 1)
    rwkv_scan_decode<T, HD><<<dim3(a.H, a.B), HD, 0, stream>>>(a);
  else
    rwkv_scan_kernel<T, HD><<<dim3(a.H, a.B, a.P), HD, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(a, stream);
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
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
// (contiguous float32; s0 16-byte aligned, as the tile reads it with
// float4 loads), on `stream` of `device`, in `segments` segments
// per sequence.  hd is 16, 32 or 64.  With segments > 1, ws_state
// [segments-1, B, H, hd, hd] and ws_decay [segments-1, B, H, hd]
// (float32, 16-byte aligned) are its workspace.  Returns the first
// cudaGetLastError() that is not cudaSuccess, or cudaSuccess.
int rwkv_scan_launch(const void* r, const void* k, const void* v,
                     const void* w, const float* u, const float* s0,
                     void* y, float* s_final, float* ws_state,
                     float* ws_decay, int B, int S, int H, int hd,
                     int segments, long long rsb, long long rss,
                     long long rsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, long long wsb, long long wss,
                     long long wsh, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || S < 1 || H < 0 || B > 65535 || segments < 1 ||
      segments > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  if (segments > 1 && (ws_state == nullptr || ws_decay == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {{r, k, v, w},
                  {rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb, wss,
                   wsh},
                  u, s0, y, s_final, ws_state, ws_decay, S, H, B, segments};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RS_FLOAT32)
    return static_cast<int>(launch_hd<float>(hd, a, s));
  if (dtype == RS_BFLOAT16)
    return static_cast<int>(launch_hd<__nv_bfloat16>(hd, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
