// decode_attention: one query position over a KV cache, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (body _kernel).  It computes, for q [B,h,hd] over a
// cache k, v [B,S,kv,hd] with g = h/kv grouped query heads per kv head,
//   out[b,n] = sum_j p_j v[b,j,n/g] / max(sum_j p_j, 1e-30)
// over the live positions j < cache_len[b] (and j >= cache_len[b] - window
// with a window), logits (q . k_j) * hd^-0.5 in float32, p_j = exp(x_j -
// m) rounded to the input type before the PV product; m, l and the
// accumulator are float32.  cache_len is a value passed with the launch or
// an int32 [B] device array.
//
// What bounds it on an H100: every live k and v row is read once and used
// for 4*g*hd flops, about g flops per byte in bf16, so it is bound by the
// bytes of the live cache (decode_attention_cost in the Python module):
// 134 MB for a 32k-token cache at gemma3-1b's geometry, 0.040 ms at
// 3.35 TB/s.  Reaching that takes bytes in flight on every SM: one block
// per (kv head, batch row) is only B * kv blocks (4 at gemma3-1b's B=4,
// kv=1), each with about two tiles on their way, which pulled 65 GB/s.
//
// Design (flash-decoding): the n 32-position tiles that the live range of
// a row touches are cut into `splits` runs of whole tiles, run j holding
// tiles [j*n/splits, (j+1)*n/splits) (decode_split_plan in the Python
// module picks `splits` on the host from the shapes alone, so that the
// grid holds about 2 blocks per SM, one wave where 2 fit; cache_len is
// never read back, and n is worked out on the device per row).  Each block
// (kv head, split, batch row, head group) streams its run through a
// 3-stage ring of cp.async copies and writes unnormalised float32
// partials acc[hd], m and l per query head to a workspace [B,H,splits,
// hd+2]; a run with no live position writes m = -inf, l = 0.  A second
// kernel, decode_attention_combine, one block per (query head, batch
// row), forms m* = max m_i, w_i = exp(m_i - m*) (0 where m_i = -inf) and
// writes sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30) in the input type.
// With one split (the served shapes: B * kv blocks already cover the
// short cache) the block writes the output itself: one launch, no
// workspace.  p is rounded to the input type relative to the run's
// running maximum, as the one-split kernel rounds relative to its own.
//
// The per-tile body: 256 threads (8 warps) per block, carrying GM = 1, 2 or
// 4 query heads of one kv head (heads_per_block in the Python module picks
// GM from g and passes it; more than GM heads take more blocks along z,
// each rereading the cache).  Tiles are DA_BK = 32 positions (the Python
// module's TILE, which checks decode_attention_tile() on loading); warp w
// owns positions 4w..4w+3 of a tile and lane c the head-dim columns
// 8c..8c+7, so one 16-byte (bf16) or two (float32) shared loads give a lane
// its slice of a k or v row.  The logit of a (head, position) is a warp sum;
// warp gi then runs head gi's online softmax over the tile's 32 logits (one
// per lane); every warp keeps its own partial accumulator over its
// positions, and the 8 partials are summed through shared memory at the
// end.  A warp's 4 x GM logit sums of a tile go through one interleaved
// butterfly of shuffles: done one after another they were a dependent chain
// of up to 80 shuffles per tile.  Positions outside the live range are never
// read: the ring holds zeros there and their logits are minus infinity, so
// a row with no live position comes out 0 (the Pallas kernel, whose m
// starts at -1e30, gives a mean of v instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define DA_BK 32
#define DA_STAGES 3
#define DA_WARPS 8
#define DA_THREADS (DA_WARPS * 32)
#define DA_KPW (DA_BK / DA_WARPS)     // positions per warp per tile
#define DA_FLOAT32 0
#define DA_BFLOAT16 1

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

// 8 consecutive values of the input type -> float32.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A thread's 16-byte chunks of a [DA_BK][hd] tile: chunk threadIdx.x +
// i * DA_THREADS is row r0 + i * dr (+ carries), chunk column c0 + i * dc
// (mod cpr), worked out once so the tile loop divides nothing.
struct ChunkWalk {
  int r0, c0, dr, dc, cpr;
  __device__ explicit ChunkWalk(int cpr_) : cpr(cpr_) {
    r0 = threadIdx.x / cpr;
    c0 = threadIdx.x - r0 * cpr;
    dr = DA_THREADS / cpr;
    dc = DA_THREADS - dr * cpr;
  }
};

// Ask for positions k0 .. k0+DA_BK-1 of k and v into one ring stage
// ([DA_BK][hd] each); positions outside [lo, hi) are zeroed instead.
template <typename T>
__device__ __forceinline__ void fetch_tile(const T* __restrict__ kb,
                                           const T* __restrict__ vb,
                                           long long kss, long long vss,
                                           int k0, int lo, int hi, int hd,
                                           const ChunkWalk& w, T* ks,
                                           T* vs) {
  constexpr int E = 16 / sizeof(T);
  int r = w.r0, cc = w.c0;
  while (r < DA_BK) {
    const int c = cc * E, pos = k0 + r;
    T* kd = ks + r * hd + c;
    T* vd = vs + r * hd + c;
    if (pos >= lo && pos < hi) {
      cp_async16(kd, kb + static_cast<long long>(pos) * kss + c);
      cp_async16(vd, vb + static_cast<long long>(pos) * vss + c);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    }
    r += w.dr;
    cc += w.dc;
    if (cc >= w.cpr) {
      cc -= w.cpr;
      ++r;
    }
  }
}

// GM: query heads per block (1, 2 or 4).  SPLIT: blockIdx.x = kv
// head + KV * split, split j of `splits` takes tiles [j * n / splits,
// (j + 1) * n / splits) of the n its row's live range touches and writes
// its partials to ws [B,H,splits,hd+2]; else (one split, the served
// shapes: no split arithmetic before the first fetch) blockIdx.x is the kv
// head and the block writes out.
template <typename T, int GM, bool SPLIT>
__global__ void __launch_bounds__(DA_THREADS) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int G,
    int hd, long long qsb, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    const int* __restrict__ lens, int len_value, int window, float scale,
    int splits, float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage_elems = DA_BK * hd;
  T* ring = reinterpret_cast<T*>(smem_raw);  // [DA_STAGES][2][DA_BK][hd]
  float* Ls = reinterpret_cast<float*>(
      smem_raw + sizeof(T) * DA_STAGES * 2 * stage_elems);  // [GM][BK]
  float* Ps = Ls + GM * DA_BK;                              // [GM][BK]
  float* alpha_s = Ps + GM * DA_BK;                         // [GM]
  float* l_s = alpha_s + GM;                                // [GM]
  float* m_s = l_s + GM;                                    // [GM]

  int split = 0, kvh = blockIdx.x;
  if constexpr (SPLIT) {
    split = blockIdx.x / (H / G);
    kvh = blockIdx.x - split * (H / G);
  }
  const int bi = blockIdx.y;
  const int g0 = blockIdx.z * GM;
  const int ng = min(GM, G - g0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool has = lane < hd / 8;  // this lane's 8 columns exist

  const int len = lens ? lens[bi] : len_value;
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int hi = min(len, S);
  // This split's run of tiles of the row's live range.
  const int row_nt = hi > lo ? (hi + DA_BK - 1) / DA_BK - lo / DA_BK : 0;
  int j0 = 0, nt = row_nt;
  if constexpr (SPLIT) {
    j0 = static_cast<int>(static_cast<long long>(split) * row_nt / splits);
    nt = static_cast<int>(static_cast<long long>(split + 1) * row_nt /
                          splits) - j0;
  }
  const int t_lo = lo / DA_BK + j0;
  const ChunkWalk walk(hd / (16 / static_cast<int>(sizeof(T))));

  const T* kb = k + bi * ksb + kvh * ksh;
  const T* vb = v + bi * vsb + kvh * vsh;

  float qr[GM][8];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    if (gi < ng && has) {
      load8(q + bi * qsb + (kvh * G + g0 + gi) * qsh + lane * 8, qr[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[gi][e] = 0.f;
    }
  }

#pragma unroll
  for (int st = 0; st < DA_STAGES - 1; ++st) {
    if (st < nt) {
      T* base = ring + st * 2 * stage_elems;
      fetch_tile(kb, vb, kss, vss, (t_lo + st) * DA_BK, lo, hi, hd, walk,
                 base, base + stage_elems);
    }
    cp_async_commit();
  }

  // Heads past ng keep p = 0 and alpha = 0, so the loop below can run
  // all GM heads without branches (their q rows are zero too).
  for (int i = threadIdx.x; i < GM * DA_BK + GM; i += DA_THREADS)
    Ps[i] = 0.f;  // Ps, then alpha_s

  float m = -INFINITY, l = 0.f;  // head `warp`'s softmax state (warp < ng)
  float acc[GM][8];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gi][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int nxt = it + DA_STAGES - 1;
    if (nxt < nt) {
      T* base = ring + (nxt % DA_STAGES) * 2 * stage_elems;
      fetch_tile(kb, vb, kss, vss, (t_lo + nxt) * DA_BK, lo, hi, hd, walk,
                 base, base + stage_elems);
    }
    cp_async_commit();
    cp_async_wait<DA_STAGES - 1>();
    __syncthreads();
    const T* Kt = ring + (it % DA_STAGES) * 2 * stage_elems;
    const T* Vt = Kt + stage_elems;
    const int k0 = (t_lo + it) * DA_BK;

    // The warp's DA_KPW x GM logits: lane partial dots, then the warp
    // sums all of them in one interleaved butterfly (independent shuffles
    // overlap; one sum after another would be a chain of them).
    float part[DA_KPW][GM];
#pragma unroll
    for (int kk = 0; kk < DA_KPW; ++kk) {
      float kf[8];
      if (has) {
        load8(Kt + (warp * DA_KPW + kk) * hd + lane * 8, kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        part[kk][gi] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part[kk][gi] = fmaf(qr[gi][e], kf[e], part[kk][gi]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int kk = 0; kk < DA_KPW; ++kk)
#pragma unroll
        for (int gi = 0; gi < GM; ++gi)
          part[kk][gi] += __shfl_xor_sync(0xffffffffu, part[kk][gi], o);
    if (lane == 0) {
#pragma unroll
      for (int kk = 0; kk < DA_KPW; ++kk)
#pragma unroll
        for (int gi = 0; gi < GM; ++gi)
          Ls[gi * DA_BK + warp * DA_KPW + kk] = part[kk][gi] * scale;
    }
    __syncthreads();

    if (warp < ng) {
      const int pos = k0 + lane;
      const bool live = pos >= lo && pos < hi;
      const float x = live ? Ls[warp * DA_BK + lane] : -INFINITY;
      const float m_new = fmaxf(m, warp_max(x));
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - mu);
      const float p = expf(x - mu);
      l = l * alpha + warp_sum(p);
      m = m_new;
      Ps[warp * DA_BK + lane] = round_to<T>(p);
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    if (has) {
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        const float a = alpha_s[gi];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[gi][e] *= a;
      }
#pragma unroll
      for (int kk = 0; kk < DA_KPW; ++kk) {
        const int j = warp * DA_KPW + kk;
        float vf[8];
        load8(Vt + j * hd + lane * 8, vf);
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
          const float p = Ps[gi * DA_BK + j];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
        }
      }
    }
    __syncthreads();  // this stage and Ls/Ps are free for reuse
  }
  cp_async_wait<0>();
  __syncthreads();

  // Sum the warps' partial accumulators: red [DA_WARPS][GM][hd] over
  // the ring, which is idle now.
  float* red = reinterpret_cast<float*>(smem_raw);
  if (has) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= ng) break;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(warp * GM + gi) * hd + lane * 8 + e] = acc[gi][e];
    }
  }
  if (warp < ng && lane == 0) {
    l_s[warp] = l;
    m_s[warp] = m;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < ng * hd; o += DA_THREADS) {
    const int gi = o / hd, d = o - gi * hd;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) sum += red[(w * GM + gi) * hd + d];
    const long long row = static_cast<long long>(bi) * H + kvh * G + g0 + gi;
    if constexpr (!SPLIT) {
      out[row * hd + d] = from_f32<T>(sum / fmaxf(l_s[gi], 1e-30f));
    } else {
      float* part = ws + (row * splits + split) * (hd + 2);
      part[d] = sum;
      if (d == 0) {
        part[hd] = m_s[gi];
        part[hd + 1] = l_s[gi];
      }
    }
  }
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool mx) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = mx ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is free (an earlier reduction may be reading it)
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < DA_WARPS; ++w) x = mx ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// One block per (query head, batch row): merges the head's `splits`
// partials (acc[hd], m, l) from ws into out[b, head].
template <typename T>
__global__ void __launch_bounds__(DA_THREADS) decode_attention_combine(
    const float* __restrict__ ws, T* __restrict__ out, int H, int hd,
    int splits) {
  extern __shared__ float wts[];  // [splits]
  __shared__ float red[DA_WARPS];
  const long long row = static_cast<long long>(blockIdx.y) * H + blockIdx.x;
  const float* part = ws + row * splits * (hd + 2);
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < splits; i += DA_THREADS)
    mx = fmaxf(mx, part[i * (hd + 2) + hd]);
  mx = block_reduce(mx, red, true);
  float den = 0.f;
  for (int i = threadIdx.x; i < splits; i += DA_THREADS) {
    const float mi = part[i * (hd + 2) + hd];
    const float w = mi == -INFINITY ? 0.f : expf(mi - mx);
    wts[i] = w;
    den += w * part[i * (hd + 2) + hd + 1];
  }
  den = fmaxf(block_reduce(den, red, false), 1e-30f);  // syncs: wts ready
  for (int d = threadIdx.x; d < hd; d += DA_THREADS) {
    float acc = 0.f;
    for (int i = 0; i < splits; ++i)
      acc = fmaf(wts[i], part[i * (hd + 2) + d], acc);
    out[row * hd + d] = from_f32<T>(acc / den);
  }
}

template <typename T, int GM>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int KV, int hd,
                          const long long* st, const int* lens,
                          int len_value, int window, float scale,
                          int splits, float* ws, int device,
                          cudaStream_t stream) {
  static int configured = -1;  // device whose shared-memory limit is set
  auto kern = splits > 1 ? decode_attention_kernel<T, GM, true>
                         : decode_attention_kernel<T, GM, false>;
  if (configured != device) {
    for (auto f : {decode_attention_kernel<T, GM, true>,
                   decode_attention_kernel<T, GM, false>}) {
      cudaError_t err = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
      if (err != cudaSuccess) return err;
    }
    configured = device;
  }
  // The ring (at least 384 * hd bytes) also holds the final cross-warp
  // sums (DA_WARPS * GM * hd floats, at most 128 * hd bytes).
  const size_t smem = sizeof(T) * DA_STAGES * 2 * DA_BK * hd +
                      sizeof(float) * (2 * GM * DA_BK + 3 * GM);
  const int G = H / KV;
  const dim3 grid(KV * splits, B, (G + GM - 1) / GM);
  kern<<<grid, DA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, G, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], lens, len_value,
      window, scale, splits, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_attention_combine<T>
      <<<dim3(H, B), DA_THREADS, sizeof(float) * splits, stream>>>(
          ws, static_cast<T*>(out), H, hd, splits);
  return cudaGetLastError();
}

// One block carries gm = 1, 2 or 4 of a kv head's g query heads (more
// heads take more blocks along z).
template <typename T>
static cudaError_t launch_g(const void* q, const void* k, const void* v,
                            void* out, int B, int S, int H, int KV, int hd,
                            const long long* st, const int* lens,
                            int len_value, int window, float scale,
                            int splits, float* ws, int gm, int device,
                            cudaStream_t s) {
  if (gm == 1)
    return launch<T, 1>(q, k, v, out, B, S, H, KV, hd, st, lens, len_value,
                        window, scale, splits, ws, device, s);
  if (gm == 2)
    return launch<T, 2>(q, k, v, out, B, S, H, KV, hd, st, lens, len_value,
                        window, scale, splits, ws, device, s);
  return launch<T, 4>(q, k, v, out, B, S, H, KV, hd, st, lens, len_value,
                      window, scale, splits, ws, device, s);
}

extern "C" {

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Cache positions per tile, for the Python module's split plan.
int decode_attention_tile(void) { return DA_BK; }

// out [B,H,hd] (contiguous) = attention of q [B,H,hd] over the cache k, v
// [B,S,KV,hd] on `stream` of `device`.  Strides in elements: q's batch
// and head strides, then k's batch, position and head strides, then v's;
// the head dim has unit stride and every row is 16-byte aligned.
// cache_len is lens[b] when lens is not null, else len_value; window 0 =
// none.  With splits > 1 each row's live range is cut into `splits` runs
// of whole 32-position tiles, ws is a float32 workspace [B,H,splits,hd+2],
// and a second kernel (decode_attention_combine) follows on the same
// stream; with splits == 1, ws is not read.  gm (1, 2 or 4) query heads
// go to one block.  Returns cudaGetLastError() after the launches.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, int B, int S, int H, int KV, int hd,
                            long long qsb, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, const int* lens,
                            int len_value, int window, float scale,
                            int splits, void* ws, int gm, int dtype,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || S < 0 || H < 1 || KV < 1 || H % KV || hd % 8 || hd < 8 ||
      hd > 256 || window < 0 || B > 65535 ||
      !(gm == 1 || gm == 2 || gm == 4) || (H / KV + gm - 1) / gm > 65535 ||
      splits < 1 || splits > 8192 ||
      static_cast<long long>(KV) * splits > 2147483647LL ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long st[8] = {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == DA_FLOAT32)
    return static_cast<int>(launch_g<float>(q, k, v, out, B, S, H, KV, hd,
                                            st, lens, len_value, window,
                                            scale, splits, w, gm, device,
                                            s));
  if (dtype == DA_BFLOAT16)
    return static_cast<int>(launch_g<__nv_bfloat16>(
        q, k, v, out, B, S, H, KV, hd, st, lens, len_value, window, scale,
        splits, w, gm, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
