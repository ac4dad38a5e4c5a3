// K11 / K12: one query token per sequence against its KV cache.
//
// Replaces, in ddlb_tpu/ops/decode_attention.py, both Pallas kernels of the
// file, which share one tile body (_attn_tile_body, :52):
//  - ddlb_decode_attention with paged = 0: decode_attention (:148,
//    _decode_attn_kernel :116, K11), the cache in its native contiguous
//    [b, S, h_kv, dh] layout;
//  - ddlb_decode_attention with paged = 1: paged_decode_attention (:274,
//    _paged_decode_attn_kernel :236, K12), the cache read through a page
//    table [b, max_pages] from pools [P, page_size, h_kv, dh]; a table
//    entry >= P (the sentinel) is unmapped and its page contributes
//    nothing.
// Semantics (the tile body's): query head hq reads kv head hq / G with
// G = h / h_kv; q is widened to f32 and scaled by 1/sqrt(dh) before the
// dot; key j is live iff j <= pos[b] and, with a window, j > pos[b] -
// window; int8 K/V are dequantized as (int8 -> f32) * scale, rounded to the
// model dtype (q's), then widened to f32 (the _cache_read contract, :337);
// the softmax runs in f32; a row with no live key gives 0 (the l == 0
// guard); o is written in q's dtype.
//
// What bounds it on an H100: bytes. A step does 4 * h * dh operations per
// live key of each sequence on 2 * h_kv * dh * itemsize bytes of K and V:
// 1 to 8 operations a byte against the card's ~295. At the serving path's
// shape (b = 8, S = 8193, 16 heads of 128, bf16) the MHA cache is 537 MB,
// 0.160 ms at 3.35 TB/s; GQA with 4 kv heads 134 MB, 0.040 ms; an int8 MHA
// cache 268 MB plus 8.4 MB of scales, 0.083 ms.
//
// What the design does about it (simple and right first; cp.async or TMA
// pipelining and tuning the split are later work):
//  - The Pallas grid (b, S / block) walks S in order on one TPU core. Here
//    the cache is split across blocks as well (flash-decoding): a block
//    owns (split, kv head, sequence) and a range of that sequence's live
//    keys, so b * h_kv * splits blocks stream the cache at once. One block
//    per (b, kv head) would be 128 blocks at MHA and 32 at GQA-4, fewer
//    than the 132 SMs. The wrapper picks the split count from S, b * h_kv
//    and the SM count.
//  - Only live keys are read: the range [max(0, pos - window + 1),
//    min(pos, S - 1)] is cut into the splits (whole pages for K12), and K12
//    reads each page's table entry itself and skips an unmapped page
//    outright (no clamped read of page P - 1: that was the TPU's
//    static-shape tax, :296-298).
//  - A block loads its G query rows once into registers (f32, scaled);
//    each of its four warps takes KT keys at a time, a lane holding 4 of
//    the 128 dims (8-byte loads of bf16, coalesced 256-byte rows). The
//    scores and P.V are SIMT f32 dots (tensor cores buy nothing below the
//    ridge); int8 is dequantized in registers with the round-through-dtype
//    step. Each warp keeps (m, l, acc) for the G rows; the warps merge in
//    shared memory and the block writes an f32 partial (acc, m, l) to
//    scratch the wrapper allocated.
//  - A second small kernel merges the partials of the splits and writes o.
//
// Plain C interface for ctypes; returns cudaGetLastError() after its
// launches (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing. head_dim is 128 and G one of 1, 2, 4,
// 8, 16; anything else returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int DH = 128;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int DPL = DH / 32;  // dims per lane

struct Params {
  const void* q;      // [b, h, dh]
  const void* k;      // [b, S, h_kv, dh], or the pool [P, page_size, h_kv, dh]
  const void* v;
  const float* ks;    // int8 only: [b, S, h_kv] or [P, page_size, h_kv]
  const float* vs;
  const int* pos;     // [b]
  const int* table;   // paged only: [b, max_pages]
  void* o;            // [b, h, dh]
  float* part_acc;    // [b, h_kv, splits, G, dh]
  float* part_ml;     // [b, h_kv, splits, G, 2]: (m, l)
  int b, h, h_kv;
  int S;              // positions: the cache length, or max_pages * page_size
  int page_size, num_pages, max_pages, paged;
  int window, splits;
  float scale;
};

// 4 consecutive elements as f32
template <typename T>
struct Load4;
template <>
struct Load4<float> {
  static __device__ __forceinline__ void run(const void* base, size_t off,
                                             float* out) {
    const float4 x = *reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <>
struct Load4<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const void* base, size_t off,
                                             float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + off);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};
template <>
struct Load4<__half> {
  static __device__ __forceinline__ void run(const void* base, size_t off,
                                             float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __half*>(base) + off);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};
template <>
struct Load4<int8_t> {
  static __device__ __forceinline__ void run(const void* base, size_t off,
                                             float* out) {
    const char4 c = *reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(base) + off);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  }
};

// x rounded to T and widened back (the dequant's round-through-dtype step)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// keys a warp takes at a time: fewer for wide groups, to keep registers
template <int G>
struct KeysPerStep {
  static constexpr int value = G <= 4 ? 4 : (G == 8 ? 2 : 1);
};

// One warp's online-softmax state for the G query rows of its kv head.
template <typename T, typename KV, int G>
struct WarpState {
  float q[G][DPL];
  float m[G], l[G], acc[G][DPL];

  // Fold keys [j0, j1) whose rows sit at row_delta + j (rows of
  // [.., h_kv, dh]); the warps of the block take KT keys each in turn.
  __device__ __forceinline__ void fold(const Params& p, int kvh, int warp,
                                       int lane, int j0, int j1,
                                       long long row_delta) {
    constexpr int KT = KeysPerStep<G>::value;
    constexpr bool INT8 = sizeof(KV) == 1;
    for (int base = j0 + warp * KT; base < j1; base += WARPS * KT) {
      float kf[KT][DPL], vf[KT][DPL];
      bool valid[KT];
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        valid[t] = base + t < j1;
        // an invalid key reads key j0's row (in bounds) and is masked
        const long long row = row_delta + (valid[t] ? base + t : j0);
        const size_t off = (size_t)(row * p.h_kv + kvh) * DH + lane * DPL;
        Load4<KV>::run(p.k, off, kf[t]);
        Load4<KV>::run(p.v, off, vf[t]);
        if constexpr (INT8) {
          const float sk = p.ks[row * p.h_kv + kvh];
          const float sv = p.vs[row * p.h_kv + kvh];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            kf[t][i] = round_to<T>(kf[t][i] * sk);
            vf[t][i] = round_to<T>(vf[t][i] * sv);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[KT];
        float mx = NEG_INF;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(q[g][i], kf[t][i], part);
          s[t] = valid[t] ? warp_sum(part) : NEG_INF;
          mx = fmaxf(mx, s[t]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          // a masked key contributes no mass, not exp(NEG_INF - NEG_INF)
          const float pt = valid[t] ? expf(s[t] - m_new) : 0.f;
          l[g] += pt;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pt, vf[t][i], acc[g][i]);
        }
        m[g] = m_new;
      }
    }
  }
};

template <typename T, typename KV, int G>
__global__ void __launch_bounds__(THREADS) decode_split(const Params p) {
  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pos = p.pos[bi];

  // this split's share [begin, end) of the live keys, in whole pages for
  // the paged cache
  const int hi = min(pos, p.S - 1);
  const int lo = p.window ? max(0, pos - p.window + 1) : 0;
  int begin = 0, end = 0;
  if (hi >= lo) {
    const int unit = p.paged ? p.page_size : 1;
    const int u_lo = lo / unit, u_hi = hi / unit;
    const int per = (u_hi - u_lo + 1 + p.splits - 1) / p.splits;
    const int u0 = u_lo + split * per;
    const int u1 = min(u0 + per, u_hi + 1);
    begin = max(lo, u0 * unit);
    end = min(hi + 1, u1 * unit);
  }

  WarpState<T, KV, G> st;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Load4<T>::run(p.q, ((size_t)bi * p.h + kvh * G + g) * DH + lane * DPL,
                  st.q[g]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      st.q[g][i] *= p.scale;
      st.acc[g][i] = 0.f;
    }
    st.m[g] = NEG_INF;
    st.l[g] = 0.f;
  }

  if (!p.paged) {
    if (begin < end)
      st.fold(p, kvh, warp, lane, begin, end, (long long)bi * p.S);
  } else if (begin < end) {
    const int ps = p.page_size;
    for (int pg = begin / ps; pg <= (end - 1) / ps; ++pg) {
      const int pid = p.table[(size_t)bi * p.max_pages + pg];
      if (pid < 0 || pid >= p.num_pages) continue;  // unmapped: no mass
      const int j0 = max(begin, pg * ps), j1 = min(end, pg * ps + ps);
      st.fold(p, kvh, warp, lane, j0, j1, (long long)pid * ps - (long long)pg * ps);
    }
  }

  // merge the warps' states, then write this split's partial
  __shared__ float sm_acc[WARPS][G][DH];
  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane * DPL + i] = st.acc[g][i];
    if (lane == 0) {
      sm_m[warp][g] = st.m[g];
      sm_l[warp][g] = st.l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], e, L);
      A = fmaf(sm_acc[w][g][d], e, A);
    }
    const size_t slot =
        (((size_t)bi * p.h_kv + kvh) * p.splits + split) * G + g;
    p.part_acc[slot * DH + d] = A;
    if (d == 0) {
      p.part_ml[slot * 2] = M;
      p.part_ml[slot * 2 + 1] = L;
    }
  }
}

// One block per (kv head, sequence), one thread per dim: the splits'
// partials merged into o.
template <typename T, int G>
__global__ void __launch_bounds__(DH) decode_merge(const Params p) {
  const int kvh = blockIdx.x, bi = blockIdx.y, d = threadIdx.x;
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    const size_t first = (((size_t)bi * p.h_kv + kvh) * p.splits) * G + g;
    float M = NEG_INF;
    for (int s = 0; s < p.splits; ++s)
      M = fmaxf(M, p.part_ml[(first + (size_t)s * G) * 2]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const size_t slot = first + (size_t)s * G;
      const float e = expf(p.part_ml[slot * 2] - M);
      L = fmaf(p.part_ml[slot * 2 + 1], e, L);
      A = fmaf(p.part_acc[slot * DH + d], e, A);
    }
    const float out = A / (L == 0.f ? 1.f : L);
    static_cast<T*>(p.o)[((size_t)bi * p.h + kvh * G + g) * DH + d] =
        from_float<T>(out);
  }
}

template <typename T, typename KV, int G>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  decode_split<T, KV, G>
      <<<dim3(p.splits, p.h_kv, p.b), THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<T, G><<<dim3(p.h_kv, p.b), DH, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_group(const Params& p, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, KV, 1>(p, stream);
    case 2: return launch<T, KV, 2>(p, stream);
    case 4: return launch<T, KV, 4>(p, stream);
    case 8: return launch<T, KV, 8>(p, stream);
    case 16: return launch<T, KV, 16>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_cache(const Params& p, int G, int int8, cudaStream_t stream) {
  return int8 ? launch_group<T, int8_t>(p, G, stream)
              : launch_group<T, T>(p, G, stream);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 f16, 2 bf16 (q, o, and K/V unless int8 = 1, when K/V are
// int8 with f32 scales ks/vs). paged = 0: k/v [b, S, h_kv, dh], table
// unused; paged = 1: k/v pools [num_pages, page_size, h_kv, dh], table
// [b, max_pages], S = max_pages * page_size. part_acc/part_ml: scratch of
// b * h_kv * splits * G * dh and b * h_kv * splits * G * 2 floats.
int ddlb_decode_attention(int dtype, int int8, const void* q, const void* k,
                          const void* v, const float* ks, const float* vs,
                          const int* pos, const int* table, void* o,
                          float* part_acc, float* part_ml, int b, int h,
                          int h_kv, int dh, int S, int page_size,
                          int num_pages, int max_pages, int paged, int window,
                          int splits, float scale, void* stream) {
  if (dh != DH || h_kv < 1 || h % h_kv || splits < 1 || b < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.ks = ks; p.vs = vs; p.pos = pos;
  p.table = table; p.o = o; p.part_acc = part_acc; p.part_ml = part_ml;
  p.b = b; p.h = h; p.h_kv = h_kv; p.S = S; p.page_size = page_size;
  p.num_pages = num_pages; p.max_pages = max_pages; p.paged = paged;
  p.window = window; p.splits = splits; p.scale = scale;
  const int G = h / h_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_cache<float>(p, G, int8, s);
    case 1: return launch_cache<__half>(p, G, int8, s);
    case 2: return launch_cache<__nv_bfloat16>(p, G, int8, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ddlb_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
