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
// G = h / h_kv; key j is live iff j <= pos[b] and, with a window,
// j > pos[b] - window; scores are q.k / sqrt(dh) in f32; int8 K/V are
// dequantized as (int8 -> f32) * scale, rounded to the model dtype (q's),
// then widened to f32 (the _cache_read contract, :337); the softmax runs in
// f32; a row with no live key gives 0 (the l == 0 guard); o is written in
// q's dtype.
//
// What bounds it on an H100: bytes. A step does 4 * h * dh operations per
// live key of each sequence on 2 * h_kv * dh * itemsize bytes of K and V:
// 1 to 8 operations a byte against the card's ~295. At the serving path's
// shape (b = 8, S = 8193, 16 heads of 128, bf16) the MHA cache is 537 MB,
// 0.160 ms at 3.35 TB/s; GQA with 4 kv heads 134 MB, 0.040 ms; an int8 MHA
// cache 268 MB plus 8.4 MB of scales, 0.083 ms. At the serve pool (17
// pages of 128, ragged positions) K12 moves about 69 MB, 0.021 ms, so a
// launch's fixed cost weighs as much as its bytes.
//
// The design (decode_mma, bf16/fp16 queries, bf16/fp16 or int8 cache):
//  - Flash-decoding: a block owns (split, kv head, sequence) and a range of
//    that sequence's live keys, [max(0, pos - window + 1), min(pos, S - 1)]
//    cut into `splits` runs of whole 128-key units (whole pages for K12),
//    so b * h_kv * splits blocks stream the cache at once. Only live keys
//    are read.
//  - One launch. Each block writes its partial (acc, m, l) to scratch,
//    fences, and takes a ticket on its (sequence, kv head)'s arrival
//    counter; the last block to arrive merges the partials in split order
//    (so the result does not depend on which block came last), writes o
//    and sets the counter back to 0. The counters are one buffer a
//    (device, stream) that every launch leaves zeroed (the partials
//    another, which no launch needs zeroed), so a launch is capturable in
//    a CUDA graph and replays bit for bit. One split writes o directly. A
//    split with no live key leaves at once: every block knows from pos how
//    many splits are live, and the ticket and the merge count only those.
//  - Bytes in flight: a producer warp streams the block's K and V rows
//    through a ring of 3 stages in shared memory (64 keys a stage, 128 for
//    int8, whose rows are half as long: 33-35 KB a stage, two blocks an SM
//    up to G = 8, G = 4 for int8, so up to about 200 KB in flight an SM)
//    with 16-byte cp.async, a warp
//    instruction copying two whole 256-byte rows (four int8 rows), each
//    lane's copies completing on the stage's mbarrier
//    (cp.async.mbarrier.arrive.noinc); int8 scales ride along as 4-byte
//    copies. Not cp.async.bulk a row: measured on the card, one bulk copy
//    of each 256-byte row ran at about one copy per 36 cycles an SM, so the
//    time followed the count of rows (int8 as slow as bf16 at half the
//    bytes; K11 MHA at 0.28 ms against 0.18 with 16-byte copies). Not TMA
//    tensor maps: a map encoded on the host costs microseconds a call (or a
//    cache keyed by pointer), and a box loads whole 64-key tiles past a
//    window's or a page's ragged end. For K12 the producer loads the
//    block's table entries once, 32 pages to a warp load, and skips an
//    unmapped page outright (no mass, no copy). Each stage carries its key
//    count; a count of 0 ends the stream.
//  - Scores on the tensor cores: four consumer warps (eight for an int8
//    cache, whose dequantization wants the warps) each take 16 keys of a
//    stage and compute S^T = K Q^T with
//    mma.sync.m16n8k16, the keys as rows and the G query rows as columns
//    (padded to 8, two n-tiles at G = 16), accumulating in f32; the scale
//    1/sqrt(dh) is applied to the f32 scores. Products of two bf16 or fp16
//    values are exact in f32, so only the summation order and the place of
//    the scale differ from the tile body. K rows are read from shared
//    memory with 16-byte loads straight into A fragments: the dot runs over
//    a permutation of the head dim (the same for K and Q), chosen so that
//    a quarter-warp's loads hit eight distinct bank groups of rows padded
//    by 16 bytes. int8 K is dequantized in registers through the model
//    dtype before the mma: its values are then exact in that dtype.
//  - The softmax is online per 16 keys: a 3-step shuffle max over the key
//    rows of a column, then p and alpha through a warp-private buffer in
//    shared memory. P.V runs in f32 with lanes over dims (4 of the 128 a
//    lane), p broadcast from shared memory: no cross-lane reduction. The
//    warps' states are merged in shared memory at the end.
//
// float32 queries (tests and small shapes) take decode_simt: four warps,
// each holding its G query rows in registers and folding KT keys at a time
// from device memory with f32 dots (a lane holds 4 of the 128 dims), the
// same one-launch merge.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the
// launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing. head_dim is 128 and G one of 1, 2, 4,
// 8, 16; anything else returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"  // the mbarrier helpers (hopper::mbar_*)

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int DH = 128;
constexpr int WARPS = 4;                      // decode_simt's warps
constexpr int SIMT_THREADS = 32 * WARPS;
constexpr int DPL = DH / 32;                  // dims per lane
constexpr int MAX_DEVICES = 64;

// The kernels' own arguments.
struct Args {
  const void* q;      // [b, h, dh]
  const void* k;      // [b, S, h_kv, dh], or the pool [P, page_size, h_kv, dh]
  const void* v;
  const float* ks;    // int8 only: [b, S, h_kv] or [P, page_size, h_kv]
  const float* vs;
  const int* pos;     // [b]
  const int* table;   // paged only: [b, max_pages]
  void* o;            // [b, h, dh]
  int* counters;      // [b * h_kv] arrival counters, zero between launches
  float* part_ml;     // [b, h_kv, splits, G, 2]: (m, l)
  float* part_acc;    // [b, h_kv, splits, G, dh]
  int b, h, h_kv;
  int S;              // positions: the cache length, or max_pages * page_size
  int page_size, num_pages, max_pages, paged;
  int window, splits, unit;
  float scale;
};

// the partials' floats: (m, l), then acc, of every (sequence, kv head,
// split, query row)
inline long long partial_floats(int b, int h_kv, int splits, int G) {
  return (long long)b * h_kv * splits * G * (2 + DH);
}

// Split s of a range of U units takes units [s U / splits, (s + 1) U /
// splits): evenly spread, and empty only when U < splits.
__device__ __forceinline__ int unit_of(int s, int units, int splits) {
  return (int)((long long)s * units / splits);
}

// This split's share [begin, end) of sequence bi's live keys, in whole
// units (128 keys, or pages), empty when begin >= end; units: the live
// range's units (0 with no live key).
__device__ __forceinline__ void split_range(const Args& p, int bi, int split, int& begin,
                                            int& end, int& units) {
  const int pos = p.pos[bi];
  const int hi = min(pos, p.S - 1);
  const int lo = p.window ? max(0, pos - p.window + 1) : 0;
  begin = end = units = 0;
  if (hi >= lo) {
    const int u_lo = lo / p.unit;
    units = hi / p.unit - u_lo + 1;
    begin = max(lo, (u_lo + unit_of(split, units, p.splits)) * p.unit);
    end = min(hi + 1, (u_lo + unit_of(split + 1, units, p.splits)) * p.unit);
  }
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

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// A split with no live key: the block leaves at once (the live splits'
// tickets and the merge count without it); with no live key at all split
// 0 writes o = 0. Every thread of the block calls it.
template <typename T, int G>
__device__ __forceinline__ void finish_empty(const Args& p, int bi, int kvh, int split,
                                             int units) {
  if (units == 0 && split == 0) {
    T* o = static_cast<T*>(p.o) + ((size_t)bi * p.h + kvh * G) * DH;
    for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) o[idx] = from_float<T>(0.f);
  }
}

// Merge the block's NW warps' states (sm_acc [NW][G][DH], sm_m/sm_l
// [NW][G]); with one split write o, else write the partial, take a
// ticket, and let the last of the min(units, splits) live blocks of
// (bi, kvh) merge the live splits in split order, write o and zero the
// counter. Every thread of the block calls it; the last block reuses
// sm_acc (at least 3 * splits * G floats).
template <typename T, int G, int NW>
__device__ __forceinline__ void finish(const Args& p, const float* sm_acc,
                                       const float* sm_m, const float* sm_l,
                                       int bi, int kvh, int split, int units) {
  __shared__ int ticket;
  const size_t pair = (size_t)bi * p.h_kv + kvh;
  T* o = static_cast<T*>(p.o) + ((size_t)bi * p.h + kvh * G) * DH;
  for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) {
    const int g = idx / DH, d = idx % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(sm_m[w * G + g] - M);
      L = fmaf(sm_l[w * G + g], e, L);
      A = fmaf(sm_acc[(w * G + g) * DH + d], e, A);
    }
    if (p.splits == 1) {
      o[idx] = from_float<T>(A / (L == 0.f ? 1.f : L));
      continue;
    }
    const size_t slot = (pair * p.splits + split) * G + g;
    p.part_acc[slot * DH + d] = A;
    if (d == 0) {
      p.part_ml[slot * 2] = M;
      p.part_ml[slot * 2 + 1] = L;
    }
  }
  if (p.splits == 1) return;
  // one thread publishes the block's partial (the barrier orders every
  // thread's stores before its release fence) and takes the ticket; the
  // last block's acquire fence makes every split's partial visible
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    ticket = atomicAdd(p.counters + pair, 1);
    if (ticket == min(units, p.splits) - 1) fence_acq_rel_gpu();
  }
  __syncthreads();
  if (ticket != min(units, p.splits) - 1) return;
  // the last block: every live split's (m, l) at once into shared memory
  // (the warps' states are no longer needed; an empty split reads as m =
  // -1e30, l = 0), each row's weights e = exp(m - M) and L in split order
  // over the splits with mass (l > 0: a split's largest score adds exp(0);
  // a live split on unmapped pages has none), then acc in split order
  const int n = p.splits * G;
  float* w = const_cast<float*>(sm_acc);  // [splits][G] m, then e
  float* lw = w + n;                      // [splits][G] l
  float* L = lw + n;                      // [G]
  const float* ml = p.part_ml + pair * n * 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = i / G;
    const bool live = unit_of(s, units, p.splits) < unit_of(s + 1, units, p.splits);
    const float2 x = live ? __ldcg(reinterpret_cast<const float2*>(ml) + i)
                          : make_float2(NEG_INF, 0.f);
    w[i] = x.x;
    lw[i] = x.y;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) M = fmaxf(M, w[s * G + g]);
    float sum = 0.f;
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) {
      const float e = lw[s * G + g] == 0.f ? 0.f : expf(w[s * G + g] - M);
      w[s * G + g] = e;
      sum = fmaf(lw[s * G + g], e, sum);
    }
    L[g] = sum;
  }
  __syncthreads();
  const float* acc = p.part_acc + pair * n * DH;
  for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) {
    const int g = idx / DH;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) {
      const float e = w[s * G + g];
      if (e != 0.f) A = fmaf(__ldcg(acc + (size_t)s * G * DH + idx), e, A);
    }
    o[idx] = from_float<T>(L[g] == 0.f ? 0.f : A / L[g]);
  }
  if (threadIdx.x == 0) p.counters[pair] = 0;
}

// ---------------------------------------------------------------------------
// decode_mma: bf16/fp16 queries, the cache in the same dtype or int8
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[0]), "r"(b[1]));
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[0]), "r"(b[1]));
  }
};

// The shared memory of decode_mma for a cache of KV and GP padded query
// columns: STAGES stages of K rows (padded by 16 bytes), V rows and (int8)
// the two scales; each consumer warp's p buffer [16][GP] and alpha row; the
// stages' key counts; the full and empty barriers. The warps' final states
// reuse the stages.
template <typename KV, int GP>
struct Layout {
  static constexpr bool INT8 = sizeof(KV) == 1;
  // consumer warps, 16 keys each a stage: eight for int8, whose
  // dequantization wants the warps (two such blocks still fit an SM up to
  // G = 8), four for bf16/fp16, which the copies bound
  static constexpr int CW = INT8 ? 8 : 4;
  static constexpr int THREADS = 32 * (CW + 1);  // + the producer warp
  static constexpr int KT = 16 * CW;
  static constexpr int ROW = DH * (int)sizeof(KV);
  static constexpr int KLD = ROW + 16;
  static constexpr int STAGES = 3;
  static constexpr int V_OFF = KT * KLD;
  static constexpr int SK_OFF = V_OFF + KT * ROW;
  static constexpr int SV_OFF = SK_OFF + (INT8 ? KT * 4 : 0);
  static constexpr int STAGE = SV_OFF + (INT8 ? KT * 4 : 0);
  static constexpr int P_OFF = STAGES * STAGE;
  static constexpr int P_FLOATS = 17 * GP;  // 16 rows of p, then alpha
  static constexpr int HDR_OFF = P_OFF + CW * P_FLOATS * 4;
  static constexpr int BAR_OFF = HDR_OFF + 16;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static_assert(STAGE % 16 == 0 && HDR_OFF % 16 == 0, "16-byte aligned regions");
  static_assert(CW * GP * (DH + 2) * 4 <= P_OFF, "the merge fits in the stages");
  static_assert((INT8 && GP == 16) || 2 * (BYTES + 1024) <= 233472, "two blocks an SM");
};

// Physical head dim of k-step ks's first column for thread c (lane % 4):
// each k-step takes 4 consecutive dims from each of the 4 threads of a
// row, in the order one thread's 16-byte shared loads return them.
template <typename KV>
__device__ __forceinline__ int kdim(int c, int ks) {
  if constexpr (sizeof(KV) == 1) {
    return 32 * c + 4 * ks;  // loads i = 0, 1: 16 bytes at chunk 2c + i
  } else {
    const int i = ks / 2;    // loads i = 0..3: 16 bytes at chunk f(c, i)
    return 8 * (2 * c + (i % 2) + 8 * (i / 2)) + 4 * (ks % 2);
  }
}

// Four signed bytes as exact floats without a conversion instruction: each
// byte, biased by 128, becomes the low byte of 2^23's bit pattern, and
// 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4_to_float(uint32_t word, float (&f)[4]) {
  const uint32_t biased = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | i)) - 8388736.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// The barrier's phase waits for this thread's earlier cp.async copies (one
// of its expected arrivals).
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// The producer warp: the block's keys [begin, end) as stages of at most KT
// keys, none across a page; then a stage of 0 keys, the end.
template <typename KV, int GP>
__device__ __forceinline__ void produce(const Args& p, unsigned char* smem, int bi,
                                        int kvh, int begin, int end) {
  using Ly = Layout<KV, GP>;
  const int lane = threadIdx.x % 32;
  int* hdr = reinterpret_cast<int*>(smem + Ly::HDR_OFF);
  const uint32_t bars = smem_addr(smem + Ly::BAR_OFF);
  const size_t pitch = (size_t)p.h_kv * Ly::ROW;  // bytes from key to key
  const unsigned char* kb = static_cast<const unsigned char*>(p.k) + (size_t)kvh * Ly::ROW;
  const unsigned char* vb = static_cast<const unsigned char*>(p.v) + (size_t)kvh * Ly::ROW;
  int stage = 0;
  uint32_t phase = 0;
  // a warp instruction copies whole rows: lane l takes 16-byte chunk
  // l % CPR of row l / CPR
  constexpr int CPR = Ly::ROW / 16, RPI = 32 / CPR;
  const int chunk = lane % CPR, sub = lane / CPR;
  auto publish = [&](int count, long long row0) {
    const uint32_t full = bars + 8 * stage, empty = bars + 8 * (Ly::STAGES + stage);
    hopper::mbar_wait(empty, phase ^ 1u);
    const uint32_t st = smem_addr(smem + stage * Ly::STAGE);
#pragma unroll 4
    for (int t = sub; t < count; t += RPI) {
      const size_t off = (size_t)(row0 + t) * pitch + 16 * chunk;
      copy16(st + t * Ly::KLD + 16 * chunk, kb + off);
      copy16(st + Ly::V_OFF + t * Ly::ROW + 16 * chunk, vb + off);
    }
    if constexpr (Ly::INT8) {
      for (int t = lane; t < count; t += 32) {
        const size_t row = (size_t)(row0 + t);
        copy4(st + Ly::SK_OFF + 4 * t, p.ks + row * p.h_kv + kvh);
        copy4(st + Ly::SV_OFF + 4 * t, p.vs + row * p.h_kv + kvh);
      }
    }
    copies_arrive(full);
    if (lane == 0) {
      hdr[stage] = count;
      hopper::mbar_arrive(full);
    }
    if (++stage == Ly::STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  };
  const int ps = p.page_size;
  int batch = -1, mine = -1;  // table entries of pages batch .. batch + 31
  for (int j = begin; j < end;) {
    long long row0;
    int j1;
    if (p.paged) {
      const int pg = j / ps;
      if (batch < 0 || pg - batch >= 32) {
        batch = pg;
        mine = pg + lane < p.max_pages ? p.table[(size_t)bi * p.max_pages + pg + lane] : -1;
      }
      const int pid = __shfl_sync(0xffffffffu, mine, pg - batch);
      if (pid < 0 || pid >= p.num_pages) {  // unmapped: no mass, no copy
        j = (pg + 1) * ps;
        continue;
      }
      j1 = min(min(end, (pg + 1) * ps), j + Ly::KT);
      row0 = (long long)pid * ps + (j - pg * ps);
    } else {
      j1 = min(end, j + Ly::KT);
      row0 = (long long)bi * p.S + j;
    }
    publish(j1 - j, row0);
    j = j1;
  }
  publish(0, 0);
}

// A consumer warp: 16 keys of every stage against the G query rows.
// Writes its final state (acc, m, l) to the merge area at the stages.
template <typename T, typename KV, int G>
__device__ __forceinline__ void consume(const Args& p, unsigned char* smem, int bi,
                                        int kvh) {
  constexpr int NT = G > 8 ? 2 : 1, GP = 8 * NT;
  using Ly = Layout<KV, GP>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, c = lane % 4;
  const int* hdr = reinterpret_cast<const int*>(smem + Ly::HDR_OFF);
  const uint32_t bars = smem_addr(smem + Ly::BAR_OFF);
  float* pbuf = reinterpret_cast<float*>(smem + Ly::P_OFF) + warp * Ly::P_FLOATS;
  float* alpha_buf = pbuf + 16 * GP;

  // Q^T as B fragments: column n = query nt * 8 + gid, k-step ks's dims
  // kdim .. kdim + 3 (raw bits, unscaled)
  uint32_t qf[NT][8][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + gid;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint2 x = make_uint2(0u, 0u);
      if (n < G)
        x = *reinterpret_cast<const uint2*>(
            static_cast<const T*>(p.q) + ((size_t)bi * p.h + kvh * G + n) * DH +
            kdim<KV>(c, ks));
      qf[nt][ks][0] = x.x;
      qf[nt][ks][1] = x.y;
    }
  }
  float m[NT][2], l[NT][2], acc[G][DPL];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[nt][j] = NEG_INF;
      l[nt][j] = 0.f;  // this lane's rows' share; summed over gid at the end
    }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    hopper::mbar_wait(bars + 8 * stage, phase);
    const int count = hdr[stage];
    if (count == 0) break;
    const unsigned char* st = smem + stage * Ly::STAGE;
    const int k0 = warp * 16;
    if (k0 < count) {
      // S^T [16 keys][GP] = K Q^T
      float cf[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) cf[nt][0] = cf[nt][1] = cf[nt][2] = cf[nt][3] = 0.f;
      const unsigned char* r0 = st + (k0 + gid) * Ly::KLD;
      const unsigned char* r1 = r0 + 8 * Ly::KLD;
      if constexpr (Ly::INT8) {
        const float* sk = reinterpret_cast<const float*>(st + Ly::SK_OFF);
        const float s0 = sk[k0 + gid], s1 = sk[k0 + gid + 8];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 x0 = *reinterpret_cast<const uint4*>(r0 + 16 * (2 * c + i));
          const uint4 x1 = *reinterpret_cast<const uint4*>(r1 + 16 * (2 * c + i));
          const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
          const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            // (int8 -> f32) * scale rounded to T: exact in T for the mma
            float f0[4], f1[4];
            int8x4_to_float(w0[w], f0);
            int8x4_to_float(w1[w], f1);
            const uint32_t a0 = Mma<T>::pack(f0[0] * s0, f0[1] * s0);
            const uint32_t a1 = Mma<T>::pack(f1[0] * s1, f1[1] * s1);
            const uint32_t a2 = Mma<T>::pack(f0[2] * s0, f0[3] * s0);
            const uint32_t a3 = Mma<T>::pack(f1[2] * s1, f1[3] * s1);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) Mma<T>::mma(cf[nt], a0, a1, a2, a3, qf[nt][4 * i + w]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int chunk = 2 * c + (i % 2) + 8 * (i / 2);
          const uint4 x0 = *reinterpret_cast<const uint4*>(r0 + 16 * chunk);
          const uint4 x1 = *reinterpret_cast<const uint4*>(r1 + 16 * chunk);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            Mma<T>::mma(cf[nt], x0.x, x1.x, x0.y, x1.y, qf[nt][2 * i]);
            Mma<T>::mma(cf[nt], x0.z, x1.z, x0.w, x1.w, qf[nt][2 * i + 1]);
          }
        }
      }
      // online softmax of the 16 keys, column by column
      const bool v0 = k0 + gid < count, v1 = k0 + gid + 8 < count;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s0 = v0 ? cf[nt][j] * p.scale : NEG_INF;
          const float s1 = v1 ? cf[nt][2 + j] * p.scale : NEG_INF;
          float mx = fmaxf(s0, s1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[nt][j], mx);
          const float a = expf(m[nt][j] - m_new);
          // a masked key contributes no mass, not exp(NEG_INF - NEG_INF)
          const float p0 = v0 ? expf(s0 - m_new) : 0.f;
          const float p1 = v1 ? expf(s1 - m_new) : 0.f;
          l[nt][j] = l[nt][j] * a + p0 + p1;
          m[nt][j] = m_new;
          const int col = nt * 8 + 2 * c + j;
          pbuf[gid * GP + col] = p0;
          pbuf[(gid + 8) * GP + col] = p1;
          if (gid == 0) alpha_buf[col] = a;
        }
      }
      __syncwarp();
      // P.V, lanes over dims
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a = alpha_buf[g];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= a;
      }
      const int n = min(16, count - k0);
      const unsigned char* vrow = st + Ly::V_OFF + k0 * Ly::ROW;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        float vf[DPL];
        if constexpr (Ly::INT8) {
          const float sv = reinterpret_cast<const float*>(st + Ly::SV_OFF)[k0 + t];
          int8x4_to_float(*reinterpret_cast<const uint32_t*>(vrow + t * Ly::ROW + 4 * lane), vf);
          // (x * scale) rounded to T and widened, two at a time
          const float2 lo = Mma<T>::unpack(Mma<T>::pack(vf[0] * sv, vf[1] * sv));
          const float2 hi = Mma<T>::unpack(Mma<T>::pack(vf[2] * sv, vf[3] * sv));
          vf[0] = lo.x; vf[1] = lo.y; vf[2] = hi.x; vf[3] = hi.y;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(vrow + t * Ly::ROW + 8 * lane);
          const float2 lo = Mma<T>::unpack(x.x), hi = Mma<T>::unpack(x.y);
          vf[0] = lo.x; vf[1] = lo.y; vf[2] = hi.x; vf[3] = hi.y;
        }
        const float* pr = pbuf + t * GP;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = pr[g];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pg, vf[i], acc[g][i]);
        }
      }
      __syncwarp();
    }
    if (lane == 0) hopper::mbar_arrive(bars + 8 * (Ly::STAGES + stage));
    if (++stage == Ly::STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // l over the 8 row groups of each column; then the state to the merge area
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 4);
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 8);
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 16);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * Ly::CW) : "memory");  // stages free
  float* sm_acc = reinterpret_cast<float*>(smem);
  float* sm_m = sm_acc + Ly::CW * G * DH;
  float* sm_l = sm_m + Ly::CW * G;
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(sm_acc + (warp * G + g) * DH + lane * DPL) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  if (gid == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * c + j;
        if (col < G) {
          sm_m[warp * G + col] = m[nt][j];
          sm_l[warp * G + col] = l[nt][j];
        }
      }
  }
}

// Two blocks an SM where their registers allow it (beyond, ptxas spills).
template <typename T, typename KV, int G>
__global__ void __launch_bounds__((Layout<KV, 8>::THREADS),
                                  (G > 8 || (sizeof(KV) == 1 && G > 4) ? 1 : 2))
    decode_mma(const Args p) {
  constexpr int GP = G > 8 ? 16 : 8;
  using Ly = Layout<KV, GP>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  int begin, end, units;
  split_range(p, bi, split, begin, end, units);
  if (begin >= end) {
    finish_empty<T, G>(p, bi, kvh, split, units);
    return;
  }
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(smem + Ly::BAR_OFF);
    for (int s = 0; s < Ly::STAGES; ++s) {
      // each producer lane's copies, and lane 0's key count
      hopper::mbar_init(bars + 8 * s, 33);
      hopper::mbar_init(bars + 8 * (Ly::STAGES + s), Ly::CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x / 32 == Ly::CW)
    produce<KV, GP>(p, smem, bi, kvh, begin, end);
  else
    consume<T, KV, G>(p, smem, bi, kvh);
  __syncthreads();
  const float* sm_acc = reinterpret_cast<const float*>(smem);
  finish<T, G, Ly::CW>(p, sm_acc, sm_acc + Ly::CW * G * DH,
                       sm_acc + Ly::CW * G * DH + Ly::CW * G, bi, kvh, split, units);
}

// ---------------------------------------------------------------------------
// decode_simt: float32 queries
// ---------------------------------------------------------------------------

// 4 consecutive elements as f32
template <typename T>
struct Load4;
template <>
struct Load4<float> {
  static __device__ __forceinline__ void run(const void* base, size_t off, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <>
struct Load4<int8_t> {
  static __device__ __forceinline__ void run(const void* base, size_t off, float* out) {
    const char4 c = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(base) + off);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// keys a warp takes at a time: fewer for wide groups, to keep registers
template <int G>
struct KeysPerStep {
  static constexpr int value = G == 1 ? 4 : (G <= 8 ? 2 : 1);
};

// One warp's online-softmax state for the G query rows of its kv head
// (float32 queries: the dequantized int8 is already exact in f32).
template <typename KV, int G>
struct WarpState {
  float q[G][DPL];
  float m[G], l[G], acc[G][DPL];

  // Fold keys [j0, j1) whose rows sit at row_delta + j (rows of
  // [.., h_kv, dh]); the warps of the block take KT keys each in turn.
  __device__ __forceinline__ void fold(const Args& p, int kvh, int warp, int lane, int j0,
                                       int j1, long long row_delta) {
    constexpr int KT = KeysPerStep<G>::value;
    constexpr bool INT8 = sizeof(KV) == 1;
    for (int base = j0 + warp * KT; base < j1; base += WARPS * KT) {
      float kf[KT][DPL], vf[KT][DPL];
      bool valid[KT];
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        valid[t] = base + t < j1;
        // an invalid key reads key j1 - 1's row (in bounds) and is masked
        const long long row = row_delta + min(base + t, j1 - 1);
        const size_t off = (size_t)(row * p.h_kv + kvh) * DH + lane * DPL;
        Load4<KV>::run(p.k, off, kf[t]);
        Load4<KV>::run(p.v, off, vf[t]);
        if constexpr (INT8) {
          const float sk = p.ks[row * p.h_kv + kvh];
          const float sv = p.vs[row * p.h_kv + kvh];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            kf[t][i] *= sk;
            vf[t][i] *= sv;
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

template <typename KV, int G>
__global__ void __launch_bounds__(SIMT_THREADS) decode_simt(const Args p) {
  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int begin, end, units;
  split_range(p, bi, split, begin, end, units);
  if (begin >= end) {
    finish_empty<float, G>(p, bi, kvh, split, units);
    return;
  }

  WarpState<KV, G> st;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Load4<float>::run(p.q, ((size_t)bi * p.h + kvh * G + g) * DH + lane * DPL, st.q[g]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      st.q[g][i] *= p.scale;
      st.acc[g][i] = 0.f;
    }
    st.m[g] = NEG_INF;
    st.l[g] = 0.f;
  }

  if (!p.paged) {
    st.fold(p, kvh, warp, lane, begin, end, (long long)bi * p.S);
  } else {
    const int ps = p.page_size;
    for (int pg = begin / ps; pg <= (end - 1) / ps; ++pg) {
      const int pid = p.table[(size_t)bi * p.max_pages + pg];
      if (pid < 0 || pid >= p.num_pages) continue;  // unmapped: no mass
      const int j0 = max(begin, pg * ps), j1 = min(end, pg * ps + ps);
      st.fold(p, kvh, warp, lane, j0, j1, (long long)pid * ps - (long long)pg * ps);
    }
  }

  __shared__ float sm_acc[WARPS * G * DH];
  __shared__ float sm_m[WARPS * G], sm_l[WARPS * G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[(warp * G + g) * DH + lane * DPL + i] = st.acc[g][i];
    if (lane == 0) {
      sm_m[warp * G + g] = st.m[g];
      sm_l[warp * G + g] = st.l[g];
    }
  }
  __syncthreads();
  finish<float, G, WARPS>(p, sm_acc, sm_m, sm_l, bi, kvh, split, units);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename KV, int G>
cudaError_t launch_mma(const Args& p, cudaStream_t stream) {
  constexpr int BYTES = Layout<KV, (G > 8 ? 16 : 8)>::BYTES;
  constexpr int THREADS = Layout<KV, 8>::THREADS;
  static bool smem_set[MAX_DEVICES];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    e = cudaFuncSetAttribute(decode_mma<T, KV, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BYTES);
    if (e != cudaSuccess) return e;
    smem_set[device] = true;
  }
  decode_mma<T, KV, G><<<dim3(p.splits, p.h_kv, p.b), THREADS, BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename KV, int G>
cudaError_t launch_simt(const Args& p, cudaStream_t stream) {
  decode_simt<KV, G><<<dim3(p.splits, p.h_kv, p.b), SIMT_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_group(const Args& p, int G, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    switch (G) {
      case 1: return launch_simt<KV, 1>(p, stream);
      case 2: return launch_simt<KV, 2>(p, stream);
      case 4: return launch_simt<KV, 4>(p, stream);
      case 8: return launch_simt<KV, 8>(p, stream);
      case 16: return launch_simt<KV, 16>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (G) {
      case 1: return launch_mma<T, KV, 1>(p, stream);
      case 2: return launch_mma<T, KV, 2>(p, stream);
      case 4: return launch_mma<T, KV, 4>(p, stream);
      case 8: return launch_mma<T, KV, 8>(p, stream);
      case 16: return launch_mma<T, KV, 16>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T>
cudaError_t launch_cache(const Args& p, int G, int int8, cudaStream_t stream) {
  return int8 ? launch_group<T, int8_t>(p, G, stream) : launch_group<T, T>(p, G, stream);
}

}  // namespace

extern "C" {

// The kernel a dtype runs: 1 decode_mma (f16, bf16), 0 decode_simt (f32);
// -1 for another code.
int ddlb_decode_design(int dtype) { return dtype == 0 ? 0 : (dtype == 1 || dtype == 2 ? 1 : -1); }

// Floats of partials a launch with splits > 1 needs (it also needs b * h_kv
// int counters, zero before the launch and zero after it).
long long ddlb_decode_partial_floats(int b, int h_kv, int splits, int G) {
  return partial_floats(b, h_kv, splits, G);
}

// One launch of K11 (paged = 0) or K12 (paged = 1). consts, 14 ints:
//   dtype (0 f32, 1 f16, 2 bf16: q, o, and K/V unless int8), int8 (K/V
//   int8 with f32 scales ks/vs), b, h, h_kv, dh, S, page_size, num_pages,
//   max_pages, paged, window, splits, unit;
// ptrs, 10 pointers: q, k, v, ks, vs, pos, table, o, counters, partials.
// paged = 0: k/v [b, S, h_kv, dh], table unused; paged = 1: k/v pools
// [num_pages, page_size, h_kv, dh], table [b, max_pages], S = max_pages *
// page_size. A split covers whole runs of `unit` keys (a page for paged =
// 1). counters: b * h_kv ints, zero; partials: ddlb_decode_partial_floats
// floats; both unused (may be null) with one split. Two arrays rather than
// 26 arguments: ctypes converts each argument on every call.
int ddlb_decode_attention(const int* consts, void* const* ptrs, float scale, void* stream) {
  const int dtype = consts[0], int8 = consts[1];
  Args p;
  p.b = consts[2]; p.h = consts[3]; p.h_kv = consts[4];
  const int dh = consts[5];
  p.S = consts[6]; p.page_size = consts[7]; p.num_pages = consts[8];
  p.max_pages = consts[9]; p.paged = consts[10]; p.window = consts[11];
  p.splits = consts[12]; p.unit = consts[13]; p.scale = scale;
  p.q = ptrs[0]; p.k = ptrs[1]; p.v = ptrs[2];
  p.ks = static_cast<const float*>(ptrs[3]);
  p.vs = static_cast<const float*>(ptrs[4]);
  p.pos = static_cast<const int*>(ptrs[5]);
  p.table = static_cast<const int*>(ptrs[6]);
  p.o = ptrs[7];
  p.counters = static_cast<int*>(ptrs[8]);
  float* partials = static_cast<float*>(ptrs[9]);
  if (dh != DH || p.h_kv < 1 || p.h % p.h_kv || p.splits < 1 || p.splits > 255 || p.b < 1 ||
      p.unit < 1 || (p.splits > 1 && (p.counters == nullptr || partials == nullptr)))
    return cudaErrorInvalidValue;
  const int G = p.h / p.h_kv;
  p.part_ml = partials;
  p.part_acc = partials ? partials + (long long)p.b * p.h_kv * p.splits * G * 2 : nullptr;
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
