// K8a / K8b / K9: flash attention forward and the carried-chunk fold.
//
// Replaces, in ddlb_tpu/ops/flash_attention.py:
//  - _flash_forward (:433) with both of its Pallas kernels, the
//    triangular-grid _flash_kernel_tri (:373, K8a: causal, offset 0, sq ==
//    skv; in bf16/fp16 the Hopper kernel of namespace tri below,
//    ddlb_flash_forward_tri) and the rectangular _flash_kernel (:96, K8b:
//    runtime row_offset, sliding window, causal=False, GQA; in bf16/fp16
//    the Hopper kernel of namespace band below, ddlb_flash_forward_band).
//    Writes o in the operand dtype and lse = m + log(l) in f32 (NEG_INF for
//    empty rows).
//  - flash_attention_chunk (:211) with _flash_chunk_kernel (:146, K9; in
//    bf16/fp16 namespace band's kernel too, ddlb_flash_chunk_band): the same
//    walk, but the (acc, m, l) carry is read at the start and written back
//    at the end, in place, instead of being created and normalised. causal
//    = offset (global offsets), diagonal (relative mask) or past (no mask).
//  - ddlb_flash_forward and ddlb_flash_chunk take every case in float32,
//    on flash_f32 below.
//
// What bounds it on an H100: at the shipped shape (sq = skv = 16384, 8 heads
// of 128, bf16, causal) the live work is 4 * h * dh * m(m+1)/2 = 5.5e11 FLOP
// against 128 MiB of q, k, v and o: about 4,100 FLOP per byte, far above
// the card's ~295 FLOP/byte balance point. So the bf16 tensor cores bound
// it (989 TFLOP/s dense: 0.556 ms), not memory (0.040 ms at 3.35 TB/s), and
// the exp of every live score is the next cost after the products.
//
// What the design does about it. In bf16/fp16 K8a runs tri::flash_fwd_wgmma
// and K8b and K9 band::flash_fwd_wgmma (each namespace with its own design
// note): TMA loads, a producer warpgroup and two consumer warpgroups on
// wgmma, 128-row query tiles. float32 runs flash_f32, below:
//  - One block per (query tile, head); blocks run in no order on 132 SMs, so
//    the TPU's sequential kv grid axis becomes a loop inside the block. The
//    loop walks only the key tiles that the tile's live band reaches (from
//    row_offset, col_offset, causal and window): the causal triangle costs
//    half the square, which is what the TPU's prefetched triangular grid
//    maps buy (K8a). Only tiles that straddle a band edge or the ragged end
//    of the keys apply the mask. The heaviest query tiles (the last, under
//    a causal mask) are scheduled first.
//  - float32: a SIMT kernel in true f32 (no TF32), 64-row query tiles and
//    32-key tiles in shared memory, two threads per query row.
//  - Rows whose live band is empty give o = 0 and lse = NEG_INF: the mask
//    sentinel is -1e30, not -inf, so exp(m_prev - m_new) stays finite, and
//    masked p is zeroed, as _online_softmax_update (:41) does.
//  - Operands are read in their [s, h, dh] layout through strides (no
//    transposed copy); lse and the carry are head-major [h, sq, ...].
//
// K10a / K10b / K10c / K10d: the flash backward.
//
// Replaces, in ddlb_tpu/ops/flash_attention.py, flash_attention_bwd (:781)
// with its four Pallas kernels: the triangular-grid dQ and dK/dV kernels
// _flash_bwd_dq_kernel_tri (:706, K10a) and _flash_bwd_dkv_kernel_tri (:741,
// K10b), and the rectangular _flash_bwd_dq_kernel (:624, K10c) and
// _flash_bwd_dkv_kernel (:664, K10d) for runtime offsets, the window, the
// past and none modes and GQA. In bf16/fp16 the triangle runs the Hopper
// kernels of namespace tri_bwd (entry points ddlb_flash_bwd_dq_tri and
// ddlb_flash_bwd_dkv_tri) and everything else those of namespace band_bwd
// (ddlb_flash_bwd_dq_band and ddlb_flash_bwd_dkv_band: tri_bwd's shape over
// a runtime band), each namespace with its own design note; float32 runs
// ddlb_flash_bwd_dq and ddlb_flash_bwd_dkv. The wrapper counts the four
// cases apart. Each tile recomputes S = scale q k^T and P = exp(S - lse)
// (masked), then dP = dO v^T and dS = P (dP - delta), with delta =
// rowsum(dO o) computed by the wrapper:
//  - the dQ pass: one block per (query tile, head) walks the key tiles of
//    its live band and accumulates dQ = scale dS K in registers;
//  - the dK/dV pass: one block per (key tile, kv head) walks, for each of
//    the group's G query heads in turn, the query tiles of its live band
//    and accumulates dV = P^T dO and dK = scale dS^T Q. GQA is summed over
//    the group inside the block, so dK/dV come out with h_kv heads directly.
// Two accumulation directions and no atomics: the result is deterministic.
// dq, dk and dv are written in float32, in the operands' [s, heads, dh]
// layout.
//
// What bounds it on an H100: per live (query, key) pair the dQ pass does
// 6 dh operations (S, dP, dQ) and the dK/dV pass 8 dh (S, dP, dV, dK). At
// the training path's full width (S = 4096, 64 merged heads of 128) that is
// 1.0e12 operations over 5.4e8 live pairs against about 0.67 GB of bf16
// operands and float32 gradients: the bf16 tensor cores bound it (about
// 1 ms), not memory (0.2 ms). float32 runs SIMT kernels in true f32, two
// threads per row (a query row for dQ, a key row for dK/dV), each owning
// half of the head dim.

// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing. head_dim is 128, the only one a shipped
// configuration uses.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;  // [sq, h, dh]
  const void* k;  // [skv, h_kv, dh]
  const void* v;
  void* o;        // [sq, h, dh], forward only
  float* lse;     // [h, sq]: written by the forward, read by the backward
  float* acc;     // [h, sq, dh], carry only, updated in place
  float* m;       // [h, sq]
  float* l;       // [h, sq]
  int sq, skv, h, h_kv, group;
  float scale;
  int q_base, k_base;  // global positions of query row 0 and key 0
  int causal, window, carry;
};

// The backward's own operands, a second kernel argument beside Params: a
// larger Params changes how ptxas allocates the forward kernels' registers
// (224 -> 200 for the former mma.sync forward on sm_90a) and slows them by
// about 40%.
struct Grads {
  const void* dout;    // [sq, h, dh]
  const float* delta;  // [h, sq]: rowsum(dout * o)
  float* dq;           // [sq, h, dh]
  float* dk;           // [skv, h_kv, dh]
  float* dv;
};

// Is key kcol (local index) live for the query at global position qpos?
__device__ __forceinline__ bool live(const Params& p, int qpos, int kcol) {
  if (kcol >= p.skv) return false;
  const int kpos = p.k_base + kcol;
  if (p.causal && kpos > qpos) return false;
  if (p.window && kpos <= qpos - p.window) return false;
  return true;
}

// Key tiles [first, last) that meet the live band of local query rows
// [qlo, qhi): the loop bounds that replace the TPU's triangular grid.
template <int BKV>
__device__ __forceinline__ void tile_range(const Params& p, int qlo, int qhi,
                                           int& first, int& last) {
  int lo = 0, hi = p.skv;
  if (p.causal) hi = min(hi, p.q_base + qhi - p.k_base);
  if (p.window) lo = max(lo, p.q_base + qlo - p.window + 1 - p.k_base);
  first = lo / BKV;
  last = hi > lo ? (hi + BKV - 1) / BKV : first;
}

// Does key tile k0 hold a masked entry for some row of [qlo, qhi)?
template <int BKV>
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int qlo,
                                                int qhi, int k0) {
  if (k0 + BKV > p.skv) return true;  // ragged end of the keys
  // causal: the first query row against the last key of the tile
  if (p.causal && p.k_base + k0 + BKV - 1 > p.q_base + qlo) return true;
  // window: the last query row against the first key of the tile
  if (p.window && p.k_base + k0 <= p.q_base + qhi - 1 - p.window) return true;
  return false;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 operands of the tensor cores
// ---------------------------------------------------------------------------

// Two float32 values rounded to T and packed into 32 bits, lo in the low 16
// bits (the element of the smaller column index): a register operand of
// wgmma.
template <typename T>
struct Half;
template <>
struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Half<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// ---------------------------------------------------------------------------
// float32 on the SIMT cores (true f32, no TF32)
// ---------------------------------------------------------------------------

constexpr int FBQ = 64, FBKV = 32, F_THREADS = 2 * FBQ;

template <int D>
constexpr int f32_smem_bytes() {
  return (FBQ * (D + 1) + FBKV * (D + 1) + FBKV * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_f32(Params p) {
  constexpr int LDQ = D + 1, LDK = D + 1;  // padded against bank conflicts
  constexpr int HALF = FBKV / 2, DH = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [FBQ][LDQ]
  float* Ks = Qs + FBQ * LDQ;                      // [FBKV][LDK]
  float* Vs = Ks + FBKV * LDK;                     // [FBKV][D]

  // two threads per query row: keys [16*half, 16*half + 16) of each tile,
  // output columns 2*i + half
  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FBQ;
  const int qhi = min(q0 + FBQ, p.sq);
  const int hh = blockIdx.y, kvh = hh / p.group;
  const size_t q_stride = static_cast<size_t>(p.h) * D;
  const size_t kv_stride = static_cast<size_t>(p.h_kv) * D;
  const float* Q = static_cast<const float*>(p.q) + static_cast<size_t>(hh) * D;
  const float* K = static_cast<const float*>(p.k) + static_cast<size_t>(kvh) * D;
  const float* V = static_cast<const float*>(p.v) + static_cast<size_t>(kvh) * D;
  const int r = q0 + row;
  const bool in = r < p.sq;
  const size_t srow = static_cast<size_t>(hh) * p.sq + r;

  for (int i = tid; i < FBQ * D; i += F_THREADS) {
    const int rr = i / D, c = i % D;
    Qs[rr * LDQ + c] = q0 + rr < p.sq ? Q[(q0 + rr) * q_stride + c] : 0.0f;
  }

  float o[DH];
  float m_r = NEG_INF, l_r = 0.0f;
#pragma unroll
  for (int i = 0; i < DH; ++i) o[i] = 0.0f;
  if (p.carry && in) {
#pragma unroll
    for (int i = 0; i < DH; ++i) o[i] = p.acc[srow * D + 2 * i + half];
    m_r = p.m[srow];
    l_r = p.l[srow];
  }

  int first, last;
  tile_range<FBKV>(p, q0, qhi, first, last);
  const int qpos = p.q_base + r;
  const float* qrow = Qs + row * LDQ;
  for (int t = first; t < last; ++t) {
    const int k0 = t * FBKV;
    __syncthreads();  // the Q tile is written; the last tile's reads are done
    for (int i = tid; i < FBKV * D; i += F_THREADS) {
      const int rr = i / D, c = i % D;
      const bool ok = k0 + rr < p.skv;
      const size_t off = static_cast<size_t>(k0 + rr) * kv_stride + c;
      Ks[rr * LDK + c] = ok ? K[off] : 0.0f;
      Vs[rr * D + c] = ok ? V[off] : 0.0f;
    }
    __syncthreads();

    float s[HALF];
#pragma unroll
    for (int c = 0; c < HALF; ++c) s[c] = 0.0f;
    const float* kbase = Ks + half * HALF * LDK;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int c = 0; c < HALF; ++c) s[c] = fmaf(qd, kbase[c * LDK + d], s[c]);
    }

    const bool need_mask = tile_needs_mask<FBKV>(p, q0, qhi, k0);
    float mx = m_r;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      s[c] *= p.scale;
      if (need_mask && !live(p, qpos, k0 + half * HALF + c)) s[c] = NEG_INF;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float alpha = expf(m_r - mx);
    m_r = mx;
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      s[c] = (need_mask && s[c] == NEG_INF) ? 0.0f : expf(s[c] - mx);
      sum += s[c];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_r = l_r * alpha + sum;
#pragma unroll
    for (int i = 0; i < DH; ++i) o[i] *= alpha;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const float mine = s[c];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      const float p_lo = half ? other : mine;  // key c of the tile
      const float p_hi = half ? mine : other;  // key HALF + c
      const float* v_lo = Vs + c * D + half;
      const float* v_hi = Vs + (HALF + c) * D + half;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        o[i] = fmaf(p_lo, v_lo[2 * i], o[i]);
        o[i] = fmaf(p_hi, v_hi[2 * i], o[i]);
      }
    }
  }

  if (!in) return;
  if (p.carry) {
#pragma unroll
    for (int i = 0; i < DH; ++i) p.acc[srow * D + 2 * i + half] = o[i];
    if (half == 0) p.m[srow] = m_r, p.l[srow] = l_r;
    return;
  }
  const float den = l_r == 0.0f ? 1.0f : l_r;
  float* O = static_cast<float*>(p.o) + static_cast<size_t>(hh) * D;
#pragma unroll
  for (int i = 0; i < DH; ++i) O[r * q_stride + 2 * i + half] = o[i] / den;
  if (half == 0) p.lse[srow] = l_r == 0.0f ? NEG_INF : m_r + logf(l_r);
}

// ---------------------------------------------------------------------------
// the backward (K10a-K10d)
// ---------------------------------------------------------------------------

// Is key kcol (local) live for local query row qrow? The backward's dK/dV
// walk also meets ragged query rows, which count as dead.
__device__ __forceinline__ bool live_pair(const Params& p, int qrow, int kcol) {
  return qrow < p.sq && live(p, p.q_base + qrow, kcol);
}

// Query tiles [first, last) that meet the live band of local keys
// [klo, khi): a key at kpos is live for queries kpos <= qpos < kpos + window.
template <int BQT>
__device__ __forceinline__ void q_tile_range(const Params& p, int klo, int khi,
                                             int& first, int& last) {
  int lo = 0, hi = p.sq;
  if (p.causal) lo = max(lo, p.k_base + klo - p.q_base);
  if (p.window) hi = min(hi, p.k_base + khi - 1 + p.window - p.q_base);
  first = lo / BQT;
  last = hi > lo ? (hi + BQT - 1) / BQT : first;
}

// Does the tile of local queries [qlo, qhi) x keys [klo, khi) hold a masked
// entry? (qhi, khi clamped to sq, skv; a tile cut by a ragged end is masked)
__device__ __forceinline__ bool pair_tile_needs_mask(const Params& p, int qlo,
                                                     int qhi, int klo, int khi,
                                                     int bq, int bkv) {
  if (qlo + bq > p.sq || klo + bkv > p.skv) return true;
  if (p.causal && p.k_base + khi - 1 > p.q_base + qlo) return true;
  if (p.window && p.k_base + klo <= p.q_base + qhi - 1 - p.window) return true;
  return false;
}

// float32 on the SIMT cores: two threads per row, each owning the head-dim
// columns 2*i + half (as flash_f32)
constexpr int FB_ROWS = 64, FB_TILE = 32, FB_THREADS = 2 * FB_ROWS;

template <int D>
constexpr int f32_bwd_smem_bytes() {
  // two row tiles [FB_ROWS][D+1] held for the walk, two tiles [FB_TILE][D+1]
  // staged per step, and two [FB_TILE] vectors
  return (2 * FB_ROWS * (D + 1) + 2 * FB_TILE * (D + 1) + 2 * FB_TILE) * 4;
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_dq_f32(Params p,
                                                               Grads gr) {
  constexpr int LD = D + 1, HALF = FB_TILE / 2, DH = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [FB_ROWS][LD]
  float* Os = Qs + FB_ROWS * LD;                   // dO rows
  float* Ks = Os + FB_ROWS * LD;                   // [FB_TILE][LD]
  float* Vs = Ks + FB_TILE * LD;

  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_ROWS;
  const int qhi = min(q0 + FB_ROWS, p.sq);
  const int hh = blockIdx.y, kvh = hh / p.group;
  const size_t q_stride = static_cast<size_t>(p.h) * D;
  const size_t kv_stride = static_cast<size_t>(p.h_kv) * D;
  const float* Q = static_cast<const float*>(p.q) + static_cast<size_t>(hh) * D;
  const float* DO =
      static_cast<const float*>(gr.dout) + static_cast<size_t>(hh) * D;
  const float* K = static_cast<const float*>(p.k) + static_cast<size_t>(kvh) * D;
  const float* V = static_cast<const float*>(p.v) + static_cast<size_t>(kvh) * D;
  const int r = q0 + row;
  const bool in = r < p.sq;
  const size_t srow = static_cast<size_t>(hh) * p.sq + r;
  const float lse_r = in ? p.lse[srow] : 0.0f, dl_r = in ? gr.delta[srow] : 0.0f;

  for (int i = tid; i < FB_ROWS * D; i += FB_THREADS) {
    const int rr = i / D, c = i % D;
    const bool ok = q0 + rr < p.sq;
    Qs[rr * LD + c] = ok ? Q[(q0 + rr) * q_stride + c] : 0.0f;
    Os[rr * LD + c] = ok ? DO[(q0 + rr) * q_stride + c] : 0.0f;
  }

  float dq[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) dq[i] = 0.0f;

  int first, last;
  tile_range<FB_TILE>(p, q0, qhi, first, last);
  const float* qrow = Qs + row * LD;
  const float* orow = Os + row * LD;
  for (int t = first; t < last; ++t) {
    const int k0 = t * FB_TILE;
    __syncthreads();  // the row tiles are written; the last tile's reads are done
    for (int i = tid; i < FB_TILE * D; i += FB_THREADS) {
      const int rr = i / D, c = i % D;
      const bool ok = k0 + rr < p.skv;
      const size_t off = static_cast<size_t>(k0 + rr) * kv_stride + c;
      Ks[rr * LD + c] = ok ? K[off] : 0.0f;
      Vs[rr * LD + c] = ok ? V[off] : 0.0f;
    }
    __syncthreads();

    // this thread's keys half*HALF + c: s and dP over the whole head dim
    float s[HALF], dp[HALF];
#pragma unroll
    for (int c = 0; c < HALF; ++c) s[c] = dp[c] = 0.0f;
    const float* kb = Ks + half * HALF * LD;
    const float* vb = Vs + half * HALF * LD;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d], od = orow[d];
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        s[c] = fmaf(qd, kb[c * LD + d], s[c]);
        dp[c] = fmaf(od, vb[c * LD + d], dp[c]);
      }
    }
    const bool need_mask = tile_needs_mask<FB_TILE>(p, q0, qhi, k0);
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      float pe = expf(s[c] * p.scale - lse_r);
      if (need_mask && !live(p, p.q_base + r, k0 + half * HALF + c)) pe = 0.0f;
      s[c] = pe * (dp[c] - dl_r);  // dS
    }
    // dQ += dS K over all FB_TILE keys: the partner thread holds the other half
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const float mine = s[c];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      const float d_lo = half ? other : mine;  // key c of the tile
      const float d_hi = half ? mine : other;  // key HALF + c
      const float* k_lo = Ks + c * LD + half;
      const float* k_hi = Ks + (HALF + c) * LD + half;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        dq[i] = fmaf(d_lo, k_lo[2 * i], dq[i]);
        dq[i] = fmaf(d_hi, k_hi[2 * i], dq[i]);
      }
    }
  }
  if (!in) return;
  float* DQ = gr.dq + static_cast<size_t>(hh) * D;
#pragma unroll
  for (int i = 0; i < DH; ++i) DQ[r * q_stride + 2 * i + half] = dq[i] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_dkv_f32(Params p,
                                                                Grads gr) {
  constexpr int LD = D + 1, HALF = FB_TILE / 2, DH = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [FB_ROWS][LD]: the keys
  float* Vs = Ks + FB_ROWS * LD;
  float* Qs = Vs + FB_ROWS * LD;  // [FB_TILE][LD]
  float* Os = Qs + FB_TILE * LD;  // dO
  float* Ls = Os + FB_TILE * LD;  // [FB_TILE]
  float* Es = Ls + FB_TILE;

  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const int k0 = blockIdx.x * FB_ROWS;
  const int khi = min(k0 + FB_ROWS, p.skv);
  const int kvh = blockIdx.y;
  const size_t q_stride = static_cast<size_t>(p.h) * D;
  const size_t kv_stride = static_cast<size_t>(p.h_kv) * D;
  const float* K = static_cast<const float*>(p.k) + static_cast<size_t>(kvh) * D;
  const float* V = static_cast<const float*>(p.v) + static_cast<size_t>(kvh) * D;
  const int kr = k0 + row;

  for (int i = tid; i < FB_ROWS * D; i += FB_THREADS) {
    const int rr = i / D, c = i % D;
    const bool ok = k0 + rr < p.skv;
    const size_t off = static_cast<size_t>(k0 + rr) * kv_stride + c;
    Ks[rr * LD + c] = ok ? K[off] : 0.0f;
    Vs[rr * LD + c] = ok ? V[off] : 0.0f;
  }

  float dk[DH], dv[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) dk[i] = dv[i] = 0.0f;

  int first, last;
  q_tile_range<FB_TILE>(p, k0, khi, first, last);
  const float* krow = Ks + row * LD;
  const float* vrow = Vs + row * LD;
  for (int gi = 0; gi < p.group; ++gi) {
    const int hh = kvh * p.group + gi;
    const float* Q = static_cast<const float*>(p.q) + static_cast<size_t>(hh) * D;
    const float* DO =
        static_cast<const float*>(gr.dout) + static_cast<size_t>(hh) * D;
    for (int t = first; t < last; ++t) {
      const int q0 = t * FB_TILE;
      __syncthreads();  // the key tile is written; the last tile's reads are done
      for (int i = tid; i < FB_TILE * D; i += FB_THREADS) {
        const int rr = i / D, c = i % D;
        const bool ok = q0 + rr < p.sq;
        const size_t off = static_cast<size_t>(q0 + rr) * q_stride + c;
        Qs[rr * LD + c] = ok ? Q[off] : 0.0f;
        Os[rr * LD + c] = ok ? DO[off] : 0.0f;
      }
      if (tid < FB_TILE) {
        const bool ok = q0 + tid < p.sq;
        const size_t srow = static_cast<size_t>(hh) * p.sq + q0 + tid;
        Ls[tid] = ok ? p.lse[srow] : 0.0f;
        Es[tid] = ok ? gr.delta[srow] : 0.0f;
      }
      __syncthreads();

      // this thread's queries half*HALF + c against its key
      float s[HALF], dp[HALF];
#pragma unroll
      for (int c = 0; c < HALF; ++c) s[c] = dp[c] = 0.0f;
      const float* qb = Qs + half * HALF * LD;
      const float* ob = Os + half * HALF * LD;
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int c = 0; c < HALF; ++c) {
          s[c] = fmaf(kd, qb[c * LD + d], s[c]);
          dp[c] = fmaf(vd, ob[c * LD + d], dp[c]);
        }
      }
      const bool need_mask = pair_tile_needs_mask(
          p, q0, min(q0 + FB_TILE, p.sq), k0, khi, FB_TILE, FB_ROWS);
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        const int qc = half * HALF + c;
        float pe = expf(s[c] * p.scale - Ls[qc]);
        if (need_mask && !live_pair(p, q0 + qc, kr)) pe = 0.0f;
        s[c] = pe;                      // P^T
        dp[c] = pe * (dp[c] - Es[qc]);  // dS^T
      }
      // dV += P^T dO and dK += dS^T Q over all FB_TILE queries
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        const float p_o = __shfl_xor_sync(0xffffffffu, s[c], 1);
        const float d_o = __shfl_xor_sync(0xffffffffu, dp[c], 1);
        const float p_lo = half ? p_o : s[c], p_hi = half ? s[c] : p_o;
        const float d_lo = half ? d_o : dp[c], d_hi = half ? dp[c] : d_o;
        const float* o_lo = Os + c * LD + half;
        const float* o_hi = Os + (HALF + c) * LD + half;
        const float* q_lo = Qs + c * LD + half;
        const float* q_hi = Qs + (HALF + c) * LD + half;
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          dv[i] = fmaf(p_lo, o_lo[2 * i], dv[i]);
          dv[i] = fmaf(p_hi, o_hi[2 * i], dv[i]);
          dk[i] = fmaf(d_lo, q_lo[2 * i], dk[i]);
          dk[i] = fmaf(d_hi, q_hi[2 * i], dk[i]);
        }
      }
    }
  }
  if (kr >= p.skv) return;
  float* DK = gr.dk + static_cast<size_t>(kvh) * D;
  float* DV = gr.dv + static_cast<size_t>(kvh) * D;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    DK[kr * kv_stride + 2 * i + half] = dk[i] * p.scale;
    DV[kr * kv_stride + 2 * i + half] = dv[i];
  }
}

// Launch kernel with `smem` bytes of dynamic shared memory on stream s.
template <typename Kernel, typename... Args>
cudaError_t launch_with(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                        const Args&... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8a on Hopper: the causal triangle with TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------
//
// The triangle only (causal, offset 0, sq == skv, no window), bf16/fp16,
// head_dim 128; its own names in namespace tri, its own argument struct
// (the shared Params stays as it is: see Grads).
//  - One block of 384 threads per (128-row query tile, head) on a 1-D grid.
//    Heads go in groups whose K and V fit in L2 together (24 MB: the 128
//    heads of the serving prefill in groups of 6, the 16 of a serve bucket
//    in one); inside a group the heaviest query tiles first, so the blocks
//    running at once read the same few heads' K and V. Query tile i meets
//    key tiles 0..i; the walk goes from the diagonal tile i, the only one
//    masked, down to key tile 0.
//  - Warpgroup 0 is the producer (setmaxnreg down to 40): one thread issues
//    TMA loads, the Q tile once, then K and V tiles into two rings of two
//    stages each, with a full and an empty mbarrier a stage. K and V have
//    rings of their own, so a K stage frees as soon as its QK^T has run.
//  - Warpgroups 1 and 2 are the consumers (up to 232 registers), 64 query
//    rows each. S = Q K^T is wgmma m64n128k16 from shared memory (Q and K
//    both K-major); O += P V is wgmma m64n128k16 with P in registers (the S
//    accumulators rounded to T are the A fragments) and V
//    read MN-major through the transpose bit. A warpgroup runs QK^T, the
//    softmax and PV of a tile one after the other, and the two consumer
//    warpgroups overlap each other. (Issuing the QK^T of tile t + 1 beside
//    the PV of tile t, so a warpgroup's softmax runs under its own products,
//    needs S, P and O live at once: ptxas spilled P, and on an H100 that
//    kernel measured slower than this one at every shape timed.)
//  - Online softmax in base 2: m is the row max of the raw scores, p =
//    exp2(s * c - m * c) with c = scale * log2(e), one FMA a score; l sums
//    the unrounded p a thread at a time and is reduced over the quad once,
//    at the end. lse = m * scale + log(l), in natural-log units, as the
//    backward (K10a-d) reads it.
//  - Tensor maps are 3-D over the [s, heads, dh] layout ({dh, heads, s},
//    boxes of 64 dh x 1 head x 128 rows, 128-byte swizzle): two boxes per
//    128-dh tile, GQA by the kv-head coordinate, no transposed copy. TMA
//    fills rows past s with zeros; the causal mask drops those keys.
//  - Epilogue: O / l rounded once to T, staged through this warpgroup's
//    rows of the Q tile (its last QK^T has run) in a XOR-swizzled layout,
//    then stored 16 bytes a lane; rows past sq are not stored.
namespace tri {

constexpr int D = 128, BQ = 128, BKV = 128, STAGES = 2;
constexpr int THREADS = 384;
constexpr int BOX = 64;                      // dh columns of one 128-byte swizzle span
constexpr int TILE_BYTES = BQ * D * 2;       // Q, or one K or V stage: 32 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;   // one box of 128 rows x 64 dh
constexpr int WG_ROWS_BYTES = 64 * BOX * 2;  // a consumer warpgroup's rows of a box
static_assert(BQ == BKV, "query and key tiles line up: only tile i is masked");
// Q, the K stages, the V stages (each 1 KB aligned), then the mbarriers:
// q_full, k_full[2], k_empty[2], v_full[2], v_empty[2]
constexpr int BAR_OFFSET = (1 + 2 * STAGES) * TILE_BYTES;
constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + (1 + 4 * STAGES) * 8;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on an H100");
constexpr int CONSUMER_WARPS = 8;

struct Args {
  CUtensorMap q;  // [sq, h, dh]
  CUtensorMap k;  // [sq, h_kv, dh]
  CUtensorMap v;
  void* o;        // [sq, h, dh]
  float* lse;     // [h, sq]
  int sq, h, group, q_tiles;
  int head_group;           // query heads a group of blocks walks together
  float scale, scale_log2;  // scale, scale * log2(e)
};

// Bytes of K and V that the blocks running at once should share in L2 (of
// its 50 MB): the heads of a head group read at most this much together.
constexpr long long L2_SHARE = 24ll << 20;

struct Smem {
  uint32_t base;       // shared-window address (1 KB aligned)
  unsigned char* ptr;  // the same, as a generic pointer
  __device__ uint32_t q(int half) const { return base + half * HALF_BYTES; }
  __device__ uint32_t k(int s, int half) const {
    return base + (1 + s) * TILE_BYTES + half * HALF_BYTES;
  }
  __device__ uint32_t v(int s, int half) const {
    return base + (1 + STAGES + s) * TILE_BYTES + half * HALF_BYTES;
  }
  __device__ uint32_t q_full() const { return base + BAR_OFFSET; }
  __device__ uint32_t k_full(int s) const { return q_full() + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const { return k_full(s) + 8 * STAGES; }
  __device__ uint32_t v_full(int s) const { return k_empty(s) + 8 * STAGES; }
  __device__ uint32_t v_empty(int s) const { return v_full(s) + 8 * STAGES; }
};

#define DDLB_TRI_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DDLB_TRI_OPERANDS                                                 \
  DDLB_TRI_D8(0), DDLB_TRI_D8(8), DDLB_TRI_D8(16), DDLB_TRI_D8(24),       \
      DDLB_TRI_D8(32), DDLB_TRI_D8(40), DDLB_TRI_D8(48), DDLB_TRI_D8(56)
#define DDLB_TRI_REGS                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
// S [64 x 128] (=|+)= A [64 x 16] @ B [16 x 128], both from shared memory,
// K-major; accumulate = 0 overwrites d
#define DDLB_TRI_SS(TYPE)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE \
               " " DDLB_TRI_REGS ", %64, %65, p, 1, 1, 0, 0;\n}\n"      \
               : DDLB_TRI_OPERANDS                                        \
               : "l"(da), "l"(db), "r"(accumulate))
// O [64 x 128] += A [64 x 16] from registers @ B [16 x 128] MN-major
#define DDLB_TRI_RS(TYPE)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE \
               " " DDLB_TRI_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : DDLB_TRI_OPERANDS                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
    DDLB_TRI_SS("bf16");
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a,
                                            uint64_t db) {
    DDLB_TRI_RS("bf16");
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
    DDLB_TRI_SS("f16");
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a,
                                            uint64_t db) {
    DDLB_TRI_RS("f16");
  }
};
#undef DDLB_TRI_RS
#undef DDLB_TRI_SS
#undef DDLB_TRI_REGS
#undef DDLB_TRI_OPERANDS
#undef DDLB_TRI_D8

// Pin registers that an asynchronous wgmma wrote or read: uses after this
// point cannot be moved above the wgmma wait before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S = Q K^T of K stage st: 8 k-steps of 16 dh, 32 bytes along the swizzled
// rows, the second box from dh 64.
template <typename T>
__device__ __forceinline__ void issue_qk(const Smem& sm, float (&s)[64], int st, int wg) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int half = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = hopper::smem_desc(sm.q(half) + wg * WG_ROWS_BYTES + off, 16, 1024);
    const uint64_t db = hopper::smem_desc(sm.k(st, half) + off, 16, 1024);
    Mma<T>::ss(s, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P V of V stage st: 8 k-steps of 16 keys (16 rows of 128 bytes down
// both boxes, which sit HALF_BYTES apart).
template <typename T>
__device__ __forceinline__ void issue_pv(const Smem& sm, float (&o)[64],
                                         const uint32_t (&pa)[32], int st) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < BKV / 16; ++kt) {
    const uint64_t db = hopper::smem_desc(sm.v(st, 0) + kt * 16 * BOX * 2, HALF_BYTES, 1024);
    Mma<T>::rs(o, pa + 4 * kt, db);
  }
  hopper::wgmma_commit();
}

// 2^x on the special-function unit (ex2.approx, subnormal results flushed
// to zero: a p below 2^-126 of the row's largest is dropped from sums that
// hold at least 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile: the new row max (raw scores), the
// factor the running sums scale by, and p = exp2(s c - m c) in place.
// On the diagonal tile the keys after the query are masked and their p is
// exactly 0, so a row with nothing live keeps l == 0.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&alpha)[2],
                                             float (&sum)[2], float c, bool diag, int r0) {
  const int t4 = threadIdx.x % 4;
  if (diag) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t4 + (e & 1) > r0 + (e >= 2 ? 8 : 0)) s[4 * j + e] = NEG_INF;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2((m[r] - mx[r]) * c);
    m[r] = mx[r];
    sum[r] = 0.0f;
  }
  const float mc[2] = {mx[0] * c, mx[1] * c};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      const float pe = ex2(fmaf(x, c, -mc[e >> 1]));
      s[4 * j + e] = (diag && x == NEG_INF) ? 0.0f : pe;
    }
    sum[0] += s[4 * j] + s[4 * j + 1];
    sum[1] += s[4 * j + 2] + s[4 * j + 3];
  }
}

template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = Half<T>::pack(s[2 * i], s[2 * i + 1]);
}

// The running O and l after a tile's softmax: scaled by alpha, plus the
// tile's sums.
__device__ __forceinline__ void rescale(float (&o)[64], float (&l)[2], const float (&alpha)[2],
                                        const float (&sum)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// This block's query tile qt and heads: heads in groups of head_group,
// whose K and V fit in L2 together; inside a group the last (heaviest)
// query tiles first, head by head.
__device__ __forceinline__ void block_tile(int head_group, int q_tiles, int h, int group,
                                           int& qt, int& hh, int& kvh) {
  const int first = static_cast<int>(blockIdx.x) / (head_group * q_tiles) * head_group;
  const int heads = min(head_group, h - first);
  const int local = static_cast<int>(blockIdx.x) - first * q_tiles;
  qt = q_tiles - 1 - local / heads;
  hh = first + local % heads;
  kvh = hh / group;
}

// Thread 0 sets up the block's mbarriers; every thread waits for it.
__device__ __forceinline__ void init_barriers(const Smem& sm) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(sm.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(sm.k_full(s), 1);
      hopper::mbar_init(sm.v_full(s), 1);
      hopper::mbar_init(sm.k_empty(s), CONSUMER_WARPS);
      hopper::mbar_init(sm.v_empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer (one thread): the Q tile of rows q0 of head hh once, then
// the K and V tiles of kv head kvh from key tile last - 1 down, n_tiles of
// them, through the two rings.
__device__ __forceinline__ void load_tiles(const Smem& sm, const CUtensorMap* q,
                                           const CUtensorMap* k, const CUtensorMap* v, int hh,
                                           int kvh, int q0, int last, int n_tiles) {
  hopper::mbar_expect_tx(sm.q_full(), TILE_BYTES);
  for (int half = 0; half < 2; ++half)
    hopper::tma_load(sm.q(half), q, sm.q_full(), half * BOX, hh, q0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int k0 = (last - 1 - i) * BKV;
    hopper::mbar_wait(sm.k_empty(st), phase ^ 1u);
    hopper::mbar_expect_tx(sm.k_full(st), TILE_BYTES);
    for (int half = 0; half < 2; ++half)
      hopper::tma_load(sm.k(st, half), k, sm.k_full(st), half * BOX, kvh, k0);
    hopper::mbar_wait(sm.v_empty(st), phase ^ 1u);
    hopper::mbar_expect_tx(sm.v_full(st), TILE_BYTES);
    for (int half = 0; half < 2; ++half)
      hopper::tma_load(sm.v(st, half), v, sm.v_full(st), half * BOX, kvh, k0);
  }
}

// The epilogue of consumer warpgroup c: lse [h, sq] of its rows, then O /
// l rounded once to T, staged through its rows of the Q tile (its last
// QK^T has run) and stored to out [sq, h, 128]; rows past sq are not
// stored. l is reduced over the quad here.
template <typename T>
__device__ __forceinline__ void store_output(const Smem& sm, const float (&o)[64],
                                             const float (&m)[2], float (&l)[2], T* out,
                                             float* lse, int sq, int h, int hh, int q0, int c,
                                             float scale) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r0 = 64 * c + 16 * warp + lane / 4;
  const int t4 = lane % 4, g = lane / 4;
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    den[r] = l[r] == 0.0f ? 1.0f : l[r];
    const int row = q0 + r0 + 8 * r;
    if (t4 == 0 && row < sq)
      lse[static_cast<size_t>(hh) * sq + row] =
          l[r] == 0.0f ? NEG_INF : m[r] * scale + logf(l[r]);
  }
  // a 16-byte chunk (8 dh) of row rw sits at chunk ^ (rw % 8) of its
  // 128-byte row: conflict-free for the pairs written and the chunks read
  unsigned char* stage = sm.ptr + c * WG_ROWS_BYTES;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int half = j / 8, chunk = j % 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rw = 16 * warp + g + 8 * r;
      *reinterpret_cast<uint32_t*>(stage + half * HALF_BYTES + rw * 128 +
                                   ((chunk ^ (rw % 8)) * 16) + t4 * 4) =
          Half<T>::pack(o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int pass = 0; pass < 8; ++pass) {
    const int rw = 16 * warp + 2 * pass + lane / 16;
    const int half = (lane % 16) / 8, chunk = lane % 8;
    const int row = q0 + 64 * c + rw;
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + half * HALF_BYTES + rw * 128 + ((chunk ^ (rw % 8)) * 16));
    if (row < sq)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(row) * h + hh) * D + half * BOX +
                                chunk * 8) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma(const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const Smem sm{aligned, smem_raw + (aligned - raw)};
  int qt, hh, kvh;
  block_tile(p.head_group, p.q_tiles, p.h, p.group, qt, hh, kvh);
  const int q0 = qt * BQ, n_tiles = qt + 1;

  init_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    if (threadIdx.x == 0) load_tiles(sm, &p.q, &p.k, &p.v, hh, kvh, q0, n_tiles, n_tiles);
  } else {
    hopper::consumer_registers();
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool arrives = lane == 0;
    // this thread's rows within the tile: r0 and r0 + 8
    const int r0 = 64 * c + 16 * warp + lane / 4;
    float o[64], s[64];
    uint32_t pa[32];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, alpha[2], sum[2];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.0f;
    hopper::mbar_wait(sm.q_full(), 0);

    // the diagonal tile first, alone
    hopper::mbar_wait(sm.k_full(0), 0);
    issue_qk<T>(sm, s, 0, c);
    hopper::wgmma_wait<0>();
    fence_regs(s);
    if (arrives) hopper::mbar_arrive(sm.k_empty(0));
    softmax_tile(s, m, alpha, sum, p.scale_log2, true, r0);
    l[0] = sum[0];
    l[1] = sum[1];
    pack_p<T>(pa, s);

    hopper::mbar_wait(sm.v_full(0), 0);
    issue_pv<T>(sm, o, pa, 0);
    hopper::wgmma_wait<0>();
    fence_regs(o);
    if (arrives) hopper::mbar_arrive(sm.v_empty(0));

    // the other tiles, one after the other: the two consumer warpgroups
    // drift apart, so one's softmax runs under the other's products
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      hopper::mbar_wait(sm.k_full(st), ph);
      issue_qk<T>(sm, s, st, c);
      hopper::wgmma_wait<0>();
      fence_regs(s);
      if (arrives) hopper::mbar_arrive(sm.k_empty(st));
      softmax_tile(s, m, alpha, sum, p.scale_log2, false, r0);
      rescale(o, l, alpha, sum);
      pack_p<T>(pa, s);
      hopper::mbar_wait(sm.v_full(st), ph);
      issue_pv<T>(sm, o, pa, st);
      hopper::wgmma_wait<0>();
      fence_regs(o);
      if (arrives) hopper::mbar_arrive(sm.v_empty(st));
    }
    store_output<T>(sm, o, m, l, static_cast<T*>(p.o), p.lse, p.sq, p.h, hh, q0, c, p.scale);
  }
}

// A {dh, heads, s} map of a [s, heads, 128] operand, boxes of 64 dh x 1 head
// x box_rows rows.
int encode_heads(CUtensorMap* map, int dtype, const void* base, int s, int heads,
                 int box_rows = BQ) {
  hopper::EncodeTiled fn = nullptr;
  const int rc = hopper::encode_tiled(&fn);
  if (rc != 0) return rc;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2};
  const cuuint32_t box[3] = {BOX, 1, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map, dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Heads a group of blocks walks together: as many as share L2_SHARE bytes,
// each head reading `per_head` bytes.
int head_group(long long per_head, int heads) {
  const long long g = L2_SHARE / (per_head + 1);
  return static_cast<int>(g < 1 ? 1 : g > heads ? heads : g);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  flash_fwd_wgmma<T><<<a.q_tiles * a.h, THREADS, SMEM_BYTES, s>>>(a);
  return cudaGetLastError();
}

}  // namespace tri

// ---------------------------------------------------------------------------
// K10a / K10b on Hopper: the causal triangle's backward on TMA and wgmma
// ---------------------------------------------------------------------------
//
// The triangle only (causal, offset 0, sq == skv, no window), bf16/fp16,
// head_dim 128, as flash_fwd_wgmma; each kernel has its own argument
// struct with __grid_constant__ tensor maps (Params and Grads stay as they
// are). The arithmetic: P = exp(scale S - lse) with the causal mask, dS = P (dP - delta) in float32, P and dS rounded once
// to T as the A operands of their products, float32 sums; in base 2, p =
// ex2(s c - lse log2(e)) with c = scale log2(e), one FMA a score.
//  - Shape: one block of 384 threads; warpgroup 0 is the producer
//    (setmaxnreg down to 40), warpgroups 1 and 2 the consumers (up to 232
//    registers), 64 rows each. Tensor maps are tri's 3-D {dh, heads, s}
//    maps (128-byte swizzle, two 64-dh boxes a tile; TMA fills rows past s
//    with zeros); both kernels walk from the diagonal outwards, and only
//    the tiles that cross it (or the ragged end) run the masked
//    instantiation of their elementwise code.
//  - Registers decide the shape. On sm_90a ptxas kept the wgmma pipeline
//    only while a consumer's live values fit the kernel's 168 registers
//    (65536 / 384 threads), setmaxnreg or not: past that it spilled and
//    put a wait after every wgmma (C7512, "serialized due to insufficient
//    register resources"). A 64-register accumulator that persists, the
//    score tiles of one product step and the packed A operand fit; two
//    persistent accumulators (dK and dV) beside any score tile did not.
//  - flash_bwd_dq_wgmma (K10a): one block per (128-row query tile, query
//    head), tri's head groups and heaviest-first order. Q and dO are
//    loaded once; K and V tiles of 128 keys stream through two rings of two
//    stages. A consumer takes each key tile in halves of 64 keys: S = Q
//    K^T and dP = dO V^T (SS m64n64k16, K-major), dS in place of S, then
//    dQ += dS K (RS m64n128k16, K read MN-major through the transpose bit,
//    as issue_pv reads V); 64 + 32 + 32 + 16 registers. On the diagonal
//    tile warpgroup 0 skips the second half, wholly after its rows. lse
//    and delta are two values a thread, read once.
//  - flash_bwd_dkv_wgmma (K10b): one block per (128-key tile, kv head), key
//    tile 0 (the most live query tiles) first, kv heads grouped for L2 as
//    K10a groups query heads. K and V are loaded once; Q and dO tiles of
//    64 rows stream through a ring of three stages, for each of the
//    group's query heads in turn (GQA is summed in the accumulator), from
//    the diagonal to the end, twice: a consumer first walks them for dV
//    (S^T = K Q^T, SS m64n64k16; P^T; dV += P^T dO, RS m64n128k16 with dO
//    MN-major), stores dV, then walks them again for dK (S^T and dP^T =
//    V dO^T; dS^T; dK += dS^T Q), one 64-register accumulator at a time.
//    The second walk recomputes S^T and its exp: 10 dh operations a live
//    pair instead of 8, the price of keeping ptxas's pipeline. lse and
//    delta are indexed by query (column) here: the producer warp loads
//    each step's 64 values of lse log2(e) and delta while the stage
//    drains, stores them beside it and arrives on the stage's barrier
//    beside TMA's bytes. A warpgroup skips a query tile wholly before its
//    keys.
//  - Epilogues: scale dQ, dV, scale dK in float32, stored 8 bytes a lane
//    for rows below sq.
// The products, the dS and P passes (their masks as [lo, hi] bounds a row),
// the producers, the block orders, the dQ step, the dK/dV walk (over a walk
// policy: which steps to skip and to mask) and the epilogue are inline
// helpers that band_bwd's kernels share.
namespace tri_bwd {

using tri::BOX;
using tri::D;
using tri::fence_regs;
using tri::Mma;
constexpr int THREADS = 384, CONSUMER_WARPS = 8;
constexpr int ROWS = 128;                   // a dQ block's queries, a dK/dV block's keys
constexpr int Q_STEP = 64;                  // a dK/dV step's queries
constexpr int TILE_BYTES = ROWS * D * 2;    // Q, dO, K or V of 128 rows: 32 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;  // one 64-dh box of 128 rows
constexpr int STEP_BYTES = Q_STEP * D * 2;  // Q or dO of 64 rows: 16 KB
constexpr int STEP_HALF = STEP_BYTES / 2;   // one 64-dh box of 64 rows
// 64 rows of a 128-row box: a consumer warpgroup's rows, or half a tile's keys
constexpr int WG_ROWS_BYTES = 64 * BOX * 2;
constexpr float LOG2E = 1.4426950408889634f;

// K10a: Q, dO, the K stages, the V stages (32 KB each, 1 KB aligned), then
// the mbarriers q_full, k_full[2], k_empty[2], v_full[2], v_empty[2]
constexpr int DQ_STAGES = 2;
constexpr int DQ_BAR_OFFSET = (2 + 2 * DQ_STAGES) * TILE_BYTES;
constexpr int DQ_SMEM_BYTES = 1024 + DQ_BAR_OFFSET + (1 + 4 * DQ_STAGES) * 8;
static_assert(DQ_SMEM_BYTES <= 232448, "a block's shared memory on an H100");

// K10b: K, V (32 KB each), the Q and dO stages (16 KB each), each stage's
// lse log2(e) and delta (64 floats each), then the mbarriers kv_full,
// full[3], empty[3]
constexpr int DKV_STAGES = 3;
constexpr int DKV_VEC_OFFSET = 2 * TILE_BYTES + DKV_STAGES * 2 * STEP_BYTES;
constexpr int DKV_BAR_OFFSET = DKV_VEC_OFFSET + DKV_STAGES * 2 * Q_STEP * 4;
constexpr int DKV_SMEM_BYTES = 1024 + DKV_BAR_OFFSET + (1 + 2 * DKV_STAGES) * 8;
static_assert(DKV_SMEM_BYTES <= 232448, "a block's shared memory on an H100");
// a stage turns when TMA's bytes have landed and each lane of the producer
// warp has stored its share of lse and delta
constexpr int DKV_FULL_ARRIVALS = 1 + 32;

struct DqArgs {
  CUtensorMap q, dout;  // [sq, h, dh], boxes of 128 rows
  CUtensorMap k, v;     // [sq, h_kv, dh], boxes of 128 rows
  const float* lse;     // [h, sq]
  const float* delta;   // [h, sq]
  float* dq;            // [sq, h, dh]
  int sq, h, group, q_tiles;
  int head_group;           // query heads a group of blocks walks together
  float scale, scale_log2;  // scale, scale * log2(e)
};

struct DkvArgs {
  CUtensorMap q, dout;  // [sq, h, dh], boxes of 64 rows
  CUtensorMap k, v;     // [sq, h_kv, dh], boxes of 128 rows
  const float* lse;     // [h, sq]
  const float* delta;   // [h, sq]
  float* dk;            // [sq, h_kv, dh]
  float* dv;
  int sq, h_kv, group, k_tiles, q_steps;
  int head_group;  // kv heads a group of blocks walks together
  float scale, scale_log2;
};

struct DqSmem {
  uint32_t base;  // shared-window address (1 KB aligned)
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t dout() const { return base + TILE_BYTES; }
  __device__ uint32_t k(int s) const { return base + (2 + s) * TILE_BYTES; }
  __device__ uint32_t v(int s) const { return base + (2 + DQ_STAGES + s) * TILE_BYTES; }
  __device__ uint32_t q_full() const { return base + DQ_BAR_OFFSET; }
  __device__ uint32_t k_full(int s) const { return q_full() + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const { return k_full(s) + 8 * DQ_STAGES; }
  __device__ uint32_t v_full(int s) const { return k_empty(s) + 8 * DQ_STAGES; }
  __device__ uint32_t v_empty(int s) const { return v_full(s) + 8 * DQ_STAGES; }
};

struct DkvSmem {
  uint32_t base;       // shared-window address (1 KB aligned)
  unsigned char* ptr;  // the same, as a generic pointer
  __device__ uint32_t k() const { return base; }
  __device__ uint32_t v() const { return base + TILE_BYTES; }
  __device__ uint32_t q(int s) const { return base + 2 * TILE_BYTES + s * 2 * STEP_BYTES; }
  __device__ uint32_t dout(int s) const { return q(s) + STEP_BYTES; }
  // stage s's lse log2(e) [64], then its delta [64]
  __device__ float* vec(int s) const {
    return reinterpret_cast<float*>(ptr + DKV_VEC_OFFSET) + s * 2 * Q_STEP;
  }
  __device__ uint32_t kv_full() const { return base + DKV_BAR_OFFSET; }
  __device__ uint32_t full(int s) const { return kv_full() + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return full(s) + 8 * DKV_STAGES; }
};

#define DDLB_BWD_8(C, i)                                                  \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]),  \
      C(d[i + 6]), C(d[i + 7])
// S [64 x 64] (=|+)= A [64 x 16] @ B [16 x 64], both from shared memory,
// K-major. The first k-step (scale-d 0) only writes d: with "=f" operands
// the compiler need not keep the last step's S and dP alive into this one,
// which leaves their registers to the packed A operand of the product in
// between (with "+f" ptxas serialised the pipeline).
#define DDLB_BWD_SS(TYPE, C, ACCUMULATE)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE   \
               " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
               "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
               "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"        \
               : DDLB_BWD_8(C, 0), DDLB_BWD_8(C, 8), DDLB_BWD_8(C, 16),     \
                 DDLB_BWD_8(C, 24)                                        \
               : "l"(da), "l"(db), "r"(ACCUMULATE))

template <typename T>
struct Ss;
template <>
struct Ss<__nv_bfloat16> {
  static __device__ __forceinline__ void first(float (&d)[32], uint64_t da, uint64_t db) {
    DDLB_BWD_SS("bf16", "=f", 0);
  }
  static __device__ __forceinline__ void next(float (&d)[32], uint64_t da, uint64_t db) {
    DDLB_BWD_SS("bf16", "+f", 1);
  }
};
template <>
struct Ss<__half> {
  static __device__ __forceinline__ void first(float (&d)[32], uint64_t da, uint64_t db) {
    DDLB_BWD_SS("f16", "=f", 0);
  }
  static __device__ __forceinline__ void next(float (&d)[32], uint64_t da, uint64_t db) {
    DDLB_BWD_SS("f16", "+f", 1);
  }
};
#undef DDLB_BWD_SS
#undef DDLB_BWD_8

// S = A B^T over the 128 dh of two K-major operands in shared memory: A's
// 64 rows at a, B's 64 rows at b, the second 64-dh box of each a_half and
// b_half bytes on; 8 k-steps of 32 bytes along the swizzled rows. The
// caller fences before and commits after.
template <typename T>
__device__ __forceinline__ void ss_dh(float (&d)[32], uint32_t a, uint32_t a_half, uint32_t b,
                                      uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int half = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = hopper::smem_desc(a + half * a_half + off, 16, 1024);
    const uint64_t db = hopper::smem_desc(b + half * b_half + off, 16, 1024);
    if (kk == 0)
      Ss<T>::first(d, da, db);
    else
      Ss<T>::next(d, da, db);
  }
}

// Hide a value's origin from the compiler: descriptors built from it are
// built in the loop where they are used, not hoisted out of it into 32
// registers that the accumulators need.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// d += A B over STEPS k-steps of 16 rows: A from registers (4 a step), B
// [rows, 128 dh] in shared memory at b, read MN-major, its two 64-dh boxes
// b_half bytes apart. The caller fences before and commits after.
template <typename T, int STEPS>
__device__ __forceinline__ void rs_rows(float (&d)[64], const uint32_t* a, uint32_t b,
                                        uint32_t b_half) {
#pragma unroll
  for (int kt = 0; kt < STEPS; ++kt)
    Mma<T>::rs(d, a + 4 * kt, hopper::smem_desc(b + kt * 16 * BOX * 2, b_half, 1024));
}

template <typename T, int N>
__device__ __forceinline__ void pack(uint32_t (&a)[N / 2], const float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = Half<T>::pack(s[2 * i], s[2 * i + 1]);
}

// The rows' (rw, rw + 8 of a block's 128, from row0) lse log2(e) and delta;
// 0 past sq, where Q and dO are zeros and so is dS.
__device__ __forceinline__ void row_terms(const float* lse, const float* delta, int sq,
                                          size_t head_row0, int row0, float (&lse2)[2],
                                          float (&dl)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row0 + 8 * r < sq;
    lse2[r] = in ? lse[head_row0 + 8 * r] * LOG2E : 0.0f;
    dl[r] = in ? delta[head_row0 + 8 * r] : 0.0f;
  }
}

// This thread's two rows (row, row + 8) of a 64 x 128 float32 accumulator
// times mul, stored 8 bytes a lane at out + row * stride, below sq.
__device__ __forceinline__ void store_rows(float* out, size_t stride, const float (&acc)[64],
                                           float mul, int row, int sq) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= sq) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(out + (row + 8 * r) * stride + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// dS = P (dP - delta) into s for this thread's rows (r = 0, 1: r0 and r0 + 8)
// and the keys 8 j + 2 t4 + (e & 1) of a 64-key step. MASKED zeroes p
// outside keys [lo[r], hi[r]] + 2 t4 of row r (the caller takes 2 t4 off,
// so each fragment compares its own column, a constant): by a select,
// whatever the exp gave (an empty row's lse is NEG_INF). Its own
// instantiation, so the other steps carry no mask arithmetic.
template <bool MASKED>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32],
                                        const float (&lse2)[2], const float (&dl)[2], float c,
                                        const int (&lo)[2], const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = 8 * j + (e & 1);
      float pe = tri::ex2(fmaf(s[4 * j + e], c, -lse2[r]));
      if (MASKED && (col < lo[r] || col > hi[r])) pe = 0.0f;
      s[4 * j + e] = pe * (dp[4 * j + e] - dl[r]);
    }
  }
}

// Thread 0 sets up a dQ block's mbarriers; every thread waits for it.
__device__ __forceinline__ void init_dq_barriers(const DqSmem& sm) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(sm.q_full(), 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(sm.k_full(s), 1);
      hopper::mbar_init(sm.v_full(s), 1);
      hopper::mbar_init(sm.k_empty(s), CONSUMER_WARPS);
      hopper::mbar_init(sm.v_empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The dQ producer (one thread): Q and dO of query rows q0 of head hh once,
// then K and V of kv head kvh from key tile last - 1 down, n_tiles of
// them, through the two rings.
__device__ __forceinline__ void load_dq(const DqSmem& sm, const CUtensorMap* q,
                                        const CUtensorMap* dout, const CUtensorMap* k,
                                        const CUtensorMap* v, int hh, int kvh, int q0, int last,
                                        int n_tiles) {
  hopper::mbar_expect_tx(sm.q_full(), 2 * TILE_BYTES);
  for (int half = 0; half < 2; ++half) {
    hopper::tma_load(sm.q() + half * HALF_BYTES, q, sm.q_full(), half * BOX, hh, q0);
    hopper::tma_load(sm.dout() + half * HALF_BYTES, dout, sm.q_full(), half * BOX, hh, q0);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % DQ_STAGES;
    const uint32_t phase = (i / DQ_STAGES) & 1;
    const int k0 = (last - 1 - i) * ROWS;
    hopper::mbar_wait(sm.k_empty(st), phase ^ 1u);
    hopper::mbar_expect_tx(sm.k_full(st), TILE_BYTES);
    for (int half = 0; half < 2; ++half)
      hopper::tma_load(sm.k(st) + half * HALF_BYTES, k, sm.k_full(st), half * BOX, kvh, k0);
    hopper::mbar_wait(sm.v_empty(st), phase ^ 1u);
    hopper::mbar_expect_tx(sm.v_full(st), TILE_BYTES);
    for (int half = 0; half < 2; ++half)
      hopper::tma_load(sm.v(st) + half * HALF_BYTES, v, sm.v_full(st), half * BOX, kvh, k0);
  }
}

// One 64-key step of a dQ consumer warpgroup, keys koff bytes into K and V
// stage st: S = Q K^T and dP = dO V^T (SS m64n64k16; dQ, S and dP of a
// whole 128-key tile, 192 registers, serialise ptxas's wgmma pipeline),
// then dS = P (dP - delta) into s, masked (bounds() gives each row's keys)
// or not, then dQ += dS K (RS m64n128k16, K read MN-major through the
// transpose bit, as issue_pv reads V). release_v arrives on the V stage's
// empty barrier as soon as dP has run.
template <typename T, typename Bounds>
__device__ __forceinline__ void dq_step(const DqSmem& sm, int st, uint32_t koff, uint32_t qa,
                                        uint32_t da, bool release_v, bool masked,
                                        const Bounds& bounds, const float (&lse2)[2],
                                        const float (&dl)[2], float c, float (&s)[32],
                                        float (&dp)[32], uint32_t (&pa)[16], float (&dq)[64]) {
  hopper::wgmma_fence();
  ss_dh<T>(s, opaque(qa), HALF_BYTES, sm.k(st) + koff, HALF_BYTES);
  ss_dh<T>(dp, opaque(da), HALF_BYTES, sm.v(st) + koff, HALF_BYTES);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  if (release_v) hopper::mbar_arrive(sm.v_empty(st));
  int lo[2] = {0, 0}, hi[2] = {0, 0};
  if (masked) {
    bounds(lo, hi);
    ds_rows<true>(s, dp, lse2, dl, c, lo, hi);
  } else {
    ds_rows<false>(s, dp, lse2, dl, c, lo, hi);
  }
  pack<T, 32>(pa, s);
  hopper::wgmma_fence();
  rs_rows<T, 4>(dq, pa, sm.k(st) + koff, HALF_BYTES);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(dq);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_wgmma(const __grid_constant__ DqArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const DqSmem sm{(raw + 1023u) & ~1023u};
  // tri's order: heads in groups whose K and V fit in L2 together, the
  // heaviest query tiles first inside a group
  int qt, hh, kvh;
  tri::block_tile(p.head_group, p.q_tiles, p.h, p.group, qt, hh, kvh);
  const int q0 = qt * ROWS, n_tiles = qt + 1;

  init_dq_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    // key tiles from the diagonal (qt) down to 0
    if (threadIdx.x == 0) load_dq(sm, &p.q, &p.dout, &p.k, &p.v, hh, kvh, q0, n_tiles, n_tiles);
  } else {
    hopper::consumer_registers();
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool arrives = lane == 0;
    // this thread's rows within the tile: r0 and r0 + 8
    const int r0 = 64 * c + 16 * warp + lane / 4;
    float lse2[2], dl[2];
    row_terms(p.lse, p.delta, p.sq, static_cast<size_t>(hh) * p.sq + q0 + r0, q0 + r0, lse2, dl);
    float dq[64], s[32], dp[32];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.0f;
    const uint32_t qa = sm.q() + c * WG_ROWS_BYTES, da = sm.dout() + c * WG_ROWS_BYTES;
    hopper::mbar_wait(sm.q_full(), 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % DQ_STAGES;
      const uint32_t ph = (i / DQ_STAGES) & 1;
      hopper::mbar_wait(sm.k_full(st), ph);
      hopper::mbar_wait(sm.v_full(st), ph);
      // the tile's keys in steps of 64; on the diagonal tile (i = 0) the
      // second step lies after every row of warpgroup 0, which skips it,
      // and the keys after the query are masked (their p is exactly 0)
      const bool diag = i == 0;
      const int halves = diag && c == 0 ? 1 : 2;
      for (int h2 = 0; h2 < halves; ++h2) {
        const auto bounds = [&](int (&lo)[2], int (&hi)[2]) {
          const int t2 = 2 * (lane % 4);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            lo[r] = -t2;
            hi[r] = r0 + 8 * r - 64 * h2 - t2;
          }
        };
        dq_step<T>(sm, st, h2 * WG_ROWS_BYTES, qa, da, arrives && h2 == halves - 1, diag, bounds,
                   lse2, dl, p.scale_log2, s, dp, pa, dq);
      }
      if (arrives) hopper::mbar_arrive(sm.k_empty(st));
    }

    store_rows(p.dq + static_cast<size_t>(hh) * D, static_cast<size_t>(p.h) * D, dq, p.scale,
               q0 + r0, p.sq);
  }
}

// P^T, or (DK) dS^T = P^T (dP^T - delta), into s for this thread's keys (r
// = 0, 1: its two rows of the warpgroup's 64) and the queries 8 j + 2 t4 +
// (e & 1) of a step, from the stage's lse log2(e) and delta at vec. MASKED
// zeroes p outside queries [lo[r], hi[r]] + 2 t4 of key r (2 t4 taken off by
// the caller), by a select; its own instantiation, so the other steps carry
// no mask arithmetic.
template <bool DK, bool MASKED>
__device__ __forceinline__ void p_cols(float (&s)[32], const float (&dp)[32], const float* vec,
                                       float c, const int (&lo)[2], const int (&hi)[2]) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 l2 = *reinterpret_cast<const float2*>(vec + col);
    const float2 dl = DK ? *reinterpret_cast<const float2*>(vec + Q_STEP + col) : l2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = tri::ex2(fmaf(s[4 * j + e], c, -((e & 1) ? l2.y : l2.x)));
      if (MASKED) {
        const int x = 8 * j + (e & 1), r = e >> 1;
        if (x < lo[r] || x > hi[r]) pe = 0.0f;
      }
      s[4 * j + e] = DK ? pe * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) : pe;
    }
  }
}

// One walk of a consumer warpgroup over its block's query steps (ring
// positions it0 ...; step i is query step first + i % per_head of the
// group's query head i / per_head): dV += P^T dO, or (DK) dK += dS^T Q,
// into acc. The walk policy w says which steps the warpgroup's keys skip
// (no live pair), which it masks, and each key's live queries there.
template <typename T, bool DK, typename Walk>
__device__ __forceinline__ void dkv_walk(const Walk& w, const DkvSmem& sm, int it0, int steps,
                                         int per_head, int first, uint32_t ka, uint32_t va,
                                         float c, float (&acc)[64]) {
  const bool arrives = threadIdx.x % 32 == 0;
  float s[32], dp[32];
  uint32_t pa[16];
  for (int i = 0; i < steps; ++i) {
    const int it = it0 + i;
    const int st = it % DKV_STAGES;
    const uint32_t ph = (it / DKV_STAGES) & 1;
    const int q0 = (first + i % per_head) * Q_STEP;
    hopper::mbar_wait(sm.full(st), ph);
    if (w.skip(q0)) {
      if (arrives) hopper::mbar_arrive(sm.empty(st));
      continue;
    }
    hopper::wgmma_fence();
    ss_dh<T>(s, opaque(ka), HALF_BYTES, sm.q(st), STEP_HALF);
    if (DK) ss_dh<T>(dp, opaque(va), HALF_BYTES, sm.dout(st), STEP_HALF);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(s);
    if (DK) fence_regs(dp);
    int lo[2] = {0, 0}, hi[2] = {0, 0};
    if (w.masked(q0)) {
      w.bounds(q0, lo, hi);
      p_cols<DK, true>(s, dp, sm.vec(st), c, lo, hi);
    } else {
      p_cols<DK, false>(s, dp, sm.vec(st), c, lo, hi);
    }
    pack<T, 32>(pa, s);
    // dV += P^T dO, or dK += dS^T Q: dO and Q read MN-major
    hopper::wgmma_fence();
    rs_rows<T, Q_STEP / 16>(acc, pa, DK ? sm.q(st) : sm.dout(st), STEP_HALF);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    if (arrives) hopper::mbar_arrive(sm.empty(st));
  }
}

// The triangle's walk for a consumer warpgroup whose keys start at kb: a
// query step wholly before its keys is skipped; the steps that reach its
// first 64 queries (the diagonal) or pass sq are masked (queries before
// the key or past sq).
struct TriWalk {
  int kb, sq;
  __device__ bool skip(int q0) const { return q0 + Q_STEP <= kb; }
  __device__ bool masked(int q0) const { return q0 < kb + 64 || q0 + Q_STEP > sq; }
  __device__ void bounds(int q0, int (&lo)[2], int (&hi)[2]) const {
    const int t2 = 2 * (threadIdx.x % 4);
    const int kpos = kb + 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo[r] = kpos + 8 * r - q0 - t2;
      hi[r] = sq - 1 - q0 - t2;
    }
  }
};

// Thread 0 sets up a dK/dV block's mbarriers; every thread waits for it.
__device__ __forceinline__ void init_dkv_barriers(const DkvSmem& sm) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(sm.kv_full(), 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(sm.full(s), DKV_FULL_ARRIVALS);
      hopper::mbar_init(sm.empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A dK/dV block's key tile and kv head: kv heads in groups of head_group,
// whose Q and dO fit in L2 together; inside a group key tile 0 (under a
// causal band, the most live query steps) first, head by head.
__device__ __forceinline__ void key_tile_order(int head_group, int k_tiles, int h_kv, int& kt,
                                               int& kvh) {
  const int first = static_cast<int>(blockIdx.x) / (head_group * k_tiles) * head_group;
  const int heads = min(head_group, h_kv - first);
  const int local = static_cast<int>(blockIdx.x) - first * k_tiles;
  kt = local / heads;
  kvh = first + local % heads;
}

// The dK/dV producer warp (all 32 lanes): lane 0 loads K and V of keys k0
// of kv head kvh once, then the query steps [first, first + per_head) of
// each of the group's query heads in turn, twice (dV's walk, then dK's),
// through the ring of DKV_STAGES; every lane loads its share of a step's
// lse log2(e) and delta while the stage drains, stores it beside the stage
// and arrives on its full barrier beside TMA's bytes.
__device__ __forceinline__ void load_dkv(const DkvSmem& sm, const CUtensorMap* q,
                                         const CUtensorMap* dout, const CUtensorMap* k,
                                         const CUtensorMap* v, const float* lse,
                                         const float* delta, int sq, int group, int kvh, int k0,
                                         int first, int per_head) {
  const int lane = threadIdx.x % 32, steps = group * per_head;
  if (lane == 0) {
    hopper::mbar_expect_tx(sm.kv_full(), 2 * TILE_BYTES);
    for (int half = 0; half < 2; ++half) {
      hopper::tma_load(sm.k() + half * HALF_BYTES, k, sm.kv_full(), half * BOX, kvh, k0);
      hopper::tma_load(sm.v() + half * HALF_BYTES, v, sm.kv_full(), half * BOX, kvh, k0);
    }
  }
  for (int it = 0; it < 2 * steps; ++it) {
    const int st = it % DKV_STAGES;
    const uint32_t phase = (it / DKV_STAGES) & 1;
    const int i = it % steps;
    const int hh = kvh * group + i / per_head;
    const int q0 = (first + i % per_head) * Q_STEP;
    float lse2[2], dl[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = lane + 32 * u;
      const bool in = q0 + r < sq;
      const size_t idx = static_cast<size_t>(hh) * sq + q0 + r;
      lse2[u] = in ? lse[idx] * LOG2E : 0.0f;
      dl[u] = in ? delta[idx] : 0.0f;
    }
    hopper::mbar_wait(sm.empty(st), phase ^ 1u);
    if (lane == 0) {
      hopper::mbar_expect_tx(sm.full(st), 2 * STEP_BYTES);
      for (int half = 0; half < 2; ++half) {
        hopper::tma_load(sm.q(st) + half * STEP_HALF, q, sm.full(st), half * BOX, hh, q0);
        hopper::tma_load(sm.dout(st) + half * STEP_HALF, dout, sm.full(st), half * BOX, hh, q0);
      }
    }
    float* vec = sm.vec(st);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      vec[lane + 32 * u] = lse2[u];
      vec[Q_STEP + lane + 32 * u] = dl[u];
    }
    hopper::mbar_arrive(sm.full(st));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ DkvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const DkvSmem sm{aligned, smem_raw + (aligned - raw)};
  int kt, kvh;
  key_tile_order(p.head_group, p.k_tiles, p.h_kv, kt, kvh);
  const int k0 = kt * ROWS;
  // the live query steps of each query head: from the diagonal (k0) to the end
  const int first = 2 * kt, per_head = p.q_steps - first, steps = p.group * per_head;

  init_dkv_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    if (threadIdx.x < 32)
      load_dkv(sm, &p.q, &p.dout, &p.k, &p.v, p.lse, p.delta, p.sq, p.group, kvh, k0, first,
               per_head);
  } else {
    hopper::consumer_registers();
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    // this warpgroup's keys start at kb; this thread's are kb + kr, + 8
    const int kb = k0 + 64 * c, kr = 16 * warp + lane / 4;
    const size_t stride = static_cast<size_t>(p.h_kv) * D;
    const TriWalk w{kb, p.sq};
    float acc[64];
    const uint32_t ka = sm.k() + c * WG_ROWS_BYTES, va = sm.v() + c * WG_ROWS_BYTES;
    hopper::mbar_wait(sm.kv_full(), 0);

    // two walks of the same query steps: dV, then dK
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    dkv_walk<T, false>(w, sm, 0, steps, per_head, first, ka, va, p.scale_log2, acc);
    store_rows(p.dv + static_cast<size_t>(kvh) * D, stride, acc, 1.0f, kb + kr, p.sq);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    dkv_walk<T, true>(w, sm, steps, steps, per_head, first, ka, va, p.scale_log2, acc);
    store_rows(p.dk + static_cast<size_t>(kvh) * D, stride, acc, p.scale, kb + kr, p.sq);
  }
}

// Check the operands and encode the four maps (Q and dO [sq, h, 128] in
// boxes of q_rows rows, K and V [skv, h_kv, 128] of ROWS); 0 or a cudaError.
int encode_maps(int dtype, const void* q, const void* k, const void* v, const void* dout,
                const void* out0, const void* out1, int sq, int skv, int h, int h_kv, int dh,
                int q_rows, CUtensorMap* mq, CUtensorMap* mdo, CUtensorMap* mk,
                CUtensorMap* mv) {
  if (sq < 1 || skv < 1 || h < 1 || h_kv < 1 || h % h_kv || dh != tri::D ||
      (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(out0) | reinterpret_cast<uintptr_t>(out1);
  if (bases % 16) return static_cast<int>(cudaErrorInvalidValue);
  int rc = tri::encode_heads(mq, dtype, q, sq, h, q_rows);
  if (rc == 0) rc = tri::encode_heads(mdo, dtype, dout, sq, h, q_rows);
  if (rc == 0) rc = tri::encode_heads(mk, dtype, k, skv, h_kv, ROWS);
  if (rc == 0) rc = tri::encode_heads(mv, dtype, v, skv, h_kv, ROWS);
  return rc;
}

}  // namespace tri_bwd

// ---------------------------------------------------------------------------
// K10c / K10d on Hopper: the rectangle's backward over a runtime band
// ---------------------------------------------------------------------------
//
// The rectangle (runtime row and column offsets, a sliding window, the
// masked modes and the unmasked past and none, GQA, ragged sq and skv),
// bf16/fp16, head_dim 128. Two kernels, flash_bwd_dq_wgmma (K10c) and
// flash_bwd_dkv_wgmma (K10d), each with its own argument struct; they take
// tri_bwd's shape as band takes tri's: the 384-thread block, the TMA
// producer, the two wgmma consumer warpgroups, the 3-D {dh, heads, s}
// maps with GQA by the kv-head coordinate, the base-2 p = ex2(s c - lse
// log2(e)), one persistent 64-register accumulator, and tri_bwd's products,
// dS and P passes, producers, block orders and epilogue as shared inline
// helpers. The arithmetic is _dq_tile_update / _dkv_tile_update's (:568,
// :593) and deterministic: two accumulation directions, no atomics.
//  - Bound: 6 dh (dQ) and 8 dh (dK/dV) operations a live pair and query
//    head against q, k, v, dO, lse and delta read once and the float32
//    gradients written once. At the windowed training row (4096², 64
//    heads, window 1024) 0.182 and 0.243 ms of bf16 tensor-core work; at
//    a past ring chunk (2048², 32 heads) 0.104 and 0.139. The tensor cores
//    bound both; the dK/dV pass's two walks do 10 dh a pair.
//  - The band: query row i sits at q_base + i, key j at k_base + j; a row
//    keeps the keys at or before it (causal) and after its position less
//    the window. From one function (key_range, query_range) the producer
//    and the consumers compute the same, possibly empty, range of tiles.
//    q_base - k_base need not be a multiple of 128, so the causal edge can
//    straddle two tiles and the window edge two more.
//  - dQ: a block per (128-row query tile, query head), tri's head groups
//    and heaviest-first order; the producer streams the 128-key tiles of
//    the block's band, from the last down. A consumer warpgroup runs each
//    64-key half that one of its 64 rows reaches (tri_bwd's diagonal skip,
//    generalised) and masks only a half that holds a dead pair or keys past
//    skv; the mask comes from one base a thread, q_base + row - k_base less
//    the half's first key: each row keeps keys [lo, hi].
//  - dK/dV: a block per (128-key tile, kv head), key tile 0 first (under a
//    causal band it reaches the most queries; under past, none or a window
//    the order costs nothing); for each of the group's query heads the
//    producer streams the 64-row query steps of the block's band, twice (dV,
//    then dK). A warpgroup skips a step none of its keys reaches and masks
//    only one that holds a dead pair or rows past sq.
//  - Empty bands (a window wholly behind the keys, keys wholly after the
//    queries): the producer issues and waits on nothing, the consumers wait
//    on nothing and store zeros. A row whose lse is NEG_INF has no live
//    key, so every step that holds it is masked, and its p is 0 by a
//    select, not by inf * 0. Rows past sq (dQ) or skv (dK/dV) are not
//    stored.
//  - Registers: tri_bwd's consumers plus the band's base, the tile bounds
//    and, in the masked pass only, the lo and hi of two rows; ptxas gives a
//    384-thread kernel 168 registers a thread and serialises every wgmma
//    past that (C7512): chip_smoke.py reports each instantiation's
//    registers, spills and that warning.
namespace band_bwd {

using tri::D;
using tri_bwd::CONSUMER_WARPS;
using tri_bwd::DkvSmem;
using tri_bwd::DqSmem;
using tri_bwd::Q_STEP;
using tri_bwd::ROWS;
using tri_bwd::THREADS;
using tri_bwd::WG_ROWS_BYTES;

// The band of a rectangle: query row i at q_base + i (i < sq), key j at
// k_base + j (j < skv); causal keeps the keys at or before the query,
// window (causal only) the last `window` of them.
struct Band {
  int sq, skv;
  int q_base, k_base;
  int causal, window;
};

struct DqArgs {
  CUtensorMap q, dout;  // [sq, h, dh], boxes of 128 rows
  CUtensorMap k, v;     // [skv, h_kv, dh], boxes of 128 rows
  const float* lse;     // [h, sq]
  const float* delta;   // [h, sq]
  float* dq;            // [sq, h, dh]
  Band b;
  int h, group, q_tiles;
  int head_group;           // query heads a group of blocks walks together
  float scale, scale_log2;  // scale, scale * log2(e)
};

struct DkvArgs {
  CUtensorMap q, dout;  // [sq, h, dh], boxes of 64 rows
  CUtensorMap k, v;     // [skv, h_kv, dh], boxes of 128 rows
  const float* lse;     // [h, sq]
  const float* delta;   // [h, sq]
  float* dk;            // [skv, h_kv, dh]
  float* dv;
  Band b;
  int h_kv, group, k_tiles;
  int head_group;  // kv heads a group of blocks walks together
  float scale, scale_log2;
};

// The live keys [lo, hi) of query rows [qa, qb) (qb <= sq): the first
// row's window edge to the last row's causal edge; [0, 0) if none, so an
// empty range meets no step.
__device__ __forceinline__ void key_range(const Band& b, int qa, int qb, int& lo, int& hi) {
  lo = b.window ? max(0, b.q_base + qa - b.window + 1 - b.k_base) : 0;
  hi = b.causal ? min(b.skv, b.q_base + qb - b.k_base) : b.skv;
  if (qb <= qa || hi <= lo) lo = hi = 0;
}

// The live queries [lo, hi) of keys [ka, kb) (kb <= skv), [0, 0) if none:
// a key at position y is live for the queries y <= x < y + window.
__device__ __forceinline__ void query_range(const Band& b, int ka, int kb, int& lo, int& hi) {
  lo = b.causal ? max(0, b.k_base + ka - b.q_base) : 0;
  hi = b.window ? min(b.sq, b.k_base + kb - 1 + b.window - b.q_base) : b.sq;
  if (kb <= ka || hi <= lo) lo = hi = 0;
}

// The steps of N [first, last) that meet [lo, hi) (none if it is empty).
template <int N>
__device__ __forceinline__ void steps_of(int lo, int hi, int& first, int& last) {
  first = lo / N;
  last = hi > lo ? (hi + N - 1) / N : first;
}

// Does the tile of query rows [qa, qb) x keys [ka, kb) (within sq and skv)
// hold a dead pair? The first row against the last key (causal), the last
// row against the first key (window).
__device__ __forceinline__ bool has_dead(const Band& b, int qa, int qb, int ka, int kb) {
  return (b.causal && b.k_base + kb - 1 > b.q_base + qa) ||
         (b.window && b.k_base + ka <= b.q_base + qb - 1 - b.window);
}

// The 128-key tiles [first, last) of the query tile at q0: what the dQ
// producer loads and its consumers walk.
__device__ __forceinline__ void dq_tiles(const Band& b, int q0, int& first, int& last) {
  int lo, hi;
  key_range(b, q0, min(q0 + ROWS, b.sq), lo, hi);
  steps_of<ROWS>(lo, hi, first, last);
}

// The 64-row query steps [first, last) of the key tile at k0: what the
// dK/dV producer loads (for each query head of the group) and its
// consumers walk.
__device__ __forceinline__ void dkv_steps(const Band& b, int k0, int& first, int& last) {
  int lo, hi;
  query_range(b, k0, min(k0 + ROWS, b.skv), lo, hi);
  steps_of<Q_STEP>(lo, hi, first, last);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_wgmma(const __grid_constant__ DqArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const DqSmem sm{(raw + 1023u) & ~1023u};
  int qt, hh, kvh;
  tri::block_tile(p.head_group, p.q_tiles, p.h, p.group, qt, hh, kvh);
  const int q0 = qt * ROWS;
  int first, last;
  dq_tiles(p.b, q0, first, last);
  const int n_tiles = last - first;

  tri_bwd::init_dq_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    if (threadIdx.x == 0 && n_tiles > 0)
      tri_bwd::load_dq(sm, &p.q, &p.dout, &p.k, &p.v, hh, kvh, q0, last, n_tiles);
  } else {
    hopper::consumer_registers();
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool arrives = lane == 0;
    // this thread's rows within the tile: r0 and r0 + 8; its warpgroup's
    // rows start at ra
    const int r0 = 64 * c + 16 * warp + lane / 4, ra = q0 + 64 * c;
    float lse2[2], dl[2];
    tri_bwd::row_terms(p.lse, p.delta, p.b.sq, static_cast<size_t>(hh) * p.b.sq + q0 + r0,
                       q0 + r0, lse2, dl);
    float dq[64], s[32], dp[32];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.0f;
    // the 64-key steps [wf, wl) that this warpgroup's rows reach
    int wf, wl;
    {
      int lo, hi;
      key_range(p.b, ra, min(ra + 64, p.b.sq), lo, hi);
      steps_of<64>(lo, hi, wf, wl);
    }
    const uint32_t qa = sm.q() + c * WG_ROWS_BYTES, da = sm.dout() + c * WG_ROWS_BYTES;
    if (n_tiles > 0) hopper::mbar_wait(sm.q_full(), 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % tri_bwd::DQ_STAGES;
      const uint32_t ph = (i / tri_bwd::DQ_STAGES) & 1;
      const int kt = last - 1 - i;
      hopper::mbar_wait(sm.k_full(st), ph);
      hopper::mbar_wait(sm.v_full(st), ph);
      // the tile's 64-key steps that some row of this warpgroup reaches
      const int h_lo = max(wf - 2 * kt, 0), h_hi = min(wl - 2 * kt, 2);
      for (int h2 = h_lo; h2 < h_hi; ++h2) {
        const int ka = kt * ROWS + 64 * h2;
        const bool masked =
            ka + 64 > p.b.skv || has_dead(p.b, ra, min(ra + 64, p.b.sq), ka, ka + 64);
        // row r0 + 8 r sits d + 8 r keys after key ka: it keeps keys
        // [d + 8 r - window + 1, d + 8 r] below skv
        const auto bounds = [&](int (&lo)[2], int (&hi)[2]) {
          const int t2 = 2 * (lane % 4), d = p.b.q_base + q0 + r0 - p.b.k_base - ka;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int top = p.b.skv - ka - 1;
            hi[r] = (p.b.causal ? min(d + 8 * r, top) : top) - t2;
            lo[r] = (p.b.window ? d + 8 * r - p.b.window + 1 : 0) - t2;
          }
        };
        tri_bwd::dq_step<T>(sm, st, h2 * WG_ROWS_BYTES, qa, da, arrives && h2 == h_hi - 1, masked,
                            bounds, lse2, dl, p.scale_log2, s, dp, pa, dq);
      }
      if (arrives) {
        if (h_hi <= h_lo) hopper::mbar_arrive(sm.v_empty(st));
        hopper::mbar_arrive(sm.k_empty(st));
      }
    }

    tri_bwd::store_rows(p.dq + static_cast<size_t>(hh) * D, static_cast<size_t>(p.h) * D, dq,
                        p.scale, q0 + r0, p.b.sq);
  }
}

// The band's walk for a dK/dV consumer warpgroup whose keys are [kb, ke):
// a query step that none of its keys reaches is skipped; one that holds a
// dead pair or rows past sq is masked, each key keeping the queries of
// its own band.
struct KeyWalk {
  const Band& b;
  int kb, ke, q_lo, q_hi;  // keys [kb, ke) reach queries [q_lo, q_hi)
  __device__ KeyWalk(const Band& band, int k) : b(band), kb(k), ke(min(k + 64, band.skv)) {
    query_range(b, kb, ke, q_lo, q_hi);
  }
  __device__ bool skip(int q0) const { return q0 + Q_STEP <= q_lo || q0 >= q_hi; }
  __device__ bool masked(int q0) const {
    return q0 + Q_STEP > b.sq || has_dead(b, q0, q0 + Q_STEP, kb, ke);
  }
  // key kpos + 8 r sits d + 8 r queries after query q0: it keeps queries
  // [d + 8 r, d + 8 r + window - 1] below sq
  __device__ void bounds(int q0, int (&lo)[2], int (&hi)[2]) const {
    const int t2 = 2 * (threadIdx.x % 4);
    const int kpos = kb + 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4;
    const int d = b.k_base + kpos - b.q_base - q0, top = b.sq - 1 - q0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo[r] = (b.causal ? d + 8 * r : 0) - t2;
      hi[r] = (b.window ? min(d + 8 * r + b.window - 1, top) : top) - t2;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ DkvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const DkvSmem sm{aligned, smem_raw + (aligned - raw)};
  int kt, kvh;
  tri_bwd::key_tile_order(p.head_group, p.k_tiles, p.h_kv, kt, kvh);
  const int k0 = kt * ROWS;
  int first, last;
  dkv_steps(p.b, k0, first, last);
  const int per_head = last - first, steps = p.group * per_head;

  tri_bwd::init_dkv_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    if (threadIdx.x < 32 && steps > 0)
      tri_bwd::load_dkv(sm, &p.q, &p.dout, &p.k, &p.v, p.lse, p.delta, p.b.sq, p.group, kvh, k0,
                        first, per_head);
  } else {
    hopper::consumer_registers();
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    // this warpgroup's keys start at kb; this thread's are kb + kr, + 8
    const int kb = k0 + 64 * c, kr = 16 * warp + lane / 4;
    const size_t stride = static_cast<size_t>(p.h_kv) * D;
    const KeyWalk w(p.b, kb);
    float acc[64];
    const uint32_t ka = sm.k() + c * WG_ROWS_BYTES, va = sm.v() + c * WG_ROWS_BYTES;
    if (steps > 0) hopper::mbar_wait(sm.kv_full(), 0);

    // two walks of the same query steps: dV, then dK (none: zeros)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    tri_bwd::dkv_walk<T, false>(w, sm, 0, steps, per_head, first, ka, va, p.scale_log2, acc);
    tri_bwd::store_rows(p.dv + static_cast<size_t>(kvh) * D, stride, acc, 1.0f, kb + kr, p.b.skv);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    tri_bwd::dkv_walk<T, true>(w, sm, steps, steps, per_head, first, ka, va, p.scale_log2, acc);
    tri_bwd::store_rows(p.dk + static_cast<size_t>(kvh) * D, stride, acc, p.scale, kb + kr,
                        p.b.skv);
  }
}

// The fields both passes share: the checks, the four tensor maps (Q and dO
// in boxes of q_rows rows), lse and delta, the band, the scale; 0 or a
// cudaError.
template <typename A>
int prepare(A* a, int dtype, const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, const void* out0, const void* out1, int sq,
            int skv, int h, int h_kv, int dh, float scale, int row_offset, int col_offset,
            int masked, int window, int q_rows) {
  if (window < 0 || (window && !masked)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = tri_bwd::encode_maps(dtype, q, k, v, dout, out0, out1, sq, skv, h, h_kv, dh,
                                      q_rows, &a->q, &a->dout, &a->k, &a->v);
  if (rc != 0) return rc;
  a->lse = static_cast<const float*>(lse);
  a->delta = static_cast<const float*>(delta);
  a->b = Band{sq, skv, row_offset, col_offset, masked ? 1 : 0, window};
  a->group = h / h_kv;
  a->scale = scale;
  a->scale_log2 = scale * tri_bwd::LOG2E;
  return 0;
}

}  // namespace band_bwd

// ---------------------------------------------------------------------------
// K8b and K9 on Hopper: the band with TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------
//
// The rectangle (K8b: a runtime row offset, a sliding window, causal or
// not, GQA, ragged sq and skv) and the carried chunk fold (K9: offset,
// diagonal and past, the same band with the (acc, m, l) carry read before
// the first product and written back unnormalised, in place), bf16/fp16,
// head_dim 128. One kernel, flash_fwd_wgmma<T, CARRY>, with its own
// argument struct; the shape is tri's, and so are its products, its
// shared-memory layout, its tensor maps, its block order, its producer,
// its softmax and its epilogue (namespace tri's helpers, forced inline).
// It takes tri's case too (a causal band at offset 0), but 3-4% slower than
// tri there on an H100 (scripts/time_flash_triangle.py): K8a stays on tri.
//  - Bound: 4 h dh (live pairs) operations against q, k, v read once and o
//    written once (or the float32 carry read and written once). At the
//    attention path's diagonal chunk (16384², 8 heads) that is 0.556 ms of
//    bf16 tensor-core work beside 0.04 ms of the carry's 128 MB; at K8b's
//    row (4096 rows at offset 12288 of 16384 keys, window 4096, GQA 8/2)
//    0.069 ms. The tensor cores bound both.
//  - The band: a block of 384 threads per (128-row query tile, query
//    head), tri's head groups and heaviest-first order (the last query
//    tiles reach the most keys under a causal band; under a window every
//    tile does about the same work and the order costs nothing). From
//    q_base, k_base, causal and window a block computes the 128-key tiles
//    its rows reach (tile_range at 128/128); the producer walks only
//    those, from the last down. q_base - k_base need not be a multiple of
//    128, so the causal edge can straddle two key tiles and the window
//    edge two more: only tiles that tile_needs_mask flags (a band edge or
//    the ragged end of skv) run the mask, a pass of its own before the
//    softmax; the others carry no mask arithmetic. The mask of a fragment
//    comes from one per-thread base, q_base + row - k_base, less the
//    tile's first key: each row keeps keys [lo, hi], two integers a row.
//  - Masked scores are -inf, not NEG_INF: p = ex2(-inf) is exactly 0 and a
//    masked score never raises the running max, so a row with nothing live
//    keeps l == 0 and its m unchanged. The running max starts finite
//    (NEG_INF, or the carry's), so exp2 never sees inf - inf.
//  - Empty bands (a window behind the chunk, rows past the band, skv = 0):
//    the producer issues and waits on nothing; without CARRY the consumers
//    write o = 0 and lse = NEG_INF, with CARRY they leave the carry as it
//    was.
//  - Carry units. tri keeps m as the max of the raw scores and p =
//    ex2(s c - m c), c = scale log2(e). The carry holds the JAX package's
//    units: m the max of scale s (natural log), l = sum exp(scale s - m),
//    acc = sum p v. So l and acc need no conversion, and m is divided by
//    scale on load (scale > 0, checked at the entry point). On store a row
//    whose running max did not rise above the loaded one writes the
//    carry's own m back bit for bit; one whose max rose writes m scale.
//    Rows past sq are neither loaded nor stored.
//  - Registers: tri's consumer (o[64], s[64], pa[32]) plus a base, the
//    tile bounds and, in the masked pass only, lo and hi of two rows; the
//    carry's m is read again from global memory at the store rather than
//    kept. ptxas gives a 384-thread kernel 168 registers a thread and
//    serialises every wgmma past that (C7512): chip_smoke.py reports each
//    instantiation's registers, spills and that warning.
namespace band {

using tri::BKV;
using tri::BQ;
using tri::D;
using tri::SMEM_BYTES;
using tri::Smem;
using tri::STAGES;
using tri::THREADS;

struct Args {
  CUtensorMap q;  // [sq, h, dh]
  CUtensorMap k;  // [skv, h_kv, dh]
  CUtensorMap v;
  void* o;        // [sq, h, dh], forward only
  float* lse;     // [h, sq], forward only
  float* acc;     // [h, sq, dh], carry only, updated in place
  float* m;       // [h, sq]
  float* l;       // [h, sq]
  int sq, skv, h, group, q_tiles;
  int head_group;      // query heads a group of blocks walks together
  int q_base, k_base;  // global positions of query row 0 and key 0
  int causal, window;
  float scale, scale_log2;  // scale, scale * log2(e)
};

// Key tiles [first, last) that the live band of query rows [q0, q0 + BQ)
// reaches (tile_range at 128 / 128).
__device__ __forceinline__ void key_tiles(const Args& p, int q0, int& first, int& last) {
  const int qhi = min(q0 + BQ, p.sq);
  int lo = 0, hi = p.skv;
  if (p.causal) hi = min(hi, p.q_base + qhi - p.k_base);
  if (p.window) lo = max(lo, p.q_base + q0 - p.window + 1 - p.k_base);
  first = lo / BKV;
  last = hi > lo ? (hi + BKV - 1) / BKV : first;
}

// Does key tile k0 hold a masked entry for some row of [q0, q0 + BQ)?
// (tile_needs_mask at 128 / 128)
__device__ __forceinline__ bool needs_mask(const Args& p, int q0, int k0) {
  const int qhi = min(q0 + BQ, p.sq);
  if (k0 + BKV > p.skv) return true;  // ragged end of the keys
  if (p.causal && p.k_base + k0 + BKV - 1 > p.q_base + q0) return true;
  if (p.window && p.k_base + k0 <= p.q_base + qhi - 1 - p.window) return true;
  return false;
}

// -inf on the scores outside this thread's rows' live keys: row r (r0, r0
// + 8) sits dk + 8 r keys after the tile's first key (dk = q_base + q0 +
// r0 - k_base - k0) and keeps keys [lo, hi] of the tile.
__device__ __forceinline__ void mask_band(const Args& p, float (&s)[64], int dk, int k0) {
  const int t2 = 2 * (threadIdx.x % 4);
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int d = dk + 8 * r;
    hi[r] = (p.causal ? min(d, p.skv - k0 - 1) : p.skv - k0 - 1) - t2;
    lo[r] = (p.window ? d - p.window + 1 : 0) - t2;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + (e & 1), r = e >> 1;
      if (col < lo[r] || col > hi[r]) s[4 * j + e] = __uint_as_float(0xff800000u);  // -inf
    }
}

// This thread's rows (r = 0, 1: row + 8 r, [h, sq] index idx + 8 r) of the
// carry into the O accumulator, m in raw-score units, and l (on one thread
// of the quad; the quad's partial sums meet at the store).
__device__ __forceinline__ void load_carry(const Args& p, size_t idx, int row, float (&o)[64],
                                           float (&m)[2], float (&l)[2]) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < p.sq;
    const size_t i = idx + 8 * r;
    m[r] = in ? p.m[i] / p.scale : NEG_INF;
    l[r] = in && t4 == 0 ? p.l[i] : 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 a = in ? *reinterpret_cast<const float2*>(p.acc + i * D + 8 * j + 2 * t4)
                          : make_float2(0.0f, 0.0f);
      o[4 * j + 2 * r] = a.x;
      o[4 * j + 2 * r + 1] = a.y;
    }
  }
}

// The carry back in place, unnormalised: acc, l, and m in natural-log
// units (the loaded m bit for bit where the row's max did not rise).
__device__ __forceinline__ void store_carry(const Args& p, size_t idx, int row,
                                            const float (&o)[64], const float (&m)[2],
                                            float (&l)[2]) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= p.sq) continue;
    const size_t i = idx + 8 * r;
    if (t4 == 0) {
      const float m_in = p.m[i];
      p.m[i] = m[r] > m_in / p.scale ? m[r] * p.scale : m_in;
      p.l[i] = l[r];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(p.acc + i * D + 8 * j + 2 * t4) =
          make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

template <typename T, bool CARRY>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma(const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const Smem sm{aligned, smem_raw + (aligned - raw)};
  int qt, hh, kvh;
  tri::block_tile(p.head_group, p.q_tiles, p.h, p.group, qt, hh, kvh);
  const int q0 = qt * BQ;
  int first, last;
  key_tiles(p, q0, first, last);
  const int n_tiles = last - first;

  tri::init_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    if (threadIdx.x == 0 && n_tiles > 0)
      tri::load_tiles(sm, &p.q, &p.k, &p.v, hh, kvh, q0, last, n_tiles);
  } else {
    hopper::consumer_registers();
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool arrives = lane == 0;
    // this thread's rows within the tile: r0 and r0 + 8
    const int r0 = 64 * c + 16 * warp + lane / 4;
    const size_t idx = static_cast<size_t>(hh) * p.sq + q0 + r0;  // [h, sq] index of r0
    float o[64], s[64];
    uint32_t pa[32];
    float m[2], l[2], alpha[2], sum[2];
    if (CARRY) {
      if (n_tiles == 0) return;  // the carry stays as it was
      load_carry(p, idx, q0 + r0, o, m, l);
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.0f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.0f;
    }
    if (n_tiles > 0) hopper::mbar_wait(sm.q_full(), 0);
    // the keys of row r0 sit dk0 - k0 keys before it in key tile k0
    const int dk0 = p.q_base + q0 + r0 - p.k_base;
    // the two consumer warpgroups drift apart, so one's softmax runs under
    // the other's products
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = (last - 1 - i) * BKV;
      hopper::mbar_wait(sm.k_full(st), ph);
      tri::issue_qk<T>(sm, s, st, c);
      hopper::wgmma_wait<0>();
      tri::fence_regs(s);
      if (arrives) hopper::mbar_arrive(sm.k_empty(st));
      if (needs_mask(p, q0, k0)) mask_band(p, s, dk0 - k0, k0);
      // masked scores are already -inf: no diagonal
      tri::softmax_tile(s, m, alpha, sum, p.scale_log2, false, r0);
      tri::rescale(o, l, alpha, sum);
      tri::pack_p<T>(pa, s);
      hopper::mbar_wait(sm.v_full(st), ph);
      tri::issue_pv<T>(sm, o, pa, st);
      hopper::wgmma_wait<0>();
      tri::fence_regs(o);
      if (arrives) hopper::mbar_arrive(sm.v_empty(st));
    }

    if (CARRY)
      store_carry(p, idx, q0 + r0, o, m, l);
    else
      tri::store_output<T>(sm, o, m, l, static_cast<T*>(p.o), p.lse, p.sq, p.h, hh, q0, c,
                           p.scale);
  }
}

// The shared fields of a launch: checks, tensor maps, the grid's order.
// With skv = 0 no key is read, and k, v's maps are q's (a tensor map
// needs at least one row).
int prepare(Args* a, int dtype, const void* q, const void* k, const void* v, const void* out,
            int sq, int skv, int h, int h_kv, int dh, float scale, int window) {
  if (sq < 1 || skv < 0 || h < 1 || h_kv < 1 || h % h_kv || dh != D || window < 0 ||
      !(scale > 0.0f) || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (bases % 16) return static_cast<int>(cudaErrorInvalidValue);
  int rc = tri::encode_heads(&a->q, dtype, q, sq, h);
  if (rc == 0) rc = tri::encode_heads(&a->k, dtype, skv ? k : q, skv ? skv : sq, skv ? h_kv : h);
  if (rc == 0) rc = tri::encode_heads(&a->v, dtype, skv ? v : q, skv ? skv : sq, skv ? h_kv : h);
  if (rc != 0) return rc;
  a->o = nullptr;
  a->lse = a->acc = a->m = a->l = nullptr;
  a->sq = sq;
  a->skv = skv;
  a->h = h;
  a->group = h / h_kv;
  a->q_tiles = (sq + BQ - 1) / BQ;
  // a query head reads at most 2 * skv * 128 * 2 bytes of K and V, shared by its group
  a->head_group = tri::head_group(512ll * skv / a->group, h);
  a->q_base = a->k_base = a->causal = 0;
  a->window = window;
  a->scale = scale;
  a->scale_log2 = scale * 1.4426950408889634f;
  return 0;
}

template <bool CARRY>
cudaError_t launch(int dtype, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = a.q_tiles * a.h;
  return dtype == 1
             ? launch_with(flash_fwd_wgmma<__half, CARRY>, blocks, THREADS, SMEM_BYTES, s, a)
             : launch_with(flash_fwd_wgmma<__nv_bfloat16, CARRY>, blocks, THREADS, SMEM_BYTES,
                           s, a);
}

}  // namespace band

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  constexpr int smem = f32_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_f32<D><<<dim3((p.sq + FBQ - 1) / FBQ, p.h), F_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// the forward and the chunk fold in float32 (dtype 0); dh: 128
cudaError_t launch(int dtype, int dh, const Params& p, void* stream) {
  if (p.sq < 1 || p.skv < 0 || p.h < 1 || p.h_kv < 1 || p.h % p.h_kv ||
      dh != 128 || dtype != 0)
    return cudaErrorInvalidValue;
  return launch_f32<128>(p, static_cast<cudaStream_t>(stream));
}

// the backward in float32 (dtype 0; bf16/fp16 take ddlb_flash_bwd_*_tri and
// ddlb_flash_bwd_*_band): dkv = 0 launches the dQ pass, 1 the dK/dV pass
cudaError_t launch_bwd(int dtype, int dh, int dkv, const Params& p,
                       const Grads& gr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.sq < 1 || p.skv < 1 || p.h < 1 || p.h_kv < 1 || p.h % p.h_kv ||
      dh != 128 || (p.window && !p.causal) || dtype != 0)
    return cudaErrorInvalidValue;
  constexpr int D = 128;
  const int rows = dkv ? p.skv : p.sq;
  const dim3 grid((rows + FB_ROWS - 1) / FB_ROWS, dkv ? p.h_kv : p.h);
  return dkv ? launch_with(flash_bwd_dkv_f32<D>, grid, FB_THREADS,
                           f32_bwd_smem_bytes<D>(), s, p, gr)
             : launch_with(flash_bwd_dq_f32<D>, grid, FB_THREADS,
                           f32_bwd_smem_bytes<D>(), s, p, gr);
}

Params make_params(const void* q, const void* k, const void* v, int sq,
                   int skv, int h, int h_kv, float scale, int window) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.h_kv = h_kv;
  p.group = h_kv > 0 ? h / h_kv : 1;
  p.scale = scale;
  p.window = window;
  return p;
}

}  // namespace

extern "C" {

// K8a / K8b in float32 (dtype 0; bf16/fp16 take ddlb_flash_forward_tri and
// ddlb_flash_forward_band): o [sq, h, dh], lse [h, sq] f32. Query row i
// sits at global position row_offset + i, key j at j.
int ddlb_flash_forward(int dtype, const void* q, const void* k, const void* v,
                       void* o, void* lse, int sq, int skv, int h, int h_kv,
                       int dh, float scale, int row_offset, int causal,
                       int window, void* stream) {
  Params p = make_params(q, k, v, sq, skv, h, h_kv, scale, window);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_base = row_offset;
  p.causal = causal;
  if (window && !causal) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(dtype, dh, p, stream));
}

// K9 in float32 (dtype 0; bf16/fp16 take ddlb_flash_chunk_band): folds the
// chunk into acc [h, sq, dh], m, l [h, sq] (f32) in place. mode: 0 =
// offset, 1 = diagonal, 2 = past (no window).
int ddlb_flash_chunk(int dtype, const void* q, const void* k, const void* v,
                     void* acc, void* m, void* l, int sq, int skv, int h,
                     int h_kv, int dh, float scale, int row_offset,
                     int col_offset, int mode, int window, void* stream) {
  Params p = make_params(q, k, v, sq, skv, h, h_kv, scale, window);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.carry = 1;
  if (mode == 0) {
    p.q_base = row_offset;
    p.k_base = col_offset;
    p.causal = 1;
  } else if (mode == 1) {
    p.causal = 1;
  } else if (mode != 2 || window) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch(dtype, dh, p, stream));
}

// K10a-K10d in float32 (dtype 0; bf16/fp16 take ddlb_flash_bwd_*_tri and
// ddlb_flash_bwd_*_band). q, dout [sq, h, dh] and k, v [skv, h_kv, dh] in
// the operand dtype; lse, delta [h, sq] f32. Query row i sits at global position
// row_offset + i, key j at col_offset + j; masked = 1 applies the causal
// mask (and the window) from those positions, masked = 0 takes every key
// (the past and none modes). ddlb_flash_bwd_dq writes dq [sq, h, dh] f32,
// ddlb_flash_bwd_dkv dk, dv [skv, h_kv, dh] f32, summed over each kv
// head's group of query heads.
int ddlb_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int sq, int skv, int h, int h_kv, int dh,
                      float scale, int row_offset, int col_offset, int masked,
                      int window, void* stream) {
  Params p = make_params(q, k, v, sq, skv, h, h_kv, scale, window);
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.q_base = row_offset;
  p.k_base = col_offset;
  p.causal = masked;
  Grads gr = {};
  gr.dout = dout;
  gr.delta = static_cast<const float*>(delta);
  gr.dq = static_cast<float*>(dq);
  return static_cast<int>(launch_bwd(dtype, dh, 0, p, gr, stream));
}

int ddlb_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int sq, int skv, int h, int h_kv,
                       int dh, float scale, int row_offset, int col_offset,
                       int masked, int window, void* stream) {
  Params p = make_params(q, k, v, sq, skv, h, h_kv, scale, window);
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.q_base = row_offset;
  p.k_base = col_offset;
  p.causal = masked;
  Grads gr = {};
  gr.dout = dout;
  gr.delta = static_cast<const float*>(delta);
  gr.dk = static_cast<float*>(dk);
  gr.dv = static_cast<float*>(dv);
  return static_cast<int>(launch_bwd(dtype, dh, 1, p, gr, stream));
}

// K8a on Hopper (namespace tri): the causal triangle at offset 0, sq == skv,
// dtype 1 = float16 or 2 = bfloat16, dh 128. o [sq, h, dh], lse [h, sq]
// f32. Every operand 16-byte aligned (TMA's rule; the wrapper checks).
int ddlb_flash_forward_tri(int dtype, const void* q, const void* k, const void* v,
                           void* o, void* lse, int sq, int h, int h_kv, int dh,
                           float scale, void* stream) {
  if (sq < 1 || h < 1 || h_kv < 1 || h % h_kv || dh != tri::D || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bases % 16) return static_cast<int>(cudaErrorInvalidValue);
  tri::Args a;
  int rc = tri::encode_heads(&a.q, dtype, q, sq, h);
  if (rc == 0) rc = tri::encode_heads(&a.k, dtype, k, sq, h_kv);
  if (rc == 0) rc = tri::encode_heads(&a.v, dtype, v, sq, h_kv);
  if (rc != 0) return rc;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.sq = sq;
  a.h = h;
  a.group = h / h_kv;
  a.q_tiles = (sq + tri::BQ - 1) / tri::BQ;
  // a query head reads 2 * sq * 128 * 2 bytes of K and V, shared by its group
  a.head_group = tri::head_group(512ll * sq / a.group, h);
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? tri::launch<__half>(a, s)
                                     : tri::launch<__nv_bfloat16>(a, s));
}

// K8b on Hopper (namespace band): ddlb_flash_forward's arguments and
// results, dtype 1 = float16 or 2 = bfloat16, dh 128, scale > 0; q, k, v and
// o 16-byte aligned (TMA's rule; the wrapper checks).
int ddlb_flash_forward_band(int dtype, const void* q, const void* k, const void* v, void* o,
                            void* lse, int sq, int skv, int h, int h_kv, int dh, float scale,
                            int row_offset, int causal, int window, void* stream) {
  if (window && !causal) return static_cast<int>(cudaErrorInvalidValue);
  band::Args a;
  const int rc = band::prepare(&a, dtype, q, k, v, o, sq, skv, h, h_kv, dh, scale, window);
  if (rc != 0) return rc;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.q_base = row_offset;
  a.causal = causal ? 1 : 0;
  return static_cast<int>(band::launch<false>(dtype, a, stream));
}

// K9 on Hopper (namespace band): ddlb_flash_chunk's arguments and results
// (the carry acc [h, sq, dh], m, l [h, sq] f32 folded in place), dtype 1 =
// float16 or 2 = bfloat16, dh 128, scale > 0; q, k, v and acc 16-byte
// aligned. mode: 0 = offset, 1 = diagonal, 2 = past (no window).
int ddlb_flash_chunk_band(int dtype, const void* q, const void* k, const void* v, void* acc,
                          void* m, void* l, int sq, int skv, int h, int h_kv, int dh,
                          float scale, int row_offset, int col_offset, int mode, int window,
                          void* stream) {
  if (mode < 0 || mode > 2 || (mode == 2 && window))
    return static_cast<int>(cudaErrorInvalidValue);
  band::Args a;
  const int rc = band::prepare(&a, dtype, q, k, v, acc, sq, skv, h, h_kv, dh, scale, window);
  if (rc != 0) return rc;
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  if (mode == 0) {  // global offsets
    a.q_base = row_offset;
    a.k_base = col_offset;
  }
  a.causal = mode != 2;  // diagonal: relative positions, offsets 0
  return static_cast<int>(band::launch<true>(dtype, a, stream));
}

// K10a / K10b on Hopper (namespace tri_bwd): the causal triangle at offset
// 0, sq == skv, dtype 1 = float16 or 2 = bfloat16, dh 128. q, dout [sq, h,
// dh] and k, v [sq, h_kv, dh] in the operand dtype, each 16-byte aligned
// (TMA's rule; the wrapper checks); lse, delta [h, sq] f32.
// ddlb_flash_bwd_dq_tri writes dq [sq, h, dh] f32, ddlb_flash_bwd_dkv_tri
// dk, dv [sq, h_kv, dh] f32, summed over each kv head's group.
int ddlb_flash_bwd_dq_tri(int dtype, const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta, void* dq,
                          int sq, int h, int h_kv, int dh, float scale, void* stream) {
  tri_bwd::DqArgs a;
  const int rc = tri_bwd::encode_maps(dtype, q, k, v, dout, dq, dq, sq, sq, h, h_kv, dh,
                                      tri_bwd::ROWS, &a.q, &a.dout, &a.k, &a.v);
  if (rc != 0) return rc;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.sq = sq;
  a.h = h;
  a.group = h / h_kv;
  a.q_tiles = (sq + tri_bwd::ROWS - 1) / tri_bwd::ROWS;
  // a query head reads 2 * sq * 128 * 2 bytes of K and V, shared by its group
  a.head_group = tri::head_group(512ll * sq / a.group, h);
  a.scale = scale;
  a.scale_log2 = scale * tri_bwd::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = a.q_tiles * h;
  return static_cast<int>(
      dtype == 1 ? launch_with(tri_bwd::flash_bwd_dq_wgmma<__half>, blocks, tri_bwd::THREADS,
                               tri_bwd::DQ_SMEM_BYTES, s, a)
                 : launch_with(tri_bwd::flash_bwd_dq_wgmma<__nv_bfloat16>, blocks,
                               tri_bwd::THREADS, tri_bwd::DQ_SMEM_BYTES, s, a));
}

int ddlb_flash_bwd_dkv_tri(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dk,
                           void* dv, int sq, int h, int h_kv, int dh, float scale,
                           void* stream) {
  tri_bwd::DkvArgs a;
  const int rc = tri_bwd::encode_maps(dtype, q, k, v, dout, dk, dv, sq, sq, h, h_kv, dh,
                                      tri_bwd::Q_STEP, &a.q, &a.dout, &a.k, &a.v);
  if (rc != 0) return rc;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.sq = sq;
  a.h_kv = h_kv;
  a.group = h / h_kv;
  a.k_tiles = (sq + tri_bwd::ROWS - 1) / tri_bwd::ROWS;
  a.q_steps = (sq + tri_bwd::Q_STEP - 1) / tri_bwd::Q_STEP;
  // a kv head's blocks read Q and dO of its group: 2 * sq * 128 * 2 bytes a query head
  a.head_group = tri::head_group(512ll * sq * a.group, h_kv);
  a.scale = scale;
  a.scale_log2 = scale * tri_bwd::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = a.k_tiles * h_kv;
  return static_cast<int>(
      dtype == 1 ? launch_with(tri_bwd::flash_bwd_dkv_wgmma<__half>, blocks, tri_bwd::THREADS,
                               tri_bwd::DKV_SMEM_BYTES, s, a)
                 : launch_with(tri_bwd::flash_bwd_dkv_wgmma<__nv_bfloat16>, blocks,
                               tri_bwd::THREADS, tri_bwd::DKV_SMEM_BYTES, s, a));
}

// K10c / K10d on Hopper (namespace band_bwd): ddlb_flash_bwd_dq's and
// ddlb_flash_bwd_dkv's arguments and results (offsets, masked, window),
// dtype 1 = float16 or 2 = bfloat16, dh 128, sq and skv >= 1; q, k, v, dout
// and the outputs 16-byte aligned (TMA's rule; the wrapper checks).
int ddlb_flash_bwd_dq_band(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq, int sq,
                           int skv, int h, int h_kv, int dh, float scale, int row_offset,
                           int col_offset, int masked, int window, void* stream) {
  band_bwd::DqArgs a;
  const int rc = band_bwd::prepare(&a, dtype, q, k, v, dout, lse, delta, dq, dq, sq, skv, h, h_kv,
                                   dh, scale, row_offset, col_offset, masked, window,
                                   tri_bwd::ROWS);
  if (rc != 0) return rc;
  a.dq = static_cast<float*>(dq);
  a.h = h;
  a.q_tiles = (sq + tri_bwd::ROWS - 1) / tri_bwd::ROWS;
  // a query head reads at most 2 * skv * 128 * 2 bytes of K and V, shared by its group
  a.head_group = tri::head_group(512ll * skv / a.group, h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = a.q_tiles * h;
  return static_cast<int>(
      dtype == 1 ? launch_with(band_bwd::flash_bwd_dq_wgmma<__half>, blocks, tri_bwd::THREADS,
                               tri_bwd::DQ_SMEM_BYTES, s, a)
                 : launch_with(band_bwd::flash_bwd_dq_wgmma<__nv_bfloat16>, blocks,
                               tri_bwd::THREADS, tri_bwd::DQ_SMEM_BYTES, s, a));
}

int ddlb_flash_bwd_dkv_band(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int sq, int skv, int h, int h_kv, int dh, float scale,
                            int row_offset, int col_offset, int masked, int window,
                            void* stream) {
  band_bwd::DkvArgs a;
  const int rc = band_bwd::prepare(&a, dtype, q, k, v, dout, lse, delta, dk, dv, sq, skv, h, h_kv,
                                   dh, scale, row_offset, col_offset, masked, window,
                                   tri_bwd::Q_STEP);
  if (rc != 0) return rc;
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.h_kv = h_kv;
  a.k_tiles = (skv + tri_bwd::ROWS - 1) / tri_bwd::ROWS;
  // a kv head's blocks read Q and dO of its group: 2 * sq * 128 * 2 bytes a query head
  a.head_group = tri::head_group(512ll * sq * a.group, h_kv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = a.k_tiles * h_kv;
  return static_cast<int>(
      dtype == 1 ? launch_with(band_bwd::flash_bwd_dkv_wgmma<__half>, blocks, tri_bwd::THREADS,
                               tri_bwd::DKV_SMEM_BYTES, s, a)
                 : launch_with(band_bwd::flash_bwd_dkv_wgmma<__nv_bfloat16>, blocks,
                               tri_bwd::THREADS, tri_bwd::DKV_SMEM_BYTES, s, a));
}

const char* ddlb_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
