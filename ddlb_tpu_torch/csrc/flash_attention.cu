// K8a / K8b / K9: flash attention forward and the carried-chunk fold.
//
// Replaces, in ddlb_tpu/ops/flash_attention.py:
//  - ddlb_flash_forward: _flash_forward (:433) with both of its Pallas
//    kernels, the triangular-grid _flash_kernel_tri (:373, K8a: causal,
//    offset 0, sq == skv) and the rectangular _flash_kernel (:96, K8b:
//    runtime row_offset, sliding window, causal=False, GQA). Writes o in the
//    operand dtype and lse = m + log(l) in f32 (NEG_INF for empty rows).
//  - ddlb_flash_chunk: flash_attention_chunk (:211) with _flash_chunk_kernel
//    (:146, K9): the same walk, but the (acc, m, l) carry is read at the
//    start and written back at the end, in place, instead of being created
//    and normalised. causal = offset (global offsets), diagonal (relative
//    mask) or past (no mask).
//
// What bounds it on an H100: at the shipped shape (sq = skv = 16384, 8 heads
// of 128, bf16, causal) the live work is 4 * h * dh * m(m+1)/2 = 5.5e11 FLOP
// against 128 MiB of q, k, v and o: about 4,100 FLOP per byte, far above
// the card's ~295 FLOP/byte balance point. So the bf16 tensor cores bound
// it (989 TFLOP/s dense: 0.556 ms), not memory (0.040 ms at 3.35 TB/s), and
// the exp of every live score is the next cost after the products.
//
// What the design does about it (simple and right first; wgmma, TMA and
// warp specialisation are later work):
//  - One block per (query tile, head); blocks run in no order on 132 SMs, so
//    the TPU's sequential kv grid axis becomes a loop inside the block. The
//    loop walks only the key tiles that the tile's live band reaches (from
//    row_offset, col_offset, causal and window): the causal triangle costs
//    half the square, which is what the TPU's prefetched triangular grid
//    maps buy (K8a). Only tiles that straddle a band edge or the ragged end
//    of the keys apply the mask. The heaviest query tiles (the last, under
//    a causal mask) are scheduled first.
//  - bf16/fp16: 64-row query tiles, four warps of 16 rows each, 64-key
//    tiles. QK^T and PV run on mma.sync m16n8k16 with f32 accumulators. Q
//    stays in registers as A fragments for the whole walk; K and V tiles
//    are staged through shared memory by cp.async, two stages deep, so the
//    next tile's copy overlaps this tile's products. The softmax state
//    (m, l and the O accumulator) lives in registers; P goes from the S
//    accumulator registers straight into the A fragments of the PV product
//    (rounded to the operand type there, as any tensor-core flash kernel
//    does; l sums the unrounded f32 p), never through shared memory.
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
// past and none modes and GQA. Two entry points, ddlb_flash_bwd_dq and
// ddlb_flash_bwd_dkv; as in the forward, the triangle and the rectangle are
// the same walk with other band parameters, and the wrapper counts the four
// cases apart. Each tile recomputes S = scale q k^T and P = exp(S - lse)
// (masked), then dP = dO v^T and dS = P (dP - delta), with delta =
// rowsum(dO o) computed by the wrapper:
//  - ddlb_flash_bwd_dq: one block per (query tile, head) walks the key tiles
//    of its live band and accumulates dQ = scale dS K in registers;
//  - ddlb_flash_bwd_dkv: one block per (key tile, kv head) walks, for each
//    of the group's G query heads in turn, the query tiles of its live band
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
// 1 ms), not memory (0.2 ms). Like the forward, this first version is
// simple: mma.sync m16n8k16 with f32 sums, cp.async double buffering, no
// wgmma or TMA.
//  - bf16/fp16 dQ: 64-row query tiles, four warps of 16 rows; Q and dO stay
//    in registers as A fragments; K and V tiles are staged through shared
//    memory, two stages deep. dS goes from the C registers of dP straight
//    into the A fragments of the dS K product, rounded to the operand type
//    there (P and dS themselves are computed in f32).
//  - bf16/fp16 dK/dV: 64-key tiles, four warps of 16 keys; the block's K and
//    V tiles sit in shared memory for the whole walk and feed S^T = K Q^T
//    and dP^T = V dO^T as A fragments; Q, dO, lse and delta of each query
//    tile are staged two deep. P^T and dS^T become the A fragments of the
//    P^T dO and dS^T Q products, rounded to the operand type there.
//  - float32: SIMT kernels in true f32, two threads per row (a query row
//    for dQ, a key row for dK/dV), each owning half of the head dim.

// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing. head_dim is 128, the only one a shipped
// configuration uses.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// (224 -> 200 for flash_mma on sm_90a) and slows them by about 40%.
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
// bf16 / fp16 on the tensor cores (mma.sync m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = 32 * WARPS, STAGES = 2;

template <typename T>
struct Half;
template <>
struct Half<__nv_bfloat16> {
  // lo in the low 16 bits: the element of the smaller column index
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};
template <>
struct Half<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr int mma_smem_bytes() {
  return STAGES * 2 * BKV * (D + 8) * 2;  // K and V, rows padded by 16 bytes
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) flash_mma(Params p) {
  constexpr int LDS = D + 8;  // shared row in elements (16 bytes of padding)
  constexpr int KSTEPS = D / 16, NT_S = BKV / 8, NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // STAGES x [BKV][LDS]
  T* Vs = Ks + STAGES * BKV * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int qhi = min(q0 + BQ, p.sq);
  const int hh = blockIdx.y, kvh = hh / p.group;
  const size_t q_stride = static_cast<size_t>(p.h) * D;
  const size_t kv_stride = static_cast<size_t>(p.h_kv) * D;
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(hh) * D;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(kvh) * D;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(kvh) * D;

  // this thread's two query rows (local), and their A fragments of Q
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool in0 = r0 < p.sq, in1 = r1 < p.sq;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = in0 ? ld32(Q + r0 * q_stride + c) : 0u;
    qf[kk][1] = in1 ? ld32(Q + r1 * q_stride + c) : 0u;
    qf[kk][2] = in0 ? ld32(Q + r0 * q_stride + c + 8) : 0u;
    qf[kk][3] = in1 ? ld32(Q + r1 * q_stride + c + 8) : 0u;
  }

  // the softmax state: O accumulator (C fragments), running max and sum
  float o[NT_O][4];
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  const size_t row0 = static_cast<size_t>(hh) * p.sq + r0;  // [h, sq] index
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  if (p.carry) {
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      const int c = j * 8 + t4 * 2;
      if (in0) {
        const float2 a = *reinterpret_cast<const float2*>(p.acc + row0 * D + c);
        o[j][0] = a.x;
        o[j][1] = a.y;
      }
      if (in1) {
        const float2 a = *reinterpret_cast<const float2*>(p.acc + row1 * D + c);
        o[j][2] = a.x;
        o[j][3] = a.y;
      }
    }
    if (in0) m_r[0] = p.m[row0], l_r[0] = p.l[row0];
    if (in1) m_r[1] = p.m[row1], l_r[1] = p.l[row1];
  }

  auto load_tile = [&](int stage, int tile) {
    T* ks = Ks + stage * BKV * LDS;
    T* vs = Vs + stage * BKV * LDS;
    const int k0 = tile * BKV;
    for (int i = tid; i < BKV * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (k0 + r < p.skv) {
        const size_t off = static_cast<size_t>(k0 + r) * kv_stride + c;
        cp_async16(ks + r * LDS + c, K + off);
        cp_async16(vs + r * LDS + c, V + off);
      } else {  // past the ragged end: zeros (and the mask drops them)
        *reinterpret_cast<uint4*>(ks + r * LDS + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + r * LDS + c) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  int first, last;
  tile_range<BKV>(p, q0, qhi, first, last);
  if (first < last) load_tile(0, first);
  cp_async_commit();
  const int qpos0 = p.q_base + r0, qpos1 = p.q_base + r1;

  for (int t = first; t < last; ++t) {
    const int stage = (t - first) & 1;
    if (t + 1 < last) {
      load_tile(stage ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const T* ks = Ks + stage * BKV * LDS;
    const uint16_t* vs =
        reinterpret_cast<const uint16_t*>(Vs + stage * BKV * LDS);
    const int k0 = t * BKV;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const T* kp = ks + (j * 8 + g) * LDS + kk * 16 + t4 * 2;
        const uint32_t b[2] = {ld32(kp), ld32(kp + 8)};
        Half<T>::mma(s[j], qf[kk], b);
      }
    }

    // scale, mask the straddling tiles, online softmax
    const bool need_mask = tile_needs_mask<BKV>(p, q0, qhi, k0);
    float mx0 = m_r[0], mx1 = m_r[1];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
      if (need_mask) {
        const int c = k0 + j * 8 + t4 * 2;
        if (!live(p, qpos0, c)) s[j][0] = NEG_INF;
        if (!live(p, qpos0, c + 1)) s[j][1] = NEG_INF;
        if (!live(p, qpos1, c)) s[j][2] = NEG_INF;
        if (!live(p, qpos1, c + 1)) s[j][3] = NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = expf(m_r[0] - mx0), alpha1 = expf(m_r[1] - mx1);
    m_r[0] = mx0;
    m_r[1] = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked entry holds exactly NEG_INF (no live score can): zero
        // its p, so a row with nothing live keeps l == 0
        const float pe = (need_mask && s[j][e] == NEG_INF)
                             ? 0.0f
                             : expf(s[j][e] - (e < 2 ? mx0 : mx1));
        s[j][e] = pe;
      }
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l_r[0] = l_r[0] * alpha0 + quad_sum(sum0);
    l_r[1] = l_r[1] * alpha1 + quad_sum(sum1);
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }

    // O += P V: the C fragments of S (two n-tiles) are the A fragment of P
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      const uint32_t a[4] = {
          Half<T>::pack(s[2 * kt][0], s[2 * kt][1]),
          Half<T>::pack(s[2 * kt][2], s[2 * kt][3]),
          Half<T>::pack(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          Half<T>::pack(s[2 * kt + 1][2], s[2 * kt + 1][3]),
      };
      const uint16_t* vrow = vs + (kt * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const uint16_t* vp = vrow + j * 8;
        const uint32_t b[2] = {
            static_cast<uint32_t>(vp[0]) |
                (static_cast<uint32_t>(vp[LDS]) << 16),
            static_cast<uint32_t>(vp[8 * LDS]) |
                (static_cast<uint32_t>(vp[9 * LDS]) << 16),
        };
        Half<T>::mma(o[j], a, b);
      }
    }
    __syncthreads();  // the stage is free for the copy two tiles ahead
  }

  if (p.carry) {
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      const int c = j * 8 + t4 * 2;
      if (in0)
        *reinterpret_cast<float2*>(p.acc + row0 * D + c) =
            make_float2(o[j][0], o[j][1]);
      if (in1)
        *reinterpret_cast<float2*>(p.acc + row1 * D + c) =
            make_float2(o[j][2], o[j][3]);
    }
    if (t4 == 0) {
      if (in0) p.m[row0] = m_r[0], p.l[row0] = l_r[0];
      if (in1) p.m[row1] = m_r[1], p.l[row1] = l_r[1];
    }
    return;
  }
  const float d0 = l_r[0] == 0.0f ? 1.0f : l_r[0];
  const float d1 = l_r[1] == 0.0f ? 1.0f : l_r[1];
  T* O = static_cast<T*>(p.o) + static_cast<size_t>(hh) * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + t4 * 2;
    if (in0)
      *reinterpret_cast<uint32_t*>(O + r0 * q_stride + c) =
          Half<T>::pack(o[j][0] / d0, o[j][1] / d0);
    if (in1)
      *reinterpret_cast<uint32_t*>(O + r1 * q_stride + c) =
          Half<T>::pack(o[j][2] / d1, o[j][3] / d1);
  }
  if (t4 == 0) {
    if (in0) p.lse[row0] = l_r[0] == 0.0f ? NEG_INF : m_r[0] + logf(l_r[0]);
    if (in1) p.lse[row1] = l_r[1] == 0.0f ? NEG_INF : m_r[1] + logf(l_r[1]);
  }
}

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

template <int D>
constexpr int dkv_smem_bytes() {
  // this block's K and V, then two stages of Q, dO, lse and delta
  return 2 * BKV * (D + 8) * 2 + STAGES * (2 * BQ * (D + 8) * 2 + 2 * BQ * 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_mma(Params p,
                                                               Grads gr) {
  constexpr int LDS = D + 8;
  constexpr int KSTEPS = D / 16, NT_S = BKV / 8, NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // STAGES x [BKV][LDS]
  T* Vs = Ks + STAGES * BKV * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int qhi = min(q0 + BQ, p.sq);
  const int hh = blockIdx.y, kvh = hh / p.group;
  const size_t q_stride = static_cast<size_t>(p.h) * D;
  const size_t kv_stride = static_cast<size_t>(p.h_kv) * D;
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(hh) * D;
  const T* DO = static_cast<const T*>(gr.dout) + static_cast<size_t>(hh) * D;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(kvh) * D;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(kvh) * D;

  // this thread's two query rows and their A fragments of Q and dO
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool in0 = r0 < p.sq, in1 = r1 < p.sq;
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = in0 ? ld32(Q + r0 * q_stride + c) : 0u;
    qf[kk][1] = in1 ? ld32(Q + r1 * q_stride + c) : 0u;
    qf[kk][2] = in0 ? ld32(Q + r0 * q_stride + c + 8) : 0u;
    qf[kk][3] = in1 ? ld32(Q + r1 * q_stride + c + 8) : 0u;
    df[kk][0] = in0 ? ld32(DO + r0 * q_stride + c) : 0u;
    df[kk][1] = in1 ? ld32(DO + r1 * q_stride + c) : 0u;
    df[kk][2] = in0 ? ld32(DO + r0 * q_stride + c + 8) : 0u;
    df[kk][3] = in1 ? ld32(DO + r1 * q_stride + c + 8) : 0u;
  }
  const size_t row0 = static_cast<size_t>(hh) * p.sq + r0;  // [h, sq] index
  const size_t row1 = row0 + 8;
  const float lse0 = in0 ? p.lse[row0] : 0.0f, lse1 = in1 ? p.lse[row1] : 0.0f;
  const float dl0 = in0 ? gr.delta[row0] : 0.0f;
  const float dl1 = in1 ? gr.delta[row1] : 0.0f;

  float dq[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;

  auto load_tile = [&](int stage, int tile) {
    T* ks = Ks + stage * BKV * LDS;
    T* vs = Vs + stage * BKV * LDS;
    const int k0 = tile * BKV;
    for (int i = tid; i < BKV * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (k0 + r < p.skv) {
        const size_t off = static_cast<size_t>(k0 + r) * kv_stride + c;
        cp_async16(ks + r * LDS + c, K + off);
        cp_async16(vs + r * LDS + c, V + off);
      } else {
        *reinterpret_cast<uint4*>(ks + r * LDS + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + r * LDS + c) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  int first, last;
  tile_range<BKV>(p, q0, qhi, first, last);
  if (first < last) load_tile(0, first);
  cp_async_commit();

  for (int t = first; t < last; ++t) {
    const int stage = (t - first) & 1;
    if (t + 1 < last) {
      load_tile(stage ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const T* ks = Ks + stage * BKV * LDS;
    const T* vs = Vs + stage * BKV * LDS;
    const int k0 = t * BKV;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const int off = (j * 8 + g) * LDS + kk * 16 + t4 * 2;
        const uint32_t bk[2] = {ld32(ks + off), ld32(ks + off + 8)};
        const uint32_t bv[2] = {ld32(vs + off), ld32(vs + off + 8)};
        Half<T>::mma(s[j], qf[kk], bk);
        Half<T>::mma(dp[j], df[kk], bv);
      }
    }

    // P = exp(scale S - lse), masked; dS = P (dP - delta), kept in s
    const bool need_mask = tile_needs_mask<BKV>(p, q0, qhi, k0);
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const int c = k0 + j * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float pe = expf(s[j][e] * p.scale - (lo ? lse0 : lse1));
        if (need_mask && !live(p, p.q_base + (lo ? r0 : r1), c + (e & 1)))
          pe = 0.0f;
        s[j][e] = pe * (dp[j][e] - (lo ? dl0 : dl1));
      }
    }

    // dQ += dS K: the C fragments of dS are the A fragment, K the B operand
    const uint16_t* ku = reinterpret_cast<const uint16_t*>(ks);
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      const uint32_t a[4] = {
          Half<T>::pack(s[2 * kt][0], s[2 * kt][1]),
          Half<T>::pack(s[2 * kt][2], s[2 * kt][3]),
          Half<T>::pack(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          Half<T>::pack(s[2 * kt + 1][2], s[2 * kt + 1][3]),
      };
      const uint16_t* krow = ku + (kt * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const uint16_t* kp = krow + j * 8;
        const uint32_t b[2] = {
            static_cast<uint32_t>(kp[0]) | (static_cast<uint32_t>(kp[LDS]) << 16),
            static_cast<uint32_t>(kp[8 * LDS]) |
                (static_cast<uint32_t>(kp[9 * LDS]) << 16),
        };
        Half<T>::mma(dq[j], a, b);
      }
    }
    __syncthreads();  // the stage is free for the copy two tiles ahead
  }

  float* DQ = gr.dq + static_cast<size_t>(hh) * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + t4 * 2;
    if (in0)
      *reinterpret_cast<float2*>(DQ + r0 * q_stride + c) =
          make_float2(dq[j][0] * p.scale, dq[j][1] * p.scale);
    if (in1)
      *reinterpret_cast<float2*>(DQ + r1 * q_stride + c) =
          make_float2(dq[j][2] * p.scale, dq[j][3] * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_mma(Params p,
                                                                Grads gr) {
  constexpr int LDS = D + 8;
  constexpr int KSTEPS = D / 16, NT_Q = BQ / 8, NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BKV][LDS], this block's keys
  T* Vs = Ks + BKV * LDS;
  T* Qs = Vs + BKV * LDS;                  // STAGES x [BQ][LDS]
  T* Ds = Qs + STAGES * BQ * LDS;          // STAGES x [BQ][LDS] (dO)
  float* Ls = reinterpret_cast<float*>(Ds + STAGES * BQ * LDS);  // STAGES x [BQ]
  float* Es = Ls + STAGES * BQ;                                  // delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BKV;
  const int khi = min(k0 + BKV, p.skv);
  const int kvh = blockIdx.y;
  const size_t q_stride = static_cast<size_t>(p.h) * D;
  const size_t kv_stride = static_cast<size_t>(p.h_kv) * D;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(kvh) * D;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(kvh) * D;

  for (int i = tid; i < BKV * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (k0 + r < p.skv) {
      const size_t off = static_cast<size_t>(k0 + r) * kv_stride + c;
      cp_async16(Ks + r * LDS + c, K + off);
      cp_async16(Vs + r * LDS + c, V + off);
    } else {
      *reinterpret_cast<uint4*>(Ks + r * LDS + c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vs + r * LDS + c) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();

  // this thread's two keys (local), the rows of the warp's A fragments
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.0f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.0f;
  }

  int first, last;
  q_tile_range<BQ>(p, k0, khi, first, last);
  const int per_head = last - first, steps = p.group * per_head;

  // step it: query head kvh * group + it / per_head, query tile
  // first + it % per_head
  auto load_tile = [&](int stage, int it) {
    const int hh = kvh * p.group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    T* qs = Qs + stage * BQ * LDS;
    T* ds = Ds + stage * BQ * LDS;
    const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(hh) * D;
    const T* DO = static_cast<const T*>(gr.dout) + static_cast<size_t>(hh) * D;
    for (int i = tid; i < BQ * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (q0 + r < p.sq) {
        const size_t off = static_cast<size_t>(q0 + r) * q_stride + c;
        cp_async16(qs + r * LDS + c, Q + off);
        cp_async16(ds + r * LDS + c, DO + off);
      } else {
        *reinterpret_cast<uint4*>(qs + r * LDS + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(ds + r * LDS + c) = make_uint4(0, 0, 0, 0);
      }
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < p.sq;
      const size_t row = static_cast<size_t>(hh) * p.sq + q0 + tid;
      Ls[stage * BQ + tid] = ok ? p.lse[row] : 0.0f;
      Es[stage * BQ + tid] = ok ? gr.delta[row] : 0.0f;
    }
  };

  if (steps > 0) load_tile(0, 0);
  cp_async_commit();

  for (int it = 0; it < steps; ++it) {
    const int stage = it & 1;
    if (it + 1 < steps) {
      load_tile(stage ^ 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int q0 = (first + it % per_head) * BQ;
    const int qhi = min(q0 + BQ, p.sq);
    const T* qs = Qs + stage * BQ * LDS;
    const T* ds = Ds + stage * BQ * LDS;
    const float* ls = Ls + stage * BQ;
    const float* es = Es + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float s[NT_Q][4], dp[NT_Q][4];
#pragma unroll
    for (int j = 0; j < NT_Q; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int a0 = (warp * 16 + g) * LDS + kk * 16 + t4 * 2;
      const uint32_t ak[4] = {ld32(Ks + a0), ld32(Ks + a0 + 8 * LDS),
                              ld32(Ks + a0 + 8), ld32(Ks + a0 + 8 * LDS + 8)};
      const uint32_t av[4] = {ld32(Vs + a0), ld32(Vs + a0 + 8 * LDS),
                              ld32(Vs + a0 + 8), ld32(Vs + a0 + 8 * LDS + 8)};
#pragma unroll
      for (int j = 0; j < NT_Q; ++j) {
        const int off = (j * 8 + g) * LDS + kk * 16 + t4 * 2;
        const uint32_t bq[2] = {ld32(qs + off), ld32(qs + off + 8)};
        const uint32_t bd[2] = {ld32(ds + off), ld32(ds + off + 8)};
        Half<T>::mma(s[j], ak, bq);
        Half<T>::mma(dp[j], av, bd);
      }
    }

    // P^T = exp(scale S^T - lse) (masked) into s, dS^T = P^T (dP^T - delta)
    // into dp; entry e holds key (e < 2 ? kr0 : kr1), query j*8 + 2*t4 + e%2
    const bool need_mask =
        pair_tile_needs_mask(p, q0, qhi, k0, khi, BQ, BKV);
#pragma unroll
    for (int j = 0; j < NT_Q; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        float pe = expf(s[j][e] * p.scale - ls[qc]);
        if (need_mask && !live_pair(p, q0 + qc, e < 2 ? kr0 : kr1)) pe = 0.0f;
        s[j][e] = pe;
        dp[j][e] = pe * (dp[j][e] - es[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: A fragments from the C registers,
    // dO and Q rows as the B operands
    const uint16_t* du = reinterpret_cast<const uint16_t*>(ds);
    const uint16_t* qu = reinterpret_cast<const uint16_t*>(qs);
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt) {
      const uint32_t ap[4] = {
          Half<T>::pack(s[2 * kt][0], s[2 * kt][1]),
          Half<T>::pack(s[2 * kt][2], s[2 * kt][3]),
          Half<T>::pack(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          Half<T>::pack(s[2 * kt + 1][2], s[2 * kt + 1][3]),
      };
      const uint32_t as[4] = {
          Half<T>::pack(dp[2 * kt][0], dp[2 * kt][1]),
          Half<T>::pack(dp[2 * kt][2], dp[2 * kt][3]),
          Half<T>::pack(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
          Half<T>::pack(dp[2 * kt + 1][2], dp[2 * kt + 1][3]),
      };
      const int rowoff = (kt * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const uint16_t* dpp = du + rowoff + j * 8;
        const uint16_t* qpp = qu + rowoff + j * 8;
        const uint32_t bd[2] = {
            static_cast<uint32_t>(dpp[0]) | (static_cast<uint32_t>(dpp[LDS]) << 16),
            static_cast<uint32_t>(dpp[8 * LDS]) |
                (static_cast<uint32_t>(dpp[9 * LDS]) << 16),
        };
        const uint32_t bq[2] = {
            static_cast<uint32_t>(qpp[0]) | (static_cast<uint32_t>(qpp[LDS]) << 16),
            static_cast<uint32_t>(qpp[8 * LDS]) |
                (static_cast<uint32_t>(qpp[9 * LDS]) << 16),
        };
        Half<T>::mma(dv[j], ap, bd);
        Half<T>::mma(dk[j], as, bq);
      }
    }
    __syncthreads();  // the stage is free for the copy two steps ahead
  }
  cp_async_wait<0>();  // the K/V copies, when no step ran

  float* DK = gr.dk + static_cast<size_t>(kvh) * D;
  float* DV = gr.dv + static_cast<size_t>(kvh) * D;
  const bool in0 = kr0 < p.skv, in1 = kr1 < p.skv;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + t4 * 2;
    if (in0) {
      *reinterpret_cast<float2*>(DK + kr0 * kv_stride + c) =
          make_float2(dk[j][0] * p.scale, dk[j][1] * p.scale);
      *reinterpret_cast<float2*>(DV + kr0 * kv_stride + c) =
          make_float2(dv[j][0], dv[j][1]);
    }
    if (in1) {
      *reinterpret_cast<float2*>(DK + kr1 * kv_stride + c) =
          make_float2(dk[j][2] * p.scale, dk[j][3] * p.scale);
      *reinterpret_cast<float2*>(DV + kr1 * kv_stride + c) =
          make_float2(dv[j][2], dv[j][3]);
    }
  }
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_mma(const Params& p, cudaStream_t s) {
  constexpr int smem = mma_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_mma<T, D><<<dim3((p.sq + BQ - 1) / BQ, p.h), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  constexpr int smem = f32_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_f32<D><<<dim3((p.sq + FBQ - 1) / FBQ, p.h), F_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; dh: 128
cudaError_t launch(int dtype, int dh, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.sq < 1 || p.skv < 0 || p.h < 1 || p.h_kv < 1 || p.h % p.h_kv ||
      dh != 128)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32<128>(p, s);
  if (dtype == 1) return launch_mma<__half, 128>(p, s);
  if (dtype == 2) return launch_mma<__nv_bfloat16, 128>(p, s);
  return cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t launch_with(Kernel kernel, dim3 grid, int threads, int smem,
                        const Params& p, const Grads& gr, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(p, gr);
  return cudaGetLastError();
}

// the backward: dkv = 0 launches the dQ pass, 1 the dK/dV pass
cudaError_t launch_bwd(int dtype, int dh, int dkv, const Params& p,
                       const Grads& gr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.sq < 1 || p.skv < 1 || p.h < 1 || p.h_kv < 1 || p.h % p.h_kv ||
      dh != 128 || (p.window && !p.causal))
    return cudaErrorInvalidValue;
  constexpr int D = 128;
  if (dtype == 0) {
    const int rows = dkv ? p.skv : p.sq;
    const dim3 grid((rows + FB_ROWS - 1) / FB_ROWS, dkv ? p.h_kv : p.h);
    return dkv ? launch_with(flash_bwd_dkv_f32<D>, grid, FB_THREADS,
                             f32_bwd_smem_bytes<D>(), p, gr, s)
               : launch_with(flash_bwd_dq_f32<D>, grid, FB_THREADS,
                             f32_bwd_smem_bytes<D>(), p, gr, s);
  }
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  if (dkv) {
    const dim3 grid((p.skv + BKV - 1) / BKV, p.h_kv);
    return dtype == 1 ? launch_with(flash_bwd_dkv_mma<__half, D>, grid, THREADS,
                                    dkv_smem_bytes<D>(), p, gr, s)
                      : launch_with(flash_bwd_dkv_mma<__nv_bfloat16, D>, grid,
                                    THREADS, dkv_smem_bytes<D>(), p, gr, s);
  }
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h);
  return dtype == 1 ? launch_with(flash_bwd_dq_mma<__half, D>, grid, THREADS,
                                  mma_smem_bytes<D>(), p, gr, s)
                    : launch_with(flash_bwd_dq_mma<__nv_bfloat16, D>, grid,
                                  THREADS, mma_smem_bytes<D>(), p, gr, s);
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

// K8a / K8b: o [sq, h, dh] in the operand dtype, lse [h, sq] f32. Query row
// i sits at global position row_offset + i, key j at j.
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

// K9: folds the chunk into acc [h, sq, dh], m, l [h, sq] (f32) in place.
// mode: 0 = offset, 1 = diagonal, 2 = past (no window).
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

// K10a-K10d. q, dout [sq, h, dh] and k, v [skv, h_kv, dh] in the operand
// dtype; lse, delta [h, sq] f32. Query row i sits at global position
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

const char* ddlb_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
