// K6: the fused MoE all-to-all expert GEMM, one persistent kernel per rank
// that dispatches tokens over NVLink peer memory, runs the resident
// expert's GEMM on each group as it lands and sends each result home.
//
// Replaces the TPU kernel of ddlb_tpu/ops/alltoall_matmul.py,
// alltoall_expert_matmul (_a2a_matmul_kernel, _global_barrier): rank r holds
// tokens [m/d, k] in d contiguous groups of g = m/d^2 (group e is routed to
// expert e, resident on rank e) and its expert's weight [k, n]; it returns
// [m/d, n] in token order, group e through expert e. Each group's product
// is summed in float32 and rounded once to the operand dtype (out_buf
// there).
//
// What bounds it on an H100: the GEMM. At 8192^3 bf16 over d = 4 ranks a
// rank multiplies [2048, 8192] @ [8192, 8192], 0.275 TFLOP (0.278 ms at
// 989 TFLOP/s), while 3 groups of [512, 8192] bf16 leave and 3 of
// [512, 8192] come back (25 MB each way, 0.056 ms at 450 GB/s).
//
// Design (the protocol of the TPU kernel):
//  1. A global entry barrier: every rank adds one to every rank's barrier
//     counter and waits for d a call. It keeps a fast rank's next dispatch
//     out of a slot, and its next combine out of a region, that a peer is
//     still reading in the previous call.
//  2. Dispatch: group p of the tokens goes into rank p's dispatch slot
//     indexed by the sender, for every p != r, with 16-byte stores, and
//     each sender signals that slot's own arrival counter on rank p. The
//     slots are distinct, so no credits are needed within a call. The
//     local group is read where it is.
//  3. The GEMM takes the groups in arrival order, source s = (r + t) % d at
//     step t, each step waiting only on slot s's arrival counter.
//  4. Combine: the epilogue stores each finished group straight into the
//     combine region r of source s's buffer (this rank's own group goes
//     straight to the output) and signals s's arrival counter of expert r.
//  5. The caller's output is not peer memory, so a rank cannot be written
//     into it: once expert e's group has landed in combine region e, it is
//     copied into the output rows of group e (an [m/d, n] pass less the
//     local group; the next call reuses the regions, so the result is never
//     a view of them). The kernel ends when every inbound group has landed
//     and been copied.
//  - bf16/fp16 (the host's choice, by dtype and shape): the Hopper tile of
//    hopper_gemm.cuh, one 384-thread block an SM. The producer
//    warpgroup's TMA thread waits for slot s's counter, fences the async
//    proxy (a peer wrote the slot with generic stores; TMA reads it) and
//    loads the group's 128x256 output tiles stage by stage: at g = 512 and
//    n = 8192 a step is 128 tiles, one wave on 132 SMs. Its other three
//    warps do the copies of steps 2 and 5, a share a block, so every block
//    copies and no SM is kept from the GEMM. The consumers' epilogue is the
//    combine store, 16 bytes a lane.
//  - float32 (SimtTile, K1's f32 kernel): 256 threads; the first blocks of
//    the grid are put blocks that do the copies, the rest walk 128x128
//    tiles.
//  - Counters: one per dispatch slot and one per combine region, each
//    growing by the copying (resp. the GEMM) blocks' count every call;
//    the host passes the call's epoch and waits compare with >= modulo
//    2^32. Signals are red.release.sys after a system fence; waits are
//    ld.acquire.sys; landed data is read through L2 only (TMA, cp.async.cg,
//    ld.global.cg). A wait of 20 s traps rather than holding the card.
//  - One cooperative launch per rank: blocks spin on flags that other
//    blocks and cards write, so every block must be resident at once.
//  - Loopback: gridDim.y = d runs d virtual ranks on one card, each with
//    its own buffer in that card's memory.
//  - Tensor maps are built on the host for every launch and passed by
//    value (__grid_constant__): per virtual rank the tokens and the
//    dispatch slots, each as one [d, g, k] map, and the expert, 24 maps at
//    most, under the classic 4 KB of kernel parameters.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "peer_flags.cuh"

namespace {

using namespace peer;

constexpr int MAX_RANKS = 8;
// flag words of a rank's buffer (uint32 offsets, one 128-byte line each):
// the barrier, then DISPATCH + s (tokens from source s have landed), then
// COMBINE + e (expert e's output for this rank's group e has landed)
constexpr int LINE = 32;
constexpr int BARRIER = 0, DISPATCH = LINE, COMBINE = LINE * (1 + MAX_RANKS);
constexpr int FLAG_BYTES = 4096;  // the dispatch slots start here
static_assert(4 * (COMBINE + LINE * MAX_RANKS) <= FLAG_BYTES, "flag lines");

struct A2AArgs {
  // per virtual rank (blockIdx.y); index 0 only with one rank a process
  const void* a[MAX_RANKS];    // tokens [d * g, k]
  const void* w[MAX_RANKS];    // the resident expert [k, n]
  void* out[MAX_RANKS];        // [d * g, n]
  // per ring rank: the base of its buffer (flags, d dispatch slots [g, k],
  // d combine regions [g, n])
  unsigned char* buf[MAX_RANKS];
  int rank0;  // rank of blockIdx.y == 0
  int d;
  int g, n, k;
  int put_blocks;
  unsigned epoch;
};

// ---------------------------------------------------------------------------
// flags
// ---------------------------------------------------------------------------

template <typename Args>
__device__ __forceinline__ unsigned* flags_of(const Args& p, int rank) {
  return reinterpret_cast<unsigned*>(p.buf[rank]);
}

// rank's dispatch slot holding the tokens of source s
template <typename T, typename Args>
__device__ __forceinline__ T* dispatch_of(const Args& p, int rank, int s) {
  return reinterpret_cast<T*>(p.buf[rank] + FLAG_BYTES) +
         static_cast<size_t>(s) * p.g * p.k;
}

// rank's combine region holding expert e's output for rank's group e
template <typename T, typename Args>
__device__ __forceinline__ T* combine_of(const Args& p, int rank, int e) {
  return reinterpret_cast<T*>(p.buf[rank] + FLAG_BYTES) +
         static_cast<size_t>(p.d) * p.g * p.k +
         static_cast<size_t>(e) * p.g * p.n;
}

// Block (0, y) tells every rank that this rank entered the call (its
// previous call is over); every block waits until every rank has. A rank
// cannot run two calls ahead of another (its call ends only once every
// peer has combined into it), so d signals a call on each counter suffice.
template <typename Args>
__device__ __forceinline__ void global_barrier(const Args& p, int r) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < p.d; ++i) red_release_add(flags_of(p, i) + BARRIER, 1u);
  }
  block_wait(flags_of(p, r) + BARRIER, static_cast<unsigned>(p.d) * (p.epoch + 1u));
}

// ---------------------------------------------------------------------------
// element helpers
// ---------------------------------------------------------------------------

template <typename T>
struct Cvt;
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ float to_float(__half x) {
    return __half2float(x);
  }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float from_float(float x) { return x; }
  static __device__ __forceinline__ float to_float(float x) { return x; }
};

// Round eight float32 values to T and store the first `avail` of them at
// dst: 16-byte stores when whole and aligned, else one element at a time.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* v, int avail) {
  alignas(16) T vals[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) vals[e] = Cvt<T>::from_float(v[e]);
  if (avail >= 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < static_cast<int>(8 * sizeof(T) / 16); ++q)
      reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(vals)[q];
  } else {
    for (int e = 0; e < 8 && e < avail; ++e) dst[e] = vals[e];
  }
}

// ---------------------------------------------------------------------------
// the float32 GEMM tile: K1's f32 kernel (csrc/matmul.cu) on the SIMT
// cores, one 128x128 output tile of A[rows, k] @ B[k, n] a call, 8x8
// outputs a thread, true f32 (no TF32), loads through L2 only
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128;
constexpr int FBK = 8, FT = 8, F_PAD = 4;
constexpr int THREADS = (BM / FT) * (BN / FT);  // 256

struct SimtTile {
  static constexpr int SMEM = 2 * FBK * (BM + F_PAD) * 4;
  float acc[FT][FT];

  __device__ void compute(const float* A, const float* B, int rows, int n,
                          int k, int row0, int col0, unsigned char* smem) {
    float(*As)[BM + F_PAD] = reinterpret_cast<float(*)[BM + F_PAD]>(smem);
    float(*Bs)[BN + F_PAD] = As + FBK;
    const int tid = threadIdx.x;
    const int tx = tid % (BN / FT), ty = tid / (BN / FT);
#pragma unroll
    for (int i = 0; i < FT; ++i)
#pragma unroll
      for (int j = 0; j < FT; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < k; k0 += FBK) {
      __syncthreads();
      {
        const int r = tid / 2, c = (tid % 2) * 4, gr = row0 + r;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gc = k0 + c + e;
          As[c + e][r] = (gr < rows && gc < k)
                             ? __ldcg(A + static_cast<size_t>(gr) * k + gc)
                             : 0.0f;
        }
      }
      {
        const int r = tid / 32, c = (tid % 32) * 4, gr = k0 + r;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gc = col0 + c + e;
          Bs[r][c + e] = (gr < k && gc < n)
                             ? __ldcg(B + static_cast<size_t>(gr) * n + gc)
                             : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FBK; ++kk) {
        float a[FT], b[FT];
#pragma unroll
        for (int i = 0; i < FT; ++i) a[i] = As[kk][ty * FT + i];
#pragma unroll
        for (int j = 0; j < FT; ++j) b[j] = Bs[kk][tx * FT + j];
#pragma unroll
        for (int i = 0; i < FT; ++i)
#pragma unroll
          for (int j = 0; j < FT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  template <typename Store>
  __device__ void store(int row0, int col0, unsigned char*, const Store& st) {
    const int tx = threadIdx.x % (BN / FT), ty = threadIdx.x / (BN / FT);
#pragma unroll
    for (int i = 0; i < FT; ++i) st(row0 + ty * FT + i, col0 + tx * FT, acc[i]);
  }
};


// ---------------------------------------------------------------------------
// the epilogue and the copies
// ---------------------------------------------------------------------------

// Round each sum once and store it in the group's rows at dst (the output,
// or the source's combine region in peer memory).
template <typename T>
struct StoreRows {
  T* dst;
  int rows, n;
  __device__ void operator()(int r, int c, const float* v) const {
    if (r < rows && c < n) store8(dst + static_cast<size_t>(r) * n + c, v, n - c);
  }
};

// This block's share of a copy of `bytes` bytes (a multiple of 16): 16-byte
// units through L2, split into `parts` contiguous ranges.
__device__ void copy_part(void* dst, const void* src, size_t bytes, int part,
                          int parts) {
  const size_t units = bytes / 16;
  const size_t per = (units + parts - 1) / parts;
  const size_t lo = per * part, hi = lo + per < units ? lo + per : units;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* t = static_cast<uint4*>(dst);
  for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
    __stcg(t + i, __ldcg(s + i));
}

// ---------------------------------------------------------------------------
// K6: dispatch, expert GEMM, combine
// ---------------------------------------------------------------------------

// K6 on float32: put blocks do the copies, the rest run SimtTile.
__global__ void __launch_bounds__(THREADS) a2a_matmul_kernel(A2AArgs p) {
  using T = float;
  __shared__ __align__(128) unsigned char smem[SimtTile::SMEM];
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const unsigned G = gridDim.x, P = p.put_blocks;
  const unsigned e = p.epoch;
  unsigned* mine = flags_of(p, r);
  const T* A = static_cast<const T*>(p.a[y]);
  T* out = static_cast<T*>(p.out[y]);
  const size_t gk = static_cast<size_t>(p.g) * p.k;
  const size_t gn = static_cast<size_t>(p.g) * p.n;

  global_barrier(p, r);
  if (blockIdx.x < P) {
    // dispatch: group q of the tokens to rank q's slot of this source
    for (int i = 1; i < d; ++i) {
      const int q = (r + i) % d;
      copy_part(dispatch_of<T>(p, q, r), A + q * gk, gk * sizeof(T), blockIdx.x, P);
      block_signal(flags_of(p, q) + DISPATCH + r);
    }
    // combine: expert x reaches this rank's group at its step (r - x) % d,
    // so the regions land in the order x = r - 1, r - 2, ...
    for (int i = 1; i < d; ++i) {
      const int x = (r + d - i) % d;
      block_wait(mine + COMBINE + x, (e + 1) * (G - P));
      copy_part(out + x * gn, combine_of<T>(p, r, x), gn * sizeof(T), blockIdx.x, P);
    }
    return;
  }
  const T* W = static_cast<const T*>(p.w[y]);
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = ((p.g + BM - 1) / BM) * tiles_n;
  SimtTile tile;
  for (int t = 0; t < d; ++t) {
    const int s = (r + t) % d;  // the source whose tokens this step multiplies
    if (t > 0) block_wait(mine + DISPATCH + s, (e + 1) * P);
    const T* rows = t == 0 ? A + r * gk : dispatch_of<T>(p, r, s);
    const StoreRows<T> st{t == 0 ? out + r * gn : combine_of<T>(p, s, r), p.g, p.n};
    for (int j = blockIdx.x - P; j < tiles; j += G - P) {
      const int row0 = (j / tiles_n) * BM, col0 = (j % tiles_n) * BN;
      tile.compute(rows, W, p.g, p.n, p.k, row0, col0, smem);
      tile.store(row0, col0, smem, st);
    }
    if (t > 0) block_signal(flags_of(p, s) + COMBINE + r);
  }
}

// K6 on the Hopper tile (bf16 / fp16).
struct A2ATmaArgs {
  // per virtual rank (blockIdx.y): its tokens and its dispatch slots, each
  // as a [d, g, k] map (a routing group or a source by depth), its expert
  CUtensorMap tokens[MAX_RANKS];
  CUtensorMap dispatch[MAX_RANKS];
  CUtensorMap w[MAX_RANKS];
  const void* a[MAX_RANKS];
  void* out[MAX_RANKS];
  unsigned char* buf[MAX_RANKS];
  int rank0, d;
  int g, n, k;
  unsigned epoch;
};

template <typename T>
__global__ void __launch_bounds__(hopper::THREADS, 1)
    a2a_wgmma_kernel(const __grid_constant__ A2ATmaArgs p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_of(smem_raw);
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const unsigned G = gridDim.x, e = p.epoch;
  unsigned* mine = flags_of(p, r);
  const size_t gk = static_cast<size_t>(p.g) * p.k;
  const size_t gn = static_cast<size_t>(p.g) * p.n;
  T* out = static_cast<T*>(p.out[y]);
  const Tiles tiles(p.g, p.n);

  if (threadIdx.x == 0) init_barriers(sm);
  global_barrier(p, r);  // its __syncthreads also publishes the barriers
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  if (wg == 0) {
    producer_registers();
    if (warp == 0) {
      Pipe pipe;
      for (int t = 0; t < d; ++t) {
        const int s = (r + t) % d;  // the source whose tokens this step multiplies
        if (t > 0) {
          // the issuing lane acquires the slot, then orders it before its
          // TMA reads
          if (threadIdx.x == 0) {
            spin_wait(mine + DISPATCH + s, (e + 1) * G);
            fence_proxy_async();
          }
          __syncwarp();
        }
        const CUtensorMap* a = t == 0 ? &p.tokens[y] : &p.dispatch[y];
        for (int j = first_tile(t * tiles.count); j < tiles.count; j += G)
          load_tile(sm, pipe, a, t == 0 ? r : s, &p.w[y], tiles.row0(j), tiles.col0(j), p.n,
                    p.k);
      }
      return;
    }
    const int tid = threadIdx.x - 32;
    const T* A = static_cast<const T*>(p.a[y]);
    // dispatch: group q of the tokens to rank q's slot of this source
    for (int i = 1; i < d; ++i) {
      const int q = (r + i) % d;
      copy_share(dispatch_of<T>(p, q, r), A + q * gk, gk * sizeof(T), blockIdx.x, G, tid,
                 COPY_THREADS);
      group_signal(flags_of(p, q) + DISPATCH + r, tid, BAR_COPY, COPY_THREADS);
    }
    // combine: expert x reaches this rank's group at its step (r - x) % d,
    // so the regions land in the order x = r - 1, r - 2, ...
    for (int i = 1; i < d; ++i) {
      const int x = (r + d - i) % d;
      group_wait(mine + COMBINE + x, (e + 1) * G, tid, BAR_COPY, COPY_THREADS);
      copy_share(out + x * gn, combine_of<T>(p, r, x), gn * sizeof(T), blockIdx.x, G, tid,
                 COPY_THREADS);
    }
    return;
  }
  consumer_registers();
  Pipe pipe;
  float acc[128];
  for (int t = 0; t < d; ++t) {
    const int s = (r + t) % d;
    const StoreRows<T> st{t == 0 ? out + r * gn : combine_of<T>(p, s, r), p.g, p.n};
    for (int j = first_tile(t * tiles.count); j < tiles.count; j += G) {
      mma_tile<T>(sm, pipe, acc, p.k, wg - 1);
      store_tile(sm, acc, wg - 1, tiles.row0(j), tiles.col0(j), st);
    }
    if (t > 0)
      group_signal(flags_of(p, s) + COMBINE + r, threadIdx.x - 128, BAR_CONSUMER,
                   CONSUMER_THREADS);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int launch_simt(A2AArgs& p, int vranks, cudaStream_t s) {
  int blocks = 0;
  int rc = grid_for(a2a_matmul_kernel, THREADS, 0, vranks, &blocks);
  if (rc != 0) return rc;
  // one put block for every eight, at most 16
  const int share = blocks / 8 < 1 ? 1 : blocks / 8;
  p.put_blocks = share < 16 ? share : 16;
  return launch_coop(a2a_matmul_kernel, p, blocks, vranks, THREADS, 0, s);
}

// K6 on the Hopper tile: the tensor maps of every virtual rank, then one
// launch of hopper::THREADS-thread blocks with hopper::SMEM_BYTES each.
template <typename T>
int launch_wgmma(int dtype, const A2AArgs& q, int vranks, cudaStream_t s) {
  A2ATmaArgs p;
  const unsigned long long group_bytes =
      static_cast<unsigned long long>(q.g) * q.k * sizeof(T);
  for (int y = 0; y < vranks; ++y) {
    const unsigned char* slots = q.buf[q.rank0 + y] + FLAG_BYTES;
    if (!hopper::tma_ok(q.a[y], q.k) || !hopper::tma_ok(q.w[y], q.n) ||
        !hopper::tma_ok(slots, q.k))
      return static_cast<int>(cudaErrorInvalidValue);
    int rc = hopper::encode_a(&p.tokens[y], dtype, q.a[y], q.g, q.k, q.d, group_bytes);
    if (rc == 0) rc = hopper::encode_a(&p.dispatch[y], dtype, slots, q.g, q.k, q.d, group_bytes);
    if (rc == 0) rc = hopper::encode_b(&p.w[y], dtype, q.w[y], q.k, q.n);
    if (rc != 0) return rc;
    p.a[y] = q.a[y];
    p.out[y] = q.out[y];
  }
  for (int i = 0; i < q.d; ++i) p.buf[i] = q.buf[i];
  p.rank0 = q.rank0;
  p.d = q.d;
  p.g = q.g;
  p.n = q.n;
  p.k = q.k;
  p.epoch = q.epoch;
  int blocks = 0;
  const int rc = grid_for(a2a_wgmma_kernel<T>, hopper::THREADS, hopper::SMEM_BYTES,
                          vranks, &blocks);
  if (rc != 0) return rc;
  return launch_coop(a2a_wgmma_kernel<T>, p, blocks, vranks, hopper::THREADS,
                     hopper::SMEM_BYTES, s);
}

// GEMM tiles (the host's choice, by dtype; the codes are K2's, whose
// WmmaTile, code 1, K6 has no use for)
constexpr int TILE_SIMT = 0, TILE_WGMMA = 2;

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// tile: 0 = SimtTile (float32), 2 = the Hopper tile (16-bit, 16-byte
// aligned operands and slots).
// a, w, out: vranks device pointers each (the tokens [d * g, k], the
// resident expert [k, n] and the output [d * g, n] of ranks rank0 ..
// rank0 + vranks - 1); buf: d device pointers, each rank's buffer
// (FLAG_BYTES of zeroed flags, then d dispatch slots [g, k], then d combine
// regions [g, n]) as this process addresses it. k and n times the element
// size must be multiples of 16 bytes.
int ddlb_a2a_matmul(int dtype, int tile, const unsigned long long* a,
                    const unsigned long long* w, const unsigned long long* out,
                    const unsigned long long* buf, int rank0, int vranks, int d,
                    int g, int n, int k, unsigned epoch, void* stream) {
  if (d < 1 || d > MAX_RANKS || vranks < 1 || rank0 < 0 || rank0 + vranks > d ||
      g < 1 || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  A2AArgs p;
  for (int i = 0; i < vranks; ++i) {
    p.a[i] = reinterpret_cast<const void*>(a[i]);
    p.w[i] = reinterpret_cast<const void*>(w[i]);
    p.out[i] = reinterpret_cast<void*>(out[i]);
  }
  for (int i = 0; i < d; ++i) p.buf[i] = reinterpret_cast<unsigned char*>(buf[i]);
  p.rank0 = rank0;
  p.d = d;
  p.g = g;
  p.n = n;
  p.k = k;
  p.put_blocks = 0;
  p.epoch = epoch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tile == TILE_SIMT) return launch_simt(p, vranks, s);
  if (dtype == 1 && tile == TILE_WGMMA) return launch_wgmma<__half>(dtype, p, vranks, s);
  if (dtype == 2 && tile == TILE_WGMMA)
    return launch_wgmma<__nv_bfloat16>(dtype, p, vranks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks a virtual rank gets in a launch of `vranks` ranks on `tile`, or
// a negative cudaError.
int ddlb_a2a_blocks(int dtype, int tile, int vranks) {
  int blocks = 0, rc = 0;
  if (dtype == 0 && tile == TILE_SIMT)
    rc = grid_for(a2a_matmul_kernel, THREADS, 0, vranks, &blocks);
  else if (dtype == 1 && tile == TILE_WGMMA)
    rc = grid_for(a2a_wgmma_kernel<__half>, hopper::THREADS, hopper::SMEM_BYTES, vranks,
                  &blocks);
  else if (dtype == 2 && tile == TILE_WGMMA)
    rc = grid_for(a2a_wgmma_kernel<__nv_bfloat16>, hopper::THREADS, hopper::SMEM_BYTES,
                  vranks, &blocks);
  else
    return -static_cast<int>(cudaErrorInvalidValue);
  return rc != 0 ? -rc : blocks;
}

int ddlb_a2a_flag_bytes() { return FLAG_BYTES; }

const char* ddlb_a2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
