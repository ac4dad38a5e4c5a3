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
// Design (the protocol of the TPU kernel; right and simple first, the GEMM
// is K1's tile, not wgmma):
//  1. A global entry barrier: every rank adds one to every rank's barrier
//     counter and waits for d a call. It keeps a fast rank's next dispatch
//     out of a slot, and its next combine out of a region, that a peer is
//     still reading in the previous call.
//  2. Dispatch: the first blocks of the grid are put blocks. They copy
//     group p of the tokens into rank p's dispatch slot indexed by the
//     sender, for every p != r, with 16-byte stores, and signal that
//     slot's own arrival counter on rank p. The slots are distinct, so no
//     credits are needed within a call. The local group is read where it
//     is.
//  3. The other blocks GEMM the groups in arrival order, source
//     s = (r + t) % d at step t, each step waiting only on slot s's
//     arrival counter.
//  4. Combine: the epilogue stores each finished group straight into the
//     combine region r of source s's buffer (this rank's own group goes
//     straight to the output) and signals s's arrival counter of expert r.
//  5. The caller's output is not peer memory, so a rank cannot be written
//     into it: once expert e's group has landed in combine region e, the
//     put blocks copy it into the output rows of group e (an [m/d, n] pass
//     less the local group; the next call reuses the regions, so the
//     result is never a view of them). The kernel ends when every inbound
//     group has landed and been copied.
//  - Counters: one per dispatch slot and one per combine region, each
//    growing by the put blocks' (resp. the GEMM blocks') count every call;
//    the host passes the call's epoch and waits compare with >= modulo
//    2^32. Signals are red.release.sys after a system fence; waits are
//    ld.acquire.sys; landed data is read through L2 only (cp.async.cg,
//    ld.global.cg). A wait of 20 s traps rather than holding the card.
//  - One cooperative launch per rank: blocks spin on flags that other
//    blocks and cards write, so every block must be resident at once.
//  - Loopback: gridDim.y = d runs d virtual ranks on one card, each with
//    its own buffer in that card's memory.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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

__device__ __forceinline__ unsigned* flags_of(const A2AArgs& p, int rank) {
  return reinterpret_cast<unsigned*>(p.buf[rank]);
}

// rank's dispatch slot holding the tokens of source s
template <typename T>
__device__ __forceinline__ T* dispatch_of(const A2AArgs& p, int rank, int s) {
  return reinterpret_cast<T*>(p.buf[rank] + FLAG_BYTES) +
         static_cast<size_t>(s) * p.g * p.k;
}

// rank's combine region holding expert e's output for rank's group e
template <typename T>
__device__ __forceinline__ T* combine_of(const A2AArgs& p, int rank, int e) {
  return reinterpret_cast<T*>(p.buf[rank] + FLAG_BYTES) +
         static_cast<size_t>(p.d) * p.g * p.k +
         static_cast<size_t>(e) * p.g * p.n;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(f)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* f, unsigned v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;\n" ::"l"(f), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait this long means a peer never signalled (a rank that did not
// launch, or a protocol fault): trap, so the launch fails with an error
// instead of holding the card forever.
constexpr unsigned long long WAIT_LIMIT_NS = 20ull * 1000 * 1000 * 1000;

// Block-wide: wait until *f >= target (mod 2^32), then every thread may
// read what the signallers wrote before they signalled.
__device__ __forceinline__ void block_wait(const unsigned* f,
                                           unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long start = globaltimer_ns();
    while (static_cast<int>(ld_acquire(f) - target) < 0) {
      __nanosleep(64);
      if (globaltimer_ns() - start > WAIT_LIMIT_NS) __trap();
    }
  }
  __syncthreads();
}

// Block-wide: publish every thread's earlier writes, then add one to *f.
__device__ __forceinline__ void block_signal(unsigned* f) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(f, 1u);
}

// Block (0, y) tells every rank that this rank entered the call (its
// previous call is over); every block waits until every rank has. A rank
// cannot run two calls ahead of another (its call ends only once every
// peer has combined into it), so d signals a call on each counter suffice.
__device__ __forceinline__ void global_barrier(const A2AArgs& p, int r) {
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

// One element through L2 only (slot data may have been rewritten by a
// peer since this SM last read the line).
template <typename T>
__device__ __forceinline__ T ldcg(const T* p) {
  if constexpr (sizeof(T) == 2) {
    const unsigned short bits =
        __ldcg(reinterpret_cast<const unsigned short*>(p));
    return *reinterpret_cast<const T*>(&bits);
  } else {
    return __ldcg(p);
  }
}

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
// the GEMM tile: K1's structure (csrc/matmul.cu), one 128x128 output tile of
// A[rows, k] @ B[k, n] a call, with loads through L2 only
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int PAD = 8;
constexpr int LDA = BK + PAD, LDB = BN + PAD;
constexpr int A_TILE = BM * LDA, B_TILE = BK * LDB;
constexpr int STAGES = 2;
constexpr int WMMA_SMEM = STAGES * (A_TILE + B_TILE) * 2;  // 37,888
static_assert(WMMA_SMEM <= 48 * 1024, "static shared memory limit");
static_assert((THREADS / 32) * 16 * 16 * 4 <= WMMA_SMEM,
              "epilogue scratch aliases the tiles");

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

template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int r, int c,
                                           int rows, int cols) {
  if (r < rows && c + 8 <= cols) {
    const T* q = src + static_cast<size_t>(r) * cols + c;
    if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      cp_async16(dst, q);
      return;
    }
  }
  const T zero = Cvt<T>::from_float(0.0f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = (r < rows && c + e < cols)
                 ? ldcg(src + static_cast<size_t>(r) * cols + c + e)
                 : zero;
  }
}

template <typename T>
__device__ __forceinline__ void load_tiles(T* as, T* bs, const T* A,
                                           const T* B, int rows, int n, int k,
                                           int row0, int col0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
    load_chunk(as + r * LDA + cc, A, row0 + r, k0 + cc, rows, k);
  }
#pragma unroll
  for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    load_chunk(bs + r * LDB + cc, B, k0 + r, col0 + cc, k, n);
  }
}

// bf16 / fp16 on the tensor cores
template <typename T>
struct WmmaTile {
  static constexpr int SMEM = WMMA_SMEM;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];

  __device__ void compute(const T* A, const T* B, int rows, int n, int k,
                          int row0, int col0, unsigned char* smem) {
    T* As = reinterpret_cast<T*>(smem);
    T* Bs = As + STAGES * A_TILE;
    const int warp = threadIdx.x / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    __syncthreads();  // the last tile's epilogue is done with the scratch
    const int ktiles = (k + BK - 1) / BK;
    if (ktiles > 0) load_tiles(As, Bs, A, B, rows, n, k, row0, col0, 0);
    cp_async_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) {
        const int nxt = (kt + 1) % STAGES;
        load_tiles(As + nxt * A_TILE, Bs + nxt * B_TILE, A, B, rows, n, k,
                   row0, col0, (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* as = As + (kt % STAGES) * A_TILE;
      const T* bs = Bs + (kt % STAGES) * B_TILE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(fa[i], as + (wm * WM + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Hands each lane's eight consecutive float32 sums to st(row, col, v).
  template <typename Store>
  __device__ void store(int row0, int col0, unsigned char* smem,
                        const Store& st) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    float* scratch = reinterpret_cast<float*>(smem) + warp * 16 * 16;
    const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        st(row0 + wm * WM + i * 16 + r, col0 + wn * WN + j * 16 + c,
           scratch + r * 16 + c);
        __syncwarp();
      }
    }
  }
};

// float32 on the SIMT cores (K1's f32 kernel: 8x8 outputs a thread, true
// f32, no TF32)
constexpr int FBK = 8, FT = 8, F_PAD = 4;

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

template <typename T>
struct TileFor {
  using type = WmmaTile<T>;
};
template <>
struct TileFor<float> {
  using type = SimtTile;
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

template <typename T>
__global__ void __launch_bounds__(THREADS) a2a_matmul_kernel(A2AArgs p) {
  using Tile = typename TileFor<T>::type;
  __shared__ __align__(128) unsigned char smem[Tile::SMEM];
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
  Tile tile;
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Blocks a virtual rank gets: what the card holds at once, shared by the
// ranks of the launch (a cooperative launch of more would be refused).
template <typename K>
int grid_for(K kernel, int vranks, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms / vranks;
  return *blocks >= 2 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename T>
int launch(A2AArgs& p, int vranks, cudaStream_t s) {
  int blocks = 0;
  int rc = grid_for(a2a_matmul_kernel<T>, vranks, &blocks);
  if (rc != 0) return rc;
  // one put block for every eight, at most 16
  const int share = blocks / 8 < 1 ? 1 : blocks / 8;
  p.put_blocks = share < 16 ? share : 16;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(a2a_matmul_kernel<T>), dim3(blocks, vranks),
      dim3(THREADS), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// a, w, out: vranks device pointers each (the tokens [d * g, k], the
// resident expert [k, n] and the output [d * g, n] of ranks rank0 ..
// rank0 + vranks - 1); buf: d device pointers, each rank's buffer
// (FLAG_BYTES of zeroed flags, then d dispatch slots [g, k], then d combine
// regions [g, n]) as this process addresses it. k and n times the element
// size must be multiples of 16 bytes.
int ddlb_a2a_matmul(int dtype, const unsigned long long* a,
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
  switch (dtype) {
    case 0:
      return launch<float>(p, vranks, s);
    case 1:
      return launch<__half>(p, vranks, s);
    case 2:
      return launch<__nv_bfloat16>(p, vranks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ddlb_a2a_flag_bytes() { return FLAG_BYTES; }

const char* ddlb_a2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
