// K2 and K3: the ring collective matmuls, one persistent kernel per rank
// that moves the ring's data over NVLink peer memory and runs the GEMM.
//
// Replace the TPU kernels of ddlb_tpu/ops/collective_matmul.py:
//  - K2 ring_ag_matmul (_ag_matmul_kernel): all-gather fused with the GEMM,
//    [m/d, k] @ [k, n] -> [m, n]. At step t rank r holds chunk (r - t) % d,
//    forwards it to rank r + 1 and GEMMs it into its output rows.
//  - K3 ring_matmul_rs (_matmul_rs_kernel): GEMM fused with a ring
//    reduce-scatter, [m, k/d] @ [k/d, n] -> [m/d, n]. At step t rank r
//    GEMMs the rows of chunk (r + d - 1 - t) % d, adds the accumulator it
//    received from rank r - 1 and forwards the sum to rank r + 1; after d
//    steps it holds its own chunk, reduced over the ring. As on the TPU the
//    travelling accumulator is in the operand dtype: each step rounds the
//    float32 GEMM once (the partial), adds the received accumulator in
//    float32 and rounds once more.
//
// What bounds them on an H100: the GEMM. At 8192^3 bf16 over d = 4 ranks,
// K2 does 2*8192^3 = 1.10 TFLOP a rank (1.112 ms at 989 TFLOP/s) and sends
// 3 chunks of 2048 x 8192 bf16 (100.7 MB, 0.224 ms at 450 GB/s a
// direction); K3 does a quarter of the FLOPs (0.278 ms) and sends the same
// bytes. So the ring hides behind the GEMM when the two overlap.
//
// Design:
//  - One cooperative launch per rank: every block of the grid is resident
//    at once, because blocks spin on flags that other blocks (of this rank
//    and of its neighbours) write. The grid is the occupancy times the SMs.
//  - Peer memory: each rank owns a buffer of flag words and two slots of
//    one chunk. The kernel gets a table of every rank's buffer (NVLink peer
//    pointers from symmetric memory, or one card's memory in loopback).
//  - K2 on bf16/fp16 operands whose rows are multiples of 16 bytes (TMA's
//    rules; the host chooses by dtype and shape): the Hopper tile of
//    hopper_gemm.cuh, one 384-thread block an SM. Its producer warpgroup's
//    TMA thread waits for step t's chunk (the arrival counter), fences the
//    async proxy (a peer wrote the slot with generic stores; TMA reads it)
//    and loads the chunk's 128x256 output tiles stage by stage; the two
//    consumer warpgroups run wgmma and store each tile's rows. The producer
//    warpgroup's other three warps are the puts: at step t they copy this
//    block's share of the chunk held (the local shard at t = 0, else slot
//    t % 2) into the right neighbour's slot (t + 1) % 2 with 16-byte stores
//    and signal its arrival counter, so every block puts and no SM is kept
//    from the GEMM. The steps' tiles go round robin over the blocks as one
//    sequence.
//  - K2 on float32 (SimtTile, K1's f32 kernel) and on 16-bit operands of
//    other widths (WmmaTile, K1's wmma structure), and K3 always: 256
//    threads; the first blocks of K2's grid are put blocks and the rest walk
//    128x128 output tiles.
//  - K3: every block is a GEMM block; the epilogue waits for the received
//    accumulator (so the inbound copy overlaps the main loop), folds it in
//    and stores the sum straight into the right neighbour's slot (or the
//    output at the last step): the put is the epilogue's store.
//  - Credits: after step t >= 1 every block tells the left neighbour that
//    it is done with slot t % 2 (in the Hopper tile: once the puts have
//    read it and every TMA load from it has landed, not merely been
//    issued); a sender waits for all of them before it overwrites that
//    slot at step t + 1. An entry barrier with both neighbours keeps a fast
//    rank's first put out of a slot its neighbour still reads in the
//    previous call, and the last credits are drained.
//  - Flags never reset: each step has its own arrival and credit counter,
//    each grows by the same count every call (the arrival counter by the
//    putting blocks: every block in the Hopper tile, the put blocks
//    otherwise; a ring serves one tile), the host passes the call's epoch
//    (the number of earlier calls on the buffer) and waits compare with
//    >= modulo 2^32. Signals are red.release.sys after a system fence;
//    waits are ld.acquire.sys. Slot data is read through L2 only
//    (cp.async.cg, ld.global.cg, TMA), never from a stale L1 line.
//  - Loopback: gridDim.y = d runs d virtual ranks on one card, each with
//    its own buffer in that card's memory: the same protocol, on one card.
//  - Tensor maps are built on the host for every launch and passed by
//    value (__grid_constant__): per virtual rank the shard, the two slots
//    as one 3-D map and B, 24 maps at most, so the argument struct stays
//    under the classic 4 KB of kernel parameters.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "peer_flags.cuh"

using namespace nvcuda;

namespace {

using namespace peer;

constexpr int MAX_RANKS = 8;
// flag words of a rank's buffer (uint32 offsets, one 128-byte line each):
// ARRIVE + t and CREDIT + t count the signals of ring step t alone (an
// aggregate count would let a block that ran ahead to a later step stand
// in for one still at work on an earlier one)
constexpr int ARRIVE = 0, CREDIT = 32, BARRIER = 64;
constexpr int FLAG_BYTES = 1024;  // the slots start here

struct RingArgs {
  // per virtual rank (blockIdx.y); index 0 only with one rank a process
  const void* a[MAX_RANKS];
  const void* b[MAX_RANKS];
  void* out[MAX_RANKS];
  // per ring rank: the base of its buffer (flags, then two slots)
  unsigned char* buf[MAX_RANKS];
  int rank0;  // ring rank of blockIdx.y == 0
  int d;
  int m_loc, n, k;          // k: K2's full k, K3's k / d
  long long slot_stride;    // elements from slot 0 to slot 1
  int put_blocks;           // K2 only
  unsigned epoch;
};

// ---------------------------------------------------------------------------
// flags
// ---------------------------------------------------------------------------

template <typename Args>
__device__ __forceinline__ unsigned* flags_of(const Args& p, int rank) {
  return reinterpret_cast<unsigned*>(p.buf[rank]);
}

template <typename T, typename Args>
__device__ __forceinline__ T* slot_of(const Args& p, int rank, int slot) {
  return reinterpret_cast<T*>(p.buf[rank] + FLAG_BYTES) + slot * p.slot_stride;
}

// Block (0, y) tells both neighbours that this rank entered the call (its
// previous call is over); every block waits until both neighbours have.
template <typename Args>
__device__ __forceinline__ void entry_barrier(const Args& p, int r) {
  const int d = p.d;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    red_release_add(flags_of(p, (r + d - 1) % d) + BARRIER, 1u);
    red_release_add(flags_of(p, (r + 1) % d) + BARRIER, 1u);
  }
  block_wait(flags_of(p, r) + BARRIER, 2u * (p.epoch + 1u));
}

// Block 0 waits for every credit of the call: the right neighbour has
// finished with the slots we wrote and will signal into us no more.
__device__ __forceinline__ void drain(const unsigned* mine, int d,
                                      unsigned target) {
  if (blockIdx.x != 0) return;
  for (int t = 1; t < d; ++t) block_wait(mine + CREDIT + t, target);
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
// epilogues
// ---------------------------------------------------------------------------

// K2: round each sum once and store it in the chunk's output rows.
template <typename T>
struct StoreRows {
  T* dst;  // the chunk's first output row
  int rows, n;
  __device__ void operator()(int r, int c, const float* v) const {
    if (r < rows && c < n) store8(dst + static_cast<size_t>(r) * n + c, v, n - c);
  }
};

// K3: partial = round(sum); with a received accumulator,
// round(float(partial) + float(acc_in)); stored at dst (the right
// neighbour's slot, or the output at the last step).
template <typename T>
struct StoreFold {
  T* dst;
  const T* acc_in;  // nullptr at step 0
  int rows, n;
  __device__ void operator()(int r, int c, const float* v) const {
    if (r >= rows || c >= n) return;
    const size_t at = static_cast<size_t>(r) * n + c;
    float w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = Cvt<T>::to_float(Cvt<T>::from_float(v[e]));
    if (acc_in != nullptr) {
      for (int e = 0; e < 8 && c + e < n; ++e)
        w[e] += Cvt<T>::to_float(ldcg(acc_in + at + e));
    }
    store8(dst + at, w, n - c);
  }
};

// ---------------------------------------------------------------------------
// K2: ring all-gather + GEMM
// ---------------------------------------------------------------------------

// This block's share of a copy of `bytes` bytes: 16-byte units through L2,
// split into `parts` contiguous ranges; part 0 also copies the tail.
__device__ void copy_part(unsigned char* dst, const unsigned char* src,
                          size_t bytes, int part, int parts) {
  const size_t units = bytes / 16;
  const size_t per = (units + parts - 1) / parts;
  const size_t lo = per * part, hi = lo + per < units ? lo + per : units;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* t = reinterpret_cast<uint4*>(dst);
  for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
    __stcg(t + i, __ldcg(s + i));
  if (part == 0) {
    for (size_t i = units * 16 + threadIdx.x; i < bytes; i += blockDim.x)
      dst[i] = __ldcg(reinterpret_cast<const char*>(src) + i);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ring_ag_matmul_kernel(RingArgs p) {
  using Tile = typename TileFor<T>::type;
  __shared__ __align__(128) unsigned char smem[Tile::SMEM];
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const int right = (r + 1) % d, left = (r + d - 1) % d;
  const unsigned G = gridDim.x, P = p.put_blocks;
  const unsigned e = p.epoch;
  unsigned* mine = flags_of(p, r);
  const T* B = static_cast<const T*>(p.b[y]);
  T* out = static_cast<T*>(p.out[y]);
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = ((p.m_loc + BM - 1) / BM) * tiles_n;
  const size_t chunk_bytes = static_cast<size_t>(p.m_loc) * p.k * sizeof(T);
  Tile tile;

  entry_barrier(p, r);
  for (int t = 0; t < d; ++t) {
    const T* held =
        t == 0 ? static_cast<const T*>(p.a[y]) : slot_of<T>(p, r, t & 1);
    // the chunk of step t has landed: the left neighbour's puts of step t - 1
    if (t > 0) block_wait(mine + ARRIVE + t, (e + 1) * P);
    if (blockIdx.x < P) {
      if (t < d - 1) {
        // every block of the right neighbour is done with the target slot
        // (it read it at its step t - 1)
        if (t >= 2) block_wait(mine + CREDIT + t - 1, (e + 1) * G);
        copy_part(reinterpret_cast<unsigned char*>(slot_of<T>(p, right, (t + 1) & 1)),
                  reinterpret_cast<const unsigned char*>(held), chunk_bytes,
                  blockIdx.x, P);
        block_signal(flags_of(p, right) + ARRIVE + t + 1);
      }
    } else {
      const int chunk = (r - t + d) % d;
      const StoreRows<T> st{out + static_cast<size_t>(chunk) * p.m_loc * p.n,
                            p.m_loc, p.n};
      for (int j = blockIdx.x - P; j < tiles; j += G - P) {
        const int row0 = (j / tiles_n) * BM, col0 = (j % tiles_n) * BN;
        tile.compute(held, B, p.m_loc, p.n, p.k, row0, col0, smem);
        tile.store(row0, col0, smem, st);
      }
    }
    // this block is done with slot t % 2
    if (t > 0) block_signal(flags_of(p, left) + CREDIT + t);
  }
  drain(mine, d, (e + 1) * G);
}

// K2 on the Hopper tile (bf16 / fp16, TMA's widths).
struct RingTmaArgs {
  // per virtual rank (blockIdx.y): the shard [m_loc, k], this rank's two
  // slots as one [2, m_loc, k] map, B [k, n]
  CUtensorMap shard[MAX_RANKS];
  CUtensorMap slots[MAX_RANKS];
  CUtensorMap b[MAX_RANKS];
  const void* a[MAX_RANKS];
  void* out[MAX_RANKS];
  unsigned char* buf[MAX_RANKS];
  int rank0, d;
  int m_loc, n, k;
  long long slot_stride;
  unsigned epoch;
};

template <typename T>
__global__ void __launch_bounds__(hopper::THREADS, 1)
    ring_ag_wgmma_kernel(const __grid_constant__ RingTmaArgs p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_of(smem_raw);
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const int right = (r + 1) % d, left = (r + d - 1) % d;
  const unsigned G = gridDim.x, e = p.epoch;
  unsigned* mine = flags_of(p, r);
  const Tiles tiles(p.m_loc, p.n);

  if (threadIdx.x == 0) init_barriers(sm);
  entry_barrier(p, r);  // its __syncthreads also publishes the barriers
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  if (wg == 0) {
    producer_registers();
    Pipe pipe;
    long long issued = 0;
    for (int t = 0; t < d; ++t) {
      const T* held = t == 0 ? static_cast<const T*>(p.a[y]) : slot_of<T>(p, r, t & 1);
      if (warp == 0) {
        if (t > 0) {
          // the chunk of step t has landed: every block of the left
          // neighbour put its share at step t - 1. The issuing lane
          // acquires it, then orders it before its TMA reads.
          if (threadIdx.x == 0) {
            spin_wait(mine + ARRIVE + t, (e + 1) * G);
            fence_proxy_async();
          }
          __syncwarp();
        }
        const CUtensorMap* a = t == 0 ? &p.shard[y] : &p.slots[y];
        for (int j = first_tile(t * tiles.count); j < tiles.count; j += G) {
          load_tile(sm, pipe, a, t == 0 ? 0 : (t & 1), &p.b[y], tiles.row0(j), tiles.col0(j),
                    p.n, p.k);
          issued += k_blocks(p.k);
        }
        // the credit below may go only once slot t % 2 is read
        if (t > 0) wait_landed(sm, pipe, issued);
      } else if (t < d - 1) {
        const int tid = threadIdx.x - 32;
        if (t > 0) group_wait(mine + ARRIVE + t, (e + 1) * G, tid, BAR_COPY, COPY_THREADS);
        // every block of the right neighbour is done with the target slot
        // (it read it at its step t - 1)
        if (t >= 2)
          group_wait(mine + CREDIT + t - 1, (e + 1) * G, tid, BAR_COPY, COPY_THREADS);
        copy_share(slot_of<T>(p, right, (t + 1) & 1), held,
                   static_cast<size_t>(p.m_loc) * p.k * sizeof(T), blockIdx.x, G, tid,
                   COPY_THREADS);
        group_signal(flags_of(p, right) + ARRIVE + t + 1, tid, BAR_COPY, COPY_THREADS);
      }
      // this block is done with slot t % 2
      if (t > 0) group_signal(flags_of(p, left) + CREDIT + t, threadIdx.x, BAR_PRODUCER, 128);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      for (int t = 1; t < d; ++t) spin_wait(mine + CREDIT + t, (e + 1) * G);
    }
  } else {
    consumer_registers();
    Pipe pipe;
    float acc[128];
    for (int t = 0; t < d; ++t) {
      const int chunk = (r - t + d) % d;
      const StoreRows<T> st{static_cast<T*>(p.out[y]) + static_cast<size_t>(chunk) * p.m_loc * p.n,
                            p.m_loc, p.n};
      for (int j = first_tile(t * tiles.count); j < tiles.count; j += G) {
        mma_tile<T>(sm, pipe, acc, p.k, wg - 1);
        store_tile(sm, acc, wg - 1, tiles.row0(j), tiles.col0(j), st);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: GEMM + ring reduce-scatter
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) ring_matmul_rs_kernel(RingArgs p) {
  using Tile = typename TileFor<T>::type;
  __shared__ __align__(128) unsigned char smem[Tile::SMEM];
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const int right = (r + 1) % d, left = (r + d - 1) % d;
  const unsigned G = gridDim.x;
  const unsigned e = p.epoch;
  unsigned* mine = flags_of(p, r);
  const T* A = static_cast<const T*>(p.a[y]);
  const T* B = static_cast<const T*>(p.b[y]);
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = ((p.m_loc + BM - 1) / BM) * tiles_n;
  Tile tile;

  entry_barrier(p, r);
  for (int t = 0; t < d; ++t) {
    const int chunk = (r + d - 1 - t) % d;
    const T* rows = A + static_cast<size_t>(chunk) * p.m_loc * p.k;
    const StoreFold<T> st{
        t < d - 1 ? slot_of<T>(p, right, (t + 1) & 1) : static_cast<T*>(p.out[y]),
        t > 0 ? slot_of<T>(p, r, t & 1) : nullptr, p.m_loc, p.n};
    bool ready = false;
    for (int j = blockIdx.x; j < tiles; j += G) {
      const int row0 = (j / tiles_n) * BM, col0 = (j % tiles_n) * BN;
      tile.compute(rows, B, p.m_loc, p.n, p.k, row0, col0, smem);
      if (!ready) {
        // the accumulator of step t has landed (the left neighbour's
        // epilogues of step t - 1), and every block of the right neighbour
        // is done with the slot this step writes (its step t - 1)
        if (t > 0) block_wait(mine + ARRIVE + t, (e + 1) * G);
        if (t >= 2 && t < d - 1) block_wait(mine + CREDIT + t - 1, (e + 1) * G);
        ready = true;
      }
      tile.store(row0, col0, smem, st);
    }
    if (t < d - 1) block_signal(flags_of(p, right) + ARRIVE + t + 1);
    if (t > 0) block_signal(flags_of(p, left) + CREDIT + t);
  }
  drain(mine, d, (e + 1) * G);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
int launch(K kernel, RingArgs& p, int vranks, bool puts, cudaStream_t s) {
  int blocks = 0;
  int rc = grid_for(kernel, THREADS, 0, vranks, &blocks);
  if (rc != 0) return rc;
  // K2: one put block for every eight, at most 16
  const int share = blocks / 8 < 1 ? 1 : blocks / 8;
  p.put_blocks = puts ? (share < 16 ? share : 16) : 0;
  return launch_coop(kernel, p, blocks, vranks, THREADS, 0, s);
}

// K2 on the Hopper tile: the tensor maps of every virtual rank, then one
// launch of hopper::THREADS-thread blocks with hopper::SMEM_BYTES each.
template <typename T>
int launch_wgmma(int dtype, const RingArgs& q, int vranks, cudaStream_t s) {
  RingTmaArgs p;
  const long long slot_bytes = q.slot_stride * static_cast<long long>(sizeof(T));
  if (slot_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int y = 0; y < vranks; ++y) {
    const unsigned char* slots = q.buf[q.rank0 + y] + FLAG_BYTES;
    if (!hopper::tma_ok(q.a[y], q.k) || !hopper::tma_ok(q.b[y], q.n) ||
        !hopper::tma_ok(slots, q.k))
      return static_cast<int>(cudaErrorInvalidValue);
    int rc = hopper::encode_a(&p.shard[y], dtype, q.a[y], q.m_loc, q.k, 1, 0);
    if (rc == 0) rc = hopper::encode_a(&p.slots[y], dtype, slots, q.m_loc, q.k, 2, slot_bytes);
    if (rc == 0) rc = hopper::encode_b(&p.b[y], dtype, q.b[y], q.k, q.n);
    if (rc != 0) return rc;
    p.a[y] = q.a[y];
    p.out[y] = q.out[y];
  }
  for (int i = 0; i < q.d; ++i) p.buf[i] = q.buf[i];
  p.rank0 = q.rank0;
  p.d = q.d;
  p.m_loc = q.m_loc;
  p.n = q.n;
  p.k = q.k;
  p.slot_stride = q.slot_stride;
  p.epoch = q.epoch;
  int blocks = 0;
  const int rc = grid_for(ring_ag_wgmma_kernel<T>, hopper::THREADS, hopper::SMEM_BYTES,
                          vranks, &blocks);
  if (rc != 0) return rc;
  return launch_coop(ring_ag_wgmma_kernel<T>, p, blocks, vranks, hopper::THREADS,
                     hopper::SMEM_BYTES, s);
}

int fill(RingArgs& p, const unsigned long long* a, const unsigned long long* b,
         const unsigned long long* out, const unsigned long long* buf,
         int rank0, int vranks, int d, int m_loc, int n, int k,
         long long slot_stride, unsigned epoch) {
  if (d < 1 || d > MAX_RANKS || vranks < 1 || rank0 < 0 || rank0 + vranks > d)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < vranks; ++i) {
    p.a[i] = reinterpret_cast<const void*>(a[i]);
    p.b[i] = reinterpret_cast<const void*>(b[i]);
    p.out[i] = reinterpret_cast<void*>(out[i]);
  }
  for (int i = 0; i < d; ++i) p.buf[i] = reinterpret_cast<unsigned char*>(buf[i]);
  p.rank0 = rank0;
  p.d = d;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.slot_stride = slot_stride;
  p.put_blocks = 0;
  p.epoch = epoch;
  return 0;
}

// GEMM tiles (the host's choice, by dtype and shape)
constexpr int TILE_SIMT = 0, TILE_WMMA = 1, TILE_WGMMA = 2;

// Whether `tile` computes `dtype` (0 = float32, 1 = float16, 2 = bfloat16)
// for kernel `kind`: float32 on SimtTile, 16-bit on WmmaTile, and K2's
// 16-bit on the Hopper tile.
bool tile_takes(int kind, int dtype, int tile) {
  if (dtype < 0 || dtype > 2) return false;
  if (dtype == 0) return tile == TILE_SIMT;
  return tile == TILE_WMMA || (kind == 0 && tile == TILE_WGMMA);
}

template <typename T>
int run(int kind, int dtype, int tile, RingArgs& p, int vranks, cudaStream_t s) {
  if (tile == TILE_WGMMA) {
    if constexpr (sizeof(T) == 2) return launch_wgmma<T>(dtype, p, vranks, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kind == 0 ? launch(ring_ag_matmul_kernel<T>, p, vranks, true, s)
                   : launch(ring_matmul_rs_kernel<T>, p, vranks, false, s);
}

}  // namespace

extern "C" {

// kind: 0 = K2 ring_ag_matmul, 1 = K3 ring_matmul_rs.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// tile: 0 = SimtTile (float32), 1 = WmmaTile (16-bit), 2 = the Hopper tile
// (K2, 16-bit, k and n times 2 bytes multiples of 16, 16-byte aligned
// operands and slots).
// a, b, out: vranks device pointers each (the operands and output of ring
// ranks rank0 .. rank0 + vranks - 1); buf: d device pointers, each rank's
// buffer (FLAG_BYTES of zeroed flags, then two slots slot_stride elements
// apart) as this process addresses it. K2: a [m_loc, k], b [k, n],
// out [d * m_loc, n]; K3: a [d * m_loc, k], b [k, n], out [m_loc, n].
int ddlb_ring_matmul(int kind, int dtype, int tile, const unsigned long long* a,
                     const unsigned long long* b, const unsigned long long* out,
                     const unsigned long long* buf, int rank0, int vranks,
                     int d, int m_loc, int n, int k, long long slot_stride,
                     unsigned epoch, void* stream) {
  RingArgs p;
  int rc = fill(p, a, b, out, buf, rank0, vranks, d, m_loc, n, k, slot_stride,
                epoch);
  if (rc != 0 || (kind != 0 && kind != 1) || !tile_takes(kind, dtype, tile)) {
    return rc != 0 ? rc : static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run<float>(kind, dtype, tile, p, vranks, s);
    case 1:
      return run<__half>(kind, dtype, tile, p, vranks, s);
    default:
      return run<__nv_bfloat16>(kind, dtype, tile, p, vranks, s);
  }
}

// Blocks a virtual rank gets in a launch of `vranks` ranks on `tile` (the
// counters' increments a step depend on it), or a negative cudaError.
int ddlb_ring_blocks(int kind, int dtype, int tile, int vranks) {
  if ((kind != 0 && kind != 1) || !tile_takes(kind, dtype, tile))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, rc = 0;
  if (tile == TILE_WGMMA) {
    rc = dtype == 1 ? grid_for(ring_ag_wgmma_kernel<__half>, hopper::THREADS,
                               hopper::SMEM_BYTES, vranks, &blocks)
                    : grid_for(ring_ag_wgmma_kernel<__nv_bfloat16>, hopper::THREADS,
                               hopper::SMEM_BYTES, vranks, &blocks);
    return rc != 0 ? -rc : blocks;
  }
  switch (dtype * 2 + kind) {
    case 0: rc = grid_for(ring_ag_matmul_kernel<float>, THREADS, 0, vranks, &blocks); break;
    case 1: rc = grid_for(ring_matmul_rs_kernel<float>, THREADS, 0, vranks, &blocks); break;
    case 2: rc = grid_for(ring_ag_matmul_kernel<__half>, THREADS, 0, vranks, &blocks); break;
    case 3: rc = grid_for(ring_matmul_rs_kernel<__half>, THREADS, 0, vranks, &blocks); break;
    case 4: rc = grid_for(ring_ag_matmul_kernel<__nv_bfloat16>, THREADS, 0, vranks, &blocks); break;
    default: rc = grid_for(ring_matmul_rs_kernel<__nv_bfloat16>, THREADS, 0, vranks, &blocks); break;
  }
  return rc != 0 ? -rc : blocks;
}

int ddlb_ring_flag_bytes() { return FLAG_BYTES; }

const char* ddlb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
