// K1: tiled GEMM C[m, n] = A[m, k] @ B[k, n], row-major, f32 accumulation.
//
// Replaces the TPU kernel ddlb_tpu/ops/matmul.py::matmul (_matmul_kernel):
// a Pallas grid (m, n, k) with k innermost, a float32 VMEM accumulator
// carried across the k steps and flushed in the operand dtype.
//
// What bounds it on an H100: at the main path's 8192^3 bf16 the work is
// 2*m*n*k = 1.1 TFLOP against 3 x 128 MiB of operands, about 2,700 FLOP per
// byte, far above the card's ~295 FLOP/byte balance point. So the bf16
// tensor cores bound it (989 TFLOP/s dense: 1.11 ms), not memory.
//
// What the design does about it, by tile (the wrapper's tile_for picks one):
//  - wgmma (bf16/fp16 whose rows of A and B are multiples of 16 bytes, TMA's
//    rule): gemm_wgmma runs the Hopper GEMM tile of hopper_gemm.cuh, the one
//    K2 and K6 run, as it is: one persistent 384-thread block an SM walks
//    the 128 x 256 output tiles, grouped eight tile rows at a time so a
//    wave's blocks share panels of A and B in L2; the producer warp keeps
//    a 4-stage ring of TMA loads (A [128, 64], B [64, 256], 128-byte
//    swizzle) in flight while two consumer warpgroups run wgmma.m64n256k16
//    with float32 sums in registers, and one tile's epilogue overlaps the
//    next tile's loads. The epilogue (StoreC) masks the ragged rows, rounds
//    each sum once to the operand dtype and stores 16 bytes. TMA fills
//    loads past the edge with zeros. The tile's geometry comes from
//    hopper::Tiles alone: this file's own BM/BN below name the wmma tile.
//  - wmma (other 16-bit widths): a 128x128 block tile walks k in steps of
//    32. A and B tiles are staged through shared memory with cp.async, two
//    stages deep, rows padded by 16 bytes against bank conflicts. Eight
//    warps each own a 64x32 sub-tile as 4x2 16x16x16 wmma fragments with
//    float accumulators, the counterpart of the TPU kernel's f32 VMEM
//    accumulator; the loop over k inside the block replaces the TPU's
//    sequential k grid axis, since blocks run in no order on 132 SMs.
//    Chunks past the ragged edge (or not 16-byte aligned) are loaded
//    element by element and zero-filled; the epilogue rounds each f32 sum
//    once to the operand dtype and writes with masks.
//  - simt (float32): a tiled SIMT kernel (128x128x8 block tile, 8x8
//    outputs per thread) with fmaf in true f32. No TF32: the f32
//    validation contract (atol = 1e-4 * k) needs the full mantissa.
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

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// bf16 / fp16 on the tensor cores (wmma)
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;                  // 64 rows per warp
constexpr int WN = BN / WARPS_N;                  // 32 columns per warp
constexpr int FM = WM / 16, FN = WN / 16;         // 4 x 2 fragments per warp
constexpr int PAD = 8;                            // 16 bytes of 2-byte types
constexpr int LDA = BK + PAD;                     // 40 elements, 80 bytes
constexpr int LDB = BN + PAD;                     // 136 elements, 272 bytes
constexpr int A_TILE = BM * LDA;
constexpr int B_TILE = BK * LDB;
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 2;  // 37,888
constexpr int EPI_BYTES = (THREADS / 32) * 16 * 16 * 4;      // 8,192
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert(EPI_BYTES <= SMEM_BYTES, "epilogue scratch aliases the tiles");
static_assert((BM * BK / 8) % THREADS == 0 && (BK * BN / 8) % THREADS == 0,
              "every thread copies the same number of 16-byte chunks");

template <typename T>
struct Cvt;
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half_rn(x);
  }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
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

// Eight consecutive elements (r, c..c+7) of a rows x cols row-major matrix
// into shared memory: one 16-byte cp.async when the chunk is whole and
// aligned, else element by element with zeros past the edge.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int r, int c,
                                           int rows, int cols) {
  if (r < rows && c + 8 <= cols) {
    const T* p = src + static_cast<size_t>(r) * cols + c;
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      cp_async16(dst, p);
      return;
    }
  }
  const T zero = Cvt<T>::from_float(0.0f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = (r < rows && c + e < cols)
                 ? src[static_cast<size_t>(r) * cols + c + e]
                 : zero;
  }
}

template <typename T>
__device__ __forceinline__ void load_tiles(T* as, T* bs, const T* A,
                                           const T* B, int m, int n, int k,
                                           int row0, int col0, int k0,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
    load_chunk(as + r * LDA + cc, A, row0 + r, k0 + cc, m, k);
  }
#pragma unroll
  for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    load_chunk(bs + r * LDB + cc, B, k0 + r, col0 + cc, k, n);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gemm_wmma(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int m, int n, int k) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);  // STAGES x [BM][LDA]
  T* Bs = As + STAGES * A_TILE;        // STAGES x [BK][LDB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (k + BK - 1) / BK;
  if (ktiles > 0) load_tiles(As, Bs, A, B, m, n, k, row0, col0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      const int nxt = (kt + 1) % STAGES;
      load_tiles(As + nxt * A_TILE, Bs + nxt * B_TILE, A, B, m, n, k, row0,
                 col0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed
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
        wmma::load_matrix_sync(fa[i], as + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is free for the copy two tiles ahead
  }

  // Epilogue: each warp spills one fragment at a time to its own 16x16 f32
  // scratch (aliasing the now idle tiles), rounds once to T and writes 8
  // consecutive outputs per lane, masked at the ragged edge.
  float* scratch = reinterpret_cast<float*>(smem) + warp * 16 * 16;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wm * WM + i * 16 + r;
      const int gc = col0 + wn * WN + j * 16 + c;
      if (gr < m) {
        alignas(16) T vals[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = Cvt<T>::from_float(scratch[r * 16 + c + e]);
        T* dst = C + static_cast<size_t>(gr) * n + gc;
        if (gc + 8 <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
        } else {
          for (int e = 0; e < 8 && gc + e < n; ++e) dst[e] = vals[e];
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the SIMT cores
// ---------------------------------------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 8, FT = 8;  // 8x8 outputs a thread
constexpr int F_THREADS = (FBM / FT) * (FBN / FT);    // 256
constexpr int F_PAD = 4;

__global__ void __launch_bounds__(F_THREADS)
    gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int m, int n, int k) {
  __shared__ __align__(16) float As[FBK][FBM + F_PAD];  // A tile, k-major
  __shared__ __align__(16) float Bs[FBK][FBN + F_PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (FBN / FT), ty = tid / (FBN / FT);
  const int row0 = blockIdx.y * FBM, col0 = blockIdx.x * FBN;

  float acc[FT][FT];
#pragma unroll
  for (int i = 0; i < FT; ++i)
#pragma unroll
    for (int j = 0; j < FT; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += FBK) {
    {  // A: 128 x 8, four elements a thread, stored transposed
      const int r = tid / 2, c = (tid % 2) * 4, gr = row0 + r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gc = k0 + c + e;
        As[c + e][r] =
            (gr < m && gc < k) ? A[static_cast<size_t>(gr) * k + gc] : 0.0f;
      }
    }
    {  // B: 8 x 128, four elements a thread
      const int r = tid / 32, c = (tid % 32) * 4, gr = k0 + r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gc = col0 + c + e;
        Bs[r][c + e] =
            (gr < k && gc < n) ? B[static_cast<size_t>(gr) * n + gc] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[FT], b[FT];
      const float4* ap = reinterpret_cast<const float4*>(&As[kk][ty * FT]);
      const float4* bp = reinterpret_cast<const float4*>(&Bs[kk][tx * FT]);
      const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < FT; ++i)
#pragma unroll
        for (int j = 0; j < FT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FT; ++i) {
    const int gr = row0 + ty * FT + i;
    if (gr >= m) break;
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      const int gc = col0 + tx * FT + j;
      if (gc < n) C[static_cast<size_t>(gr) * n + gc] = acc[i][j];
    }
  }
}

template <int TILE_M, int TILE_N>
dim3 grid_for(int m, int n) {
  return dim3((n + TILE_N - 1) / TILE_N, (m + TILE_M - 1) / TILE_M);
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 / fp16 on the Hopper GEMM tile (hopper_gemm.cuh): TMA + wgmma
// ---------------------------------------------------------------------------

namespace k1_hopper {

struct Args {
  CUtensorMap a;  // A [m, k], boxes of 128 rows x 64 k
  CUtensorMap b;  // B [k, n], boxes of 64 k x 64 columns
  void* c;        // C [m, n]
  int m, n, k;
};

// Eight consecutive sums of row r from column col, rounded once to T and
// stored 16 bytes at a time (n is a multiple of 8, so a chunk that starts
// inside the row ends inside it); rows past m are not stored.
template <typename T>
struct StoreC {
  T* c;
  int m, n;
  __device__ void operator()(int r, int col, const float* v) const {
    if (r >= m || col >= n) return;
    alignas(16) T vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = Cvt<T>::from_float(v[e]);
    *reinterpret_cast<uint4*>(c + static_cast<size_t>(r) * n + col) =
        *reinterpret_cast<const uint4*>(vals);
  }
};

template <typename T>
__global__ void __launch_bounds__(hopper::THREADS, 1)
    gemm_wgmma(const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  const hopper::Smem sm = hopper::smem_of(smem_raw);
  const hopper::Tiles tiles(p.m, p.n);
  if (threadIdx.x == 0) hopper::init_barriers(sm);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    if (threadIdx.x / 32 == 0) {
      hopper::Pipe pipe;
      for (int j = blockIdx.x; j < tiles.count; j += gridDim.x) {
        const hopper::Raster at(tiles, p.m, j);
        hopper::load_tile(sm, pipe, &p.a, 0, &p.b, at.row0, at.col0, p.n, p.k);
      }
    }
  } else {
    hopper::consumer_registers();
    hopper::Pipe pipe;
    float acc[128];
    const StoreC<T> st{static_cast<T*>(p.c), p.m, p.n};
    for (int j = blockIdx.x; j < tiles.count; j += gridDim.x) {
      const hopper::Raster at(tiles, p.m, j);
      hopper::mma_tile<T>(sm, pipe, acc, p.k, wg - 1);
      hopper::store_tile(sm, acc, wg - 1, at.row0, at.col0, st);
    }
  }
}

// One block an SM, or one a tile when there are fewer tiles.
template <typename T>
int launch(int dtype, const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t s) {
  if (k < 1 || !hopper::tma_ok(a, k) || !hopper::tma_ok(b, n) || !hopper::tma_ok(c, n))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  int rc = hopper::encode_a(&p.a, dtype, a, m, k, 1, 0);
  if (rc == 0) rc = hopper::encode_b(&p.b, dtype, b, k, n);
  if (rc != 0) return rc;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_wgmma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             hopper::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long count = static_cast<long long>((m + hopper::BM - 1) / hopper::BM) *
                          ((n + hopper::BN - 1) / hopper::BN);
  const int blocks = static_cast<int>(count < sms ? count : sms);
  gemm_wgmma<T><<<blocks, hopper::THREADS, hopper::SMEM_BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k1_hopper

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; tile: 0 = simt (float32),
// 1 = wmma, 2 = wgmma (16-bit dtypes). m, n >= 1; k >= 0 (k >= 1 on wgmma).
int ddlb_matmul(int dtype, int tile, const void* a, const void* b, void* c, int m,
                int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype == 0) != (tile == 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 2) {
    if (dtype == 1) return k1_hopper::launch<__half>(dtype, a, b, c, m, n, k, s);
    if (dtype == 2) return k1_hopper::launch<__nv_bfloat16>(dtype, a, b, c, m, n, k, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile != 0 && tile != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      gemm_f32<<<grid_for<FBM, FBN>(m, n), F_THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), m, n, k);
      break;
    case 1:
      gemm_wmma<__half><<<grid_for<BM, BN>(m, n), THREADS, 0, s>>>(
          static_cast<const __half*>(a), static_cast<const __half*>(b),
          static_cast<__half*>(c), m, n, k);
      break;
    case 2:
      gemm_wmma<__nv_bfloat16><<<grid_for<BM, BN>(m, n), THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b),
          static_cast<__nv_bfloat16*>(c), m, n, k);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ddlb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
