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
// What the design does about it (simple and right first; wgmma, TMA and
// persistent scheduling are later work):
//  - bf16/fp16: a 128x128 block tile walks k in steps of 32. A and B tiles
//    are staged through shared memory with cp.async, two stages deep, so
//    the next tile's copy overlaps this tile's tensor-core work. Rows are
//    padded by 16 bytes against bank conflicts. Eight warps each own a
//    64x32 sub-tile as 4x2 16x16x16 wmma fragments with float
//    accumulators, the counterpart of the TPU kernel's f32 VMEM
//    accumulator; the loop over k inside the block replaces the TPU's
//    sequential k grid axis, since blocks run in no order on 132 SMs.
//    Chunks past the ragged edge (or not 16-byte aligned) are loaded
//    element by element and zero-filled; the epilogue rounds each f32 sum
//    once to the operand dtype and writes with masks.
//  - float32: a tiled SIMT kernel (128x128x8 block tile, 8x8 outputs per
//    thread) with fmaf in true f32. No TF32: the f32 validation contract
//    (atol = 1e-4 * k) needs the full mantissa.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. m, n >= 1; k >= 0.
int ddlb_matmul(int dtype, const void* a, const void* b, void* c, int m,
                int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
