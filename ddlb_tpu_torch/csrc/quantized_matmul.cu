// K7: int8 GEMM with a dequantizing epilogue,
//   C[m, n] = cast((float)(A[m, k] @ B[k, n] in int32) * sa[m] * sb[n]),
// A and B int8 row-major, sa [m, 1] and sb [1, n] float32, C bf16, fp16 or
// float32 row-major.
//
// Replaces the TPU kernel ddlb_tpu/ops/quantized_matmul.py::int8_matmul_pallas
// (_int8_kernel): a Pallas grid (m, n, k) with k innermost, an int32 VMEM
// accumulator carried across the k steps, and the epilogue
// acc.astype(f32) * sa * sb applied once at the last k step.
//
// What bounds it on an H100: at 8192^3 the work is 2*m*n*k = 1.1 TOP
// against 2 x 64 MiB of int8 operands and a 128 MiB bf16 result, far above
// the card's balance point, so the int8 tensor cores bound it (1,979 TOP/s
// dense: 0.556 ms). At the decode MLP's 8 rows it is the other way round:
// B's 16 MiB are the work, a few microseconds at 3.35 TB/s.
//
// What the design does about it (simple and right first; wgmma, TMA,
// small-m tiles and split-k are later work):
//  - A 128x128 block tile walks k in steps of 64 bytes. A and B tiles are
//    staged through shared memory with cp.async, two stages deep, so the
//    next tile's copy overlaps this tile's tensor-core work; the loop over
//    k inside the block replaces the TPU's sequential k grid axis.
//  - Eight warps each own a 64x32 sub-tile as 4x4 mma.sync m16n8k32 s8
//    fragments with int32 accumulators in registers. A's fragments come
//    from shared memory by ldmatrix (rows padded to 80 bytes: conflict
//    free).
//  - B stays [k, n] row-major, as the public function takes it, but the
//    mma's B fragment holds four consecutive k of one column. Each thread
//    loads a 4x4 byte block (four k rows, four columns) as four 32-bit
//    words and transposes it with eight __byte_perm: one word per column.
//    The warp's n8 fragment j then covers columns 4g + j (g the lane's
//    group), so a thread's outputs are eight consecutive columns. Staged
//    B rows are stored in the order (k % 4, k / 4) with a 160-byte pitch,
//    which makes those loads conflict free.
//  - Exact: |acc| <= 127^2 * k stays below 2^31 for k <= 133,143 (the
//    wrapper refuses longer k). The epilogue converts acc with round to
//    nearest and multiplies by sa, then by sb, each rounded (no addition,
//    nothing to contract), then rounds once to bf16/fp16: the JAX
//    epilogue's arithmetic, bit for bit.
//  - Any m, n >= 1 and k >= 0: 16-byte chunks past an edge (or not 16-byte
//    aligned) are loaded byte by byte with zeros beyond it, and wholly
//    outside chunks are zero-stored without a read; the epilogue masks its
//    stores.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;      // block tile; BK in bytes
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;                 // 64 rows per warp
constexpr int WN = BN / WARPS_N;                 // 32 columns per warp
constexpr int FM = WM / 16;                      // 4 m16 fragments
constexpr int FN = WN / 8;                       // 4 n8 fragments
constexpr int LDA = BK + 16;                     // 80-byte A rows
constexpr int LDB = BN + 32;                     // 160-byte B rows
constexpr int A_TILE = BM * LDA;                 // 10,240 bytes
constexpr int B_TILE = BK * LDB;                 // 10,240 bytes
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE);  // 40,960
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert((BM * BK / 16) % THREADS == 0 && (BK * BN / 16) % THREADS == 0,
              "every thread copies the same number of 16-byte chunks");

template <typename T>
struct Out;
template <>
struct Out<float> {
  static __device__ __forceinline__ float from_float(float x) { return x; }
};
template <>
struct Out<__half> {
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half_rn(x);
  }
};
template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
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

// Sixteen consecutive bytes (r, c..c+15) of a rows x cols row-major int8
// matrix into shared memory: one cp.async when the chunk is whole and
// aligned, a zero store when it lies wholly outside, else byte by byte with
// zeros past the edge.
__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* src,
                                           int r, int c, int rows, int cols) {
  if (r >= rows || c >= cols) {
    *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    return;
  }
  const int8_t* p = src + static_cast<size_t>(r) * cols + c;
  if (c + 16 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(dst, p);
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) dst[e] = (c + e < cols) ? p[e] : int8_t(0);
}

// Staged B row of the tile's k row kl: rows are stored in the order
// (kl % 4, kl / 4), so the four k rows a thread reads for one fragment lie
// 16 rows (2,560 bytes) apart and the warp's 32 loads hit 32 banks.
__device__ __forceinline__ int b_row(int kl) { return (kl % 4) * (BK / 4) + kl / 4; }

__device__ __forceinline__ void load_tiles(int8_t* as, int8_t* bs,
                                           const int8_t* A, const int8_t* B,
                                           int m, int n, int k, int row0,
                                           int col0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < (BM * BK / 16) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BK / 16), cc = (c % (BK / 16)) * 16;
    load_chunk(as + r * LDA + cc, A, row0 + r, k0 + cc, m, k);
  }
#pragma unroll
  for (int i = 0; i < (BK * BN / 16) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
    load_chunk(bs + b_row(r) * LDB + cc, B, k0 + r, col0 + cc, k, n);
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four registers of an m16 x k32 A fragment: rows (g, g + 8) x bytes
// (4t.., 16 + 4t..), as ldmatrix.x4 delivers four 8x16-byte matrices.
__device__ __forceinline__ void load_a(uint32_t* a, const int8_t* tile,
                                       int lane) {
  const int q = lane / 8;
  const int8_t* p = tile + ((q % 2) * 8 + lane % 8) * LDA + (q / 2) * 16;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// Words w[r] hold bytes (row r, columns 0..3) of a 4x4 byte block; returns
// in v[j] the bytes (rows 0..3, column j): the k-major fragment register.
__device__ __forceinline__ void transpose4x4(uint32_t* v, const uint32_t* w) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  v[0] = __byte_perm(x0, y0, 0x5410);
  v[1] = __byte_perm(x0, y0, 0x7632);
  v[2] = __byte_perm(x1, y1, 0x5410);
  v[3] = __byte_perm(x1, y1, 0x7632);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
              const float* __restrict__ sa, const float* __restrict__ sb,
              T* __restrict__ C, int m, int n, int k) {
  __shared__ __align__(128) int8_t smem[SMEM_BYTES];
  int8_t* As = smem;                   // STAGES x [BM][LDA]
  int8_t* Bs = smem + STAGES * A_TILE;  // STAGES x [BK][LDB], rows permuted

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  int acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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

    const int8_t* as = As + (kt % STAGES) * A_TILE + wm * WM * LDA;
    const int8_t* bs = Bs + (kt % STAGES) * B_TILE + wn * WN + 4 * g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) load_a(a[i], as + i * 16 * LDA + kk, lane);
      // B: k rows kk + 16h + 4t + r (r = 0..3) of columns 4g..4g+3
      uint32_t b[FN][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(
              bs + b_row(kk + 16 * h + 4 * t + r) * LDB);
        transpose4x4(v, w);
#pragma unroll
        for (int j = 0; j < FN; ++j) b[j][h] = v[j];
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the stage is free for the copy two tiles ahead
  }

  // Epilogue. Fragment j's accumulator e holds row g (e < 2) or g + 8 and
  // mma column 2t + e % 2, which is column 4 * (2t + e % 2) + j of the
  // warp's 32: a thread owns columns 8t..8t+7 of each of its rows.
  const int c0 = col0 + wn * WN + 8 * t;
  float col_scale[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) col_scale[e] = (c0 + e < n) ? sb[c0 + e] : 0.0f;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * WM + i * 16 + g + 8 * half;
      if (r >= m) continue;
      const float row_scale = sa[r];
      alignas(16) T vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int a = acc[i][e % 4][2 * half + e / 4];
        vals[e] = Out<T>::from_float(
            __fmul_rn(__fmul_rn(__int2float_rn(a), row_scale), col_scale[e]));
      }
      T* dst = C + static_cast<size_t>(r) * n + c0;
      if (c0 + 8 <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
        for (int v = 0; v < static_cast<int>(8 * sizeof(T) / 16); ++v)
          reinterpret_cast<uint4*>(dst)[v] =
              reinterpret_cast<const uint4*>(vals)[v];
      } else {
        for (int e = 0; e < 8 && c0 + e < n; ++e) dst[e] = vals[e];
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           void* c, int m, int n, int k, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_gemm<T><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<T*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = float16, 2 = bfloat16. m, n >= 1; k >= 0.
int ddlb_int8_matmul(int out_dtype, const void* aq, const void* bq,
                     const void* sa, const void* sb, void* out, int m, int n,
                     int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return launch<float>(aq, bq, sa, sb, out, m, n, k, s);
    case 1:
      return launch<__half>(aq, bq, sa, sb, out, m, n, k, s);
    case 2:
      return launch<__nv_bfloat16>(aq, bq, sa, sb, out, m, n, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ddlb_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
