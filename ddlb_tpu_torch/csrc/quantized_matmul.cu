// K7: int8 GEMM with a dequantizing epilogue,
//   C[m, n] = cast((float)(A[m, k] @ B[k, n] in int32) * sa[m] * sb[n]),
// A int8 row-major, B int8 row-major or column-major (k contiguous), sa
// [m, 1] and sb [1, n] float32, C bf16, fp16 or float32 row-major.
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
// B's 16 MiB are the work, 5 us at 3.35 TB/s.
//
// Three kernels; the wrapper's tile_for picks one:
//  - wgmma (TMA's widths: k a multiple of 16, 16-byte aligned bases; B
//    column-major; m > 64): int8_gemm_wgmma, the Hopper GEMM tile of
//    hopper_gemm.cuh in int8. One persistent 384-thread block an SM walks
//    the 128 x 256 output tiles in hopper::Raster's grouped order; a
//    producer warp keeps a 4-stage ring of TMA loads in flight (A [128
//    rows, 128 k], B [256 columns, 128 k], both K-major, 128-byte
//    swizzle: 48 KB a stage, the header's bf16 stage in bytes, so its
//    stage ring, barriers and tile order serve unchanged); two
//    consumer warpgroups run wgmma.m64n256k32.s32.s8.s8 with int32 sums in
//    registers (128 a thread). The epilogue hands each warp's 16 x 32
//    output boxes to TMA stores, two in flight a warp, so the output's
//    bytes drain under the next tile's products (at the prefill's k = 2048
//    and float32 output they are half a tile's time); output rows that are
//    not a multiple of 16 bytes take a staged, masked store instead. s8
//    wgmma reads both operands K-major only (it has no transpose bit for
//    8-bit types), so B must reach shared memory as [n, k] rows: the port
//    keeps its quantized weights column-major from the moment they are
//    made, and the TMA box of B is then 256 rows of 128 bytes, A's form.
//  - small_m (the same widths, m <= 64: decode): int8_gemm_small_m, a tile
//    for the bytes. The operands swap, C^T = B^T A^T: 64 rows of the
//    K-major weight are wgmma's A operand and the m K-major activation
//    rows, zero-padded by TMA to N = 8, 16, 32 or 64, its B operand
//    (m64nNk32), so no tensor-core row is wasted on padding. A block of
//    one warpgroup streams its 64 weight rows through a 4-stage TMA ring.
//    The weight's 64-row tiles are too few to fill the card (w2 of the
//    decode MLP has 32), so k is split too: the grid is (n / 64 tiles, k
//    splits), about four blocks an SM, all resident at once. Each split
//    adds its int32 sums into a workspace with atomicAdd (integer
//    addition: exact, and the same result in any order), and the last
//    block of a tile to arrive (an arrival counter a tile) runs the
//    epilogue once on the full sums, then zeroes its sums and its counter,
//    so the workspace is zero again for the next launch. With one split
//    the block runs the epilogue from its own registers.
//  - mma (any widths and layouts; k % 16 != 0 or unaligned bases): the
//    first design. A 128x128 block tile walks k in steps of 64 bytes
//    staged by cp.async two deep into mma.sync m16n8k32 s8 fragments; A's
//    come by ldmatrix. A row-major B is turned into K-major fragments in
//    registers (each thread loads a 4x4 byte block and transposes it with
//    eight __byte_perm); a column-major B is staged as [n, k] rows and
//    its fragments are plain 32-bit words (KMAJOR). Chunks past an edge
//    (or not 16-byte aligned) are loaded byte by byte with zeros beyond
//    it.
//
// Exact on every kernel: |acc| <= 127^2 * k stays below 2^31 for k <=
// 133,143 (the wrapper refuses longer k). The epilogue converts acc with
// round to nearest (__int2float_rn, once) and multiplies by sa, then by sb,
// each rounded (__fmul_rn: no addition, nothing to contract), then rounds
// once to bf16/fp16: the JAX epilogue's arithmetic, bit for bit.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing (small_m's workspace is the caller's).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;      // block tile; BK in bytes
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;                 // 64 rows per warp
constexpr int WN = BN / WARPS_N;                 // 32 columns per warp
constexpr int FM = WM / 16;                      // 4 m16 fragments
constexpr int FN = WN / 8;                       // 4 n8 fragments
constexpr int LDA = BK + 16;                     // 80-byte A rows (K-major B rows too)
constexpr int LDB = BN + 32;                     // 160-byte row-major B rows
constexpr int A_TILE = BM * LDA;                 // 10,240 bytes
constexpr int B_TILE = BK * LDB;                 // 10,240 bytes
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE);  // 40,960
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert(BN * LDA == B_TILE, "a K-major B tile fills a row-major one's room");
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

// The epilogue of one sum: converted once, scaled by its row's and then its
// column's scale, each product rounded, then rounded once to T.
template <typename T>
__device__ __forceinline__ T dequantize(int acc, float row_scale, float col_scale) {
  return Out<T>::from_float(
      __fmul_rn(__fmul_rn(__int2float_rn(acc), row_scale), col_scale));
}

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

// Staged row of a K-major B tile's column nl: columns are stored in the
// order (nl % 4, nl / 4), so the columns 4g + j (g = 0..7) of a warp's
// fragment j lie in consecutive 80-byte rows and the warp's 32 word loads
// hit 32 banks.
__device__ __forceinline__ int bt_row(int nl) { return (nl % 4) * (BN / 4) + nl / 4; }

template <bool KMAJOR>
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
    if (KMAJOR) {  // B^T [n, k] row-major: column col0 + r, bytes k0 + cc..
      const int r = c / (BK / 16), cc = (c % (BK / 16)) * 16;
      load_chunk(bs + bt_row(r) * LDA + cc, B, col0 + r, k0 + cc, n, k);
    } else {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      load_chunk(bs + b_row(r) * LDB + cc, B, k0 + r, col0 + cc, k, n);
    }
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

// The mma tile. The warp's n8 fragment j covers columns 4g + j of its 32
// (g the lane's group), with either layout of B, so a thread's outputs are
// eight consecutive columns.
template <typename T, bool KMAJOR>
__global__ void __launch_bounds__(THREADS)
    int8_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
              const float* __restrict__ sa, const float* __restrict__ sb,
              T* __restrict__ C, int m, int n, int k) {
  __shared__ __align__(128) int8_t smem[SMEM_BYTES];
  int8_t* As = smem;                   // STAGES x [BM][LDA]
  int8_t* Bs = smem + STAGES * A_TILE;  // STAGES x [BK][LDB] or [BN][LDA], rows permuted

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
  if (ktiles > 0) load_tiles<KMAJOR>(As, Bs, A, B, m, n, k, row0, col0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      const int nxt = (kt + 1) % STAGES;
      load_tiles<KMAJOR>(As + nxt * A_TILE, Bs + nxt * B_TILE, A, B, m, n, k, row0,
                         col0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* as = As + (kt % STAGES) * A_TILE + wm * WM * LDA;
    // K-major: fragment j's column 4g + j is staged row j * BN/4 + 8 wn + g
    const int8_t* bs = KMAJOR ? Bs + (kt % STAGES) * B_TILE + (wn * WN / 4 + g) * LDA
                              : Bs + (kt % STAGES) * B_TILE + wn * WN + 4 * g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) load_a(a[i], as + i * 16 * LDA + kk, lane);
      // B: k rows kk + 16h + 4t + r (r = 0..3) of columns 4g + j
      uint32_t b[FN][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (KMAJOR) {
#pragma unroll
          for (int j = 0; j < FN; ++j)
            b[j][h] = *reinterpret_cast<const uint32_t*>(
                bs + j * (BN / 4) * LDA + kk + 16 * h + 4 * t);
        } else {
          uint32_t w[4], v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            w[r] = *reinterpret_cast<const uint32_t*>(
                bs + b_row(kk + 16 * h + 4 * t + r) * LDB);
          transpose4x4(v, w);
#pragma unroll
          for (int j = 0; j < FN; ++j) b[j][h] = v[j];
        }
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
      for (int e = 0; e < 8; ++e)
        vals[e] = dequantize<T>(acc[i][e % 4][2 * half + e / 4], row_scale, col_scale[e]);
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

template <typename T, bool KMAJOR>
int launch_mma(const void* a, const void* b, const void* sa, const void* sb,
               void* c, int m, int n, int k, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_gemm<T, KMAJOR><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<T*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// host helpers of the two TMA kernels
// ---------------------------------------------------------------------------

namespace k7 {

// TMA's bytes a box row: one 128-byte swizzle span of k.
constexpr int BOX_K = 128;

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

// A 3-D map (depth 1) of a row-major [rows, cols] int8 matrix, loaded in
// boxes of box_rows rows x 128 bytes with 128-byte swizzle; zeros past its
// edges. Returns 0 or a cudaError.
inline int encode_rows(CUtensorMap* map, const void* base, int rows, int cols,
                       uint32_t box_rows) {
  hopper::EncodeTiled fn = nullptr;
  const int rc = hopper::encode_tiled(&fn);
  if (rc != 0) return rc;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows), 1};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols),
                                 static_cast<cuuint64_t>(cols) * rows};
  const cuuint32_t box[3] = {BOX_K, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// TMA's rules for the two int8 operands: rows of a multiple of 16 bytes,
// 16-byte aligned bases.
inline bool tma_ok(const void* a, const void* b, int k) {
  return k >= 1 && k % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(b) & 15) == 0;
}

// The current device and its SM count, asked of CUDA once a device
// (a launch's host time otherwise pays for the query every call).
constexpr int MAX_DEVICES = 64;

inline int device_sms(int* device, int* sms) {
  static int cached[MAX_DEVICES];
  cudaError_t e = cudaGetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*device < 0 || *device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[*device] == 0) {
    int count = 0;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, *device);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached[*device] = count;
  }
  *sms = cached[*device];
  return 0;
}

// Raise a kernel's dynamic shared memory to `bytes` once a device; `done`
// is the kernel's own table.
template <typename K>
inline int allow_smem(K kernel, int bytes, int device, bool (&done)[MAX_DEVICES]) {
  if (done[device]) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done[device] = true;
  return 0;
}

}  // namespace k7

// ---------------------------------------------------------------------------
// wgmma: the Hopper GEMM tile in int8 (m > 64)
// ---------------------------------------------------------------------------

namespace k7_hopper {

// A stage: A [128 rows, 128 k] and B [256 columns, 128 k], 48 KB, the
// bytes of hopper_gemm.cuh's bf16 stage, so its barriers, Pipe, Tiles and
// Raster serve as they are; the epilogue's area is K7's own (two 2 KB
// output boxes a consumer warp).
constexpr int BK = k7::BOX_K;
constexpr int A_BYTES = hopper::BM * BK;
constexpr int B_BYTES = hopper::BN * BK;
static_assert(A_BYTES == hopper::A_BYTES && A_BYTES + B_BYTES == hopper::STAGE_BYTES,
              "the int8 stage has the bf16 stage's layout");
static_assert(hopper::EPI_COLS == 32, "a warp stages 16 rows x 32 sums");
constexpr int BOX_ROWS = 16, BOX_COLS = 32;      // a warp's output box
constexpr int BOX_BYTES = BOX_ROWS * BOX_COLS * 4;  // 2 KB at float32
constexpr int EPI_WARP_BYTES = 2 * BOX_BYTES;       // two boxes in flight a warp
constexpr int EPI_BYTES = hopper::CONSUMER_WARPS * EPI_WARP_BYTES;  // 32 KB
constexpr int SMEM_BYTES =
    1024 + hopper::STAGES * hopper::STAGE_BYTES + EPI_BYTES + 2 * hopper::STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on an H100");
static_assert(16 * hopper::EPI_LD * 4 <= EPI_WARP_BYTES, "the staged sums fit a warp's area");

struct Args {
  CUtensorMap a;  // A [m, k], boxes of 128 rows x 128 k
  CUtensorMap b;  // B^T [n, k] (B column-major), boxes of 256 columns x 128 k
  CUtensorMap c;  // C [m, n] (TMA stores), boxes of 16 rows x 32 columns
  const float* sa;
  const float* sb;
  void* out;      // C [m, n]
  int m, n, k;
};

struct Smem {
  uint32_t base;        // shared-window address of stage 0 (1 KB aligned)
  unsigned char* ptr;   // the same, as a generic pointer

  __device__ uint32_t a(int s) const { return base + s * hopper::STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t epi(int warp) const {
    return base + hopper::STAGES * hopper::STAGE_BYTES + warp * EPI_WARP_BYTES;
  }
  __device__ unsigned char* epi_ptr(int warp) const { return ptr + (epi(warp) - base); }
  __device__ uint32_t full(int s) const {
    return base + hopper::STAGES * hopper::STAGE_BYTES + EPI_BYTES + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(s) + 8 * hopper::STAGES; }
};

__device__ __forceinline__ Smem smem_of(unsigned char* raw) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t aligned = (s + 1023u) & ~1023u;
  return Smem{aligned, raw + (aligned - s)};
}

// Thread 0, before the block's first __syncthreads.
__device__ __forceinline__ void init_barriers(const Smem& sm) {
  for (int s = 0; s < hopper::STAGES; ++s) {
    hopper::mbar_init(sm.full(s), 1);
    hopper::mbar_init(sm.empty(s), hopper::CONSUMER_WARPS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ int k_blocks(int k) { return (k + BK - 1) / BK; }

// d[64 x 256 of this warpgroup] += A[64 x 32] @ B[32 x 256]: both K-major,
// int32 sums.
struct Wgmma {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Issue the loads of output tile (row0, col0), k / 128 stages; the whole
// producer warp runs the loop, its lane 0 issues.
__device__ __forceinline__ void load_tile(const Smem& sm, hopper::Pipe& p,
                                          const CUtensorMap* a, const CUtensorMap* b,
                                          int row0, int col0, int k) {
  const int kb_end = k_blocks(k);
  const bool issuer = threadIdx.x % 32 == 0;
  for (int kb = 0; kb < kb_end; ++kb) {
    hopper::mbar_wait(sm.empty(p.stage), p.phase ^ 1u);
    if (issuer) {
      const uint32_t full = sm.full(p.stage);
      hopper::mbar_expect_tx(full, hopper::STAGE_BYTES);
      hopper::tma_load(sm.a(p.stage), a, full, kb * BK, row0, 0);
      hopper::tma_load(sm.b(p.stage), b, full, kb * BK, col0, 0);
    }
    __syncwarp();
    p.advance();
  }
}

// Warpgroup wg's 64 rows of a tile, hopper::mma_tile's pipeline: one k
// block's group stays in flight while the next is issued.
__device__ __forceinline__ void mma_tile(const Smem& sm, hopper::Pipe& p,
                                         int (&d)[128], int k, int wg) {
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  const int kb_end = k_blocks(k);
  int held = -1;
  for (int kb = 0; kb < kb_end; ++kb) {
    hopper::mbar_wait(sm.full(p.stage), p.phase);
    const uint64_t da = hopper::smem_desc(sm.a(p.stage) + wg * 64 * BK, 16, 1024);
    const uint64_t db = hopper::smem_desc(sm.b(p.stage), 16, 1024);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // 32 k: 32 bytes along both operands' swizzled rows
      Wgmma::mma(d, da + 2 * kk, db + 2 * kk);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (held >= 0 && threadIdx.x % 32 == 0) hopper::mbar_arrive(sm.empty(held));
    held = p.stage;
    p.advance();
  }
  hopper::wgmma_wait<0>();
  if (held >= 0 && threadIdx.x % 32 == 0) hopper::mbar_arrive(sm.empty(held));
}

// The accumulator layout of m64nNk32.s32 is m64nNk16.f32's: warp w of the
// warpgroup holds rows 16 w + lane / 4 (d[4 j], d[4 j + 1]) and 8 more
// (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 (lane % 4) + {0, 1}.

// ---- the TMA-store epilogue (rows of C a multiple of 16 bytes) ----
//
// Each consumer warp converts one 32-column chunk of its 16 rows at a time
// into a box of shared memory and one lane hands the box to TMA, which
// stores it while the warp goes on: to the next chunk, then to the next
// tile's products, so the output's bytes leave the SM under the tensor
// cores' work instead of in front of it (at k = 2048 and float32 output
// the stores are half the tile's time). Two boxes a warp: before a box is
// rewritten, the store that read it two chunks ago has finished reading.
// The boxes are TMA-swizzled (128 bytes for float32 rows of 32, 64 for
// 16-bit ones), so the warp's writes are free of bank conflicts; TMA clips
// what lies past m or n.

template <typename T>
struct OutBox {
  static constexpr int ROW_BYTES = BOX_COLS * static_cast<int>(sizeof(T));
  // the swizzled byte offset of (row, byte in row) of a box
  static __device__ __forceinline__ uint32_t at(int row, int byte) {
    const int swz = sizeof(T) == 4 ? (row & 7) : ((row >> 1) & 3);
    return row * ROW_BYTES + (((byte >> 4) ^ swz) << 4) + (byte & 15);
  }
};

__device__ __forceinline__ void put_pair(unsigned char* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <typename T>
__device__ __forceinline__ void put_pair(unsigned char* p, T x, T y) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(&x);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(&y);
  *reinterpret_cast<uint32_t*>(p) = lo | (hi << 16);
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(0)
      : "memory");
}

// Order this thread's writes to shared memory before the async proxy's
// reads of it (a TMA store of the box).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until every bulk store of this thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void store_tile_tma(const Smem& sm, const int (&d)[128], int wg,
                                              int row0, int col0, const Args& p,
                                              int& boxes) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, w = wg * 4 + warp;
  const int r = lane / 4, c = 2 * (lane % 4);
  const int rows0 = row0 + 64 * wg + 16 * warp;
  const float s_lo = rows0 + r < p.m ? p.sa[rows0 + r] : 0.0f;
  const float s_hi = rows0 + r + 8 < p.m ? p.sa[rows0 + r + 8] : 0.0f;
#pragma unroll
  for (int chunk = 0; chunk < hopper::BN / BOX_COLS; ++chunk) {
    const int slot = boxes & 1;
    if (boxes >= 2) {
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
    }
    unsigned char* box = sm.epi_ptr(w) + slot * BOX_BYTES;
#pragma unroll
    for (int jj = 0; jj < BOX_COLS / 8; ++jj) {
      const int j = chunk * (BOX_COLS / 8) + jj;
      const int col = col0 + chunk * BOX_COLS + 8 * jj + c;
      const float t0 = col < p.n ? p.sb[col] : 0.0f;
      const float t1 = col + 1 < p.n ? p.sb[col + 1] : 0.0f;
      const int byte = (8 * jj + c) * static_cast<int>(sizeof(T));
      put_pair(box + OutBox<T>::at(r, byte), dequantize<T>(d[4 * j], s_lo, t0),
               dequantize<T>(d[4 * j + 1], s_lo, t1));
      put_pair(box + OutBox<T>::at(r + 8, byte), dequantize<T>(d[4 * j + 2], s_hi, t0),
               dequantize<T>(d[4 * j + 3], s_hi, t1));
    }
    fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      tma_store(&p.c, sm.epi(w) + slot * BOX_BYTES, col0 + chunk * BOX_COLS, rows0);
      bulk_commit();
    }
    ++boxes;
  }
}

// ---- the staged epilogue (any row width) ----

// Eight consecutive int32 sums of row r from column col through the
// epilogue, stored 16 bytes at a time where the row allows, masked at the
// ragged edges.
template <typename T>
struct StoreQ {
  T* c;
  const float* sa;
  const float* sb;
  int m, n;
  __device__ void operator()(int r, int col, const int* v) const {
    if (r >= m || col >= n) return;
    const float row_scale = sa[r];
    alignas(16) T vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vals[e] = col + e < n ? dequantize<T>(v[e], row_scale, sb[col + e]) : T();
    T* dst = c + static_cast<size_t>(r) * n + col;
    if (col + 8 <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
      for (int u = 0; u < static_cast<int>(8 * sizeof(T) / 16); ++u)
        reinterpret_cast<uint4*>(dst)[u] = reinterpret_cast<const uint4*>(vals)[u];
    } else {
      for (int e = 0; e < 8 && col + e < n; ++e) dst[e] = vals[e];
    }
  }
};

// hopper::store_tile for int32 sums: each warp stages one column chunk (its
// 16 rows x 32 sums) in its area of the epilogue's shared memory, then each
// lane hands eight consecutive sums of one row to st.
template <typename T>
__device__ __forceinline__ void store_tile(const Smem& sm, const int (&d)[128],
                                          int wg, int row0, int col0, const StoreQ<T>& st) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  int* stage = reinterpret_cast<int*>(sm.epi_ptr(wg * 4 + warp));
  const int rows0 = row0 + 64 * wg + 16 * warp;
  const int r = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int chunk = 0; chunk < hopper::BN / hopper::EPI_COLS; ++chunk) {
#pragma unroll
    for (int jj = 0; jj < hopper::EPI_COLS / 8; ++jj) {
      const int j = chunk * (hopper::EPI_COLS / 8) + jj;
      *reinterpret_cast<int2*>(stage + r * hopper::EPI_LD + 8 * jj + c) =
          make_int2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<int2*>(stage + (r + 8) * hopper::EPI_LD + 8 * jj + c) =
          make_int2(d[4 * j + 2], d[4 * j + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      st(rows0 + i / 4, col0 + chunk * hopper::EPI_COLS + (i % 4) * 8,
         stage + (i / 4) * hopper::EPI_LD + (i % 4) * 8);
    }
    __syncwarp();
  }
}

template <typename T, bool TMA_OUT>
__global__ void __launch_bounds__(hopper::THREADS, 1)
    int8_gemm_wgmma(const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_of(smem_raw);
  const hopper::Tiles tiles(p.m, p.n);
  if (threadIdx.x == 0) init_barriers(sm);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_registers();
    if (threadIdx.x / 32 == 0) {
      hopper::Pipe pipe;
      for (int j = blockIdx.x; j < tiles.count; j += gridDim.x) {
        const hopper::Raster at(tiles, p.m, j);
        load_tile(sm, pipe, &p.a, &p.b, at.row0, at.col0, p.k);
      }
    }
  } else {
    hopper::consumer_registers();
    hopper::Pipe pipe;
    int acc[128];
    int boxes = 0;  // output boxes this warp has handed to TMA
    const StoreQ<T> st{static_cast<T*>(p.out), p.sa, p.sb, p.m, p.n};
    for (int j = blockIdx.x; j < tiles.count; j += gridDim.x) {
      const hopper::Raster at(tiles, p.m, j);
      mma_tile(sm, pipe, acc, p.k, wg - 1);
      if (TMA_OUT)
        store_tile_tma<T>(sm, acc, wg - 1, at.row0, at.col0, p, boxes);
      else
        store_tile(sm, acc, wg - 1, at.row0, at.col0, st);
    }
    if (TMA_OUT && threadIdx.x % 32 == 0) bulk_wait_all();
  }
}

// The output map of C [m, n] for TMA stores: boxes of 16 rows x 32
// columns, swizzled as OutBox lays them out.
template <typename T>
int encode_out(CUtensorMap* map, void* base, int m, int n) {
  hopper::EncodeTiled fn = nullptr;
  const int rc = hopper::encode_tiled(&fn);
  if (rc != 0) return rc;
  const uint64_t row_bytes = static_cast<uint64_t>(n) * sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(m), 1};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * m};
  const cuuint32_t box[3] = {BOX_COLS, BOX_ROWS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : (k7::IsBf16<T>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
  const CUresult res =
      fn(map, type, 3, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         sizeof(T) == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool TMA_OUT>
int launch_out(Args& p, int device, int blocks, cudaStream_t s) {
  static bool smem_set[k7::MAX_DEVICES];
  const int rc = k7::allow_smem(int8_gemm_wgmma<T, TMA_OUT>, SMEM_BYTES, device, smem_set);
  if (rc != 0) return rc;
  int8_gemm_wgmma<T, TMA_OUT><<<blocks, hopper::THREADS, SMEM_BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One block an SM, or one a tile when there are fewer tiles. The output
// goes through TMA stores where C's rows are a multiple of 16 bytes and
// its base is aligned, else through the staged epilogue.
template <typename T>
int launch(const void* a, const void* b, const void* sa, const void* sb, void* c, int m,
           int n, int k, cudaStream_t s) {
  if (!k7::tma_ok(a, b, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool tma_out = (reinterpret_cast<uintptr_t>(c) & 15) == 0 &&
                       (static_cast<uint64_t>(n) * sizeof(T)) % 16 == 0;
  Args p;
  int rc = k7::encode_rows(&p.a, a, m, k, hopper::BM);
  if (rc == 0) rc = k7::encode_rows(&p.b, b, n, k, hopper::BN);
  if (rc == 0 && tma_out) rc = encode_out<T>(&p.c, c, m, n);
  int device = 0, sms = 0;
  if (rc == 0) rc = k7::device_sms(&device, &sms);
  if (rc != 0) return rc;
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.out = c;
  p.m = m;
  p.n = n;
  p.k = k;
  const long long count = static_cast<long long>((m + hopper::BM - 1) / hopper::BM) *
                          ((n + hopper::BN - 1) / hopper::BN);
  const int blocks = static_cast<int>(count < sms ? count : sms);
  return tma_out ? launch_out<T, true>(p, device, blocks, s)
                 : launch_out<T, false>(p, device, blocks, s);
}

}  // namespace k7_hopper

// ---------------------------------------------------------------------------
// small_m: C^T = B^T A^T on wgmma, split over k (m <= 64)
// ---------------------------------------------------------------------------

namespace k7_small {

constexpr int ROWS = 64;               // weight rows a block: its output columns
constexpr int BK = k7::BOX_K;          // bytes of k a stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;           // one warpgroup
constexpr int W_BYTES = ROWS * BK;     // 8 KB of weight a stage
constexpr int BLOCKS_PER_SM = 4;       // the grid's aim: every block resident at once
constexpr int SUM_LD = ROWS + 4;       // a staged row of sums, padded
constexpr int MAX_M = 64;

template <int N>
struct Geo {
  static constexpr int X_BYTES = N * BK;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int RING = STAGES * STAGE;
  // 1 KB of slack aligns the ring to the 128-byte swizzle's 1 KB pattern
  static constexpr int SMEM = 1024 + RING + 8 * STAGES;
  static_assert(STAGE % 1024 == 0, "every box starts on the swizzle pattern");
  static_assert(N * SUM_LD * 4 <= RING, "the staged sums fit the ring");
};

struct Args {
  CUtensorMap w;  // B^T [n, k]: boxes of 64 rows x 128 k
  CUtensorMap x;  // A [m, k]: boxes of N rows x 128 k (rows past m are zeros)
  const float* sa;
  const float* sb;
  void* c;        // C [m, n]
  int* work;      // [tiles][N][64] split sums, then [tiles] arrival counters; zero
  int m, n, k;
  int kb_per;     // k blocks a split
};

// d[64 weight rows x N activation rows] += W[64 x 32] @ X[N x 32]^T: both
// K-major, int32 sums.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Issue load i of the block's k range into stage i % STAGES (thread 0).
template <int N>
__device__ __forceinline__ void load_stage(const CUtensorMap* w_map, const CUtensorMap* x_map,
                                           uint32_t ring, uint32_t bars, int i, int kb0,
                                           int n0) {
  const int s = i % STAGES;
  const uint32_t full = bars + 8 * s, w = ring + s * Geo<N>::STAGE;
  hopper::mbar_expect_tx(full, Geo<N>::STAGE);
  hopper::tma_load(w, w_map, full, (kb0 + i) * BK, n0, 0);
  hopper::tma_load(w + W_BYTES, x_map, full, (kb0 + i) * BK, 0, 0);
}

// Block (tile, split): weight rows [64 tile, 64 tile + 64) over k blocks
// [kb_per split, + kb_per). Thread 0 keeps STAGES stages of TMA loads in
// flight; after each stage's products the warpgroup syncs and the stage is
// reloaded.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    int8_gemm_small_m(const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;
  int* sums = reinterpret_cast<int*>(smem_raw + (ring - raw));  // the ring, after the loop
  const uint32_t bars = ring + Geo<N>::RING;
  const int tid = threadIdx.x, tile = blockIdx.x, n0 = tile * ROWS;
  const int kb0 = blockIdx.y * p.kb_per;
  const int kb_total = (p.k + BK - 1) / BK;
  const int nk = p.kb_per < kb_total - kb0 ? p.kb_per : kb_total - kb0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < STAGES && i < nk; ++i)
      load_stage<N>(&p.w, &p.x, ring, bars, i, kb0, n0);
  }

  int d[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) d[e] = 0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    hopper::mbar_wait(bars + 8 * s, (i / STAGES) & 1);
    const uint32_t w = ring + s * Geo<N>::STAGE;
    const uint64_t dw = hopper::smem_desc(w, 16, 1024);
    const uint64_t dx = hopper::smem_desc(w + W_BYTES, 16, 1024);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) Wgmma<N>::mma(d, dw + 2 * kk, dx + 2 * kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncthreads();  // the warpgroup is done with stage s
    if (tid == 0 && i + STAGES < nk) load_stage<N>(&p.w, &p.x, ring, bars, i + STAGES, kb0, n0);
  }

  // d[4 j + e]: weight row (output column) 16 warp + lane / 4 + 8 (e / 2),
  // activation row (output row) 8 j + 2 (lane % 4) + e % 2
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  T* C = static_cast<T*>(p.c);
  if (gridDim.y == 1) {  // one split: the epilogue from this block's sums
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sums[(8 * j + c0 + e % 2) * SUM_LD + r0 + 8 * (e / 2)] = d[4 * j + e];
    __syncthreads();
    for (int i = tid; i < N * ROWS; i += THREADS) {
      const int row = i / ROWS, col = n0 + i % ROWS;
      if (row < p.m && col < p.n)
        C[static_cast<size_t>(row) * p.n + col] =
            dequantize<T>(sums[row * SUM_LD + i % ROWS], p.sa[row], p.sb[col]);
    }
    return;
  }
  // several splits: add into the tile's sums; the last block to arrive
  // runs the epilogue on the total and leaves the workspace zero
  int* part = p.work + static_cast<size_t>(tile) * N * ROWS;
  int* counter = p.work + static_cast<size_t>(gridDim.x) * N * ROWS + tile;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      atomicAdd(part + (8 * j + c0 + e % 2) * ROWS + r0 + 8 * (e / 2), d[4 * j + e]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < N * ROWS; i += THREADS) {
    const int row = i / ROWS, col = n0 + i % ROWS;
    const int v = __ldcg(part + i);
    __stcg(part + i, 0);
    if (row < p.m && col < p.n)
      C[static_cast<size_t>(row) * p.n + col] = dequantize<T>(v, p.sa[row], p.sb[col]);
  }
  if (tid == 0) *counter = 0;
}

// Ints of the workspace a launch at width n needs (the widest N).
inline long long work_ints(int n) {
  const long long tiles = (n + ROWS - 1) / ROWS;
  return tiles * MAX_M * ROWS + tiles;
}

template <typename T, int N>
int launch_n(const Args& p, int device, int tiles, int splits, cudaStream_t s) {
  static bool smem_set[k7::MAX_DEVICES];
  const int rc = k7::allow_smem(int8_gemm_small_m<T, N>, Geo<N>::SMEM, device, smem_set);
  if (rc != 0) return rc;
  int8_gemm_small_m<T, N><<<dim3(tiles, splits), THREADS, Geo<N>::SMEM, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The grid: n / 64 weight tiles times k splits, the splits as many as
// make about BLOCKS_PER_SM blocks an SM, each at least one k block.
template <typename T>
int launch(const void* a, const void* b, const void* sa, const void* sb, void* c, int m,
           int n, int k, void* work, cudaStream_t s) {
  if (m < 1 || m > MAX_M || work == nullptr || !k7::tma_ok(a, b, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int N = m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : 64;
  Args p;
  int rc = k7::encode_rows(&p.w, b, n, k, ROWS);
  if (rc == 0) rc = k7::encode_rows(&p.x, a, m, k, N);
  int device = 0, sms = 0;
  if (rc == 0) rc = k7::device_sms(&device, &sms);
  if (rc != 0) return rc;
  const int tiles = (n + ROWS - 1) / ROWS, kb_total = (k + BK - 1) / BK;
  int splits = (BLOCKS_PER_SM * sms + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : splits > kb_total ? kb_total : splits;
  p.kb_per = (kb_total + splits - 1) / splits;
  splits = (kb_total + p.kb_per - 1) / p.kb_per;
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.c = c;
  p.work = static_cast<int*>(work);
  p.m = m;
  p.n = n;
  p.k = k;
  switch (N) {
    case 8:
      return launch_n<T, 8>(p, device, tiles, splits, s);
    case 16:
      return launch_n<T, 16>(p, device, tiles, splits, s);
    case 32:
      return launch_n<T, 32>(p, device, tiles, splits, s);
    default:
      return launch_n<T, 64>(p, device, tiles, splits, s);
  }
}

}  // namespace k7_small

namespace {

template <typename T>
int dispatch(int tile, int b_kmajor, const void* a, const void* b, const void* sa,
             const void* sb, void* c, int m, int n, int k, void* work, cudaStream_t s) {
  switch (tile) {
    case 0:
      return b_kmajor ? launch_mma<T, true>(a, b, sa, sb, c, m, n, k, s)
                      : launch_mma<T, false>(a, b, sa, sb, c, m, n, k, s);
    case 1:
      return b_kmajor ? k7_hopper::launch<T>(a, b, sa, sb, c, m, n, k, s)
                      : static_cast<int>(cudaErrorInvalidValue);
    case 2:
      return b_kmajor ? k7_small::launch<T>(a, b, sa, sb, c, m, n, k, work, s)
                      : static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = float16, 2 = bfloat16. tile: 0 = mma (any
// widths), 1 = wgmma, 2 = small_m (m <= 64); 1 and 2 need TMA's widths (k a
// multiple of 16, 16-byte aligned bases) and a column-major B. b_kmajor: B
// is column-major (element (kk, j) at bq + j * k + kk), else row-major.
// work: small_m's workspace, ddlb_int8_work_ints(n) zeroed ints (a launch
// leaves it zero), else unused. m, n >= 1; k >= 0 (k >= 16 on wgmma and
// small_m).
int ddlb_int8_matmul(int out_dtype, int tile, int b_kmajor, const void* aq,
                     const void* bq, const void* sa, const void* sb, void* out, int m,
                     int n, int k, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return dispatch<float>(tile, b_kmajor, aq, bq, sa, sb, out, m, n, k, work, s);
    case 1:
      return dispatch<__half>(tile, b_kmajor, aq, bq, sa, sb, out, m, n, k, work, s);
    case 2:
      return dispatch<__nv_bfloat16>(tile, b_kmajor, aq, bq, sa, sb, out, m, n, k, work, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

long long ddlb_int8_work_ints(int n) { return k7_small::work_ints(n); }

int ddlb_int8_small_m_max() { return k7_small::MAX_M; }

const char* ddlb_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
