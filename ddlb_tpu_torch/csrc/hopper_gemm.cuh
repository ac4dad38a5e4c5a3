// The Hopper GEMM tile of K2 (csrc/collective_matmul.cu) and K6
// (csrc/alltoall_matmul.cu): one warp-specialised TMA + wgmma tile loop,
// C[128, 256] of A[rows, k] @ B[k, n] a tile, float32 sums in registers.
//
// What bounds the GEMM on an H100: the bf16/fp16 tensor cores (989 TFLOP/s
// dense); only wgmma reaches that rate, and only when the operands are in
// shared memory before the tensor cores ask for them.
//
// Design:
//  - 384 threads, one block an SM (__launch_bounds__(384, 1)), a persistent
//    loop over the kernel's output tiles.
//  - Warpgroup 0 is the producer. Its warp 0 runs the stage loop, one lane
//    issuing the TMA loads of every stage; warps 1-3 are left to the kernel
//    for its own copies (the ring's puts, the all-to-all's dispatch and
//    copy-out). setmaxnreg lowers it to 40 registers a thread.
//  - Warpgroups 1 and 2 are the consumers, raised to 232 registers: each
//    runs wgmma.m64n256k16 on its 64 rows of the tile, the float32 sums of
//    its 64 x 256 half in registers (128 a thread).
//  - Shared memory: a ring of 4 stages, each A [128, 64] and B [64, 256]
//    (48 KB), 128-byte swizzled by TMA, with a full and an empty mbarrier a
//    stage; then a float32 staging area for the epilogue. B stays row-major
//    [k, n] in device memory: wgmma reads it MN-major through its transpose
//    bit, so nothing is copied transposed.
//  - Tensor maps are 3-D ({cols, rows, depth}, depth 1 for a plain matrix):
//    a kernel addresses a slot or a routing group by its depth coordinate.
//    TMA fills out-of-bounds rows and columns with zeros; a B box wholly
//    past n is not loaded (its columns are never stored).
//  - Epilogue: each warp stages 16 rows x 32 sums in shared memory, then
//    each lane hands eight consecutive float32 sums of one row to the
//    kernel's Store functor, st(row, col, v), which masks the ragged edge,
//    rounds each sum once to the operand dtype and stores 16 bytes. While
//    the consumers store, the producer loads the next tile's stages.
//
// Host side: encode_map builds a tensor map with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK * 2;                // 16 KB
constexpr int B_BOX_N = 64;                         // one 128-byte swizzle span
constexpr int B_BOX_BYTES = BK * B_BOX_N * 2;       // 8 KB
constexpr int B_BYTES = BK * BN * 2;                // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;      // 48 KB
constexpr int EPI_COLS = 32, EPI_LD = 40;           // a warp's 16 x 32 sums, padded
constexpr int EPI_BYTES = CONSUMER_WARPS * 16 * EPI_LD * 4;
constexpr int BAR_BYTES = 2 * STAGES * 8;
// 1 KB of slack aligns the stages to the 128-byte swizzle's 1 KB pattern
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + BAR_BYTES;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on an H100");

// named barriers (0 is __syncthreads): the producer warpgroup, its three
// copy warps, the two consumer warpgroups
constexpr int BAR_PRODUCER = 1, BAR_COPY = 2, BAR_CONSUMER = 3;
constexpr int COPY_THREADS = 96, CONSUMER_THREADS = 256;

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A stage that has not turned in this long means a fault (a load that
// never lands): trap, so the launch fails instead of holding the card.
constexpr unsigned long long STALL_LIMIT_NS = 20ull * 1000 * 1000 * 1000;

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  unsigned long long start, now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(start));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (now - start > STALL_LIMIT_NS) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's generic-proxy view of global memory (what an acquire
// made visible: a peer's stores into a slot) before its later TMA reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle. A (K-major): LBO is
// unused, SBO = 1024 (eight 128-byte rows). B (MN-major): LBO = the stride
// between 64-column boxes, SBO = 1024 (eight k rows).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define DDLB_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DDLB_WGMMA_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"
#define DDLB_WGMMA_OPERANDS                                              \
  DDLB_D8(0), DDLB_D8(8), DDLB_D8(16), DDLB_D8(24), DDLB_D8(32), DDLB_D8(40), \
      DDLB_D8(48), DDLB_D8(56), DDLB_D8(64), DDLB_D8(72), DDLB_D8(80),   \
      DDLB_D8(88), DDLB_D8(96), DDLB_D8(104), DDLB_D8(112), DDLB_D8(120)

// d[64 x 256 of this warpgroup] += A[64 x 16] @ B[16 x 256]: A K-major,
// B MN-major (transpose bit set), float32 sums.
template <typename T>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DDLB_WGMMA_REGS
        ", %128, %129, p, 1, 1, 0, 1;\n"
        "}\n"
        : DDLB_WGMMA_OPERANDS
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<__half> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " DDLB_WGMMA_REGS
        ", %128, %129, p, 1, 1, 0, 1;\n"
        "}\n"
        : DDLB_WGMMA_OPERANDS
        : "l"(da), "l"(db), "r"(1));
  }
};

#undef DDLB_WGMMA_OPERANDS
#undef DDLB_WGMMA_REGS
#undef DDLB_D8

// ---------------------------------------------------------------------------
// shared memory and the stage ring
// ---------------------------------------------------------------------------

struct Smem {
  uint32_t base;        // shared-window address of stage 0 (1 KB aligned)
  unsigned char* ptr;   // the same, as a generic pointer

  __device__ uint32_t a(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t full(int s) const {
    return base + STAGES * STAGE_BYTES + EPI_BYTES + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(s) + 8 * STAGES; }
  __device__ float* epi(int warp) const {
    return reinterpret_cast<float*>(ptr + STAGES * STAGE_BYTES) + warp * 16 * EPI_LD;
  }
};

__device__ __forceinline__ Smem smem_of(unsigned char* raw) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t aligned = (s + 1023u) & ~1023u;
  return Smem{aligned, raw + (aligned - s)};
}

// Thread 0, before the block's first __syncthreads.
__device__ __forceinline__ void init_barriers(const Smem& sm) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(sm.full(s), 1);
    mbar_init(sm.empty(s), CONSUMER_WARPS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A role's position in the stage ring: the next stage and its phase.
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

__device__ __forceinline__ int k_blocks(int k) { return (k + BK - 1) / BK; }

// The output tiles of C[rows, n], BM x BN each, row-major: their count
// and tile j's corner. A kernel takes the tile's shape from here alone:
// its own constants named BM or BN (K1's 128x128 tile beside it) would
// hide hopper's inside it, `using namespace hopper` or not.
struct Tiles {
  int across, count;
  __device__ Tiles(int rows, int n)
      : across((n + BN - 1) / BN), count(((rows + BM - 1) / BM) * across) {}
  __device__ int row0(int j) const { return (j / across) * BM; }
  __device__ int col0(int j) const { return (j % across) * BN; }
};

// The grouped tile order: groups of RASTER tile rows, column by column
// inside a group, so the blocks of one wave share a few panels of A and B
// in L2 (Tiles' plain row-major order streams all of B once a tile row;
// it measured slower for K1 at 8192^3 bf16 and for K3 on an H100). Tile
// j's corner, from Tiles' geometry.
constexpr int RASTER = 8;

struct Raster {
  int row0, col0;
  __device__ Raster(const Tiles& t, int rows, int j) {
    const int tiles_m = (rows + BM - 1) / BM;
    const int group = j / (RASTER * t.across), first = group * RASTER;
    const int height = tiles_m - first < RASTER ? tiles_m - first : RASTER;
    const int local = j - group * RASTER * t.across;
    row0 = (first + local % height) * BM;
    col0 = (local / height) * BN;
  }
};

// The tile loop's order: this block's first tile of a step whose tiles
// follow `before` tiles of earlier steps, so the blocks take the steps'
// tiles round robin as one sequence.
__device__ __forceinline__ int first_tile(int before) {
  const int G = gridDim.x;
  return (static_cast<int>(blockIdx.x) + G - before % G) % G;
}

// ---------------------------------------------------------------------------
// producer: one warp, one issuing lane
// ---------------------------------------------------------------------------

// Issue the loads of the output tile (row0, col0): A's rows [row0, row0 +
// 128) at depth az, B's columns [col0, col0 + 256), k / 64 stages. The
// whole producer warp runs the loop (a warp that waits together stays
// converged); its lane 0 issues.
__device__ __forceinline__ void load_tile(const Smem& sm, Pipe& p,
                                          const CUtensorMap* a, int az,
                                          const CUtensorMap* b, int row0,
                                          int col0, int n, int k) {
  int boxes = (n - col0 + B_BOX_N - 1) / B_BOX_N;
  boxes = boxes < BN / B_BOX_N ? boxes : BN / B_BOX_N;
  const uint32_t bytes = A_BYTES + boxes * B_BOX_BYTES;
  const int kb_end = k_blocks(k);
  const bool issuer = threadIdx.x % 32 == 0;
  for (int kb = 0; kb < kb_end; ++kb) {
    mbar_wait(sm.empty(p.stage), p.phase ^ 1u);
    if (issuer) {
      const uint32_t full = sm.full(p.stage);
      mbar_expect_tx(full, bytes);
      tma_load(sm.a(p.stage), a, full, kb * BK, row0, az);
      for (int i = 0; i < boxes; ++i)
        tma_load(sm.b(p.stage) + i * B_BOX_BYTES, b, full, col0 + i * B_BOX_N, kb * BK, 0);
    }
    __syncwarp();
    p.advance();
  }
}

// Wait until every load issued so far has landed in shared memory
// (`issued` stages in all): the last STAGES of them may be in flight.
__device__ __forceinline__ void wait_landed(const Smem& sm, const Pipe& p,
                                            long long issued) {
  const int last = issued < STAGES ? static_cast<int>(issued) : STAGES;
  for (int i = 1; i <= last; ++i) {
    const int s = p.stage - i;
    mbar_wait(sm.full((s + STAGES) % STAGES), s < 0 ? p.phase ^ 1u : p.phase);
  }
}

// ---------------------------------------------------------------------------
// consumers: warpgroup wg (0 or 1) owns rows [64 wg, 64 wg + 64) of a tile
// ---------------------------------------------------------------------------

// One k block's group is kept in flight while the next is issued: a
// stage is released once the group after it has been committed and it has
// itself completed.
template <typename T>
__device__ __forceinline__ void mma_tile(const Smem& sm, Pipe& p,
                                         float (&d)[128], int k, int wg) {
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  const int kb_end = k_blocks(k);
  int held = -1;  // the stage of the group still in flight
  for (int kb = 0; kb < kb_end; ++kb) {
    mbar_wait(sm.full(p.stage), p.phase);
    const uint64_t da = smem_desc(sm.a(p.stage) + wg * 64 * BK * 2, 16, 1024);
    const uint64_t db = smem_desc(sm.b(p.stage), B_BOX_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // 16 k: 32 bytes along A's swizzled row, 16 rows (2 KB) down B
      Wgmma<T>::mma(d, da + 2 * kk, db + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0 && threadIdx.x % 32 == 0) mbar_arrive(sm.empty(held));
    held = p.stage;
    p.advance();
  }
  wgmma_wait<0>();
  if (held >= 0 && threadIdx.x % 32 == 0) mbar_arrive(sm.empty(held));
}

// The epilogue's staging, shared by store_tile and a kernel's own
// epilogue (K3's fold): warp `warp` of consumer warpgroup `wg` stages the
// sums of one column chunk (its 16 rows x EPI_COLS) in its area of shared
// memory, then each lane takes eight consecutive sums of one row a call,
// calls h = 0, 1: row row(h), column col(chunk, h), the sums at sums(h).
// The accumulator layout of m64nNk16: warp w of the warpgroup holds rows
// 16 w + lane / 4 (d[4 j], d[4 j + 1]) and 8 more (d[4 j + 2],
// d[4 j + 3]) at columns 8 j + 2 (lane % 4) + {0, 1}.
struct EpiStage {
  float* stage;
  int lane, rows0, col0;

  __device__ EpiStage(const Smem& sm, int wg, int row0, int col0_)
      : lane(threadIdx.x % 32), col0(col0_) {
    const int warp = (threadIdx.x / 32) % 4;
    stage = sm.epi(wg * 4 + warp);
    rows0 = row0 + 64 * wg + 16 * warp;
  }
  // Stage chunk `chunk`'s sums; the warp has read the previous chunk's.
  __device__ __forceinline__ void put(const float (&d)[128], int chunk) const {
    const int r = lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = chunk * (EPI_COLS / 8) + jj;
      *reinterpret_cast<float2*>(stage + r * EPI_LD + 8 * jj + c) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(stage + (r + 8) * EPI_LD + 8 * jj + c) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    __syncwarp();
  }
  // call h's row among the warp's 16 and column in the chunk
  __device__ __forceinline__ int row_in(int h) const { return (lane + 32 * h) / 4; }
  __device__ __forceinline__ int col_in(int h) const { return ((lane + 32 * h) % 4) * 8; }
  __device__ __forceinline__ int row(int h) const { return rows0 + row_in(h); }
  __device__ __forceinline__ int col(int chunk, int h) const {
    return col0 + chunk * EPI_COLS + col_in(h);
  }
  __device__ __forceinline__ const float* sums(int h) const {
    return stage + row_in(h) * EPI_LD + col_in(h);
  }
};

// Hand the warpgroup's sums to st(row, col, v), eight consecutive float32
// sums of one row a call.
template <typename Store>
__device__ __forceinline__ void store_tile(const Smem& sm, const float (&d)[128],
                                          int wg, int row0, int col0,
                                          const Store& st) {
  const EpiStage ep(sm, wg, row0, col0);
#pragma unroll
  for (int chunk = 0; chunk < BN / EPI_COLS; ++chunk) {
    ep.put(d, chunk);
#pragma unroll
    for (int h = 0; h < 2; ++h) st(ep.row(h), ep.col(chunk, h), ep.sums(h));
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// the kernels' own copies: a share of `bytes` (a multiple of 16)
// ---------------------------------------------------------------------------

// Part `part` of `parts` contiguous ranges of 16-byte units, through L2,
// by `threads` threads (this one is `tid`), four units in flight a thread.
__device__ __forceinline__ void copy_share(void* dst, const void* src,
                                           size_t bytes, int part, int parts,
                                           int tid, int threads) {
  const size_t units = bytes / 16;
  const size_t per = (units + parts - 1) / parts;
  const size_t lo = per * part, hi = lo + per < units ? lo + per : units;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* t = static_cast<uint4*>(dst);
  size_t i = lo + tid;
  for (; i + 3 * threads < hi; i += 4 * threads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldcg(s + i + u * threads);
#pragma unroll
    for (int u = 0; u < 4; ++u) __stcg(t + i + u * threads, v[u]);
  }
  for (; i < hi; i += threads) __stcg(t + i, __ldcg(s + i));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || sym == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    cached = reinterpret_cast<EncodeTiled>(sym);
  }
  *fn = cached;
  return 0;
}

// A 3-D map {cols, rows, depth} of 16-bit elements (dtype 1 = float16,
// 2 = bfloat16) at `base`, rows `row_bytes` and depth slices `depth_bytes`
// apart, loaded in boxes of box_cols x box_rows x 1 with 128-byte swizzle.
// Returns 0 or a cudaError.
inline int encode_map(CUtensorMap* map, int dtype, const void* base,
                      uint64_t cols, uint64_t rows, uint64_t depth,
                      uint64_t row_bytes, uint64_t depth_bytes,
                      uint32_t box_cols, uint32_t box_rows) {
  EncodeTiled fn = nullptr;
  const int rc = encode_tiled(&fn);
  if (rc != 0) return rc;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {row_bytes, depth_bytes};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map, dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of a row-major [rows, cols] matrix (depth 1), or of `depth`
// such matrices `depth_bytes` apart, as A (boxes of 128 rows x 64 k).
inline int encode_a(CUtensorMap* map, int dtype, const void* base, int rows,
                    int cols, int depth, uint64_t depth_bytes) {
  const uint64_t row_bytes = static_cast<uint64_t>(cols) * 2;
  return encode_map(map, dtype, base, cols, rows, depth, row_bytes,
                    depth > 1 ? depth_bytes : row_bytes * rows, BK, BM);
}

// The map of B [k, n] (boxes of 64 k rows x 64 columns).
inline int encode_b(CUtensorMap* map, int dtype, const void* base, int k, int n) {
  const uint64_t row_bytes = static_cast<uint64_t>(n) * 2;
  return encode_map(map, dtype, base, n, k, 1, row_bytes, row_bytes * k, B_BOX_N, BK);
}

// TMA's rules for a 16-bit matrix: 16-byte aligned base, rows a multiple of
// 16 bytes.
inline bool tma_ok(const void* base, int cols) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (cols * 2) % 16 == 0;
}

}  // namespace hopper
