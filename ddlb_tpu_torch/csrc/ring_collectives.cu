// K4 and K5: the pure ring collectives, one persistent kernel per rank that
// moves the ring's data over NVLink peer memory, with no GEMM.
//
// Replace the TPU kernels of ddlb_tpu/ops/ring_collectives.py:
//  - K4 ring_all_gather (_ring_ag_kernel): [m/d, k] -> [m, k] on every
//    rank. At step t rank r holds chunk (r - t) % d (its own shard at
//    t = 0), lands it in its output rows and forwards it to rank r + 1.
//    At d = 1 it is one copy.
//  - K5 ring_reduce_scatter (_ring_rs_kernel): [m/d, k] viewed as d chunks
//    [m/d^2, k]; the sum of chunk j over the ranks lands on rank j. At
//    step t rank r folds its chunk (r + d - 1 - t) % d into the
//    accumulator rank r - 1 sent and forwards the sum. As on the TPU
//    (acc_init there) the accumulator is in the operand dtype: each hop
//    rounds float(chunk) + float(received) once; step 0 sends the chunk as
//    it is.
//
// What bounds them on an H100: bytes. A rank of K4 sends (d - 1) shards
// over NVLink (at m = 8192, k = 8192 bf16, d = 4: 100.7 MB, 0.224 ms at
// 450 GB/s a direction) and K5 (d - 1) chunks (25.2 MB, 0.056 ms); in
// loopback, d virtual ranks on one card, the same bytes cross the card's
// memory (3.35 TB/s) instead.
//
// Design (collective_matmul.cu's ring protocol without the GEMM, on
// per-block flags):
//  - One cooperative launch per rank: every block of the grid is resident
//    at once, because blocks spin on flags that other blocks (of this rank
//    and of its neighbours) write. The grid is at most two blocks of 512
//    threads an SM.
//  - Peer memory: each rank owns a buffer of flag words and two slots of
//    one chunk; the kernel gets a table of every rank's buffer (NVLink peer
//    pointers from symmetric memory, or one card's memory in loopback).
//    The output is this rank's own fresh tensor: only the slots are
//    written from other cards.
//  - Every block owns one contiguous share of the chunk's 16-byte units at
//    every step, the same share on every rank (share_of). K4: it reads its
//    share of the chunk it holds once and stores it twice, into its output
//    rows and into the right neighbour's slot (t + 1) % 2. K5: it reads its
//    share of its own chunk and of the received accumulator, adds them in
//    float32, rounds once and stores the sum into the right neighbour's
//    slot (the put is the fold's store), or into the output at the last
//    step. Each thread keeps four 16-byte loads in flight before its
//    stores, then a tail loop takes the rest.
//  - Signals are point to point: block b's share at step t depends on
//    block b of the left rank at step t - 1 alone, so block b waits for
//    that block's arrival (arrive[b][t] in its own flags), and before it
//    overwrites the right rank's slot for that block's credit
//    (credit[b][t - 1]); after its share it signals arrive[b][t + 1] at the
//    right rank and credit[b][t] at the left one, one fence, one barrier
//    and one thread for both. Blocks move through the ring at their own
//    pace, so a slow block holds up its own column of the ring only, and
//    the d - 1 steps pipeline across blocks instead of meeting at a barrier
//    across two cards. Each block drains its own last credits. The
//    per-block words sit past the entry barrier's first 1 KB of the flag
//    area, 64 bytes a block, which caps the grid at MAX_FLAG_BLOCKS. K4's
//    and K5's rings are their own (a ring serves one kernel), so both use
//    the same words.
//  - An entry barrier with both neighbours keeps a fast rank's first put
//    out of a slot its neighbour still reads in the previous call.
//  - Flags never reset: each counter grows by one every call, the host
//    passes the call's epoch and waits compare with >= modulo 2^32.
//    Signals are red.release.sys after a system fence; waits are
//    ld.acquire.sys. Slot data is read through L2 only (ld.global.cg). A
//    wait of 20 s traps rather than holding the card.
//  - Loopback: gridDim.y = d runs d virtual ranks on one card, each with
//    its own buffer in that card's memory: the same protocol, on one card.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// after its launch (0 = success). Launches on the caller's stream, never
// synchronises, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int MAX_RANKS = 8;
// flag words of a rank's buffer (uint32 offsets): the entry barrier, then
// from byte 1024 on the per-block words, block b's arrival counters of
// steps 0 .. MAX_RANKS - 1, then its credits
constexpr int BARRIER = 64;
constexpr int BLOCK_FLAGS = 256, BLOCK_WORDS = 2 * MAX_RANKS;
constexpr int FLAG_BYTES = 20480;  // the slots start here (every ring's layout)
constexpr int MAX_FLAG_BLOCKS = (FLAG_BYTES / 4 - BLOCK_FLAGS) / BLOCK_WORDS;  // 304
static_assert(BARRIER < BLOCK_FLAGS, "the entry barrier's word comes first");
static_assert(4 * (BLOCK_FLAGS + MAX_FLAG_BLOCKS * BLOCK_WORDS) <= FLAG_BYTES,
              "the per-block words end before the slots");
constexpr int THREADS = 512;
constexpr int MAX_BLOCKS_PER_SM = 2;

struct RingCollArgs {
  // per virtual rank (blockIdx.y); index 0 only with one rank a process
  const void* a[MAX_RANKS];
  void* out[MAX_RANKS];
  // per ring rank: the base of its buffer (flags, then two slots)
  unsigned char* buf[MAX_RANKS];
  int rank0;  // ring rank of blockIdx.y == 0
  int d;
  long long chunk_units;  // 16-byte units of one chunk
  long long slot_stride;  // bytes from slot 0 to slot 1
  unsigned epoch;
};

// ---------------------------------------------------------------------------
// flags
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned* flags_of(const RingCollArgs& p, int rank) {
  return reinterpret_cast<unsigned*>(p.buf[rank]);
}

// Block b's arrival counters in rank `rank`'s flags; its credits follow at
// + MAX_RANKS.
__device__ __forceinline__ unsigned* block_flags(const RingCollArgs& p, int rank,
                                                 int b) {
  return flags_of(p, rank) + BLOCK_FLAGS + b * BLOCK_WORDS;
}

__device__ __forceinline__ uint4* slot_of(const RingCollArgs& p, int rank,
                                          int slot) {
  return reinterpret_cast<uint4*>(p.buf[rank] + FLAG_BYTES +
                                  slot * p.slot_stride);
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

// One thread: wait until *f >= target (mod 2^32).
__device__ __forceinline__ void spin_wait(const unsigned* f, unsigned target) {
  const unsigned long long start = globaltimer_ns();
  while (static_cast<int>(ld_acquire(f) - target) < 0) {
    __nanosleep(64);
    if (globaltimer_ns() - start > WAIT_LIMIT_NS) __trap();
  }
}

// Block-wide: wait until *f >= target (mod 2^32), then every thread may
// read what the signallers wrote before they signalled.
__device__ __forceinline__ void block_wait(const unsigned* f,
                                           unsigned target) {
  if (threadIdx.x == 0) spin_wait(f, target);
  __syncthreads();
}

// Block (0, y) tells both neighbours that this rank entered the call (its
// previous call is over); every block waits until both neighbours have.
__device__ __forceinline__ void entry_barrier(const RingCollArgs& p, int r) {
  const int d = p.d;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    red_release_add(flags_of(p, (r + d - 1) % d) + BARRIER, 1u);
    red_release_add(flags_of(p, (r + 1) % d) + BARRIER, 1u);
  }
  block_wait(flags_of(p, r) + BARRIER, 2u * (p.epoch + 1u));
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

// The elementwise sum of two 16-byte vectors of T, each element's sum taken
// in float32 and rounded once to T.
template <typename T>
__device__ __forceinline__ uint4 add16(uint4 x, uint4 y) {
  constexpr int N = 16 / sizeof(T);
  const T* a = reinterpret_cast<const T*>(&x);
  const T* b = reinterpret_cast<const T*>(&y);
  uint4 s;
  T* o = reinterpret_cast<T*>(&s);
#pragma unroll
  for (int e = 0; e < N; ++e)
    o[e] = Cvt<T>::from_float(Cvt<T>::to_float(a[e]) + Cvt<T>::to_float(b[e]));
  return s;
}

// This block's share [lo, hi) of a chunk of `units` 16-byte units.
__device__ __forceinline__ void share_of(long long units, long long* lo,
                                         long long* hi) {
  const long long parts = gridDim.x;
  const long long per = (units + parts - 1) / parts;
  *lo = per * blockIdx.x < units ? per * blockIdx.x : units;
  *hi = *lo + per < units ? *lo + per : units;
}

// ---------------------------------------------------------------------------
// K4: ring all-gather
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) ring_all_gather_kernel(RingCollArgs p) {
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const int right = (r + 1) % d, left = (r + d - 1) % d;
  const unsigned e = p.epoch;
  // this block's arrivals and credits, and its peers' at both neighbours
  unsigned* arrive = block_flags(p, r, blockIdx.x);
  unsigned* credit = arrive + MAX_RANKS;
  unsigned* arrive_right = block_flags(p, right, blockIdx.x);
  unsigned* credit_left = block_flags(p, left, blockIdx.x) + MAX_RANKS;
  const long long units = p.chunk_units;
  long long lo, hi;
  share_of(units, &lo, &hi);
  uint4* out = static_cast<uint4*>(p.out[y]);

  entry_barrier(p, r);
  for (int t = 0; t < d; ++t) {
    const uint4* held =
        t == 0 ? static_cast<const uint4*>(p.a[y]) : slot_of(p, r, t & 1);
    const bool put = t < d - 1;
    // block b of the left rank put this block's share of step t, and block
    // b of the right rank is done with the share this step overwrites (it
    // read it at its step t - 1)
    if (threadIdx.x == 0) {
      if (t > 0) spin_wait(arrive + t, e + 1);
      if (put && t >= 2) spin_wait(credit + t - 1, e + 1);
    }
    __syncthreads();
    uint4* rows = out + static_cast<long long>((r - t + d) % d) * units;
    uint4* next = put ? slot_of(p, right, (t + 1) & 1) : nullptr;
    long long i = lo + threadIdx.x;
    for (; i + 3 * THREADS < hi; i += 4 * THREADS) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldcg(held + i + u * THREADS);
#pragma unroll
      for (int u = 0; u < 4; ++u) __stcg(rows + i + u * THREADS, v[u]);
      if (put) {
#pragma unroll
        for (int u = 0; u < 4; ++u) __stcg(next + i + u * THREADS, v[u]);
      }
    }
    for (; i < hi; i += THREADS) {
      const uint4 v = __ldcg(held + i);
      __stcg(rows + i, v);
      if (put) __stcg(next + i, v);
    }
    // publish the put to block b of the right rank; done with slot t % 2
    if (put || t > 0) {
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) {
        if (put) red_release_add(arrive_right + t + 1, 1u);
        if (t > 0) red_release_add(credit_left + t, 1u);
      }
    }
  }
  // the right rank's block b is done with every slot this block wrote
  if (threadIdx.x == 0) {
    for (int t = 1; t < d; ++t) spin_wait(credit + t, e + 1);
  }
}

// ---------------------------------------------------------------------------
// K5: ring reduce-scatter
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) ring_reduce_scatter_kernel(RingCollArgs p) {
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const int right = (r + 1) % d, left = (r + d - 1) % d;
  const unsigned e = p.epoch;
  // this block's arrivals and credits, and its peers' at both neighbours
  unsigned* arrive = block_flags(p, r, blockIdx.x);
  unsigned* credit = arrive + MAX_RANKS;
  unsigned* arrive_right = block_flags(p, right, blockIdx.x);
  unsigned* credit_left = block_flags(p, left, blockIdx.x) + MAX_RANKS;
  const long long units = p.chunk_units;
  long long lo, hi;
  share_of(units, &lo, &hi);
  const uint4* A = static_cast<const uint4*>(p.a[y]);

  entry_barrier(p, r);
  for (int t = 0; t < d; ++t) {
    const uint4* chunk = A + static_cast<long long>((r + d - 1 - t) % d) * units;
    const uint4* received = t > 0 ? slot_of(p, r, t & 1) : nullptr;
    const bool put = t < d - 1;
    // block b of the left rank put this block's share of step t, and block
    // b of the right rank is done with the share this step overwrites
    // (it read it at its step t - 1)
    if (threadIdx.x == 0) {
      if (t > 0) spin_wait(arrive + t, e + 1);
      if (put && t >= 2) spin_wait(credit + t - 1, e + 1);
    }
    __syncthreads();
    uint4* dst = put ? slot_of(p, right, (t + 1) & 1) : static_cast<uint4*>(p.out[y]);
    long long i = lo + threadIdx.x;
    for (; i + 3 * THREADS < hi; i += 4 * THREADS) {
      uint4 v[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldcg(chunk + i + u * THREADS);
      if (received != nullptr) {
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = __ldcg(received + i + u * THREADS);
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = add16<T>(v[u], w[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) __stcg(dst + i + u * THREADS, v[u]);
    }
    for (; i < hi; i += THREADS) {
      uint4 v = __ldcg(chunk + i);
      if (received != nullptr) v = add16<T>(v, __ldcg(received + i));
      __stcg(dst + i, v);
    }
    // publish the put to block b of the right rank; done with slot t % 2
    if (put || t > 0) {
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) {
        if (put) red_release_add(arrive_right + t + 1, 1u);
        if (t > 0) red_release_add(credit_left + t, 1u);
      }
    }
  }
  // the right rank's block b is done with every slot this block wrote
  if (threadIdx.x == 0) {
    for (int t = 1; t < d; ++t) spin_wait(credit + t, e + 1);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Blocks a virtual rank gets: at most two an SM, shared by the ranks of the
// launch (a cooperative launch of more than the card holds is refused), and
// at most MAX_FLAG_BLOCKS (the per-block flags). A card's SM count and a
// kernel's resident blocks an SM do not change within a process: they are
// asked once a (kernel, device) and read from a table after that, which
// keeps CUDA's queries off every launch's host time.
struct GridEntry {
  const void* kernel;
  int device, per_card;
};
constexpr int GRID_CACHE = 64;
GridEntry grid_cache[GRID_CACHE];
int grid_cached = 0;
std::mutex grid_mutex;

template <typename K>
int grid_for(K kernel, int vranks, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* key = reinterpret_cast<const void*>(kernel);
  int per_card = -1;
  {
    std::lock_guard<std::mutex> lock(grid_mutex);
    for (int i = 0; i < grid_cached; ++i)
      if (grid_cache[i].kernel == key && grid_cache[i].device == dev)
        per_card = grid_cache[i].per_card;
  }
  if (per_card < 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
    per_card = per_sm * sms;
    std::lock_guard<std::mutex> lock(grid_mutex);
    if (grid_cached < GRID_CACHE) grid_cache[grid_cached++] = {key, dev, per_card};
  }
  *blocks = per_card / vranks;
  if (*blocks > MAX_FLAG_BLOCKS) *blocks = MAX_FLAG_BLOCKS;
  return *blocks >= 1 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename K>
int launch(K kernel, RingCollArgs& p, int vranks, cudaStream_t s) {
  int blocks = 0;
  int rc = grid_for(kernel, vranks, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks, vranks),
      dim3(THREADS), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kind: 0 = K4 ring_all_gather, 1 = K5 ring_reduce_scatter.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (K4 copies bytes and
// ignores it).
// a, out: vranks device pointers each (the input and output of ring ranks
// rank0 .. rank0 + vranks - 1); buf: d device pointers, each rank's buffer
// (FLAG_BYTES of zeroed flags, then two slots slot_stride bytes apart) as
// this process addresses it. chunk_units: 16-byte units of one chunk.
// K4: a [chunk], out [d * chunk]; K5: a [d * chunk], out [chunk].
int ddlb_ring_collective(int kind, int dtype, const unsigned long long* a,
                         const unsigned long long* out,
                         const unsigned long long* buf, int rank0, int vranks,
                         int d, long long chunk_units, long long slot_stride,
                         unsigned epoch, void* stream) {
  if (d < 1 || d > MAX_RANKS || vranks < 1 || rank0 < 0 || rank0 + vranks > d ||
      chunk_units < 1 || slot_stride < 16 * chunk_units || (slot_stride & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  RingCollArgs p;
  for (int i = 0; i < vranks; ++i) {
    p.a[i] = reinterpret_cast<const void*>(a[i]);
    p.out[i] = reinterpret_cast<void*>(out[i]);
  }
  for (int i = 0; i < d; ++i) p.buf[i] = reinterpret_cast<unsigned char*>(buf[i]);
  p.rank0 = rank0;
  p.d = d;
  p.chunk_units = chunk_units;
  p.slot_stride = slot_stride;
  p.epoch = epoch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch(ring_all_gather_kernel, p, vranks, s);
  if (kind != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch(ring_reduce_scatter_kernel<float>, p, vranks, s);
    case 1:
      return launch(ring_reduce_scatter_kernel<__half>, p, vranks, s);
    case 2:
      return launch(ring_reduce_scatter_kernel<__nv_bfloat16>, p, vranks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ddlb_ring_collective_flag_bytes() { return FLAG_BYTES; }

const char* ddlb_ring_collective_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
