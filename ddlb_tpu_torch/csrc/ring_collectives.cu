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
// Design (collective_matmul.cu's ring protocol without the GEMM; right and
// simple first):
//  - One cooperative launch per rank: every block of the grid is resident
//    at once, because blocks spin on flags that other blocks (of this rank
//    and of its neighbours) write. The grid is at most two blocks an SM.
//  - Peer memory: each rank owns a buffer of flag words and two slots of
//    one chunk; the kernel gets a table of every rank's buffer (NVLink peer
//    pointers from symmetric memory, or one card's memory in loopback).
//    The output is this rank's own fresh tensor: only the slots are
//    written from other cards.
//  - Every block owns one contiguous share of the chunk's 16-byte units at
//    every step. K4: it reads its share of the chunk it holds once and
//    stores it twice, into its output rows and into the right neighbour's
//    slot (t + 1) % 2. K5: it reads its share of its own chunk and of the
//    received accumulator, adds them in float32, rounds once and stores
//    the sum into the right neighbour's slot (the put is the fold's
//    store), or into the output at the last step.
//  - Signals: after its share, a block adds one to the right neighbour's
//    arrival counter of the next step; a rank reads a slot once all the
//    left neighbour's blocks have signalled. After reading slot t % 2 a
//    block credits the left neighbour, which waits for every credit before
//    it overwrites that slot two steps later. An entry barrier with both
//    neighbours keeps a fast rank's first put out of a slot its neighbour
//    still reads in the previous call, and the last credits are drained.
//  - Flags never reset: each step has its own arrival and credit counter
//    (an aggregate count would let a block that ran ahead stand in for one
//    still at work), each grows by the grid size every call, the host
//    passes the call's epoch and waits compare with >= modulo 2^32.
//    Signals are red.release.sys after a system fence; waits are
//    ld.acquire.sys. Slot data is read through L2 only (ld.global.cg).
//    A wait of 20 s traps rather than holding the card.
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

namespace {

constexpr int MAX_RANKS = 8;
// flag words of a rank's buffer (uint32 offsets, one 128-byte line each)
constexpr int ARRIVE = 0, CREDIT = 32, BARRIER = 64;
constexpr int FLAG_BYTES = 1024;  // the slots start here
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
  const unsigned G = gridDim.x, e = p.epoch;
  unsigned* mine = flags_of(p, r);
  const long long units = p.chunk_units;
  long long lo, hi;
  share_of(units, &lo, &hi);
  uint4* out = static_cast<uint4*>(p.out[y]);

  entry_barrier(p, r);
  for (int t = 0; t < d; ++t) {
    const uint4* held =
        t == 0 ? static_cast<const uint4*>(p.a[y]) : slot_of(p, r, t & 1);
    const bool put = t < d - 1;
    // the chunk of step t has landed (every block of the left neighbour
    // signalled at its step t - 1), and every block of the right neighbour
    // is done with the slot this step writes (it read it at its step t - 1)
    if (t > 0) block_wait(mine + ARRIVE + t, (e + 1) * G);
    if (put && t >= 2) block_wait(mine + CREDIT + t - 1, (e + 1) * G);
    uint4* rows = out + static_cast<long long>((r - t + d) % d) * units;
    uint4* next = put ? slot_of(p, right, (t + 1) & 1) : nullptr;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const uint4 v = __ldcg(held + i);
      __stcg(rows + i, v);
      if (put) __stcg(next + i, v);
    }
    if (put) block_signal(flags_of(p, right) + ARRIVE + t + 1);
    // this block is done with slot t % 2
    if (t > 0) block_signal(flags_of(p, left) + CREDIT + t);
  }
  drain(mine, d, (e + 1) * G);
}

// ---------------------------------------------------------------------------
// K5: ring reduce-scatter
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) ring_reduce_scatter_kernel(RingCollArgs p) {
  const int y = blockIdx.y, d = p.d, r = p.rank0 + y;
  const int right = (r + 1) % d, left = (r + d - 1) % d;
  const unsigned G = gridDim.x, e = p.epoch;
  unsigned* mine = flags_of(p, r);
  const long long units = p.chunk_units;
  long long lo, hi;
  share_of(units, &lo, &hi);
  const uint4* A = static_cast<const uint4*>(p.a[y]);

  entry_barrier(p, r);
  for (int t = 0; t < d; ++t) {
    const uint4* chunk = A + static_cast<long long>((r + d - 1 - t) % d) * units;
    const uint4* received = t > 0 ? slot_of(p, r, t & 1) : nullptr;
    const bool put = t < d - 1;
    if (t > 0) block_wait(mine + ARRIVE + t, (e + 1) * G);
    if (put && t >= 2) block_wait(mine + CREDIT + t - 1, (e + 1) * G);
    uint4* dst = put ? slot_of(p, right, (t + 1) & 1) : static_cast<uint4*>(p.out[y]);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      uint4 v = __ldcg(chunk + i);
      if (received != nullptr) v = add16<T>(v, __ldcg(received + i));
      __stcg(dst + i, v);
    }
    if (put) block_signal(flags_of(p, right) + ARRIVE + t + 1);
    if (t > 0) block_signal(flags_of(p, left) + CREDIT + t);
  }
  drain(mine, d, (e + 1) * G);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Blocks a virtual rank gets: at most two an SM, shared by the ranks of the
// launch (a cooperative launch of more than the card holds is refused).
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
  if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
  *blocks = per_sm * sms / vranks;
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
