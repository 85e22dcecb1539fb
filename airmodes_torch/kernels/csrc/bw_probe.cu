// Probes P1-P3: what the card's device memory sustains for a copy and for
// a read, and whether bulk asynchronous copies into shared memory, single
// buffered and through a ring, reach that rate. For NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probes of scripts/tpu_bw_probe.py:
//   P1 `copy_kernel` (`pallas_copy`): y = x + 1 over a (rows, 128) f32
//      array, in BlockSpec-pipelined (1024, 128) blocks;
//   P2 `dma_kernel` (`pallas_dma_read`): per 144-row window, one manual
//      DMA into VMEM, then the window's column sums written to 8 output
//      rows;
//   P3 `dma2_kernel` (`pallas_dma2_read`): the same output, with window
//      i+1's DMA in flight while window i is summed.
// Windows: rows // 144 of them; the last rows % 144 rows are never read.
//
// What bounds them on this card: bytes. P1 reads and writes 4 bytes per
// element and does one add; P2 and P3 read 4 bytes per element and do one
// add, and write 8 rows per 144 read. At 3.35 TB/s a 1 GiB array takes
// ~0.64 ms to copy and ~0.32 ms to read; each does < 1 f32 instruction per
// 4 bytes, far below the card's 33.5 T/s.
//
// Design. The launch geometry (P1: the span of a CTA and the grid; P3: the
// grid, the ring's stages and the shared-memory bytes) is computed by
// `copy_geometry` / `ring_geometry` in probes/bw_probe.py and checked here.
//  - P1: each CTA owns one contiguous 2 KB span, one 16-byte load, add
//    and store per thread, so the CTAs that run at once (16 of 128 threads
//    per SM) sweep one contiguous front of the array, as PyTorch's
//    elementwise kernels do; __fadd_rn so that nothing else is computed.
//    A grid-stride loop, CTAs of 256-1024 threads, 2-16 float4s per
//    thread, loads that skip L1 with streaming stores, and a bulk round
//    trip through a shared-memory ring all measured slower on the card
//    (PERF.md).
//  - P2: one CTA of 128 threads per window. Thread 0 initialises an
//    mbarrier, announces 73,728 bytes on it and issues one
//    cp.async.bulk copy of the window into shared memory (the
//    counterpart of pltpu.make_async_copy + start); every thread waits on
//    the barrier's phase (+ wait). Thread t then sums column t over rows
//    0..143 in row order with __fadd_rn and writes the sum to the
//    window's 8 output rows. Three CTAs fit on an SM (3 x 72 KB of its
//    227 KB), so one CTA's copy overlaps another's sum.
//  - P3: the card's bulk-read pipeline. One persistent CTA per SM holds
//    two pipelines, each a producer thread, a summing warpgroup and its
//    own ring of three half-window slots (72 rows, 36,864 bytes; six
//    slots, 221,184 bytes a CTA). Each slot has a "full" mbarrier (the
//    copy's bytes) and an "empty" one (its 128 summing threads arrive
//    when they have read it); the producer refills a slot the moment it
//    is released, so while a half-window is summed the others' copies
//    stay in flight, and thread t sums column t of a window over both
//    halves in row order. The producers take windows from one ticket
//    counter, as the hardware hands P2's CTAs out: with a fixed walk
//    (CTA b taking windows b, b + gridDim.x, ..., the TPU's "next
//    window" read per CTA) the CTAs drift apart and the last to finish
//    sets the time, 0.5% slower on the card (PERF.md). A pipeline reads
//    every fill of its slots in order and its producer waits for every
//    release in order, so no barrier is ever two phases ahead of its
//    waiter and one parity bit names the phase.
// The column sums of P2 and P3 take the same operands in the same order
// as their plain PyTorch version (bw_probe.py), so they are equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWinRows = 144;
constexpr int kWinBytes = kWinRows * kLanes * (int)sizeof(float);  // 73,728
constexpr int kOutRows = 8;
constexpr int kHalfRows = kWinRows / 2;
constexpr int kHalfFloats = kHalfRows * kLanes;
constexpr int kHalfBytes = kHalfFloats * (int)sizeof(float);  // 36,864
constexpr int kGroups = 2;  // P3's pipelines per CTA
constexpr int kRingThreads = kGroups * (kLanes + 32);  // + producer warps
constexpr int kRingOffset = 128;  // P3's barriers and slot windows, then ring
constexpr int kMaxSmem = 232448;  // shared memory a CTA can have
constexpr int kCopyThreads = 128;

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of transactions on the barrier;
// the phase completes when the copy has delivered them.
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival (release: this thread's reads of the slot come before it).
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this CTA's shared memory, completing on `bar`.
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bulk_load with an L2 cache policy (createpolicy).
__device__ inline void bulk_load_hint(void* dst, const void* src,
                                      uint32_t bytes, uint64_t* bar,
                                      uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ inline float4 plus_one(float4 v) {
  return make_float4(__fadd_rn(v.x, 1.f), __fadd_rn(v.y, 1.f),
                     __fadd_rn(v.z, 1.f), __fadd_rn(v.w, 1.f));
}

// Thread t's column sum of a staged window, in row order, written to the
// window's 8 output rows.
__device__ inline void sum_window(const float* win, float* out, long long w) {
  const int t = threadIdx.x;
  float s = win[t];
#pragma unroll 16
  for (int r = 1; r < kWinRows; ++r) s = __fadd_rn(s, win[r * kLanes + t]);
  float* o = out + w * kOutRows * kLanes + t;
#pragma unroll
  for (int r = 0; r < kOutRows; ++r) o[r * kLanes] = s;
}

// P1 over n4 float4s: CTA b takes the span [b * kCopyThreads,
// + kCopyThreads), one float4 per thread.
__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const float4* __restrict__ x, float4* __restrict__ y,
            long long n4) {
  const long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (i < n4) y[i] = plus_one(__ldg(x + i));
}

// P2: window blockIdx.x of `steps`; a launch with no window has one CTA
// that does nothing.
__global__ void __launch_bounds__(kLanes)
dma_read_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long steps) {
  extern __shared__ __align__(128) float win[];
  __shared__ uint64_t bar;
  const long long w = blockIdx.x;
  if (w >= steps) return;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, kWinBytes);
    bulk_load(win, x + w * kWinRows * kLanes, kWinBytes, &bar);
  }
  mbar_wait(&bar, 0);
  sum_window(win, out, w);
}

// P3: kGroups pipelines per CTA, each a producer thread (lane 0 of warp
// kGroups * 4 + g), a consumer warpgroup (warps 4g..4g+3) and a ring of
// `per` half-window slots. The producer takes windows from the grid's
// ticket counter; a pipeline's i-th window fills its half-windows j = 2i
// and 2i + 1, in slot j % per as fill j / per; the window's index rides
// in `win` beside the first half, and -1 there (a fill with no bytes)
// ends the pipeline. The last CTA to finish sets the counter back to 0
// for the next launch on the stream.
__global__ void __launch_bounds__(kRingThreads, 1)
ring_read_kernel(const float* __restrict__ x, float* __restrict__ out,
                 unsigned* __restrict__ tickets, unsigned steps, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stages = per * kGroups;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  int* win = reinterpret_cast<int*>(empty + stages);
  float* ring = reinterpret_cast<float*>(smem + kRingOffset);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kLanes);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp >= kGroups * 4) {  // a producer warp: its lane 0 issues
    const int g = warp - kGroups * 4;
    if (threadIdx.x % 32 == 0) {
      uint64_t policy;  // the windows are read once: first out of L2
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(policy));
      for (int j = 0;; j += 2) {
        const unsigned w = atomicAdd(tickets, 1u);
        for (int half = 0; half < 2; ++half) {
          const int slot = g * per + (j + half) % per;
          const int fill = (j + half) / per;
          if (fill > 0) mbar_wait(&empty[slot], (fill - 1) & 1);
          if (w >= steps) {  // the end: an empty fill with win -1
            win[slot] = -1;
            mbar_arrive(&full[slot]);
            break;
          }
          if (half == 0) win[slot] = (int)w;
          mbar_expect_tx(&full[slot], kHalfBytes);
          bulk_load_hint(ring + slot * kHalfFloats,
                         x + ((long long)w * kWinRows + half * kHalfRows) *
                                 kLanes,
                         kHalfBytes, &full[slot], policy);
        }
        if (w >= steps) break;
      }
    }
  } else {
    const int g = warp / 4, t = threadIdx.x % kLanes;
    for (int j = 0;; j += 2) {
      float s = 0.f;
      int w = -1;
      for (int half = 0; half < 2; ++half) {
        const int slot = g * per + (j + half) % per;
        mbar_wait(&full[slot], ((j + half) / per) & 1);
        if (half == 0 && (w = win[slot]) < 0) break;
        const float* p = ring + slot * kHalfFloats + t;
        if (half == 0) s = p[0];
#pragma unroll 8
        for (int r = half ? 0 : 1; r < kHalfRows; ++r)
          s = __fadd_rn(s, p[r * kLanes]);
        mbar_arrive(&empty[slot]);
      }
      if (w < 0) break;
      float* o = out + (long long)w * kOutRows * kLanes + t;
#pragma unroll
      for (int r = 0; r < kOutRows; ++r) o[r * kLanes] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(tickets + 1, 1u) == gridDim.x - 1) {
      tickets[0] = 0;
      tickets[1] = 0;
    }
  }
}

}  // namespace

extern "C" {

// P1 over n floats (a multiple of 4; x and y 16-byte aligned) on
// `stream`, `grid` CTAs of `span4` float4s each (copy_geometry: span4 is
// one float4 per thread); returns cudaGetLastError(). Allocates nothing
// and does not synchronise.
int bw_copy_launch(const void* x, void* y, long long n, long long span4,
                   long long grid, void* stream) {
  const long long n4 = n / 4;
  if (n % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 || span4 != kCopyThreads ||
      grid < 1 || grid > 0x7fffffff || (grid - 1) * span4 >= n4 ||
      grid * span4 < n4)
    return (int)cudaErrorInvalidValue;
  copy_kernel<<<(unsigned)grid, kCopyThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4);
  return (int)cudaGetLastError();
}

// P2 over a (rows, 128) f32 array x (16-byte aligned) into out
// ((rows / 144) * 8, 128) on `stream`; returns cudaGetLastError().
// Allocates nothing and does not synchronise.
int bw_read_launch(const void* x, void* out, long long rows, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorInvalidValue;
  const long long steps = rows / kWinRows;
  cudaError_t err = cudaFuncSetAttribute(
      dma_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWinBytes);
  if (err != cudaSuccess) return (int)err;
  dma_read_kernel<<<(unsigned)(steps > 0 ? steps : 1), kLanes, kWinBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), steps);
  return (int)cudaGetLastError();
}

// P3 as P2, from `grid` persistent CTAs, each with a ring of `stages`
// half-window slots in `smem` bytes of shared memory (ring_geometry), and
// `tickets`: two unsigned ints on the card, 0 before the first launch on
// `stream` (each launch leaves them 0).
int bw_ring_read_launch(const void* x, void* out, void* tickets,
                        long long rows, long long grid, int stages, int smem,
                        void* stream) {
  const long long steps = rows / kWinRows;
  if (reinterpret_cast<uintptr_t>(x) % 16 || grid < 1 || grid > 0x7fffffff ||
      steps > 0x7fffffff - 2 * kGroups * grid || stages < 2 * kGroups ||
      stages % kGroups ||
      stages * (2 * (int)sizeof(uint64_t) + (int)sizeof(int)) > kRingOffset ||
      smem < kRingOffset + stages * kHalfBytes || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ring_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ring_read_kernel<<<(unsigned)grid, kRingThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<unsigned*>(tickets), (unsigned)steps, stages / kGroups);
  return (int)cudaGetLastError();
}

}  // extern "C"
