// Probes P1-P3: what the card's device memory sustains for a copy and for
// a read, and whether bulk asynchronous copies into shared memory, single
// and double buffered, reach that rate. For NVIDIA Hopper (sm_90a).
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
// Design.
//  - P1: a grid-stride loop, four 16-byte loads in flight per thread
//    before their adds and stores, __fadd_rn so that nothing else is
//    computed.
//  - P2: one CTA of 128 threads per window. Thread 0 initialises an
//    mbarrier, announces 73,728 bytes on it and issues one
//    cp.async.bulk copy of the window into shared memory (the
//    counterpart of pltpu.make_async_copy + start); every thread waits on
//    the barrier's phase (+ wait). Thread t then sums column t over rows
//    0..143 in row order with __fadd_rn and writes the sum to the
//    window's 8 output rows. Three CTAs fit on an SM (3 x 72 KB of its
//    227 KB), so one CTA's copy overlaps another's sum.
//  - P3: persistent CTAs, one per SM, each walking windows blockIdx.x,
//    + gridDim.x, ... with two shared-memory slots (144 KB) and one
//    mbarrier each. It issues its next window's copy before it waits on
//    the current one; a barrier at the end of each window keeps a slot
//    from being refilled while it is read. The TPU ran its grid in order
//    on one core, so there "next" was window i+1; here it is the CTA's
//    own next window.
// The column sums of P2 and P3 take the same operands in the same order
// as their plain PyTorch version (bw_probe.py), so they are equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWinRows = 144;
constexpr int kWinBytes = kWinRows * kLanes * (int)sizeof(float);  // 73,728
constexpr int kOutRows = 8;
constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
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

__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const float4* __restrict__ x, float4* __restrict__ y,
            long long n4) {
  const long long stride = (long long)gridDim.x * kCopyThreads;
  long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  for (; i + (kCopyUnroll - 1) * stride < n4; i += kCopyUnroll * stride) {
    float4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) v[u] = __ldg(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      y[i + u * stride] =
          make_float4(__fadd_rn(v[u].x, 1.f), __fadd_rn(v[u].y, 1.f),
                      __fadd_rn(v[u].z, 1.f), __fadd_rn(v[u].w, 1.f));
  }
  for (; i < n4; i += stride) {
    const float4 v = __ldg(x + i);
    y[i] = make_float4(__fadd_rn(v.x, 1.f), __fadd_rn(v.y, 1.f),
                       __fadd_rn(v.z, 1.f), __fadd_rn(v.w, 1.f));
  }
}

__global__ void __launch_bounds__(kLanes)
dma_read_kernel(const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ __align__(128) float win[];
  __shared__ uint64_t bar;
  const long long w = blockIdx.x;
  if (threadIdx.x == 0) {
    mbar_init(&bar);
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

__global__ void __launch_bounds__(kLanes)
dma2_read_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long steps) {
  extern __shared__ __align__(128) float win[];  // two slots
  __shared__ uint64_t bar[2];
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    mbar_fence_init();
  }
  __syncthreads();
  long long w = blockIdx.x;
  if (threadIdx.x == 0 && w < steps) {
    mbar_expect_tx(&bar[0], kWinBytes);
    bulk_load(win, x + w * kWinRows * kLanes, kWinBytes, &bar[0]);
  }
  for (int k = 0; w < steps; w += gridDim.x, ++k) {
    const int slot = k & 1;
    const long long next = w + gridDim.x;
    // the other slot was last read in window k - 1, which every thread
    // left through the barrier below
    if (threadIdx.x == 0 && next < steps) {
      mbar_expect_tx(&bar[slot ^ 1], kWinBytes);
      bulk_load(win + (slot ^ 1) * kWinRows * kLanes,
                x + next * kWinRows * kLanes, kWinBytes, &bar[slot ^ 1]);
    }
    mbar_wait(&bar[slot], (k >> 1) & 1);  // the slot's (k/2)-th fill
    sum_window(win + slot * kWinRows * kLanes, out, w);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// P1 over n floats (a multiple of 4; x and y 16-byte aligned) on `stream`;
// returns cudaGetLastError(). Allocates nothing and does not synchronise.
int bw_copy_launch(const void* x, void* y, long long n, void* stream) {
  if (n % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n4 = n / 4;
  long long blocks = (long long)sms * 8;  // 8 CTAs of 256 threads per SM
  const long long need = (n4 + kCopyThreads - 1) / kCopyThreads;
  if (blocks > need) blocks = need;
  if (blocks < 1) return (int)cudaSuccess;
  copy_kernel<<<(unsigned)blocks, kCopyThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4);
  return (int)cudaGetLastError();
}

// P2 (double_buffer = 0) or P3 (1) over a (rows, 128) f32 array x (16-byte
// aligned) into out ((rows / 144) * 8, 128) on `stream`; returns
// cudaGetLastError(). Allocates nothing and does not synchronise.
int bw_read_launch(const void* x, void* out, long long rows,
                   int double_buffer, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorInvalidValue;
  const long long steps = rows / kWinRows;
  if (steps < 1) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaError_t err;
  if (!double_buffer) {
    err = cudaFuncSetAttribute(dma_read_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWinBytes);
    if (err != cudaSuccess) return (int)err;
    dma_read_kernel<<<(unsigned)steps, kLanes, kWinBytes, s>>>(xf, of);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dma2_read_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * kWinBytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = steps < sms ? steps : sms;
  dma2_read_kernel<<<(unsigned)grid, kLanes, 2 * kWinBytes, s>>>(xf, of,
                                                                 steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
