// Kernel B2: per-detection power windows cut from planar int8 I/Q, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_slice_kernel` in
// airmodes/kernels/preamble_pallas.py, as launched by
// `slice_windows_planar`. For table row g with window start base[g] >= 0
// (a flat sample index into the (C*P,) planar streams), column j of the
// output is the power fma(xi, xi, xq*xq), xi = int8 * (1/127), of sample
// base[g] + j for j < out_len, and zero for out_len <= j < pad_len. A row
// with base < 0 (an empty table slot) is all zeros. A sample past the end
// of the streams reads as zero; the planar geometry's margin keeps every
// real window inside them.
//
// The power is a fused multiply-add because that is what the JAX reference
// computes (XLA contracts xi*xi + xq*xq); the plain PyTorch version
// reproduces it exactly.
//
// What bounds it on this card: bytes. It reads out_len int8 pairs per
// non-empty window and writes pad_len f32 per window; at C*K = 1024
// windows that is ~1.6 MB at the demod paths' width (pad_len = out_len =
// 384 at 2 Msps) and ~4 MiB at the reference's (pad_len 1024), a few
// microseconds at most at 3.35 TB/s, so a launch and one DRAM round trip
// per window are what it can hope to cost. Design: one warp per window, 8
// windows per CTA, so that a window's emptiness is uniform in its warp.
// The warp loads the window's byte span of both planes from its 16-byte
// aligned start as 16-byte vectors, up to 4 per lane and plane issued
// before any is used (one round trip at sps <= 7), into a per-warp shared
// stage; each lane then realigns 4 consecutive columns from two stage
// words with __byte_perm and stores them as one float4. Empty rows and
// the columns at out_len or beyond take float4 zero stores and no loads.
// With 128-sample rows and 16-byte aligned streams (the wrapper ensures
// both), an aligned vector never straddles the end of the streams.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // windows per CTA, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kVecs = 4;                   // vector loads per lane and plane
                                           // in flight

// Bytes of one plane's stage per warp: the window's span from its aligned
// start (< out_len + 16, in whole vectors) and the word past it that the
// last column group's realignment reads but does not use.
__host__ __device__ inline int stage_stride(int out_len) {
  return ((out_len + 15) & ~15) + 32;
}

__device__ __forceinline__ float power(uint32_t wi, uint32_t wq, int k,
                                       float scale) {
  // byte k of each word, sign-extended
  const int i = static_cast<int>(wi << (24 - 8 * k)) >> 24;
  const int q = static_cast<int>(wq << (24 - 8 * k)) >> 24;
  const float fi = __fmul_rn(static_cast<float>(i), scale);
  const float fq = __fmul_rn(static_cast<float>(q), scale);
  return __fmaf_rn(fi, fi, __fmul_rn(fq, fq));
}

__global__ void __launch_bounds__(kThreads)
slice_windows_kernel(const int8_t* __restrict__ xi,
                     const int8_t* __restrict__ xq,
                     const int32_t* __restrict__ base,
                     float* __restrict__ out, int n, long long total,
                     int out_len, int pad_len, float scale) {
  extern __shared__ uint4 stage[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= n) return;
  const int stride = stage_stride(out_len);
  unsigned char* si = reinterpret_cast<unsigned char*>(stage) +
                      warp * 2 * stride;
  unsigned char* sq = si + stride;
  float4* row = reinterpret_cast<float4*>(out + (long long)g * pad_len);
  const long long b = base[g];
  int j0 = 0;                              // zeros from column j0 on
  if (b >= 0) {
    const long long v0 = b >> 4;           // the span's first vector
    const int r = static_cast<int>(b & 15);
    const int nvec = (r + out_len + 15) >> 4;
    const long long vend = total >> 4;     // vectors in the streams
    const uint4* vi = reinterpret_cast<const uint4*>(xi) + v0;
    const uint4* vq = reinterpret_cast<const uint4*>(xq) + v0;
    for (int v = lane; v < nvec; v += 32 * kVecs) {
      uint4 li[kVecs], lq[kVecs];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int vk = v + 32 * k;
        li[k] = lq[k] = make_uint4(0u, 0u, 0u, 0u);
        if (vk < nvec && v0 + vk < vend) {
          li[k] = __ldg(vi + vk);
          lq[k] = __ldg(vq + vk);
        }
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int vk = v + 32 * k;
        if (vk < nvec) {
          reinterpret_cast<uint4*>(si)[vk] = li[k];
          reinterpret_cast<uint4*>(sq)[vk] = lq[k];
        }
      }
    }
    __syncwarp();
    const uint32_t* wi = reinterpret_cast<const uint32_t*>(si);
    const uint32_t* wq = reinterpret_cast<const uint32_t*>(sq);
    for (int j = 4 * lane; j < out_len; j += 128) {
      const int o = r + j;                 // stage byte of column j
      const int w = o >> 2;
      const unsigned sel = 0x3210u + 0x1111u * static_cast<unsigned>(o & 3);
      const uint32_t pi = __byte_perm(wi[w], wi[w + 1], sel);
      const uint32_t pq = __byte_perm(wq[w], wq[w + 1], sel);
      row[j >> 2] = make_float4(power(pi, pq, 0, scale),
                                power(pi, pq, 1, scale),
                                power(pi, pq, 2, scale),
                                power(pi, pq, 3, scale));
    }
    j0 = out_len;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = j0 + 4 * lane; j < pad_len; j += 128) row[j >> 2] = zero;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue (launching nothing) unless xi, xq and out are
// 16-byte aligned, total is a multiple of 16, and out_len and pad_len are
// multiples of 4 with out_len <= pad_len. Allocates nothing and does not
// synchronise.
int slice_windows_launch(const void* xi, const void* xq, const void* base,
                         void* out, int n, long long total, int out_len,
                         int pad_len, float scale, void* stream) {
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(xi) | reinterpret_cast<uintptr_t>(xq) |
       reinterpret_cast<uintptr_t>(out)) % 16 || total % 16 ||
      out_len % 4 || pad_len % 4 || out_len < 0 || out_len > pad_len)
    return (int)cudaErrorInvalidValue;
  const int smem = kWarps * 2 * stage_stride(out_len);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slice_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  slice_windows_kernel<<<(n + kWarps - 1) / kWarps, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xi), static_cast<const int8_t*>(xq),
      static_cast<const int32_t*>(base), static_cast<float*>(out), n, total,
      out_len, pad_len, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
