// Raw capture words -> planar f32 windows: the fused resample step's input
// conversion, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference converts a capture's samples on the
// host (io.sources.raw_file_chunks: sc16 int16 / 32768, uc8 (u8 - 127.5) /
// 127.5, complex64 as read), frames complex64 windows and splits them into
// the planar (C, 2, W) f32 rows its fused step takes. The port's fused
// runners (io/stream.run_resampled_fused and run_resampled_fused_channels)
// instead read the capture's words as the file holds them into one
// page-locked batch buffer and send that to the card; this kernel maps it
// onto the planar windows there. Row c of the output is the W samples that
// start at sample c * stride of the buffer: stride is the raw block for one
// channel's overlapping windows, W for one window per channel. A row's
// samples outside the range the runner names for it (before the capture's
// start, past its end, a row that holds no window) are 0.0, the host
// framer's zero padding.
//
// The arithmetic is the host's, one rounding for one rounding: an int16 or
// uint8 converts to f32 exactly, 127.5 is subtracted exactly, and the one
// product rounds to nearest (__fmul_rn; the library is built with
// --fmad=false besides), so every window is bit for bit what the host
// conversion gives. complex64 words are moved, not computed.
//
// What bounds it on this card: bytes. Per batch of 8 windows of 5,246,720
// sc16 samples it reads 168 MB and writes 336 MB, 0.150 ms at 3.35 TB/s.
// Design: one CTA row of the grid per window (blockIdx.y), each thread
// converts kUnroll units of 4 samples (one 16-byte vector of sc16, two of
// complex64, 8 bytes of uc8), all loads issued before any store, and
// writes a unit's I and Q as one float4 each; consecutive threads take
// consecutive units, so every warp instruction moves contiguous bytes. Only
// the units that straddle a row's range edge test sample by sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // units per thread in flight

__device__ __forceinline__ float sc16_part(uint32_t w, int hi, float scale) {
  const int16_t v = static_cast<int16_t>(hi ? (w >> 16) : (w & 0xffffu));
  return __fmul_rn(static_cast<float>(v), scale);
}

__device__ __forceinline__ float uc8_part(uint32_t w, int k, float offset,
                                          float scale) {
  const float v = static_cast<float>((w >> (8 * k)) & 0xffu);
  return __fmul_rn(__fsub_rn(v, offset), scale);
}

// One unit of input per format: kVecs vectors of type Vec holding
// kSamples interleaved I/Q samples, converted into kSamples I and Q values;
// kSamples is 4 for every format, so a unit's I and its Q are one float4
// each and a warp's stores are contiguous. uc8 loads 8 bytes a unit: 16
// would make each thread write two float4 a plane at a 32-byte stride
// across the warp.
struct Sc16 {
  using Vec = uint4;
  static constexpr int kVecs = 1, kSamples = 4;
  __device__ static void convert(const Vec* v, float* fi, float* fq, float,
                                 float scale) {
    const uint32_t w[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fi[s] = sc16_part(w[s], 0, scale);
      fq[s] = sc16_part(w[s], 1, scale);
    }
  }
};

struct Uc8 {
  using Vec = uint2;
  static constexpr int kVecs = 1, kSamples = 4;
  __device__ static void convert(const Vec* v, float* fi, float* fq,
                                 float offset, float scale) {
    const uint32_t w[2] = {v[0].x, v[0].y};
#pragma unroll
    for (int s = 0; s < 4; ++s) {           // bytes 2s (I) and 2s + 1 (Q)
      fi[s] = uc8_part(w[s >> 1], 2 * (s & 1), offset, scale);
      fq[s] = uc8_part(w[s >> 1], 2 * (s & 1) + 1, offset, scale);
    }
  }
};

struct C64 {
  using Vec = uint4;
  static constexpr int kVecs = 2, kSamples = 4;
  __device__ static void convert(const Vec* v, float* fi, float* fq, float,
                                 float) {
    const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                           v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fi[s] = __uint_as_float(w[2 * s]);
      fq[s] = __uint_as_float(w[2 * s + 1]);
    }
  }
};

// Row c's samples [valid[2c], valid[2c+1]) are the capture's; the others
// are the zero padding of the capture's edges (and of rows that hold no
// window), written as 0.0 whatever the buffer holds there: a uc8 word
// cannot stand for 0.0. Units wholly outside that range load nothing.
template <typename F>
__global__ void __launch_bounds__(kThreads)
raw_planar_kernel(const typename F::Vec* __restrict__ raw,
                  const int* __restrict__ valid, float4* __restrict__ out,
                  long long row_vecs, int units, int width4, float offset,
                  float scale) {
  using Vec = typename F::Vec;
  const int c = blockIdx.y;
  const int lo = valid[2 * c], hi = valid[2 * c + 1];
  const Vec* src = raw + static_cast<long long>(c) * row_vecs;
  float4* oi = out + static_cast<long long>(2 * c) * width4;
  float4* oq = oi + width4;
  const int u0 = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  Vec v[kUnroll][F::kVecs];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int u = u0 + k * kThreads;
#pragma unroll
    for (int j = 0; j < F::kVecs; ++j) v[k][j] = Vec{};
    if (u < units && 4 * u < hi && 4 * u + 4 > lo) {
#pragma unroll
      for (int j = 0; j < F::kVecs; ++j)
        v[k][j] = __ldg(src + static_cast<long long>(u) * F::kVecs + j);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int u = u0 + k * kThreads;
    if (u >= units) continue;
    float fi[4], fq[4];
    F::convert(v[k], fi, fq, offset, scale);
    if (4 * u < lo || 4 * u + 4 > hi) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int pos = 4 * u + s;
        if (pos < lo || pos >= hi) fi[s] = fq[s] = 0.0f;
      }
    }
    oi[u] = make_float4(fi[0], fi[1], fi[2], fi[3]);
    oq[u] = make_float4(fq[0], fq[1], fq[2], fq[3]);
  }
}

template <typename F>
int launch(const void* raw, const void* valid, void* out, int rows,
           long long stride, int width, float offset, float scale,
           cudaStream_t stream) {
  static_assert(F::kSamples == 4, "a unit is one float4 a plane");
  constexpr int vec = static_cast<int>(sizeof(typename F::Vec));
  constexpr int bytes = vec * F::kVecs / F::kSamples;   // per sample
  const int units = width / F::kSamples;
  const dim3 grid((units + kThreads * kUnroll - 1) / (kThreads * kUnroll),
                  rows);
  raw_planar_kernel<F><<<grid, kThreads, 0, stream>>>(
      static_cast<const typename F::Vec*>(raw),
      static_cast<const int*>(valid), static_cast<float4*>(out),
      stride * bytes / vec, units, width / 4, offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fmt: 0 sc16 (int16 pairs), 1 uc8 (uint8 pairs), 2 complex64 (f32 pairs).
// raw holds (rows - 1) * stride + width interleaved samples; valid holds
// rows pairs of int32, [lo, hi) of each row's samples that are the
// capture's; out is the (rows, 2, width) f32 planar windows: I = (x -
// offset) * scale for uc8, x * scale for sc16, x for complex64 inside a
// row's range, 0.0 outside it. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue (launching nothing) unless
// raw and out are 16-byte aligned, valid is 4-byte aligned, width and
// stride are positive multiples of 8, rows is 1 to 65535 and fmt is known.
// Allocates nothing and does not synchronise.
int raw_planar_launch(const void* raw, const void* valid, void* out, int fmt,
                      int rows, long long stride, int width, float offset,
                      float scale, void* stream) {
  if ((reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(out))
          % 16 || reinterpret_cast<uintptr_t>(valid) % 4 || width <= 0 ||
      width % 8 || stride <= 0 || stride % 8 || rows <= 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch<Sc16>(raw, valid, out, rows, stride, width, offset,
                                scale, s);
    case 1: return launch<Uc8>(raw, valid, out, rows, stride, width, offset,
                               scale, s);
    case 2: return launch<C64>(raw, valid, out, rows, stride, width, offset,
                               scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
