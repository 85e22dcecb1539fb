// Kernels B3, B4 and B6: preamble detection on interleaved f32 I/Q, writing
// the keep mask and the reference level of every owned sample, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels `_detect_kernel_2d` (B3, one block, launched by
// `preamble_detect_pallas_2d`) and `_detect_kernel_2d_b` (B4, a batch of C
// blocks, launched by `preamble_detect_pallas_2d_batch`) in
// airmodes/kernels/preamble_pallas.py, and in its 1-D mode (`chain`) the
// v1 kernels `_detect_kernel` and `_detect_kernel_b` (B6, launched by
// `preamble_detect_pallas` and `preamble_detect_pallas_batch`). One kernel
// with a batch dimension serves all; the wrappers (kernels/preamble.py)
// convert int8 and int16 wire samples to unit-scale f32 first, as the
// reference does. The 1-D mode differs in two things only: the reference
// level takes the 1-D kernel's FMA form (detect_body.cuh: ref_at), and the
// wrapper passes as `valid` every input sample where the 2-D ones drop a
// trailing partial 128-sample row. Neither mode checks sps: the reference's
// 2-D limit (14*sps < 128, a TPU lane-shift bound) lives in the 2-D
// wrappers, and B6 runs at 20 Msps (sps 10), where a chunk stages
// 256 + 4096 + 192 samples (~79 KB of shared memory with its fold arrays).
//
// What it computes, per channel c and owned sample d of the block
// (block position x = d + 256, the left halo before it): the power
// m[x] = fma(xi, xi, xq*xq) of the f32 pair at x, or 0 where x is at or
// past `valid` (the reference zero-pads short inputs and, for B3, drops a
// trailing partial 128-sample row), then the preamble rule of
// detect_body.cuh: noise fold, chip energies, the pulse and quiet tests,
// NMS. Output: mask[c][d] = 1 where the sample is kept, else 0 (int32), and
// ref[c][d] = the reference level at d (f32), for every owned d.
//
// Numerics: as B1's (detect_cands.cu): the reference's f32 operations in
// its order, with explicit round-to-nearest intrinsics; the one FMA of the
// power and the one of the reference level at sps > 1 are what XLA
// computes for the reference on the CPU; built with --fmad=false so that
// nothing else is contracted. The reference may take the noise-window sum
// as two matmuls (mxu_window_sum); this kernel always folds.
//
// What bounds it on this card: it reads 8 bytes per sample (an f32 pair)
// and writes 8 (mask and ref), while the rule costs ~44 f32 operations per
// sample; at 3.35 TB/s and 67 TFLOP/s the bytes take ~7x longer, so it is
// bound by bytes. Design: B1's chunked design carries over — one CTA per
// 4096 owned samples of one channel stages the power of the chunk, 256
// samples of lookback and a right halo in shared memory (~76 KB), runs the
// rule there, and writes the chunk's mask and ref coalesced. Neighbouring
// threads read neighbouring f32 pairs (8 bytes each).

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect_body.cuh"

namespace {

using detect::kChunk;
using detect::kLookback;
using detect::kThreads;

struct Params {
  const float2* iq;    // (C, L) interleaved I/Q pairs
  int32_t* mask;       // (C, N)
  float* ref;          // (C, N)
  long long L;         // pairs per channel row
  long long valid;     // pairs of each row that are read; the rest are 0
  long long n;         // owned samples per block
  int nchunk;          // chunks per block (n / kChunk)
  detect::Rule rule;
};

template <bool kChain>
__global__ void __launch_bounds__(kThreads)
detect_mask_kernel(Params p) {
  extern __shared__ float smem[];
  const detect::Smem s = detect::carve(smem, p.rule);
  const int len = detect::staged_len(p.rule);

  const int k = blockIdx.x % p.nchunk;
  const int c = blockIdx.x / p.nchunk;
  // staged index u <-> block position x = d0 + u; owned d = d0 + u - 256
  const long long d0 = (long long)k * kChunk;
  const float2* iq = p.iq + (long long)c * p.L;

  int wild = 0;  // a NaN, an Inf or a power above kFinitePower
  for (int u = threadIdx.x; u < len; u += kThreads) {
    const long long x = d0 + u;
    float v = 0.f;
    if (x < p.valid) {
      const float2 a = iq[x];
      v = __fmaf_rn(a.x, a.x, __fmul_rn(a.y, a.y));
    }
    wild |= !(v <= detect::kFinitePower);
    s.m[u] = v;
  }
  // a uniform choice per CTA (detect_body.cuh: kNan)
  const float* ce =
      __syncthreads_or(wild)
          ? detect::detect_chunk<false, kChain, true>(s, p.rule)
          : detect::detect_chunk<false, kChain, false>(s, p.rule);

  int32_t* mask = p.mask + (long long)c * p.n + d0;
  float* ref = p.ref + (long long)c * p.n + d0;
  for (int j = threadIdx.x; j < kChunk; j += kThreads) {
    mask[j] = s.keep[j];
    ref[j] = detect::ref_at<kChain>(s.m, ce, kLookback + j, p.rule);
  }
}

template <bool kChain>
cudaError_t launch(const Params& p, int nblk, cudaStream_t s) {
  const int smem = detect::smem_bytes(p.rule);
  cudaError_t err = cudaFuncSetAttribute(
      detect_mask_kernel<kChain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  detect_mask_kernel<kChain><<<nblk, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over C channels, with the 1-D kernel's
// reference-level form when `chain` is set; returns cudaGetLastError().
// Allocates nothing and does not synchronise.
int detect_mask_launch(const void* iq, void* mask, void* ref, int channels,
                       long long L, long long valid, long long n, int nchunk,
                       int chain, int sps, int half, int rhalo, float thresh,
                       float ptol, float qtol, float inv_sps, void* stream) {
  Params p;
  p.iq = static_cast<const float2*>(iq);
  p.mask = static_cast<int32_t*>(mask);
  p.ref = static_cast<float*>(ref);
  p.L = L;
  p.valid = valid;
  p.n = n;
  p.nchunk = nchunk;
  p.rule = detect::Rule{sps, half, rhalo, thresh, ptol, qtol, inv_sps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = channels * nchunk;
  return (int)(chain ? launch<true>(p, nblk, s) : launch<false>(p, nblk, s));
}

}  // extern "C"
