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
// level takes the 1-D kernel's FMA form (detect_body.cuh), and the wrapper
// passes as `valid` every input sample where the 2-D ones drop a trailing
// partial 128-sample row. Neither mode checks sps: the reference's 2-D
// limit (14*sps < 128, a TPU lane-shift bound) lives in the 2-D wrappers,
// and B6 runs at 20 Msps (sps 10).
//
// What it computes, per channel c and owned sample d of the block
// (block position x = d + 256, the left halo before it): the power
// m[x] = fma(xi, xi, xq*xq) of the f32 pair at x, or 0 where x is at or
// past `valid` (the reference zero-pads short inputs and, for B3, drops a
// trailing partial 128-sample row), then the preamble rule of
// detect_body.cuh: noise fold, chip energies, the pulse and quiet tests,
// NMS. Output: mask[c][d] = 1 where the sample is kept, else 0 (int32), and
// ref[c][d] = the reference level at d (f32), for every owned d. The block
// may be any multiple of 16 samples (the wrappers take multiples of 1024,
// as the reference's tiles): the last chunk's CTA writes only what exists.
//
// Numerics: as B1's (detect_cands.cu): the reference's f32 operations in
// its order, with explicit round-to-nearest intrinsics; the one FMA of the
// power and those of the reference level at sps > 1 are what XLA computes
// for the reference on the CPU; built with --fmad=false so that nothing
// else is contracted. The reference may take the noise-window sum as two
// matmuls (mxu_window_sum); this kernel always folds.
//
// What bounds it on this card: it reads 8 bytes per sample (an f32 pair)
// and writes 8 (mask and ref), while the rule issues ~42 f32 instructions
// per sample; at 3.35 TB/s and 33.5 T f32 instructions per second the
// bytes take ~3x longer, so it is bound by bytes. Design: one CTA per 4096
// owned samples of one channel loads its pairs as float4 (two pairs) per
// thread where the row allows, stages their power in shared memory, runs
// the rule (detect_body.cuh), and each thread stores the mask and the
// reference levels of its own 16 samples as int4 and float4, the levels
// straight from its tests.

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect_body.cuh"

namespace {

using detect::kChunk;
using detect::kRun;
using detect::kThreads;
using Params = detect::PairParams;

// The sps-1 form holds its powers in registers; capped at 64 a thread, four
// CTAs share an SM, so one's loads and stores overlap another's rule.
template <bool kChain, bool kFast>
__global__ void __launch_bounds__(kThreads, kFast ? 4 : 1)
detect_mask_kernel(Params p) {
  extern __shared__ float smem[];
  const detect::Smem s = detect::carve(smem, p.rule);

  const int k = blockIdx.x % p.nchunk;
  const int c = blockIdx.x / p.nchunk;
  // staged index u <-> block position x = d0 + u; owned d = d0 + u - 256
  const long long d0 = (long long)k * kChunk;
  const int wild = detect::stage_pairs(s, p.iq + (long long)c * p.L, d0, p);
  const long long own = p.n - d0;  // owned samples of this chunk that exist
  const bool mine = (long long)kRun * threadIdx.x < own;
  const long long at = (long long)c * p.n + d0 + kRun * threadIdx.x;
  float* ref = mine ? p.ref + at : nullptr;
  // a uniform choice per CTA (detect_body.cuh: kNan)
  const uint32_t keep =
      __syncthreads_or(wild)
          ? detect::detect_chunk<false, kChain, true, kFast>(s, p.rule, ref)
          : detect::detect_chunk<false, kChain, false, kFast>(s, p.rule, ref);
  if (mine) detect::store_bits(p.mask + at, keep);
}

template <bool kChain, bool kFast>
cudaError_t launch(const Params& p, int nblk, cudaStream_t s) {
  return detect::launch_pairs(detect_mask_kernel<kChain, kFast>, p, nblk, s);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over C channels, with the 1-D kernel's
// reference-level form when `chain` is set; returns cudaGetLastError().
// Allocates nothing and does not synchronise. n must be a multiple of 16,
// and mask and ref 16-byte aligned.
int detect_mask_launch(const void* iq, void* mask, void* ref, int channels,
                       long long L, long long valid, long long n, int nchunk,
                       int chain, int sps, int half, int rhalo, float thresh,
                       float ptol, float qtol, float inv_sps, void* stream) {
  if (n % kRun || half > detect::kMaxHalf ||
      reinterpret_cast<uintptr_t>(mask) % 16 ||
      reinterpret_cast<uintptr_t>(ref) % 16)
    return (int)cudaErrorInvalidValue;
  const Params p = detect::pair_params(
      iq, mask, ref, L, valid, n, nchunk,
      detect::Rule{sps, half, rhalo, thresh, ptol, qtol, inv_sps});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = channels * nchunk;
  // at sps 1 the two reference-level forms are one
  cudaError_t err = detect::fast_rule(p.rule) ? launch<false, true>(p, nblk, s)
                    : chain ? launch<true, false>(p, nblk, s)
                            : launch<false, false>(p, nblk, s);
  return (int)err;
}

}  // extern "C"
