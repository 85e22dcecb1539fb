// Probe P4: kernel B4 (detect_mask.cu at sps 1) cut after each stage of
// its rule, to time the stages on the card. For NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probe `make(stages)` (`kern` + `body`) of
// scripts/tpu_kernel_ablate.py, the batched 2-D f32 detect kernel with its
// stages enabled one by one. Each cut writes what `body` writes: (C, N)
// int32 mask and f32 ref over the owned samples d (block position d +
// 256):
//   stages 0 and 1 (the script's code makes them one): the power m,
//      mask = m > 0, ref = m;
//   stage 2: + the 128-sample window sum ws[d] = m[d] + ... + m[d + 127]
//      by the doubling fold, mask = ws > 0, ref = ws;
//   stage 3: + the pulse, peak, reference-level and threshold tests,
//      mask = their pass bit, ref = the reference level;
//   stage 4: + the quiet-chip maximum and its test;
//   stage 5: + NMS: B4 itself (detect::detect_chunk), so its output equals
//      B4's by construction.
// Only the sps-1 form (detect::fast_rule) is built: the script's config
// runs at sps 1.
//
// Design: B4's kernel as it is (one CTA of 256 threads per 4096 owned
// samples, the f32 pairs staged as powers in shared memory by B4's own
// detect::stage_pairs, four CTAs per SM), with the rule stopped after the
// stage. Every cut stages the same samples; stage 2 stages its chunk 128
// samples later, so that the fold of detect_body.cuh, which yields each
// owned sample's trailing window ws[u - 128], yields the window that starts
// at the owned sample. Stage 4 is B4's sps-1 test itself
// (detect::test_fast); stage 3 is the same decision (detect::decide) with no
// quiet chip to test. What bounds the cuts: bytes for all of them (B4 reads
// 8 bytes and writes 8 per sample; its rule is a third of the byte time at
// the card's peak rates), so the increments show what the rule costs beyond
// the loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect_body.cuh"

namespace {

using detect::kChunk;
using detect::kLookback;
using detect::kRun;
using detect::kThreads;
using detect::sci;
using detect::sk;
using Params = detect::PairParams;

// The test of stage 3 or 4 at run position j, from e[k] = m[u0 - 1 + k] as
// in detect::test_fast. Sets ref.
template <int kStage, bool kNan>
__device__ __forceinline__ bool test_cut(const float (&e)[kRun + 16], int j,
                                         float ws, const detect::Rule& r,
                                         float& ref) {
  if (kStage >= 4) return detect::test_fast<false, kNan>(e, j, ws, r, ref);
  const float p0 = e[j + 1], p1 = e[j + 3], p2 = e[j + 8], p3 = e[j + 10];
  ref = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(p0, p1), p2), p3), 0.25f);
  const float none = __int_as_float(0xff800000);  // -inf: no quiet chip
  return detect::decide<kNan>(p0, p1, p2, p3, e[j], e[j + 2], none, ref, ws,
                              r);
}

// Stages 3 and 4 over the thread's run, after the fold: the pass bits,
// and with ref_out the run's reference levels written there as
// detect::detect_chunk writes them.
template <int kStage, bool kNan>
__device__ inline uint32_t run_tests(const detect::Smem& s,
                                     const detect::Rule& r, float* ref_out) {
  const int i0 = r.half + kRun * threadIdx.x;
  const int u0 = kLookback + kRun * threadIdx.x;
  float e[kRun + 16];
#pragma unroll
  for (int k = 0; k < kRun + 16; ++k) e[k] = s.m[sk(u0 - 1 + k)];
  uint32_t bits = 0;
  float rv[4];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    float ref;
    bits |= (uint32_t)test_cut<kStage, kNan>(e, j, s.sc[sci(i0 + j)], r, ref)
            << j;
    rv[j & 3] = ref;
    if (ref_out != nullptr && (j & 3) == 3)
      reinterpret_cast<float4*>(ref_out)[j >> 2] =
          make_float4(rv[0], rv[1], rv[2], rv[3]);
  }
  return bits;
}

template <int kStage>
__global__ void __launch_bounds__(kThreads, 4)
detect_ablate_kernel(Params p) {
  extern __shared__ float smem[];
  const detect::Smem s = detect::carve(smem, p.rule);

  const int k = blockIdx.x % p.nchunk;
  const int c = blockIdx.x / p.nchunk;
  // staged index u <-> block position x = d0 + u; stage 2 shifts by 128
  const long long d0 = (long long)k * kChunk + (kStage == 2 ? 128 : 0);
  const int wild = detect::stage_pairs(s, p.iq + (long long)c * p.L, d0, p);
  const long long own = p.n - (long long)k * kChunk;
  const bool mine = (long long)kRun * threadIdx.x < own;
  const long long at =
      (long long)c * p.n + (long long)k * kChunk + kRun * threadIdx.x;
  float* ref = mine ? p.ref + at : nullptr;
  // the barrier after staging, and B4's uniform choice of the NaN form
  const bool nan_form = __syncthreads_or(wild);

  uint32_t bits = 0;
  if (kStage <= 2) {
    if (kStage == 2) {
      detect::fold_warp(s, p.rule);
      __syncwarp();  // ws is the warp's own
    }
    float v[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      v[j] = kStage == 2 ? s.sc[sci(p.rule.half + kRun * threadIdx.x + j)]
                         : s.m[sk(kLookback + kRun * threadIdx.x + j)];
      bits |= (uint32_t)(v[j] > 0.f) << j;
    }
    if (mine) {
#pragma unroll
      for (int j = 0; j < kRun / 4; ++j)
        reinterpret_cast<float4*>(ref)[j] =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  } else if (kStage <= 4) {
    detect::fold_warp(s, p.rule);
    __syncwarp();
    bits = nan_form ? run_tests<kStage, true>(s, p.rule, ref)
                    : run_tests<kStage, false>(s, p.rule, ref);
  } else {
    bits = nan_form
               ? detect::detect_chunk<false, false, true, true>(s, p.rule, ref)
               : detect::detect_chunk<false, false, false, true>(s, p.rule,
                                                                 ref);
  }
  if (mine) detect::store_bits(p.mask + at, bits);
}

}  // namespace

extern "C" {

// Launches the cut after `stage` (0..5) on `stream` over C channels;
// returns cudaGetLastError(). Takes the sps-1 rule only (sps 1, half <= 4).
// Allocates nothing and does not synchronise. n must be a multiple of 16,
// and mask and ref 16-byte aligned.
int detect_ablate_launch(const void* iq, void* mask, void* ref, int channels,
                         long long L, long long valid, long long n,
                         int nchunk, int stage, int sps, int half, int rhalo,
                         float thresh, float ptol, float qtol, float inv_sps,
                         void* stream) {
  const detect::Rule rule{sps, half, rhalo, thresh, ptol, qtol, inv_sps};
  // stage 2's shifted fold reads 128 samples past the first owned one's
  // window: the right halo must hold them, as the sps-1 halo (32) does
  if (n % kRun || !detect::fast_rule(rule) || stage < 0 || stage > 5 ||
      rhalo < 32 || reinterpret_cast<uintptr_t>(mask) % 16 ||
      reinterpret_cast<uintptr_t>(ref) % 16)
    return (int)cudaErrorInvalidValue;
  const Params p =
      detect::pair_params(iq, mask, ref, L, valid, n, nchunk, rule);
  // the script's code makes stages 0 and 1 one
  void (*const cuts[])(Params) = {
      detect_ablate_kernel<1>, detect_ablate_kernel<1>,
      detect_ablate_kernel<2>, detect_ablate_kernel<3>,
      detect_ablate_kernel<4>, detect_ablate_kernel<5>};
  return (int)detect::launch_pairs(cuts[stage], p, channels * nchunk,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
