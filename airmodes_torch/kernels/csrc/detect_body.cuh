// The preamble rule on one staged chunk, shared by the detect kernels B1
// and its variants B5o, B5p (detect_cands.cu) and B3/B4 and the 1-D kernel
// B6 (detect_mask.cu), for NVIDIA Hopper (sm_90a).
//
// A CTA owns kChunk = 4096 consecutive samples of one channel and stages
// their power m in shared memory with kLookback = 256 samples before them
// (the 128-sample noise window and the NMS lookback) and `rhalo` after
// them (the preamble's 16 chips and the NMS window). Staged index u holds
// the sample at block position d0 + u, so the owned samples are
// u = 256 .. 256 + kChunk - 1. detect_chunk() then computes, in the
// reference's f32 operations and order (explicit round-to-nearest
// intrinsics; the sources build with --fmad=false):
//   ws[y]  = trailing 128-sample sum of m by the log-doubling fold
//            ws <- ws[y] + ws[y+s], s = 1, 2, ..., 64
//   ce[v]  = ((m[v] + m[v+1]) + ... + m[v+sps-1]) * (1/sps)  (sps > 1)
//   the 4-pulse + quiet-chip test against nf = ws[u-128]/128 at the test
//   positions u = 256 - half .. 256 + kChunk + half - 1, then non-max
//   suppression over +-half samples: keep[s] for owned sample s.
// The reference level is ref_at(): (((p0 + p1) + p2) + p3) * 0.25, where
// at sps > 1 the reference (XLA on the CPU) contracts chip-energy scales
// into the adds, in one of two forms: in its 2-D kernels (B1, B3, B4, B5)
// pulse 0's only, fma(S0, 1/sps, p1); in its 1-D kernel (B6, kChain) all
// but pulse 1's, fma(S3, s, fma(S2, s, fma(S0, s, S1*s))), S the chip sums.
// Maxima and minima: the reference's jnp.maximum and jnp.minimum propagate
// NaN, so a NaN power in a test's reach fails the test. With kNan the rule
// does the same (max_nan, min_nan); without, it takes fmaxf and fminf,
// which are equal where every term is finite. The callers pick kNan per
// chunk: int8 powers are at most 2, and f32 chunks whose staged powers are
// all below 1e30 keep every term finite (sums of at most a few hundred of
// them, times positive constants), so only a chunk holding a NaN, an Inf
// or a huge power takes the slower form.
//
// kPrescreen (B5p) swaps the rule for the reference's stage-A prescreen:
// the peak test, the all-pulse threshold (the caller passes the slack
// threshold) and tolerance, the quiet chips {1, 3..6}, at the owned
// samples only, with no NMS.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace detect {

constexpr int kLanes = 128;
constexpr int kChunkRows = 32;
constexpr int kChunk = kChunkRows * kLanes;  // owned samples per CTA
constexpr int kLookback = 256;               // staged samples before the chunk
constexpr int kThreads = 256;

struct Rule {
  int sps;
  int half;       // NMS half-window, samples
  int rhalo;      // staged samples after the chunk
  float thresh;   // linear detection threshold
  float ptol;     // pulse tolerance
  float qtol;     // quiet tolerance
  float inv_sps;  // 1/sps
};

// Shared memory of one CTA, carved from the dynamic block in this order.
struct Smem {
  float* m;       // (len) power
  float* sa;      // (len) fold ping; holds ws after the fold
  float* sb;      // (len) fold pong, then ce
  float* score;   // (nt) ok ? ref : 0 per test position
  uint8_t* okf;   // (nt)
  uint8_t* keep;  // (kChunk)
};

__host__ __device__ inline int staged_len(const Rule& r) {
  return kLookback + kChunk + r.rhalo;
}

__host__ __device__ inline int test_len(const Rule& r) {
  return kChunk + 2 * r.half;
}

inline int smem_bytes(const Rule& r) {
  return (3 * staged_len(r) + test_len(r)) * (int)sizeof(float) +
         test_len(r) + kChunk;
}

__device__ inline float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ inline float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ inline Smem carve(float* base, const Rule& r) {
  Smem s;
  const int len = staged_len(r);
  s.m = base;
  s.sa = s.m + len;
  s.sb = s.sa + len;
  s.score = s.sb + len;
  s.okf = reinterpret_cast<uint8_t*>(s.score + test_len(r));
  s.keep = s.okf + test_len(r);
  return s;
}

// Chip sum ((m[v] + m[v+1]) + ...) + m[v+sps-1].
__device__ inline float chip_sum(const float* m, int v, int sps) {
  float acc = m[v];
  for (int s = 1; s < sps; ++s) acc = __fadd_rn(acc, m[v + s]);
  return acc;
}

// Reference level at staged position u (see the note at the top), from
// the four pulses' chip energies p0..p3 the caller has loaded (ce at u,
// u + 2sps, u + 7sps, u + 9sps) and, at sps > 1, their chip sums from m.
template <bool kChain>
__device__ inline float ref_at(const float* m, float p0, float p1, float p2,
                               float p3, int u, const Rule& r) {
  const int sps = r.sps;
  const float s = r.inv_sps;
  if (kChain && sps > 1) {
    float x = __fmaf_rn(chip_sum(m, u, sps), s,
                        __fmul_rn(chip_sum(m, u + 2 * sps, sps), s));
    x = __fmaf_rn(chip_sum(m, u + 7 * sps, sps), s, x);
    x = __fmaf_rn(chip_sum(m, u + 9 * sps, sps), s, x);
    return __fmul_rn(x, 0.25f);
  }
  const float first =
      sps > 1 ? __fmaf_rn(chip_sum(m, u, sps), s, p1) : __fadd_rn(p0, p1);
  return __fmul_rn(__fadd_rn(__fadd_rn(first, p2), p3), 0.25f);
}

// ref_at with the pulses loaded from the chip-energy array ce.
template <bool kChain>
__device__ inline float ref_at(const float* m, const float* ce, int u,
                               const Rule& r) {
  const int sps = r.sps;
  return ref_at<kChain>(m, ce[u], ce[u + 2 * sps], ce[u + 7 * sps],
                        ce[u + 9 * sps], u, r);
}

// Largest staged power for which a chunk may take the rule without kNan.
constexpr float kFinitePower = 1e30f;

template <bool kNan>
__device__ inline float vmax(float a, float b) {
  return kNan ? max_nan(a, b) : fmaxf(a, b);
}

template <bool kNan>
__device__ inline float vmin(float a, float b) {
  return kNan ? min_nan(a, b) : fminf(a, b);
}

// The rule's test at staged position u, without the NMS: the peak test,
// the pulse threshold and tolerance, and the quiet chips (all twelve, or
// with kPrescreen the early five). Returns ok and sets *ref.
template <bool kPrescreen, bool kChain, bool kNan>
__device__ inline bool test_at(const float* m, const float* ce,
                               const float* ws, int u, const Rule& r,
                               float* ref_out) {
  const int sps = r.sps;
  const float p0 = ce[u];
  const float p1 = ce[u + 2 * sps];
  const float p2 = ce[u + 7 * sps];
  const float p3 = ce[u + 9 * sps];
  const float ref = ref_at<kChain>(m, p0, p1, p2, p3, u, r);
  *ref_out = ref;
  const float nf = __fmul_rn(ws[u - 128], 0.0078125f);
  bool ok = (p0 >= ce[u - 1]) && (p0 > ce[u + 1]);
  const float pmin = vmin<kNan>(vmin<kNan>(p0, p1), vmin<kNan>(p2, p3));
  ok = ok && (pmin > vmax<kNan>(__fmul_rn(nf, r.thresh),
                                __fmul_rn(ref, r.ptol)));
  float quiet = ce[u + 1 * sps];
  quiet = vmax<kNan>(quiet, ce[u + 3 * sps]);
  quiet = vmax<kNan>(quiet, ce[u + 4 * sps]);
  quiet = vmax<kNan>(quiet, ce[u + 5 * sps]);
  quiet = vmax<kNan>(quiet, ce[u + 6 * sps]);
  if (!kPrescreen) {
    quiet = vmax<kNan>(quiet, ce[u + 8 * sps]);
    quiet = vmax<kNan>(quiet, ce[u + 10 * sps]);
    quiet = vmax<kNan>(quiet, ce[u + 11 * sps]);
    quiet = vmax<kNan>(quiet, ce[u + 12 * sps]);
    quiet = vmax<kNan>(quiet, ce[u + 13 * sps]);
    quiet = vmax<kNan>(quiet, ce[u + 14 * sps]);
    quiet = vmax<kNan>(quiet, ce[u + 15 * sps]);
  }
  return ok && (quiet < __fmul_rn(ref, r.qtol));
}

// After the caller has staged s.m[0, len) and synchronised: the fold, the
// chip energies, the tests and (but for kPrescreen) the NMS. Leaves keep[]
// for the chunk's owned samples and returns the chip-energy array (s.m at
// sps 1, else s.sb), all visible to every thread of the CTA.
template <bool kPrescreen, bool kChain, bool kNan>
__device__ inline const float* detect_chunk(const Smem& s, const Rule& r) {
  const int len = staged_len(r);
  const int nt = test_len(r);
  const int sps = r.sps;

  // trailing window sum by log-doubling: 7 passes, ping-pong m->sa->sb...
  {
    const float* src = s.m;
    float* dst = s.sa;
    int n = len;
    for (int k = 1; k <= 64; k *= 2) {
      n -= k;
      for (int y = threadIdx.x; y < n; y += kThreads)
        dst[y] = __fadd_rn(src[y], src[y + k]);
      __syncthreads();
      src = dst;
      dst = (dst == s.sa) ? s.sb : s.sa;
    }
    // 7 passes end in sa
  }
  const float* ws = s.sa;

  const float* ce = s.m;
  if (sps > 1) {
    const int nce = len - sps + 1;
    for (int v = threadIdx.x; v < nce; v += kThreads)
      s.sb[v] = __fmul_rn(chip_sum(s.m, v, sps), r.inv_sps);
    __syncthreads();
    ce = s.sb;
  }

  if (kPrescreen) {
    // the owned samples only, no NMS
    for (int k = threadIdx.x; k < kChunk; k += kThreads) {
      float ref;
      s.keep[k] =
          test_at<true, kChain, kNan>(s.m, ce, ws, kLookback + k, r, &ref);
    }
    __syncthreads();
    return ce;
  }

  // preamble tests at test positions u = 256 - half + i, i in [0, nt)
  for (int i = threadIdx.x; i < nt; i += kThreads) {
    float ref;
    const bool ok = test_at<false, kChain, kNan>(s.m, ce, ws,
                                                 kLookback - r.half + i, r,
                                                 &ref);
    s.score[i] = ok ? ref : 0.f;
    s.okf[i] = ok ? 1 : 0;
  }
  __syncthreads();

  // NMS: strictly above every score in the half samples before, at least
  // every score in the half samples after (scores are never NaN: a NaN
  // reference level fails the tests)
  for (int k = threadIdx.x; k < kChunk; k += kThreads) {
    const int i = r.half + k;
    float left = 0.f, right = 0.f;
    for (int o = 1; o <= r.half; ++o) {
      left = fmaxf(left, s.score[i - o]);
      right = fmaxf(right, s.score[i + o]);
    }
    const float own = s.score[i];
    s.keep[k] = (s.okf[i] && own > left && own >= right) ? 1 : 0;
  }
  __syncthreads();
  return ce;
}

}  // namespace detect
