// The preamble rule on one staged chunk, shared by the detect kernels B1
// (detect_cands.cu) and B3/B4 (detect_mask.cu), for NVIDIA Hopper (sm_90a).
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
// at sps > 1 the reference (XLA on the CPU) contracts pulse 0's chip-energy
// scale into the first add, fma(acc0, 1/sps, p1).

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

// Reference level at staged position u (see the note at the top).
__device__ inline float ref_at(const float* m, const float* ce, int u,
                               const Rule& r) {
  const int sps = r.sps;
  const float p1 = ce[u + 2 * sps];
  const float p2 = ce[u + 7 * sps];
  const float p3 = ce[u + 9 * sps];
  float first;
  if (sps > 1) {
    float acc0 = m[u];
    for (int s = 1; s < sps; ++s) acc0 = __fadd_rn(acc0, m[u + s]);
    first = __fmaf_rn(acc0, r.inv_sps, p1);
  } else {
    first = __fadd_rn(ce[u], p1);
  }
  return __fmul_rn(__fadd_rn(__fadd_rn(first, p2), p3), 0.25f);
}

// After the caller has staged s.m[0, len) and synchronised: the fold, the
// chip energies, the tests and the NMS. Leaves keep[] for the chunk's
// owned samples and returns the chip-energy array (s.m at sps 1, else
// s.sb), all visible to every thread of the CTA.
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
    for (int v = threadIdx.x; v < nce; v += kThreads) {
      float acc = s.m[v];
      for (int k = 1; k < sps; ++k) acc = __fadd_rn(acc, s.m[v + k]);
      s.sb[v] = __fmul_rn(acc, r.inv_sps);
    }
    __syncthreads();
    ce = s.sb;
  }

  // preamble tests at test positions u = 256 - half + i, i in [0, nt)
  for (int i = threadIdx.x; i < nt; i += kThreads) {
    const int u = kLookback - r.half + i;
    const float p0 = ce[u];
    const float p1 = ce[u + 2 * sps];
    const float p2 = ce[u + 7 * sps];
    const float p3 = ce[u + 9 * sps];
    const float ref = ref_at(s.m, ce, u, r);
    const float nf = __fmul_rn(ws[u - 128], 0.0078125f);
    bool ok = (p0 >= ce[u - 1]) && (p0 > ce[u + 1]);
    const float pmin = fminf(fminf(p0, p1), fminf(p2, p3));
    ok = ok && (pmin > fmaxf(__fmul_rn(nf, r.thresh), __fmul_rn(ref, r.ptol)));
    float quiet = ce[u + 1 * sps];
    quiet = fmaxf(quiet, ce[u + 3 * sps]);
    quiet = fmaxf(quiet, ce[u + 4 * sps]);
    quiet = fmaxf(quiet, ce[u + 5 * sps]);
    quiet = fmaxf(quiet, ce[u + 6 * sps]);
    quiet = fmaxf(quiet, ce[u + 8 * sps]);
    quiet = fmaxf(quiet, ce[u + 10 * sps]);
    quiet = fmaxf(quiet, ce[u + 11 * sps]);
    quiet = fmaxf(quiet, ce[u + 12 * sps]);
    quiet = fmaxf(quiet, ce[u + 13 * sps]);
    quiet = fmaxf(quiet, ce[u + 14 * sps]);
    quiet = fmaxf(quiet, ce[u + 15 * sps]);
    ok = ok && (quiet < __fmul_rn(ref, r.qtol));
    s.score[i] = ok ? ref : 0.f;
    s.okf[i] = ok ? 1 : 0;
  }
  __syncthreads();

  // NMS: strictly above every score in the half samples before, at least
  // every score in the half samples after
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
