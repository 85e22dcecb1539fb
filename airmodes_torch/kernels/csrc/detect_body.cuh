// The preamble rule on one staged chunk, shared by the detect kernels B1
// and its variants B5o, B5p (detect_cands.cu) and B3/B4 and the 1-D kernel
// B6 (detect_mask.cu), for NVIDIA Hopper (sm_90a).
//
// A CTA of 256 threads owns kChunk = 4096 consecutive samples of one
// channel. The caller stages their power m in shared memory with
// kLookback = 256 samples before them (the 128-sample noise window and the
// NMS lookback) and `rhalo` after them (the preamble's 16 chips and the NMS
// window): staged index u holds the sample at block position d0 + u, so the
// owned samples are u = 256 .. 256 + kChunk - 1. detect_chunk() then
// computes, in the reference's f32 operations and order (explicit
// round-to-nearest intrinsics; the sources build with --fmad=false):
//   ws[y]  = trailing 128-sample sum of m by the log-doubling fold
//            ws <- ws[y] + ws[y+s], s = 1, 2, ..., 64
//   ce[v]  = ((m[v] + m[v+1]) + ... + m[v+sps-1]) * (1/sps)  (sps > 1)
//   the 4-pulse + quiet-chip test against nf = ws[u-128]/128 at the test
//   positions u = 256 - half .. 256 + kChunk + half - 1, then non-max
//   suppression over +-half samples: the keep bit of each owned sample.
// The reference level is (((p0 + p1) + p2) + p3) * 0.25, where at sps > 1
// the reference (XLA on the CPU) contracts chip-energy scales into the adds,
// in one of two forms: in its 2-D kernels (B1, B3, B4, B5) pulse 0's only,
// fma(S0, 1/sps, p1); in its 1-D kernel (B6, kChain) all but pulse 1's,
// fma(S3, s, fma(S2, s, fma(S0, s, S1*s))), S the chip sums.
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
// samples only, with no NMS (the caller passes half = 0).
//
// Design. What bounds the rule on this card is on-chip traffic: each owned
// sample is read by ~18 tests and 2*half NMS windows, and the noise fold
// has 7 levels. So the work is laid out to touch shared memory as little
// as it can, with few barriers:
//  - The fold runs in registers, one warp per 512 owned samples. Lane t
//    holds samples y0 + 32j + t in register j (20 registers: 512 outputs
//    and the 127 samples the window reaches past them). A shift by k < 32
//    is one __shfl_sync of a value the source lane picks between its
//    registers j and j+1; a shift by 32 or 64 is a register rename. The
//    operands and their order are the doubling fold's, so the sums are.
//    The warp stores ws of its own samples; the 2*half test positions past
//    the chunk's edges get theirs from a warp-wide tree of the same shape.
//  - Each thread tests a run of kRun = 16 consecutive owned samples. At
//    sps 1 (kFast) it loads the 32 powers its run's tests read once into
//    registers and takes every test from them; at other sps each test
//    reads its chip sums, which the CTA takes once per sample beforehand.
//    Scores (ok ? ref : 0) overwrite ws in place; the NMS reads them back.
//  - Barriers: one after staging (the caller's), one before the NMS, and
//    at sps > 1 one after the chip sums. Shared memory is the staged power
//    (and at sps > 1 the chip sums) plus one ws/score array: ~35 KB at
//    sps 1, so four or more CTAs fit on an SM.
//  - Every array is skewed by one word per 32 (sk()): a warp's 32
//    consecutive words and 32 threads' runs of 16 both fall on distinct
//    banks.
// detect_chunk() returns the keep bits of the thread's run (bit j: owned
// sample kRun * threadIdx.x + j) and writes the run's reference levels
// where the caller asks (B3, B4, B6). The f32 kernels (detect_mask.cu, and
// probe P4's cuts of B4 in detect_ablate.cu) also share their parameters,
// their staging of I/Q pairs, their mask stores and their launch (last in
// this file).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace detect {

constexpr int kLanes = 128;
constexpr int kChunkRows = 32;
constexpr int kChunk = kChunkRows * kLanes;  // owned samples per CTA
constexpr int kLookback = 256;               // staged samples before the chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = kChunk / kThreads;      // owned samples per thread
constexpr int kWarpRun = 32 * kRun;          // owned samples per warp
constexpr int kFoldRegs = kWarpRun / 32 + 4; // + the window's 127 samples
constexpr int kFastHalf = 4;                 // the sps-1 form takes half <= 4
constexpr int kPad = 8;                      // score slots before index 0
constexpr int kMaxHalf = 128;                // the edge trees read m[y >= 0]
constexpr unsigned kFull = 0xffffffffu;

struct Rule {
  int sps;
  int half;       // NMS half-window, samples (0: no NMS)
  int rhalo;      // staged samples after the chunk
  float thresh;   // linear detection threshold
  float ptol;     // pulse tolerance
  float qtol;     // quiet tolerance
  float inv_sps;  // 1/sps
};

// Shared memory of one CTA, carved from the dynamic block in this order.
struct Smem {
  float* m;        // (sk(len)) staged power
  float* acc;      // (sk(len)) chip sums at sps > 1; m at sps 1
  float* sc;       // ws, then scores, per test position (at sci(i))
  uint32_t* bits;  // (kThreads) a keep-bit word per thread, for the caller
};

// One pad word per 32: bank of word w is (w + w/32) mod 32.
__host__ __device__ inline int sk(int w) { return w + (w >> 5); }

// Test position i (u = kLookback - half + i) of the score array.
__host__ __device__ inline int sci(int i) { return sk(i + kPad); }

__host__ __device__ inline int staged_len(const Rule& r) {
  return kLookback + kChunk + r.rhalo;
}

__host__ __device__ inline int test_len(const Rule& r) {
  return kChunk + 2 * r.half;
}

// The register form of the tests and the NMS serves sps 1 with a small
// NMS window; every other rule takes the general form.
__host__ __device__ inline bool fast_rule(const Rule& r) {
  return r.sps == 1 && r.half <= kFastHalf;
}

__host__ __device__ inline int m_words(const Rule& r) {
  return sk(staged_len(r)) + 1;
}

__host__ __device__ inline int sc_words(const Rule& r) {
  return sk(test_len(r) + 2 * kPad) + 1;
}

inline int smem_bytes(const Rule& r) {
  return (m_words(r) * (r.sps > 1 ? 2 : 1) + sc_words(r)) * (int)sizeof(float)
         + kThreads * (int)sizeof(uint32_t);
}

__device__ inline Smem carve(float* base, const Rule& r) {
  Smem s;
  s.m = base;
  s.acc = r.sps > 1 ? s.m + m_words(r) : s.m;
  s.sc = s.m + m_words(r) * (r.sps > 1 ? 2 : 1);
  s.bits = reinterpret_cast<uint32_t*>(s.sc + sc_words(r));
  return s;
}

__device__ inline float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ inline float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
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

// The rule's decision from what a test reads: the pulses' chip energies
// p0..p3, the peak's neighbours lo (u - 1) and hi (u + 1), the quiet
// chips' maximum, the reference level and the noise sum ws[u - 128].
template <bool kNan>
__device__ __forceinline__ bool decide(float p0, float p1, float p2,
                                       float p3, float lo, float hi,
                                       float quiet, float ref, float ws,
                                       const Rule& r) {
  const float nf = __fmul_rn(ws, 0.0078125f);
  bool ok = (p0 >= lo) && (p0 > hi);
  const float pmin = vmin<kNan>(vmin<kNan>(p0, p1), vmin<kNan>(p2, p3));
  ok = ok && (pmin > vmax<kNan>(__fmul_rn(nf, r.thresh),
                                __fmul_rn(ref, r.ptol)));
  return ok && (quiet < __fmul_rn(ref, r.qtol));
}

// The test at sps 1 of run position j, from e[k] = m[u0 - 1 + k] (ce is m
// at sps 1: ce[u + c] = e[j + 1 + c]). Sets ref.
template <bool kPrescreen, bool kNan>
__device__ __forceinline__ bool test_fast(const float (&e)[kRun + 16], int j,
                                          float ws, const Rule& r,
                                          float& ref) {
  const float p0 = e[j + 1], p1 = e[j + 3], p2 = e[j + 8], p3 = e[j + 10];
  ref = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(p0, p1), p2), p3), 0.25f);
  float quiet = e[j + 2];
  quiet = vmax<kNan>(quiet, e[j + 4]);
  quiet = vmax<kNan>(quiet, e[j + 5]);
  quiet = vmax<kNan>(quiet, e[j + 6]);
  quiet = vmax<kNan>(quiet, e[j + 7]);
  if (!kPrescreen) {
    quiet = vmax<kNan>(quiet, e[j + 9]);
#pragma unroll
    for (int c = 10; c < 16; ++c) quiet = vmax<kNan>(quiet, e[j + 1 + c]);
  }
  return decide<kNan>(p0, p1, p2, p3, e[j], e[j + 2], quiet, ref, ws, r);
}

// The test at staged position u at any sps, reading the chip sums a (m at
// sps 1). Sets ref.
template <bool kPrescreen, bool kChain, bool kNan>
__device__ inline bool test_at(const float* a, float ws, int u, const Rule& r,
                               float& ref) {
  const int sps = r.sps;
  const float s = r.inv_sps;
  auto ce = [&](int v) {
    const float x = a[sk(v)];
    return sps > 1 ? __fmul_rn(x, s) : x;
  };
  const float S0 = a[sk(u)], S1 = a[sk(u + 2 * sps)];
  const float S2 = a[sk(u + 7 * sps)], S3 = a[sk(u + 9 * sps)];
  const float p0 = sps > 1 ? __fmul_rn(S0, s) : S0;
  const float p1 = sps > 1 ? __fmul_rn(S1, s) : S1;
  const float p2 = sps > 1 ? __fmul_rn(S2, s) : S2;
  const float p3 = sps > 1 ? __fmul_rn(S3, s) : S3;
  if (kChain && sps > 1) {
    float x = __fmaf_rn(S0, s, __fmul_rn(S1, s));
    x = __fmaf_rn(S2, s, x);
    x = __fmaf_rn(S3, s, x);
    ref = __fmul_rn(x, 0.25f);
  } else {
    const float first = sps > 1 ? __fmaf_rn(S0, s, p1) : __fadd_rn(p0, p1);
    ref = __fmul_rn(__fadd_rn(__fadd_rn(first, p2), p3), 0.25f);
  }
  float quiet = ce(u + sps);
  quiet = vmax<kNan>(quiet, ce(u + 3 * sps));
  quiet = vmax<kNan>(quiet, ce(u + 4 * sps));
  quiet = vmax<kNan>(quiet, ce(u + 5 * sps));
  quiet = vmax<kNan>(quiet, ce(u + 6 * sps));
  if (!kPrescreen) {
    quiet = vmax<kNan>(quiet, ce(u + 8 * sps));
    for (int c = 10; c < 16; ++c) quiet = vmax<kNan>(quiet, ce(u + c * sps));
  }
  return decide<kNan>(p0, p1, p2, p3, ce(u - 1), ce(u + 1), quiet, ref, ws,
                      r);
}

// ws of the warp's kWarpRun owned test positions, by the doubling fold in
// registers (see the note at the top), stored at their score slots.
__device__ inline void fold_warp(const Smem& s, const Rule& r) {
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int y0 = kLookback - 128 + w * kWarpRun;  // ws[y] for u = y + 128
  float v[kFoldRegs];
#pragma unroll
  for (int j = 0; j < kFoldRegs; ++j) v[j] = s.m[sk(y0 + 32 * j + t)];
#pragma unroll
  for (int k = 1; k < 32; k *= 2) {
    // lane t takes sample y + k from lane (t + k) mod 32, which sends its
    // register j + 1 when the shift wraps (it is then below k). Every
    // register takes every level: a sum is right wherever its window lies
    // inside the loaded samples (the last register's wrapped lanes, whose
    // windows do not, never reach an output).
#pragma unroll
    for (int j = 0; j < kFoldRegs; ++j) {
      const float send = t < k ? v[j + 1 < kFoldRegs ? j + 1 : j] : v[j];
      v[j] = __fadd_rn(v[j], __shfl_sync(kFull, send, (t + k) & 31));
    }
  }
#pragma unroll
  for (int j = 0; j + 2 < kFoldRegs; ++j) v[j] = __fadd_rn(v[j], v[j + 1]);
#pragma unroll
  for (int j = 0; j + 4 < kFoldRegs; ++j) v[j] = __fadd_rn(v[j], v[j + 2]);
#pragma unroll
  for (int j = 0; j < kWarpRun / 32; ++j)
    s.sc[sci(r.half + w * kWarpRun + 32 * j + t)] = v[j];
}

// ws[y] of one position by the whole warp, in the fold's tree: lane t sums
// m[y + 4t .. y + 4t + 3] pairwise, then the lanes' sums pair up. Lane 0
// holds the result.
__device__ inline float ws_tree(const float* m, int y) {
  const int b = y + 4 * (threadIdx.x & 31);
  float x = __fadd_rn(__fadd_rn(m[sk(b)], m[sk(b + 1)]),
                      __fadd_rn(m[sk(b + 2)], m[sk(b + 3)]));
#pragma unroll
  for (int o = 1; o < 32; o *= 2)
    x = __fadd_rn(x, __shfl_down_sync(kFull, x, o));
  return x;
}

// Test position i of the 2*half past the chunk's edges.
__device__ inline int edge_pos(int h, const Rule& r) {
  return h < r.half ? h : kChunk + h;
}

// After the caller has staged s.m[sk(u)], u in [0, len), and synchronised:
// the fold, the chip sums, the tests and (but for kPrescreen) the NMS.
// Returns the keep bits of this thread's run; with ref_out, writes the
// run's kRun reference levels there (16-byte aligned).
template <bool kPrescreen, bool kChain, bool kNan, bool kFast>
__device__ inline uint32_t detect_chunk(const Smem& s, const Rule& r,
                                        float* ref_out) {
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int sps = r.sps;

  fold_warp(s, r);
  if (!kPrescreen) {
    for (int h = w; h < 2 * r.half; h += kWarps) {
      const int i = edge_pos(h, r);
      const float x = ws_tree(s.m, i + kLookback - r.half - 128);
      if (t == 0) s.sc[sci(i)] = x;
    }
  }
  if (!kFast && sps > 1) {
    // chip sums of every position a test reads
    const int lo = kLookback - r.half - 1;
    const int hi = kLookback + kChunk + r.half + 15 * sps + 1;
    for (int v = lo + (int)threadIdx.x; v < hi; v += kThreads) {
      float a = s.m[sk(v)];
      for (int q = 1; q < sps; ++q) a = __fadd_rn(a, s.m[sk(v + q)]);
      s.acc[sk(v)] = a;
    }
    __syncthreads();
  } else {
    __syncwarp();  // ws is the warp's own
  }

  // the run's tests; scores replace ws in place
  const int i0 = r.half + kRun * threadIdx.x;
  const int u0 = kLookback + kRun * threadIdx.x;
  uint32_t ok_bits = 0;
  float rv[4];
  float e[kRun + 16];
  if (kFast) {
#pragma unroll
    for (int k = 0; k < kRun + 16; ++k) e[k] = s.m[sk(u0 - 1 + k)];
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const float ws = s.sc[sci(i0 + j)];
    float ref;
    const bool ok =
        kFast ? test_fast<kPrescreen, kNan>(e, j, ws, r, ref)
              : test_at<kPrescreen, kChain, kNan>(s.acc, ws, u0 + j, r, ref);
    if (kPrescreen)
      ok_bits |= (uint32_t)ok << j;
    else
      s.sc[sci(i0 + j)] = ok ? ref : 0.f;
    rv[j & 3] = ref;
    if (ref_out != nullptr && (j & 3) == 3)
      reinterpret_cast<float4*>(ref_out)[j >> 2] =
          make_float4(rv[0], rv[1], rv[2], rv[3]);
  }
  if (kPrescreen) return ok_bits;
  if (t == 0) {
    for (int h = w; h < 2 * r.half; h += kWarps) {
      const int i = edge_pos(h, r);
      float ref;
      const bool ok = test_at<false, kChain, kNan>(
          s.acc, s.sc[sci(i)], kLookback - r.half + i, r, ref);
      s.sc[sci(i)] = ok ? ref : 0.f;
    }
  }
  __syncthreads();

  // NMS: strictly above every score in the half samples before, at least
  // every score in the half samples after. Scores are never NaN (a NaN
  // reference level fails the tests) and are > 0 exactly where the test
  // passed, so own > left >= 0 also says the test passed.
  uint32_t keep = 0;
  if (kFast) {
    float q[kRun + 2 * kFastHalf];
#pragma unroll
    for (int k = 0; k < kRun + 2 * kFastHalf; ++k)
      q[k] = s.sc[sci(i0 - kFastHalf + k)];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const float own = q[j + kFastHalf];
      float left = 0.f, right = 0.f;
#pragma unroll
      for (int o = 1; o <= kFastHalf; ++o) {
        if (o <= r.half) {
          left = fmaxf(left, q[j + kFastHalf - o]);
          right = fmaxf(right, q[j + kFastHalf + o]);
        }
      }
      keep |= (uint32_t)(own > left && own >= right) << j;
    }
  } else {
    for (int j = 0; j < kRun; ++j) {
      const int i = i0 + j;
      const float own = s.sc[sci(i)];
      float left = 0.f, right = 0.f;
      for (int o = 1; o <= r.half; ++o) {
        left = fmaxf(left, s.sc[sci(i - o)]);
        right = fmaxf(right, s.sc[sci(i + o)]);
      }
      keep |= (uint32_t)(own > left && own >= right) << j;
    }
  }
  return keep;
}

// --- the f32 I/Q kernels: B3, B4 and B6 (detect_mask.cu) and probe P4 ------
// (detect_ablate.cu) stage interleaved f32 pairs and write a mask and
// reference levels.

struct PairParams {
  const float2* iq;    // (C, L) interleaved I/Q pairs
  int32_t* mask;       // (C, N)
  float* ref;          // (C, N)
  long long L;         // pairs per channel row
  long long valid;     // pairs of each row that are read; the rest are 0
  long long n;         // owned samples per block
  int nchunk;          // chunks per block (ceil(n / kChunk))
  int vec;             // rows 16-byte aligned: load two pairs at once
  Rule rule;
};

inline PairParams pair_params(const void* iq, void* mask, void* ref,
                              long long L, long long valid, long long n,
                              int nchunk, const Rule& rule) {
  PairParams p;
  p.iq = static_cast<const float2*>(iq);
  p.mask = static_cast<int32_t*>(mask);
  p.ref = static_cast<float*>(ref);
  p.L = L;
  p.valid = valid;
  p.n = n;
  p.nchunk = nchunk;
  p.vec = reinterpret_cast<uintptr_t>(iq) % 16 == 0 && L % 2 == 0;
  p.rule = rule;
  return p;
}

// Stages the power m = fma(xi, xi, xq*xq) of the pairs of row `iq` at
// block positions d0 + u, u in [0, staged_len), in s.m[sk(u)], or 0 at or
// past p.valid, loading two pairs per step (one float4 where p.vec).
// Returns whether this thread met a NaN, an Inf or a power above
// kFinitePower; the caller synchronises.
__device__ __forceinline__ int stage_pairs(const Smem& s, const float2* iq,
                                           long long d0,
                                           const PairParams& p) {
  const int len = staged_len(p.rule);
  int wild = 0;
  for (int q = threadIdx.x; q < len / 2; q += kThreads) {
    const long long x = d0 + 2LL * q;
    float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    if (p.vec && x + 1 < p.valid) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(iq + x));
      a = make_float2(v.x, v.y);
      b = make_float2(v.z, v.w);
    } else {
      if (x < p.valid) a = iq[x];
      if (x + 1 < p.valid) b = iq[x + 1];
    }
    const float pa = __fmaf_rn(a.x, a.x, __fmul_rn(a.y, a.y));
    const float pb = __fmaf_rn(b.x, b.x, __fmul_rn(b.y, b.y));
    wild |= !(pa <= kFinitePower) || !(pb <= kFinitePower);
    s.m[sk(2 * q)] = pa;
    s.m[sk(2 * q + 1)] = pb;
  }
  return wild;
}

// Stores the bits of a thread's run as kRun int32 0/1 at out (16-byte
// aligned), bit j at out[j].
__device__ __forceinline__ void store_bits(int32_t* out, uint32_t bits) {
  int4* o = reinterpret_cast<int4*>(out);
#pragma unroll
  for (int j = 0; j < kRun / 4; ++j)
    o[j] = make_int4((bits >> (4 * j)) & 1, (bits >> (4 * j + 1)) & 1,
                     (bits >> (4 * j + 2)) & 1, (bits >> (4 * j + 3)) & 1);
}

// Launches kern over nblk chunks on stream s with the rule's shared memory.
inline cudaError_t launch_pairs(void (*kern)(PairParams), const PairParams& p,
                                int nblk, cudaStream_t s) {
  const int smem = smem_bytes(p.rule);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<nblk, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace detect
