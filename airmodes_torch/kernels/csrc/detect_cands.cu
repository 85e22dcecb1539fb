// Kernel B1: preamble detection on planar int8 I/Q with per-lane candidate
// extraction, and its variants B5o (ordered) and B5p (prescreen), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_detect_kernel_cands_i8_db` (and its serial twin
// `_detect_kernel_cands_i8`) in airmodes/kernels/preamble_pallas.py, as
// launched by `preamble_detect_cands_planar`: with ordered=False (B1), with
// ordered=True (B5o, the reference's `_extract_cands`) and with
// prescreen=True (B5p, `_prescreen_keep_2d`); the two options combine. One
// source, one instantiation per variant: the chunk kernel is templated on
// the prescreen rule and both kernels on the ordering, which sets how many
// hit rows a chunk keeps.
//
// What it computes, per channel c and owned sample d (planar x = d + 256):
//   m[x]   = fma(xi, xi, xq*xq), xi = int8 * (1/127)       (raw power)
//   ws[y]  = trailing 128-sample sum of m by the log-doubling fold
//            ws <- ws[y] + ws[y+s], s = 1, 2, ..., 64
//   ce[x]  = ((m[x] + m[x+1]) + ... + m[x+sps-1]) * (1/sps)  (sps > 1)
//   the 4-pulse + quiet-chip preamble test against nf = ws[x-128]/128,
//   then non-max suppression over +-nms_chips*sps samples
// (the rule's body, shared with B3/B4 and B6, is detect_body.cuh).
// Output, per (channel, tile), the reference's (C, tiles, 8, 128) contract,
// so the spill rules behind n_overflow stay the same (hit d in tile row r,
// lane l encodes as r*128 + l; sentinel trows*128):
//   unordered: the first per_lane (<= 4) hits of each of the 128 lane
//     columns in rows 0..per_lane-1, the sentinel in the rest of rows 0..3;
//   ordered: of each lane column's first per_lane (<= 8) hits, the tile's
//     earliest per_tile (<= 512), ascending, at flat positions 0.. of rows
//     0..3, the sentinel after them;
// per-lane hit counts in row 4, zeros in 5..7. B5p's rule (detect_body.cuh)
// drops the NMS and the late quiet chips and scales the threshold by the
// reference's slack (the caller passes it); its candidates feed stage B.
//
// Numerics: every f32 operation is the reference's, in the reference's
// order, with explicit round-to-nearest intrinsics. The power is a fused
// multiply-add, fma(xi, xi, xq*xq): that is what the JAX reference computes
// (XLA contracts xi*xi + xq*xq), and the plain PyTorch version reproduces it
// exactly. So is the reference level at sps > 1, where XLA contracts pulse
// 0's chip-energy scale into the pulse sum (detect_body.cuh: ref_at). The
// file is also built with --fmad=false so that no other product is
// contracted. The reference may take the window sum as two
// matmuls (mxu_window_sum); this kernel always takes the doubling fold.
//
// What bounds it on this card: it reads 2 bytes per sample and writes
// 4 KiB per 131072-sample tile, so the memory bound is ~2 B/sample over
// 3.35 TB/s. The arithmetic is ~46 f32 operations per owned sample at
// sps = 1 (power, the fold, the chip tests, the NMS window), which at
// 67 TFLOP/s takes a little longer than the memory: the kernel sits at
// the ridge, bound by operations. Design: one
// CTA per 4096-sample chunk (32 rows of 128 lanes) stages its power with
// 256 samples of lookback and a right halo in shared memory, runs the
// fold, the tests and the NMS there, and extracts each lane's first 4
// (ordered: 8) hits of the chunk; a second small kernel merges the chunks of
// each tile in order. A 131072-sample tile does not fit in shared memory,
// and one CTA per tile would leave most of the 132 SMs idle, hence the
// chunks. The ordered merge holds the tile's <= 1024 per-lane hits in
// shared memory and places each by its rank (the count of smaller ones,
// all distinct), in place of the reference's per_tile sequential
// min-extractions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect_body.cuh"

namespace {

using detect::kChunk;
using detect::kChunkRows;
using detect::kLanes;
using detect::kThreads;
constexpr int kCandRows = 8;
constexpr int kCountRow = 4;
constexpr int kMaxPerLane = 8;

struct Params {
  const int8_t* xi;
  const int8_t* xq;
  int32_t* chunk_out;  // (C * tiles * nchunk, 4 + 1 or 8 + 1, 128)
  int32_t* out;        // (C * tiles, 8, 128)
  long long P;         // planar samples per channel
  int tile;            // owned samples per tile
  int tiles;           // tiles per channel
  int nchunk;          // chunks per tile
  int per_lane;        // hits kept per (tile, lane): <= 4 unordered, else 8
  int per_tile;        // hits kept per tile, ordered layout, <= 512
  float scale;         // 1/127
  detect::Rule rule;
};

template <bool kPrescreen, bool kOrdered>
__global__ void __launch_bounds__(kThreads)
detect_chunk_kernel(Params p) {
  // hit rows a chunk keeps per lane: the unordered layout's 4, or the
  // ordered layout's 8 (the merge takes per_lane of them)
  constexpr int kKeep = kOrdered ? kMaxPerLane : kCountRow;
  extern __shared__ float smem[];
  const detect::Smem s = detect::carve(smem, p.rule);
  const int len = detect::staged_len(p.rule);

  const int blk = blockIdx.x;                    // (c, t, k) flattened
  const int k = blk % p.nchunk;
  const int ct = blk / p.nchunk;                 // c * tiles + t
  const int t = ct % p.tiles;
  const int c = ct / p.tiles;
  // staged local index u <-> planar sample x = d0 + u; owned u in
  // [256, 256 + kChunk) since planar x = owned d + 256
  const long long d0 = (long long)t * p.tile + (long long)k * kChunk;
  const int8_t* xi = p.xi + (long long)c * p.P;
  const int8_t* xq = p.xq + (long long)c * p.P;

  for (int u = threadIdx.x; u < len; u += kThreads) {
    const long long x = d0 + u;
    float v = 0.f;
    if (x < p.P) {
      const float fi = __fmul_rn((float)xi[x], p.scale);
      const float fq = __fmul_rn((float)xq[x], p.scale);
      v = __fmaf_rn(fi, fi, __fmul_rn(fq, fq));
    }
    s.m[u] = v;
  }
  __syncthreads();
  // int8 powers are at most 2: every term of the rule is finite
  detect::detect_chunk<kPrescreen, false, false>(s, p.rule);

  // per-lane first kKeep hits of this chunk, in tile coordinates, then
  // the lane's hit count
  if (threadIdx.x < kLanes) {
    const int lane = threadIdx.x;
    const int sent = (p.tile / kLanes) * kLanes;
    int hits[kKeep];
#pragma unroll
    for (int j = 0; j < kKeep; ++j) hits[j] = sent;
    int n = 0;
    for (int r = 0; r < kChunkRows; ++r) {
      if (s.keep[r * kLanes + lane]) {
        if (n < kKeep) hits[n] = (k * kChunkRows + r) * kLanes + lane;
        ++n;
      }
    }
    int32_t* o = p.chunk_out + (long long)blk * (kKeep + 1) * kLanes;
#pragma unroll
    for (int j = 0; j < kKeep; ++j) o[j * kLanes + lane] = hits[j];
    o[kKeep * kLanes + lane] = n;
  }
}

// One CTA per (channel, tile), one thread per lane: the first per_lane
// hits of a lane column are the first per_lane of its chunks' hits in
// chunk order (each chunk's list is ascending and chunks ascend); counts
// add. kOrdered then ranks the tile's per-lane hits and writes the
// earliest per_tile in ascending order.
template <bool kOrdered>
__global__ void __launch_bounds__(kLanes)
merge_chunks_kernel(Params p) {
  constexpr int kKeep = kOrdered ? kMaxPerLane : kCountRow;
  const int ct = blockIdx.x;
  const int lane = threadIdx.x;
  const int sent = (p.tile / kLanes) * kLanes;
  int hits[kKeep];
#pragma unroll
  for (int j = 0; j < kKeep; ++j) hits[j] = sent;
  int n = 0;
  int count = 0;
  for (int k = 0; k < p.nchunk; ++k) {
    const int32_t* o =
        p.chunk_out + ((long long)ct * p.nchunk + k) * (kKeep + 1) * kLanes;
    count += o[kKeep * kLanes + lane];
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      const int v = o[j * kLanes + lane];
      if (v < sent && n < p.per_lane) hits[n++] = v;
    }
  }
  int32_t* out = p.out + (long long)ct * kCandRows * kLanes;
  if (kOrdered) {
    __shared__ int32_t tab[kMaxPerLane * kLanes];  // per-lane hits
    __shared__ int32_t ord[kCountRow * kLanes];    // ordered rows 0..3
#pragma unroll
    for (int j = 0; j < kKeep; ++j) tab[j * kLanes + lane] = hits[j];
#pragma unroll
    for (int j = 0; j < kCountRow; ++j) ord[j * kLanes + lane] = sent;
    __syncthreads();
    // entries are distinct hit offsets (sentinels sort last), so a hit's
    // place in the ascending list is the count of smaller entries; a
    // lane's hits ascend, so its ranks do too
    for (int j = 0; j < n; ++j) {
      const int v = tab[j * kLanes + lane];
      int rank = 0;
      for (int i = 0; i < kKeep * kLanes; ++i) rank += tab[i] < v;
      if (rank >= p.per_tile) break;
      ord[rank] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCountRow; ++j)
      out[j * kLanes + lane] = ord[j * kLanes + lane];
  } else {
#pragma unroll
    for (int j = 0; j < kCountRow; ++j) out[j * kLanes + lane] = hits[j];
  }
  out[kCountRow * kLanes + lane] = count;
  for (int j = kCountRow + 1; j < kCandRows; ++j) out[j * kLanes + lane] = 0;
}

template <bool kPrescreen, bool kOrdered>
cudaError_t launch_chunks(const Params& p, int nblk, cudaStream_t s) {
  const int smem = detect::smem_bytes(p.rule);
  cudaError_t err = cudaFuncSetAttribute(
      detect_chunk_kernel<kPrescreen, kOrdered>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  detect_chunk_kernel<kPrescreen, kOrdered><<<nblk, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError(). Allocates
// nothing and does not synchronise.
int detect_cands_launch(const void* xi, const void* xq, void* chunk_out,
                        void* out, int channels, long long P, int tile,
                        int tiles, int nchunk, int per_lane, int per_tile,
                        int ordered, int prescreen, int sps, int half,
                        int rhalo, float scale, float thresh, float ptol,
                        float qtol, float inv_sps, void* stream) {
  if (per_lane < 1 || per_lane > (ordered ? kMaxPerLane : kCountRow) ||
      (ordered && (per_tile < 1 || per_tile > kCountRow * kLanes)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xi = static_cast<const int8_t*>(xi);
  p.xq = static_cast<const int8_t*>(xq);
  p.chunk_out = static_cast<int32_t*>(chunk_out);
  p.out = static_cast<int32_t*>(out);
  p.P = P;
  p.tile = tile;
  p.tiles = tiles;
  p.nchunk = nchunk;
  p.per_lane = per_lane;
  p.per_tile = per_tile;
  p.scale = scale;
  p.rule = detect::Rule{sps, half, rhalo, thresh, ptol, qtol, inv_sps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = channels * tiles * nchunk;
  cudaError_t err =
      prescreen ? (ordered ? launch_chunks<true, true>(p, nblk, s)
                           : launch_chunks<true, false>(p, nblk, s))
                : (ordered ? launch_chunks<false, true>(p, nblk, s)
                           : launch_chunks<false, false>(p, nblk, s));
  if (err != cudaSuccess) return (int)err;
  if (ordered)
    merge_chunks_kernel<true><<<channels * tiles, kLanes, 0, s>>>(p);
  else
    merge_chunks_kernel<false><<<channels * tiles, kLanes, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
