// Kernel B1: preamble detection on planar int8 I/Q with per-lane candidate
// extraction, and its variants B5o (ordered) and B5p (prescreen), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_detect_kernel_cands_i8_db` (and its serial twin
// `_detect_kernel_cands_i8`) in airmodes/kernels/preamble_pallas.py, as
// launched by `preamble_detect_cands_planar`: with ordered=False (B1), with
// ordered=True (B5o, the reference's `_extract_cands`) and with
// prescreen=True (B5p, `_prescreen_keep_2d`); the two options combine. One
// source: the chunk kernel is templated on the prescreen rule, and each
// ordering has its merge kernel.
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
//   ordered: of each lane column's first per_lane (any number) hits, the
//     tile's earliest per_tile (<= 512), ascending, at flat positions 0..
//     of rows 0..3, the sentinel after them;
// per-lane hit counts in row 4, zeros in 5..7. B5p's rule (detect_body.cuh)
// drops the NMS and the late quiet chips and scales the threshold by the
// reference's slack (the caller passes it); its candidates feed stage B.
//
// Numerics: every f32 operation is the reference's, in the reference's
// order, with explicit round-to-nearest intrinsics. The power is a fused
// multiply-add, fma(xi, xi, xq*xq): that is what the JAX reference computes
// (XLA contracts xi*xi + xq*xq), and the plain PyTorch version reproduces it
// exactly. So is the reference level at sps > 1, where XLA contracts pulse
// 0's chip-energy scale into the pulse sum (detect_body.cuh). The file is
// also built with --fmad=false so that no other product is contracted. The
// reference may take the window sum as two matmuls (mxu_window_sum); this
// kernel always takes the doubling fold.
//
// What bounds it on this card: it reads 2 bytes per sample and writes
// 4 KiB per 131072-sample tile (~5 us at 3.35 TB/s for 8 channels of 2^20
// samples), while the rule issues ~44 f32 instructions per owned sample at
// sps = 1 (power, the fold, the chip tests, the NMS window; ~11 us at the
// card's 33.5 T f32 instructions per second, an FMA counted once): bound by
// operations. Design: one CTA per 4096-sample chunk (32 rows of 128 lanes)
// loads its samples 16 bytes of I and of Q per thread, stages their power
// with 256 samples of lookback and a right halo in shared memory, and runs
// the rule (detect_body.cuh: the fold in registers, each thread's tests
// from registers). It then turns its threads' keep bits into one 32-bit
// word per lane column, bit r for row r, and writes the chunk's 128 words
// (512 bytes). A second kernel per tile takes each lane column's first hits
// with __ffs over its chunks' words and counts them with __popc; the
// ordered merge keeps a lane's first per_lane hits by their prefix count,
// gathers the kept hits of every tile row with warp ballots, and one warp
// emits the earliest per_tile in row order from a scan of the rows' counts.
// A 131072-sample tile does not fit in shared memory, and one CTA per tile
// would leave most of the 132 SMs idle, hence the chunks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect_body.cuh"

namespace {

using detect::kChunk;
using detect::kChunkRows;
using detect::kFull;
using detect::kLanes;
using detect::kThreads;
constexpr int kCandRows = 8;
constexpr int kCountRow = 4;
// chunk words a merge thread loads at once: the loads of a batch are in
// flight together, so a tile's 32 chunks cost two memory round trips
constexpr int kMergeBatch = 16;

struct Params {
  const int8_t* xi;
  const int8_t* xq;
  uint32_t* chunk_bits;  // (C * tiles * nchunk, 128) keep words
  int32_t* out;          // (C * tiles, 8, 128)
  long long P;           // planar samples per channel
  int tile;              // owned samples per tile
  int tiles;             // tiles per channel
  int nchunk;            // chunks per tile
  int per_lane;          // hits kept per (tile, lane): <= 4 unordered
  int per_tile;          // hits kept per tile, ordered layout, <= 512
  float scale;           // 1/127
  detect::Rule rule;
};

template <bool kPrescreen, bool kFast>
__global__ void __launch_bounds__(kThreads)
detect_chunk_kernel(Params p) {
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

  // 16 samples per thread and step; P and d0 are multiples of 16, so a
  // vector lies wholly inside or wholly past the row
  for (int q = threadIdx.x; q < len / 16; q += kThreads) {
    const long long x = d0 + 16LL * q;
    int4 vi = make_int4(0, 0, 0, 0), vq = make_int4(0, 0, 0, 0);
    if (x < p.P) {
      vi = __ldg(reinterpret_cast<const int4*>(xi + x));
      vq = __ldg(reinterpret_cast<const int4*>(xq + x));
    }
    const int8_t* bi = reinterpret_cast<const int8_t*>(&vi);
    const int8_t* bq = reinterpret_cast<const int8_t*>(&vq);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float fi = __fmul_rn((float)bi[i], p.scale);
      const float fq = __fmul_rn((float)bq[i], p.scale);
      s.m[detect::sk(16 * q + i)] = __fmaf_rn(fi, fi, __fmul_rn(fq, fq));
    }
  }
  __syncthreads();
  // int8 powers are at most 2: every term of the rule is finite
  const uint32_t bits =
      detect::detect_chunk<kPrescreen, false, false, kFast>(s, p.rule,
                                                            nullptr);

  // thread T holds row T/8, lanes 16(T%8) .. +15; a lane column's word
  // has bit r for row r
  s.bits[threadIdx.x] = bits;
  __syncthreads();
  if (threadIdx.x < kLanes) {
    const int lane = threadIdx.x;
    constexpr int kPerRow = kThreads / kChunkRows;
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r)
      word |= ((s.bits[r * kPerRow + (lane >> 4)] >> (lane & 15)) & 1u) << r;
    p.chunk_bits[(long long)blk * kLanes + lane] = word;
  }
}

// One CTA per (channel, tile), one thread per lane column: the column's
// first per_lane hits are the first set bits of its chunks' words in chunk
// order; counts add.
__global__ void __launch_bounds__(kLanes)
merge_unordered_kernel(Params p) {
  const int lane = threadIdx.x;
  const long long ct = blockIdx.x;
  const int sent = (p.tile / kLanes) * kLanes;
  const uint32_t* __restrict__ w = p.chunk_bits + ct * p.nchunk * kLanes + lane;
  int32_t* __restrict__ out = p.out + ct * kCandRows * kLanes + lane;
  int n = 0, count = 0;
  for (int k0 = 0; k0 < p.nchunk; k0 += kMergeBatch) {
    uint32_t b[kMergeBatch];
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i)
      b[i] = k0 + i < p.nchunk ? __ldg(w + (long long)(k0 + i) * kLanes) : 0u;
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i) {
      count += __popc(b[i]);
      for (uint32_t x = b[i]; x && n < p.per_lane; x &= x - 1, ++n)
        out[n * kLanes] = ((k0 + i) * kChunkRows + __ffs(x) - 1) * kLanes +
                          lane;
    }
  }
  for (int j = n; j < kCountRow; ++j) out[j * kLanes] = sent;
  out[kCountRow * kLanes] = count;
  for (int j = kCountRow + 1; j < kCandRows; ++j) out[j * kLanes] = 0;
}

// One CTA per (channel, tile), one thread per lane column. A lane's hit is
// kept while fewer than per_lane hits lie before it in its column; the
// kept hits of each tile row r land in rowm[r] (4 words, bit b of word j
// for lane 32j + b) by warp ballots. Then warp 0 walks the rows in order,
// 32 at a time: a scan of the rows' counts gives each row's first output
// position, and each lane writes its row's hits, ascending, below
// per_tile. The sentinel fills the rest of rows 0..3.
__global__ void __launch_bounds__(kLanes)
merge_ordered_kernel(Params p) {
  extern __shared__ uint4 rowm[];  // (trows) selected hits per tile row
  __shared__ int n_out;
  const int lane = threadIdx.x;
  const int t = lane & 31;
  const int wq = lane >> 5;
  const long long ct = blockIdx.x;
  const int trows = p.tile / kLanes;
  const int sent = trows * kLanes;
  const uint32_t* __restrict__ w = p.chunk_bits + ct * p.nchunk * kLanes + lane;
  int32_t* __restrict__ out = p.out + ct * kCandRows * kLanes;
  uint32_t* rows = reinterpret_cast<uint32_t*>(rowm);
  int count = 0;
  for (int k0 = 0; k0 < p.nchunk; k0 += kMergeBatch) {
    uint32_t words[kMergeBatch];
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i)
      words[i] =
          k0 + i < p.nchunk ? __ldg(w + (long long)(k0 + i) * kLanes) : 0u;
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i) {
      if (k0 + i >= p.nchunk) break;
      const uint32_t b = words[i];
      const int room = p.per_lane - count;
      uint32_t sel = b;
      if (__popc(b) > room) {      // keep the lowest `room` bits
        sel = 0;
        uint32_t x = b;
        for (int q = 0; q < room; ++q, x &= x - 1) sel |= x & (0u - x);
      }
      count += __popc(b);
      uint32_t mine = 0;
      if (__any_sync(kFull, sel)) {
#pragma unroll
        for (int r = 0; r < kChunkRows; ++r) {
          const uint32_t m = __ballot_sync(kFull, (sel >> r) & 1u);
          if (r == t) mine = m;
        }
      }
      rows[((k0 + i) * kChunkRows + t) * 4 + wq] = mine;
    }
  }
  out[kCountRow * kLanes + lane] = count;
  for (int j = kCountRow + 1; j < kCandRows; ++j) out[j * kLanes + lane] = 0;
  __syncthreads();
  if (wq == 0) {
    int total = 0;
    for (int r0 = 0; r0 < trows && total < p.per_tile; r0 += 32) {
      const int r = r0 + t;
      const uint4 m4 = r < trows ? rowm[r] : make_uint4(0, 0, 0, 0);
      const int c = __popc(m4.x) + __popc(m4.y) + __popc(m4.z) +
                    __popc(m4.w);
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (t >= o) incl += y;
      }
      int pos = total + incl - c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t x = j == 0 ? m4.x : j == 1 ? m4.y : j == 2 ? m4.z : m4.w;
        for (; x && pos < p.per_tile; x &= x - 1, ++pos)
          out[pos] = r * kLanes + 32 * j + __ffs(x) - 1;
      }
      total += __shfl_sync(kFull, incl, 31);
    }
    if (t == 0) n_out = min(total, p.per_tile);
  }
  __syncthreads();
  for (int i = n_out + lane; i < kCountRow * kLanes; i += kLanes)
    out[i] = sent;
}

template <bool kPrescreen, bool kFast>
cudaError_t launch_chunks(const Params& p, int nblk, cudaStream_t s) {
  const int smem = detect::smem_bytes(p.rule);
  cudaError_t err = cudaFuncSetAttribute(
      detect_chunk_kernel<kPrescreen, kFast>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  detect_chunk_kernel<kPrescreen, kFast><<<nblk, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError(). Allocates
// nothing and does not synchronise. The planar rows must be 16-byte aligned
// and P a multiple of 16.
int detect_cands_launch(const void* xi, const void* xq, void* chunk_bits,
                        void* out, int channels, long long P, int tile,
                        int tiles, int nchunk, int per_lane, int per_tile,
                        int ordered, int prescreen, int sps, int half,
                        int rhalo, float scale, float thresh, float ptol,
                        float qtol, float inv_sps, void* stream) {
  if (per_lane < 1 || (!ordered && per_lane > kCountRow) ||
      (ordered && (per_tile < 1 || per_tile > kCountRow * kLanes)) ||
      half > detect::kMaxHalf || P % 16 ||
      reinterpret_cast<uintptr_t>(xi) % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xi = static_cast<const int8_t*>(xi);
  p.xq = static_cast<const int8_t*>(xq);
  p.chunk_bits = static_cast<uint32_t*>(chunk_bits);
  p.out = static_cast<int32_t*>(out);
  p.P = P;
  p.tile = tile;
  p.tiles = tiles;
  p.nchunk = nchunk;
  p.per_lane = per_lane;
  p.per_tile = per_tile;
  p.scale = scale;
  // the prescreen rule has no NMS
  p.rule = detect::Rule{sps, prescreen ? 0 : half, rhalo, thresh, ptol, qtol,
                        inv_sps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = channels * tiles * nchunk;
  const bool fast = detect::fast_rule(p.rule);
  cudaError_t err =
      prescreen ? (fast ? launch_chunks<true, true>(p, nblk, s)
                        : launch_chunks<true, false>(p, nblk, s))
                : (fast ? launch_chunks<false, true>(p, nblk, s)
                        : launch_chunks<false, false>(p, nblk, s));
  if (err != cudaSuccess) return (int)err;
  if (ordered) {
    const int smem = (tile / kLanes) * (int)sizeof(uint4);
    err = cudaFuncSetAttribute(merge_ordered_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    merge_ordered_kernel<<<channels * tiles, kLanes, smem, s>>>(p);
  } else {
    merge_unordered_kernel<<<channels * tiles, kLanes, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
