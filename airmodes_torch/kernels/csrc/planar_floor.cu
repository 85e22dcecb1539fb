// Probe P5: the load floor of the planar int8 path, kernel B1's windows
// loaded and nothing computed, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probe `_floor_kernel` (`step_floor`) of
// scripts/tpu_unordered_stage_probe.py, which ran B1's grid with its
// NBUF-deep int8 windows and wrote zeros + the window's first I sample to
// each tile's (8, 128) candidate block. This kernel follows the port's own
// B1 geometry (detect_cands.cu) instead of the TPU's: one CTA of 256
// threads per 4096-sample chunk (c, tile t, chunk k), staging window
// planar samples d0 .. d0 + len - 1 with d0 = t * tile + k * 4096 and len =
// 256 (lookback) + 4096 + the right halo, loaded 16 bytes of I and 16 of Q
// per thread and step, as B1 loads them. It runs no rule.
//
// Output: the TPU floor's contract, out[c][t] (8 x 128 int32) = the
// planar I sample at t * tile (the first sample of the tile's first
// window), written by the tile's first chunk; and, to keep every load
// alive, each CTA's bitwise OR over the words it loaded in scratch[blk].
// Without a use of each loaded byte nvcc drops the loads.
//
// What bounds it on this card: bytes. It reads 2 bytes per staged sample
// (B1's windows overlap by their lookback and halo: 4384 staged per 4096
// owned at sps 1) and writes 4 KiB per tile; it does no f32 arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;
constexpr int kCandWords = 8 * 128;

struct Params {
  const int8_t* xi;
  const int8_t* xq;
  uint32_t* scratch;  // (C * tiles * nchunk) OR of each CTA's loads
  int32_t* out;       // (C * tiles, 8, 128)
  long long P;        // planar samples per channel
  int tile;           // owned samples per tile
  int tiles;          // tiles per channel
  int nchunk;         // chunks per tile
  int len;            // staged samples per chunk, a multiple of 16
};

__global__ void __launch_bounds__(kThreads) planar_floor_kernel(Params p) {
  __shared__ uint32_t any;
  const int blk = blockIdx.x;
  const int k = blk % p.nchunk;
  const int ct = blk / p.nchunk;
  const int t = ct % p.tiles;
  const int c = ct / p.tiles;
  const long long d0 = (long long)t * p.tile + (long long)k * kChunk;
  const int8_t* xi = p.xi + (long long)c * p.P;
  const int8_t* xq = p.xq + (long long)c * p.P;
  if (threadIdx.x == 0) any = 0;
  __syncthreads();

  // P and d0 are multiples of 16: a vector lies wholly inside or past the
  // row, and past it reads as zeros, as B1 stages it
  uint32_t acc = 0;
  for (int q = threadIdx.x; q < p.len / 16; q += kThreads) {
    const long long x = d0 + 16LL * q;
    if (x < p.P) {
      const int4 vi = __ldg(reinterpret_cast<const int4*>(xi + x));
      const int4 vq = __ldg(reinterpret_cast<const int4*>(xq + x));
      acc |= (uint32_t)(vi.x | vi.y | vi.z | vi.w | vq.x | vq.y | vq.z |
                        vq.w);
    }
  }
  acc = __reduce_or_sync(0xffffffffu, acc);
  if ((threadIdx.x & 31) == 0) atomicOr(&any, acc);
  __syncthreads();
  if (threadIdx.x == 0) p.scratch[blk] = any;

  if (k == 0) {
    const int v = xi[d0];
    int4* out = reinterpret_cast<int4*>(p.out + (long long)ct * kCandWords);
    for (int j = threadIdx.x; j < kCandWords / 4; j += kThreads)
      out[j] = make_int4(v, v, v, v);
  }
}

}  // namespace

extern "C" {

// Launches the floor over C channels of P planar samples (rows 16-byte
// aligned, P a multiple of 16) on `stream`; returns cudaGetLastError().
// Allocates nothing and does not synchronise.
int planar_floor_launch(const void* xi, const void* xq, void* scratch,
                        void* out, int channels, long long P, int tile,
                        int tiles, int nchunk, int len, void* stream) {
  if (P % 16 || len % 16 || tile != nchunk * kChunk ||
      reinterpret_cast<uintptr_t>(xi) % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xi = static_cast<const int8_t*>(xi);
  p.xq = static_cast<const int8_t*>(xq);
  p.scratch = static_cast<uint32_t*>(scratch);
  p.out = static_cast<int32_t*>(out);
  p.P = P;
  p.tile = tile;
  p.tiles = tiles;
  p.nchunk = nchunk;
  p.len = len;
  const long long nblk = (long long)channels * tiles * nchunk;
  if (nblk < 1) return (int)cudaSuccess;
  planar_floor_kernel<<<(unsigned)nblk, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
