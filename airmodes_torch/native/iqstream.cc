// Native host runtime: IQ streaming ring buffer + overlap-save block framer.
//
// Role-equivalent of the GNU Radio buffer machinery the reference leans on
// (single-writer ring buffers between block threads + set_history look-back;
// SURVEY.md §2.7/§5.8 tier a). The TPU compute path is JAX/XLA; this is the
// native runtime that feeds it: a producer thread (file reader or UDP
// receiver) fills a lock-free SPSC ring of float32 I/Q pairs, converting
// SDR wire formats (uc8 rtl-sdr offset bytes, sc16 USRP shorts) on the fly;
// the consumer pulls fixed-size overlapped blocks
// [left_halo | block | right_halo] ready for device transfer, carrying a
// monotonically increasing int64 sample counter (the timestamp base).
//
// C ABI only; bound from Python with ctypes (native/__init__.py).

#include <algorithm>
#include <atomic>
#include <vector>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cerrno>
#include <cstring>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Ring {
  float* data = nullptr;        // interleaved I/Q, 2 floats per sample
  uint64_t capacity = 0;        // samples, power of two
  std::atomic<uint64_t> head{0};  // samples written (producer)
  std::atomic<uint64_t> tail{0};  // samples consumed (consumer)
  std::atomic<bool> eof{false};
  std::atomic<uint64_t> dropped{0};

  uint64_t mask() const { return capacity - 1; }
};

struct Stream {
  Ring ring;
  // framer geometry (samples)
  uint64_t left = 0, block = 0, right = 0;
  std::atomic<uint64_t> real_pushed{0};  // samples pushed (excl. EOF pad)
  uint64_t next_start = 0;      // global sample index of next owned block
  uint64_t start_offset = 0;    // resume offset (file seek, samples)
  float* carry = nullptr;       // last `left` samples of the previous block
  int rcvbuf = 0;               // effective UDP SO_RCVBUF (bytes)
  // producer
  std::thread pump;
  std::atomic<bool> stop{false};
  int sock_fd = -1;
};

inline uint64_t ring_free(const Ring& r) {
  return r.capacity - (r.head.load(std::memory_order_acquire) -
                       r.tail.load(std::memory_order_acquire));
}
inline uint64_t ring_avail(const Ring& r) {
  return r.head.load(std::memory_order_acquire) -
         r.tail.load(std::memory_order_acquire);
}

// --- SDR wire-format converters (hot loops, auto-vectorized) ---------------

// Wire formats: 0 = f32 pairs, 1 = sc16, 2 = uc8; bytes per sample.
constexpr int kF32 = 0, kSc16 = 1, kUc8 = 2;
inline uint64_t wire_bytes(int format) {
  return format == kF32 ? 8 : (format == kSc16 ? 4 : 2);
}

void convert_uc8(const uint8_t* in, float* out, uint64_t n_samples) {
  constexpr float k = 1.0f / 127.5f;
  for (uint64_t i = 0; i < 2 * n_samples; ++i)
    out[i] = (static_cast<float>(in[i]) - 127.5f) * k;
}

void convert_sc16(const int16_t* in, float* out, uint64_t n_samples) {
  constexpr float k = 1.0f / 32768.0f;
  for (uint64_t i = 0; i < 2 * n_samples; ++i)
    out[i] = static_cast<float>(in[i]) * k;
}

// n samples of the wire format -> f32 pairs at out
void convert_wire(int format, const uint8_t* in, float* out, uint64_t n) {
  if (format == kSc16)
    convert_sc16(reinterpret_cast<const int16_t*>(in), out, n);
  else if (format == kUc8)
    convert_uc8(in, out, n);
  else
    std::memcpy(out, in, n * 2 * sizeof(float));
}

// Write n samples of the wire format into the ring at head, converted where
// they land: two spans where the ring wraps, head published after the
// samples (caller checked free space).
void ring_write(Ring& r, const uint8_t* src, int format, uint64_t n) {
  uint64_t h = r.head.load(std::memory_order_relaxed);
  uint64_t idx = h & r.mask();
  uint64_t first = std::min(n, r.capacity - idx);
  convert_wire(format, src, r.data + 2 * idx, first);
  if (n > first)
    convert_wire(format, src + first * wire_bytes(format), r.data,
                 n - first);
  r.head.store(h + n, std::memory_order_release);
}

// THE int8 quantization rule, ONE helper for every native quantize loop
// (mirrors dsp/host.py quantize_i8_np: clamp to +-127, round half to even
// = np.round; four hand-copied bodies used to carry this — a drifting
// copy breaks the cross-path dBFS/bit-exactness contract). Branch-free so
// that the loops calling it vectorize: +/-inf saturates, NaN quantizes to
// 0 (a noise sample; every compare with NaN is false, so the clamps keep
// it and the last select drops it). Adding 1.5 * 2^23 puts the clamped
// value in the binade whose unit in the last place is 1: the add rounds
// it half to even, exactly, and the low mantissa bits hold the result.
// The clamps stand between the caller's product and the add, so no FMA
// can fuse them.
inline int8_t quant_i8(float v) {
  constexpr float kRound = 12582912.f;        // 1.5 * 2^23, bits 0x4b400000
  constexpr int32_t kRoundBits = 0x4b400000;
  v = v > 127.f ? 127.f : v;
  v = v < -127.f ? -127.f : v;
  v = v == v ? v : 0.f;
  float r = v + kRound;
  int32_t b;
  std::memcpy(&b, &r, sizeof b);
  return static_cast<int8_t>(b - kRoundBits);
}

// f32 pairs -> int8 pairs (quantized device transfer format)
void quantize_i8(const float* in, int8_t* out, uint64_t n_samples,
                 float scale) {
  for (uint64_t i = 0; i < 2 * n_samples; ++i)
    out[i] = quant_i8(in[i] * scale);
}

// The AGC peak's limit: |x| above 3.4e38f (inf, NaN and the largest
// finite floats) is skipped, so that one corrupt sample cannot drive the
// gain to 0 and quantize the whole block to silence with no error.
const int32_t kPeakLimitBits = [] {
  const float lim = 3.4e38f;
  int32_t b;
  std::memcpy(&b, &lim, sizeof b);
  return b;
}();

// Largest |x| at or under the limit over n floats, as its bits: for
// sign-cleared floats the integer order of the bits is the order of the
// values, so an integer max vectorizes where a float compare chain does not
// (signed: GCC vectorizes this select and max for int32, not for uint32).
int32_t peak_bits(const float* x, uint64_t n, int32_t peak) {
  for (uint64_t i = 0; i < n; ++i) {
    int32_t b;
    std::memcpy(&b, x + i, sizeof b);
    b &= 0x7fffffff;
    b = b <= kPeakLimitBits ? b : 0;
    peak = b > peak ? b : peak;
  }
  return peak;
}

// Write up to n samples of the wire format into the ring without drop
// accounting; returns samples taken. The pumps decide the overrun policy
// themselves: the file pump blocks and retries (a file is not real-time —
// nothing is lost), the UDP pump drops the datagram tail and counts it (a
// real-time source that cannot be paused — the reference prints "O" on the
// equivalent USRP overrun, SURVEY.md §5.3).
uint64_t push_take(Stream* s, const uint8_t* src, int format, uint64_t n) {
  uint64_t take = std::min(n, ring_free(s->ring));
  if (take) ring_write(s->ring, src, format, take);
  s->real_pushed.fetch_add(take);
  return take;
}

uint64_t push_counted(void* h, const void* raw, int format, uint64_t n) {
  auto* s = static_cast<Stream*>(h);
  uint64_t take = push_take(s, static_cast<const uint8_t*>(raw), format, n);
  if (take < n) s->ring.dropped.fetch_add(n - take);
  return take;
}

// The next framed block [left halo | block | right halo], read where it
// lies: the halo from `carry`, then block + right from the ring in at most
// two spans. frame() returns 1 with the spans set, 0 when the ring holds
// no block yet, -1 at the end of the stream (a final partial block is
// zero-padded first); advance() then keeps the block's last `left` samples
// as the next carry and releases its ring slots.
struct Frame {
  const float* ptr[3];
  uint64_t len[3];  // samples
};

int frame(Stream* s, Frame* f) {
  const uint64_t need = s->block + s->right;
  uint64_t avail = ring_avail(s->ring);
  bool eof = s->ring.eof.load(std::memory_order_acquire);
  if (eof && s->next_start - s->start_offset >= s->real_pushed.load())
    return -1;
  if (avail < need) {
    if (!eof) return 0;
    // zero-pad the stream tail so the remaining real samples frame into
    // full blocks; termination is by real_pushed, not ring emptiness
    uint64_t pad = need - avail;
    static thread_local std::vector<float> zeros;
    if (zeros.size() < 2 * pad) zeros.resize(2 * pad, 0.f);
    ring_write(s->ring, reinterpret_cast<const uint8_t*>(zeros.data()), kF32,
               std::min(pad, ring_free(s->ring)));
    if (ring_avail(s->ring) < need) return 0;  // ring too small (shouldn't happen)
  }
  // peek block+right without consuming right (it belongs to the next block)
  uint64_t idx = s->ring.tail.load(std::memory_order_relaxed) & s->ring.mask();
  uint64_t first = std::min(need, s->ring.capacity - idx);
  *f = Frame{{s->carry, s->ring.data + 2 * idx, s->ring.data},
             {s->left, first, need - first}};
  return 1;
}

void advance(Stream* s, int64_t* start_sample) {
  uint64_t t = s->ring.tail.load(std::memory_order_relaxed);
  // carry = last `left` samples of the owned block
  for (uint64_t i = 0; i < s->left; ++i) {
    uint64_t idx = (t + s->block - s->left + i) & s->ring.mask();
    s->carry[2 * i] = s->ring.data[2 * idx];
    s->carry[2 * i + 1] = s->ring.data[2 * idx + 1];
  }
  s->ring.tail.store(t + s->block, std::memory_order_release);
  *start_sample = static_cast<int64_t>(s->next_start);
  s->next_start += s->block;
}

void quantize_planar(const float* iq, int8_t* out_i, int8_t* out_q,
                     uint64_t n_samples, float scale) {
  for (uint64_t i = 0; i < n_samples; ++i) {
    out_i[i] = quant_i8(iq[2 * i] * scale);
    out_q[i] = quant_i8(iq[2 * i + 1] * scale);
  }
}

// A framed block quantized with `scale` into planar rows of out_len bytes,
// zero past the frame.
void quantize_frame_planar(const Frame& f, int8_t* out_i, int8_t* out_q,
                           uint64_t out_len, float scale) {
  uint64_t off = 0;
  for (int k = 0; k < 3; ++k) {
    quantize_planar(f.ptr[k], out_i + off, out_q + off, f.len[k], scale);
    off += f.len[k];
  }
  std::memset(out_i + off, 0, out_len - off);
  std::memset(out_q + off, 0, out_len - off);
}

}  // namespace

extern "C" {

// ---- lifecycle -------------------------------------------------------------

void* iq_stream_create(uint64_t ring_capacity_samples, uint64_t left,
                       uint64_t block, uint64_t right) {
  // round capacity up to a power of two
  uint64_t cap = 1;
  while (cap < ring_capacity_samples) cap <<= 1;
  auto* s = new Stream();
  s->ring.capacity = cap;
  s->ring.data = new float[2 * cap];
  s->left = left;
  s->block = block;
  s->right = right;
  s->carry = new float[2 * left]();
  return s;
}

void iq_stream_destroy(void* h) {
  auto* s = static_cast<Stream*>(h);
  s->stop.store(true);
  if (s->sock_fd >= 0) ::shutdown(s->sock_fd, SHUT_RDWR);
  if (s->pump.joinable()) s->pump.join();
  if (s->sock_fd >= 0) ::close(s->sock_fd);
  delete[] s->ring.data;
  delete[] s->carry;
  delete s;
}

// ---- producer side ---------------------------------------------------------

// Push float32 I/Q pairs (or, below, sc16/uc8 words). Returns samples
// accepted (may be < n when full); the shortfall is counted as dropped (this
// is the one-shot non-blocking API — a caller that does not retry has lost
// those samples).
uint64_t iq_stream_push_f32(void* h, const float* iq, uint64_t n) {
  return push_counted(h, iq, kF32, n);
}

uint64_t iq_stream_push_uc8(void* h, const uint8_t* raw, uint64_t n) {
  return push_counted(h, raw, kUc8, n);
}

uint64_t iq_stream_push_sc16(void* h, const int16_t* raw, uint64_t n) {
  return push_counted(h, raw, kSc16, n);
}

void iq_stream_set_eof(void* h) {
  auto* s = static_cast<Stream*>(h);
  // end the PRODUCER before marking eof: the consumer's EOF zero-pad
  // writes into the ring, and the SPSC invariant allows exactly one
  // writer — a pump still running would race it (lost head advances,
  // interleaved zeros/samples, corrupt frames). Self-join guard: the
  // file pump sets ring.eof directly, but a callback on the pump
  // thread calling this API must not deadlock.
  s->stop.store(true);
  if (s->sock_fd >= 0) ::shutdown(s->sock_fd, SHUT_RDWR);
  if (s->pump.joinable() &&
      s->pump.get_id() != std::this_thread::get_id())
    s->pump.join();
  s->ring.eof.store(true);
}

uint64_t iq_stream_dropped(void* h) {
  return static_cast<Stream*>(h)->ring.dropped.load();
}

int iq_stream_rcvbuf(void* h) {
  return static_cast<Stream*>(h)->rcvbuf;
}

// Standalone fused quantize + planar split: interleaved f32 I/Q pairs
// (= the memory layout of a complex64 array) -> planar int8 I and Q.
// One pass; used by the pod streaming runner where the framed-ring path
// does not apply (the chunks arrive as host complex64 arrays).
void iq_quantize_planar_i8(const float* iq, int8_t* out_i, int8_t* out_q,
                           uint64_t n_samples, float scale) {
  // the ONE fused quantize+planar-split loop: the framers below run it
  // too, span by span (same consolidation rationale as quant_i8's comment)
  quantize_planar(iq, out_i, out_q, n_samples, scale);
}

// ---- background pumps ------------------------------------------------------

// Pump a recorded file through the ring. format: 0=f32 pairs, 1=sc16, 2=uc8.
// throttle_sps > 0 replays at that sample rate (real-time file replay).
// offset_samples seeks into the capture and resumes the global sample
// counter there (checkpoint/resume: stream position IS the counter,
// SURVEY.md §5.4); the left halo at resume is zeros, matching the Python
// framer's re-acquisition semantics.
int iq_stream_start_file(void* h, const char* path, int format,
                         double throttle_sps, uint64_t offset_samples) {
  auto* s = static_cast<Stream*>(h);
  if (s->pump.joinable()) return -5;   // already started: re-assigning a
  // joinable std::thread calls std::terminate — fail as an error instead
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // FIFO/pipe sources: fread blocks indefinitely while the writer
  // stalls and never consults the stop flag, so destroy()'s join would
  // hang the caller forever — poll+read for non-regular
  // files instead
  struct stat stbuf {};
  bool regular = fstat(fileno(f), &stbuf) == 0 && S_ISREG(stbuf.st_mode);
  if (offset_samples) {
    uint64_t elem = wire_bytes(format);
    if (std::fseek(f, static_cast<long>(offset_samples * elem),
                   SEEK_SET) != 0) {
      std::fclose(f);
      return -1;
    }
    s->start_offset = offset_samples;
    s->next_start = offset_samples;
  }
  s->pump = std::thread([s, f, format, throttle_sps, regular]() {
    constexpr uint64_t CHUNK = 1 << 16;
    auto* raw = new uint8_t[CHUNK * 8];
    auto t0 = std::chrono::steady_clock::now();
    uint64_t sent = 0;
    uint64_t pend = 0;   // carried partial-element bytes (pipe reads)
    while (!s->stop.load()) {
      uint64_t elem = wire_bytes(format);
      uint64_t n;
      if (regular) {
        n = std::fread(raw, elem, CHUNK, f);
      } else {
        struct pollfd pfd {fileno(f), POLLIN, 0};
        ssize_t got = -1;
        while (!s->stop.load()) {
          int pr = poll(&pfd, 1, 100);
          if (pr < 0 && errno == EINTR) continue;
          if (pr < 0) { got = 0; break; }
          if (pr == 0) continue;          // stall: re-check stop
          got = read(fileno(f), raw + pend, CHUNK * elem - pend);
          if (got < 0 && errno == EINTR) continue;  // a signal between
          // poll and read is not EOF: conflating them silently ended a
          // live FIFO feed mid-capture
          break;
        }
        if (s->stop.load() || got <= 0) break;  // EOF / error / stop
        uint64_t have = pend + static_cast<uint64_t>(got);
        n = have / elem;
        pend = have - n * elem;
        if (n == 0) continue;             // only a partial element yet
      }
      if (n == 0) break;
      uint64_t off = 0;
      while (off < n && !s->stop.load()) {
        // blocking retry, NO drop accounting: a file source pauses until
        // the consumer catches up; nothing is ever lost. The words are
        // converted where they land in the ring.
        uint64_t took = push_take(s, raw + off * elem, format, n - off);
        off += took;
        if (took == 0)
          std::this_thread::sleep_for(std::chrono::microseconds(200));
      }
      if (!regular && pend)
        std::memmove(raw, raw + n * elem, pend);
      sent += n;
      if (throttle_sps > 0) {
        auto target = t0 + std::chrono::duration_cast<
            std::chrono::steady_clock::duration>(
            std::chrono::duration<double>(sent / throttle_sps));
        // sleep in <=50 ms slices so stop (close()/destroy) interrupts
        // promptly: one uninterruptible sleep is CHUNK/throttle_sps
        // seconds (many seconds at low replay rates)
        while (!s->stop.load()) {
          auto now = std::chrono::steady_clock::now();
          if (now >= target) break;
          auto rem = target - now;
          auto slice = std::chrono::duration_cast<
              std::chrono::steady_clock::duration>(
              std::chrono::milliseconds(50));
          std::this_thread::sleep_for(rem < slice ? rem : slice);
        }
      }
    }
    std::fclose(f);
    delete[] raw;
    s->ring.eof.store(true);
  });
  return 0;
}

// UDP receiver pump: binds host:port, expects float32 I/Q pair datagrams.
// timeout_s > 0 ends the stream after that much receive silence (parity
// with the Python udp_source's flush-on-timeout semantics).
int iq_stream_start_udp(void* h, const char* host, int port,
                        double timeout_s) {
  auto* s = static_cast<Stream*>(h);
  if (s->pump.joinable()) return -5;   // already started (see start_file)
  int fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  // NO SO_REUSEADDR: on UDP it lets a second process silently bind the
  // same port and steal the stream (the first instance then "times out"
  // with zero errors anywhere); a duplicate bind must fail loudly with
  // EADDRINUSE, matching the pure-Python udp_source
  // absorb bursts while the consumer compiles / catches up: losses the
  // kernel takes here are invisible to the app, so make them rare and let
  // the ring's counted drop policy be the overrun authority
  int rcvbuf = 8 << 20;
  if (::setsockopt(fd, SOL_SOCKET, SO_RCVBUFFORCE, &rcvbuf,
                   sizeof(rcvbuf)) != 0)   // CAP_NET_ADMIN only
    ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  socklen_t rblen = sizeof(rcvbuf);
  if (::getsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, &rblen) == 0)
    s->rcvbuf = rcvbuf / 2;  // effective size; Linux getsockopt returns
    // the kernel's DOUBLED bookkeeping value, so halve it back to usable
    // bytes (kernel may clamp to rmem_max silently; expose what
    // operators actually got)
  if (timeout_s > 0) {
    timeval tv{};
    tv.tv_sec = static_cast<long>(timeout_s);
    tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
    if (tv.tv_sec == 0 && tv.tv_usec == 0)
      tv.tv_usec = 1;   // a {0,0} timeval DISABLES the timeout entirely
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (host && host[0]) {
    // numeric IPs only: inet_addr returns INADDR_NONE (=broadcast) for
    // anything it cannot parse, and binding 255.255.255.255 "succeeds"
    // while receiving nothing — fail loudly instead
    in_addr parsed{};
    if (::inet_pton(AF_INET, host, &parsed) != 1) {
      ::close(fd);
      return -3;
    }
    addr.sin_addr = parsed;
  } else {
    addr.sin_addr.s_addr = INADDR_ANY;
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -2;
  }
  s->sock_fd = fd;
  s->pump = std::thread([s, fd]() {
    auto* buf = new uint8_t[1 << 16];
    while (!s->stop.load()) {
      ssize_t n = ::recv(fd, buf, 1 << 16, 0);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;  // incl. EAGAIN from SO_RCVTIMEO: silence ends the stream
      }
      // n == 0 is an EMPTY datagram (legal on SOCK_DGRAM), not EOF
      if (n == 0) continue;
      uint64_t samples = static_cast<uint64_t>(n) / 8;
      // real-time overrun policy: take what fits, DROP the rest of the
      // datagram and count it (iq_stream_dropped). Blocking here would
      // only move the loss into the kernel socket buffer where it is
      // invisible; the counted ring drop is what --stats surfaces.
      // (Dropped samples vanish from the sample counter, so downstream
      // timestamps compress across an overrun — same loss the reference
      // has on a USRP "O"; the drop counter is the operator's signal.)
      uint64_t took = push_take(s, buf, kF32, samples);
      if (took < samples) s->ring.dropped.fetch_add(samples - took);
    }
    delete[] buf;
    s->ring.eof.store(true);
  });
  return 0;
}

// ---- consumer side: overlap-save block framer ------------------------------

// Fill `out` with left+block+right float32 I/Q pairs. Returns:
//   1 and sets *start_sample on success;
//   0 when not enough data yet (caller retries / sleeps);
//  -1 on end-of-stream with no remaining full block (a final partial block
//     is emitted zero-padded, then -1 forever).
int iq_stream_next_block(void* h, float* out, int64_t* start_sample) {
  auto* s = static_cast<Stream*>(h);
  Frame f;
  int rc = frame(s, &f);
  if (rc != 1) return rc;
  for (int k = 0; k < 3; ++k) {
    std::memcpy(out, f.ptr[k], f.len[k] * 2 * sizeof(float));
    out += 2 * f.len[k];
  }
  advance(s, start_sample);
  return 1;
}

// Same, but emits int8 quantized pairs for the low-bandwidth device path.
int iq_stream_next_block_i8(void* h, int8_t* out, int64_t* start_sample,
                            float scale) {
  auto* s = static_cast<Stream*>(h);
  Frame f;
  int rc = frame(s, &f);
  if (rc != 1) return rc;
  for (int k = 0; k < 3; ++k) {
    quantize_i8(f.ptr[k], out, f.len[k], scale);
    out += 2 * f.len[k];
  }
  advance(s, start_sample);
  return 1;
}

// Planar int8 framer: one pass from the ring's f32 pairs, where they lie,
// to quantized planar I and Q streams (each out_len >= left+block+right
// bytes, zero-padded past the frame) — the exact layout the Pallas planar
// kernel DMAs, with no interleaved intermediate on the Python side.
int iq_stream_next_block_planar_i8(void* h, int8_t* out_i, int8_t* out_q,
                                   uint64_t out_len, int64_t* start_sample,
                                   float scale) {
  auto* s = static_cast<Stream*>(h);
  if (out_len < s->left + s->block + s->right) return -2;
  Frame f;
  int rc = frame(s, &f);
  if (rc != 1) return rc;
  quantize_frame_planar(f, out_i, out_q, out_len, scale);
  advance(s, start_sample);
  return 1;
}

// AGC variant: per-block gain = target / peak over the FRAMED block
// (halos included), matching the Python path's quantize_i8 semantics
// bit for bit (gain written to *gain_out; full_scale = gain / 127). The
// block is read twice where it lies, for the peak and for the quantize.
int iq_stream_next_block_planar_agc(void* h, int8_t* out_i, int8_t* out_q,
                                    uint64_t out_len, int64_t* start_sample,
                                    float target, float* gain_out) {
  auto* s = static_cast<Stream*>(h);
  if (out_len < s->left + s->block + s->right) return -2;
  Frame f;
  int rc = frame(s, &f);
  if (rc != 1) return rc;
  int32_t bits = 0;
  for (int k = 0; k < 3; ++k) bits = peak_bits(f.ptr[k], 2 * f.len[k], bits);
  float peak;
  std::memcpy(&peak, &bits, sizeof peak);
  if (peak == 0.f) peak = 1.f;
  const float g = target / peak;
  quantize_frame_planar(f, out_i, out_q, out_len, g);
  advance(s, start_sample);
  *gain_out = g;
  return 1;
}

uint64_t iq_stream_available(void* h) {
  return ring_avail(static_cast<Stream*>(h)->ring);
}

// 1 when the next framing call has a block or the end to return: the ring
// holds a whole block's samples (block + right) or the source has ended;
// else 0. A consumer waiting for the source polls this, not the framing
// call, and frames once it reads 1.
int iq_stream_ready(void* h) {
  auto* s = static_cast<Stream*>(h);
  return ring_avail(s->ring) >= s->block + s->right ||
         s->ring.eof.load(std::memory_order_acquire);
}

}  // extern "C"
