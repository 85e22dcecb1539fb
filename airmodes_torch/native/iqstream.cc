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
#include <cmath>
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

// Copy n samples into the ring at head (caller checked free space).
void ring_write(Ring& r, const float* src, uint64_t n) {
  uint64_t h = r.head.load(std::memory_order_relaxed);
  uint64_t idx = h & r.mask();
  uint64_t first = std::min(n, r.capacity - idx);
  std::memcpy(r.data + 2 * idx, src, first * 2 * sizeof(float));
  if (n > first)
    std::memcpy(r.data, src + 2 * first, (n - first) * 2 * sizeof(float));
  r.head.store(h + n, std::memory_order_release);
}

// --- SDR wire-format converters (hot loops, auto-vectorized) ---------------

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

// THE int8 quantization rule, ONE helper for every native quantize loop
// (mirrors dsp/host.py quantize_i8_np: clamp to +-127, half-to-even
// nearbyintf = np.round; four hand-copied bodies used to carry this —
// a drifting copy breaks the cross-path dBFS/bit-exactness contract)
inline int8_t quant_i8(float v) {
  // NaN-safe clamp: comparisons with NaN are all false, so the old
  // ternary form passed NaN through to an undefined int8 cast.
  // NaN quantizes to 0 (a noise sample), +/-inf saturates.
  if (!(v >= -127.f)) return v < 0.f ? -127 : 0;
  if (v > 127.f) return 127;
  return static_cast<int8_t>(std::nearbyintf(v));
}

// f32 pairs -> int8 pairs (quantized device transfer format)
void quantize_i8(const float* in, int8_t* out, uint64_t n_samples,
                 float scale) {
  for (uint64_t i = 0; i < 2 * n_samples; ++i)
    out[i] = quant_i8(in[i] * scale);
}

// Write up to n samples into the ring without drop accounting; returns
// samples taken. The pumps decide the overrun policy themselves: the file
// pump blocks and retries (a file is not real-time — nothing is lost), the
// UDP pump drops the datagram tail and counts it (a real-time source that
// cannot be paused — the reference prints "O" on the equivalent USRP
// overrun, SURVEY.md §5.3).
uint64_t push_f32_take(Stream* s, const float* iq, uint64_t n) {
  uint64_t take = std::min(n, ring_free(s->ring));
  if (take) ring_write(s->ring, iq, take);
  s->real_pushed.fetch_add(take);
  return take;
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

// Push float32 I/Q pairs. Returns samples accepted (may be < n when full);
// the shortfall is counted as dropped (this is the one-shot non-blocking
// API — a caller that does not retry has lost those samples).
uint64_t iq_stream_push_f32(void* h, const float* iq, uint64_t n) {
  auto* s = static_cast<Stream*>(h);
  uint64_t take = push_f32_take(s, iq, n);
  if (take < n) s->ring.dropped.fetch_add(n - take);
  return take;
}

// thread_local std::vector scratch (NOT raw new[]: a raw pointer has no
// thread-exit destructor, so every short-lived worker thread — e.g. the
// multichannel framing pool — would leak its block-sized buffer)
uint64_t iq_stream_push_uc8(void* h, const uint8_t* raw, uint64_t n) {
  static thread_local std::vector<float> buf;
  if (buf.size() < 2 * n) buf.resize(2 * n);
  convert_uc8(raw, buf.data(), n);
  return iq_stream_push_f32(h, buf.data(), n);
}

uint64_t iq_stream_push_sc16(void* h, const int16_t* raw, uint64_t n) {
  static thread_local std::vector<float> buf;
  if (buf.size() < 2 * n) buf.resize(2 * n);
  convert_sc16(raw, buf.data(), n);
  return iq_stream_push_f32(h, buf.data(), n);
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
  // the ONE fused quantize+planar-split loop: the framers below call
  // this too (three hand-copied bodies used to carry it;
  // same consolidation rationale as quantize_i8's comment)
  for (uint64_t i = 0; i < n_samples; ++i) {
    out_i[i] = quant_i8(iq[2 * i] * scale);
    out_q[i] = quant_i8(iq[2 * i + 1] * scale);
  }
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
    uint64_t elem = format == 0 ? 8 : (format == 1 ? 4 : 2);
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
    auto* conv = new float[CHUNK * 2];
    auto t0 = std::chrono::steady_clock::now();
    uint64_t sent = 0;
    uint64_t pend = 0;   // carried partial-element bytes (pipe reads)
    while (!s->stop.load()) {
      uint64_t elem = format == 0 ? 8 : (format == 1 ? 4 : 2);
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
      const float* src;
      if (format == 0) {
        src = reinterpret_cast<const float*>(raw);
      } else if (format == 1) {
        convert_sc16(reinterpret_cast<const int16_t*>(raw), conv, n);
        src = conv;
      } else {
        convert_uc8(raw, conv, n);
        src = conv;
      }
      uint64_t off = 0;
      while (off < n && !s->stop.load()) {
        // blocking retry, NO drop accounting: a file source pauses until
        // the consumer catches up; nothing is ever lost
        uint64_t took = push_f32_take(s, src + 2 * off, n - off);
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
    delete[] conv;
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
      const float* src = reinterpret_cast<const float*>(buf);
      // real-time overrun policy: take what fits, DROP the rest of the
      // datagram and count it (iq_stream_dropped). Blocking here would
      // only move the loss into the kernel socket buffer where it is
      // invisible; the counted ring drop is what --stats surfaces.
      // (Dropped samples vanish from the sample counter, so downstream
      // timestamps compress across an overrun — same loss the reference
      // has on a USRP "O"; the drop counter is the operator's signal.)
      uint64_t took = push_f32_take(s, src, samples);
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
    ring_write(s->ring, zeros.data(), std::min(pad, ring_free(s->ring)));
    if (ring_avail(s->ring) < need) return 0;  // ring too small (shouldn't happen)
  }
  std::memcpy(out, s->carry, 2 * s->left * sizeof(float));
  // peek block+right without consuming right (it belongs to the next
  // block) — two memcpy spans at the wrap point, not an elementwise
  // masked loop (this is the per-block hot copy of the consumer thread)
  uint64_t t = s->ring.tail.load(std::memory_order_relaxed);
  uint64_t cap = s->ring.capacity;
  {
    uint64_t idx = t & s->ring.mask();
    uint64_t first = std::min(need, cap - idx);
    std::memcpy(out + 2 * s->left, s->ring.data + 2 * idx,
                first * 2 * sizeof(float));
    if (need > first)
      std::memcpy(out + 2 * (s->left + first), s->ring.data,
                  (need - first) * 2 * sizeof(float));
  }
  // carry = last `left` samples of the owned block
  for (uint64_t i = 0; i < s->left; ++i) {
    uint64_t idx = (t + s->block - s->left + i) & s->ring.mask();
    s->carry[2 * i] = s->ring.data[2 * idx];
    s->carry[2 * i + 1] = s->ring.data[2 * idx + 1];
  }
  s->ring.tail.store(t + s->block, std::memory_order_release);
  *start_sample = static_cast<int64_t>(s->next_start);
  s->next_start += s->block;
  return 1;
}

// Same, but emits int8 quantized pairs for the low-bandwidth device path.
int iq_stream_next_block_i8(void* h, int8_t* out, int64_t* start_sample,
                            float scale) {
  auto* s = static_cast<Stream*>(h);
  const uint64_t total = s->left + s->block + s->right;
  static thread_local std::vector<float> buf;
  if (buf.size() < 2 * total) buf.resize(2 * total);
  int rc = iq_stream_next_block(h, buf.data(), start_sample);
  if (rc == 1) quantize_i8(buf.data(), out, total, scale);
  return rc;
}

// Planar int8 framer: one fused pass ring-f32 -> quantized planar I and Q
// streams (each out_len >= left+block+right bytes, zero-padded past the
// frame) — the exact layout the Pallas planar kernel DMAs, with no
// interleaved intermediate on the Python side.
int iq_stream_next_block_planar_i8(void* h, int8_t* out_i, int8_t* out_q,
                                   uint64_t out_len, int64_t* start_sample,
                                   float scale) {
  auto* s = static_cast<Stream*>(h);
  const uint64_t total = s->left + s->block + s->right;
  if (out_len < total) return -2;
  static thread_local std::vector<float> bufv;
  if (bufv.size() < 2 * total) bufv.resize(2 * total);
  float* buf = bufv.data();
  int rc = iq_stream_next_block(h, buf, start_sample);
  if (rc != 1) return rc;
  iq_quantize_planar_i8(buf, out_i, out_q, total, scale);
  std::memset(out_i + total, 0, out_len - total);
  std::memset(out_q + total, 0, out_len - total);
  return 1;
}

// AGC variant: per-block gain = target / peak over the FRAMED block
// (halos included), matching the Python path's quantize_i8 semantics
// bit for bit (gain written to *gain_out; full_scale = gain / 127).
int iq_stream_next_block_planar_agc(void* h, int8_t* out_i, int8_t* out_q,
                                    uint64_t out_len, int64_t* start_sample,
                                    float target, float* gain_out) {
  auto* s = static_cast<Stream*>(h);
  const uint64_t total = s->left + s->block + s->right;
  if (out_len < total) return -2;
  static thread_local std::vector<float> bufv;
  if (bufv.size() < 2 * total) bufv.resize(2 * total);
  float* buf = bufv.data();
  int rc = iq_stream_next_block(h, buf, start_sample);
  if (rc != 1) return rc;
  float peak = 0.f;
  for (uint64_t i = 0; i < 2 * total; ++i) {
    float a = buf[i] < 0 ? -buf[i] : buf[i];
    // finite-only: one corrupt Inf sample otherwise drives gain to 0
    // and the whole block quantizes to silence with no error;
    // NaN already fails the > compare
    if (a > peak && a <= 3.4e38f) peak = a;
  }
  if (peak == 0.f) peak = 1.f;
  const float g = target / peak;
  iq_quantize_planar_i8(buf, out_i, out_q, total, g);
  std::memset(out_i + total, 0, out_len - total);
  std::memset(out_q + total, 0, out_len - total);
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
