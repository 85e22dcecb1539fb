// Wire lines of one block's packed detection table, in one native pass.
//
// The native form of `dsp/host.table_to_messages(dsp/pipeline.unpack_table(
// row), start, rate, epoch, full_scale)`: `row` is a block's (K+1, 9) int32
// table as `pack_table` lays it out, and the lines come out byte for byte as
// that rule writes them, separated by '\n':
//
//     "<df> <hex_frame> <syndrome_hex6> <status> <ref_dbfs> <t> <t_ns>"
//
// Slots with index < 0 are skipped and the others taken in index order,
// ties in table order (numpy's stable argsort); STATUS_FAIL slots are
// counted and dropped. The hex digits are the frame words themselves: each
// 28-bit word is 7 digits, a 56-bit frame the first two. The level goes
// through the C library's log10, as Python's does. The two fixed-point
// fields are the exact binary value rounded half to even, as printf and
// Python write them (`put_fixed`); "nan" and "inf" are spelled as Python
// spells them (never "-nan").
//
// No expression here has the form a * b + c, so no FMA contraction can
// change a value against Python's separate roundings.
//
// C ABI only; bound from Python with ctypes (native/__init__.py), called
// holding the GIL: it touches no Python object, and is shorter than the
// wait to take the interpreter back from other threads.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCols = 9;                 // pipeline.PACKED_COLS
constexpr int32_t kStatusFail = 4;       // constants.STATUS_FAIL
constexpr int64_t kExact = int64_t(1) << 53;   // samples a double holds
constexpr int kLineMax = 128;            // a line is at most ~100 bytes

char* put_hex(char* p, uint32_t v, int digits) {
  static const char kDigits[] = "0123456789abcdef";
  for (int i = digits - 1; i >= 0; --i) {
    p[i] = kDigits[v & 15];
    v >>= 4;
  }
  return p + digits;
}

char* put_int(char* p, int64_t v) {   // v > INT64_MIN
  char tmp[24];
  int n = 0;
  uint64_t u = v < 0 ? 0 - uint64_t(v) : uint64_t(v);
  do {
    tmp[n++] = char('0' + u % 10);
    u /= 10;
  } while (u);
  if (v < 0) *p++ = '-';
  while (n) *p++ = tmp[--n];
  return p;
}

// "%.<prec>f" of x, scale = 10^prec <= 10^9, written as printf and Python
// write it: the exact binary value rounded half to even at the last digit.
// false (nothing written) where x is not finite or |x| * scale reaches
// 2^64.
bool put_fixed(char*& p, double x, int prec, uint64_t scale) {
  if (!std::isfinite(x)) return false;
  int e;
  double m = std::frexp(std::fabs(x), &e);          // |x| = m * 2^e
  uint64_t mant = uint64_t(std::ldexp(m, 53));      // exact, < 2^53
  int sh = e - 53;                                  // |x| = mant * 2^sh
  unsigned __int128 num = (unsigned __int128)mant * scale;   // < 2^83
  unsigned __int128 n;
  if (sh >= 0) {
    if (sh > 11) return false;
    n = num << sh;
  } else if (-sh >= 100) {
    n = 0;                                          // below half a unit
  } else {
    int r = -sh;
    n = num >> r;
    unsigned __int128 rem = num - (n << r);
    unsigned __int128 half = (unsigned __int128)1 << (r - 1);
    if (rem > half || (rem == half && (n & 1))) ++n;
  }
  if (n >> 64) return false;
  if (std::signbit(x)) *p++ = '-';
  uint64_t whole = uint64_t(n) / scale, frac = uint64_t(n) % scale;
  p = put_int(p, int64_t(whole));
  *p++ = '.';
  for (int i = prec - 1; i >= 0; --i) {
    p[i] = char('0' + frac % 10);
    frac /= 10;
  }
  p += prec;
  return true;
}

// Python's a // b on integers (the quotient rounded toward -inf)
__int128 floor_div(__int128 a, __int128 b) {
  __int128 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

bool fits_i64(__int128 v) {
  return v >= INT64_MIN && v <= INT64_MAX;
}

// One emitted slot's line into `line`; its length, or -1 where the Python
// rule must take the row (a width it does not know, a value past what this
// pass holds exactly, or one the rule raises on).
int format_line(const int32_t* r, int64_t start, double rate, bool integral,
                int64_t irate, double epoch, int64_t epoch_ns, double fs2,
                char* line) {
  int32_t meta = r[1];
  int32_t nbits = (meta >> 8) & 0xFF;
  if (nbits != 56 && nbits != 112) return -1;
  int64_t samples = start + int64_t(r[0]);
  if (samples > kExact || samples < -kExact) return -1;

  __int128 ns;
  if (integral) {
    ns = __int128(epoch_ns) +
         floor_div(__int128(samples) * 1000000000, irate);
  } else {
    double x = double(samples) * 1e9 / rate;
    if (!(std::fabs(x) < 0x1p63)) return -1;
    ns = __int128(epoch_ns) + int64_t(std::nearbyint(x));  // half to even
  }
  if (!fits_i64(ns)) return -1;

  float ref_f;
  std::memcpy(&ref_f, &r[3], sizeof ref_f);
  double ref = ref_f;
  double v = (1e-30 > ref) ? 1e-30 : ref;    // Python's max(ref, 1e-30)
  double q = v / fs2;
  if (q == 0.0) return -1;                  // math.log10 raises there

  char* p = line;
  int32_t df = meta & 0xFF;
  p = put_int(p, df == 0xFF ? -1 : std::min(df, 24));
  *p++ = ' ';
  for (int w = 0; w < nbits / 28; ++w)
    p = put_hex(p, uint32_t(r[5 + w]) & 0x0FFFFFFF, 7);
  *p++ = ' ';
  p = put_hex(p, uint32_t(r[2]) & 0xFFFFFF, 6);
  *p++ = ' ';
  p = put_int(p, meta >> 16);
  *p++ = ' ';
  double dbfs = 10.0 * std::log10(q);     // finite, +inf or NaN
  if (std::isnan(dbfs)) {
    std::memcpy(p, "nan", 3);
    p += 3;
  } else if (std::isinf(dbfs)) {
    std::memcpy(p, "inf", 3);
    p += 3;
  } else {
    put_fixed(p, dbfs, 2, 100);             // |dbfs| < 3300
  }
  *p++ = ' ';
  if (!put_fixed(p, epoch + double(samples) / rate, 9, 1000000000))
    return -1;
  *p++ = ' ';
  p = put_int(p, int64_t(ns));
  return int(p - line);
}

}  // namespace

extern "C" {

// Wire lines of the k slots at `row` (row k is the tail) into `out` (cap
// bytes); returns the bytes written, or -1 where the Python rule must take
// the row. counts[0..5] receive the row's preambles, overflow, crc_ok,
// corrected, emitted and crc_fail (BlockStats). rate and fs2 (full scale
// squared) must be finite and > 0, rate below 2^62.
int64_t wire_lines(const int32_t* row, int64_t k, int64_t start, double rate,
                   double epoch, int64_t epoch_ns, double fs2, char* out,
                   int64_t cap, int64_t* counts) {
  if (!(rate > 0.0 && rate < 0x1p62) || !(fs2 > 0.0) || std::isinf(fs2))
    return -1;
  bool integral = std::trunc(rate) == rate;
  int64_t irate = integral ? int64_t(rate) : 0;

  std::vector<int32_t> order;
  order.reserve(size_t(k));
  int64_t crc_fail = 0;
  for (int64_t s = 0; s < k; ++s) {
    const int32_t* r = row + s * kCols;
    if (r[0] < 0) continue;
    if ((r[1] >> 16) == kStatusFail) {
      ++crc_fail;
      continue;
    }
    order.push_back(int32_t(s));
  }
  std::stable_sort(order.begin(), order.end(), [row](int32_t a, int32_t b) {
    return row[a * kCols] < row[b * kCols];
  });

  int64_t used = 0, crc_ok = 0, corrected = 0;
  char line[kLineMax];
  for (int32_t s : order) {
    const int32_t* r = row + int64_t(s) * kCols;
    int n = format_line(r, start, rate, integral, irate, epoch, epoch_ns,
                        fs2, line);
    if (n < 0) return -1;
    int64_t sep = used ? 1 : 0;
    if (used + sep + n > cap) return -1;
    if (sep) out[used++] = '\n';
    std::memcpy(out + used, line, size_t(n));
    used += n;
    int32_t status = r[1] >> 16;
    if (status == 0) ++crc_ok;
    else if (status == 1 || status == 2) ++corrected;
  }
  const int32_t* tail = row + k * kCols;
  counts[0] = tail[0];
  counts[1] = tail[1];
  counts[2] = crc_ok;
  counts[3] = corrected;
  counts[4] = int64_t(order.size());
  counts[5] = crc_fail;
  return used;
}

}  // extern "C"
