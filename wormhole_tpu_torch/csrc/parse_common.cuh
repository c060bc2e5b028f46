// What the parse kernels share, written by hand for Hopper (sm_90a):
// parse.cu (libsvm) and formats.cu (criteo, adfea) include it, and each
// builds into a library of its own.
//
// Byte classes: the kernels take printable ASCII, ' ', '\t', '\r' and
// '\n' (in_alphabet); a token is a run of other bytes than those four
// (is_sep), and '\r' and '\n' end lines (is_nl), for libsvm and adfea
// alike.
//
// Numbers: every token is converted on the card, none on the host.
//   - The grammar is float()'s and int()'s for ASCII text: an optional
//     sign; digits with single '_' between two digits (PEP 515); for a
//     float a point, an exponent, or inf, infinity, nan in any case. A
//     token outside it, and a key below 0 or at or above 2^64, is marked
//     bad, and the wrapper raises ValueError naming it, where the plain
//     parser raises.
//   - A key is accumulated in uint64 with an overflow check.
//   - A decimal whose significand M (its digits, trailing zeros moved to
//     the exponent) is below 2^53 and whose decimal exponent e satisfies
//     |e| <= 22 is double(M) * 10^e or double(M) / 10^-e: both operands
//     are exact doubles, so this one IEEE operation (built with
//     -fmad=false) is the correctly rounded double that float() gives
//     (Clinger's fast path).
//   - Any other decimal (more digits, a larger exponent) takes the exact
//     path, dec_to_double: the decimal multiple-precision conversion of
//     Go's strconv (decimal.go, floatBits), 800 digits and a flag for
//     nonzero digits dropped past them, which rounds to nearest-even as
//     float() does, to inf past the largest double and to 0 below the
//     least. It costs some thousand operations a token, and holds an
//     801-byte digit buffer in local memory.
//   - The f32 is the double's round to nearest (np.float32(float(tok)));
//     nan is written as numpy's: 0x7fc00000 with the token's sign.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// stats[] slots (int32) of every parse kernel
constexpr int kErr = 0;    // first byte outside the alphabet (unsigned; ~0 = none)
constexpr int kNe1 = 1;    // libsvm: 1 if some "k:v" value != 1.0
constexpr int kBad = 2;    // tokens the plain parser refuses
constexpr int kTokens = 3;  // tokens (criteo: cells)
constexpr int kLines = 4;   // lines with a token (criteo: line breaks + 1)
constexpr int kRows = 5;
constexpr int kFeats = 6;
constexpr int kExact = 7;  // decimals converted by the exact path
constexpr int kBadAt = 8;  // first refused token's offset (unsigned; ~0 = none)
constexpr int kStats = 9;

// ------------------------------------------------------------- numbers
__constant__ double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

constexpr uint64_t kTwo53 = uint64_t{1} << 53;
// exponents saturate here; a token (< 2^30 bytes) moves the point less
constexpr int kExpCap = 100000000;

__device__ __forceinline__ bool is_digit(uint8_t c) {
  return c >= '0' && c <= '9';
}

// The end of the digit run at p[i..len) with single '_' between digits
// (PEP 515): the index after its last digit, i if p[i] is no digit, or
// -1 where a '_' is not between two digits.
__device__ int digit_run_end(const uint8_t* p, int i, int len) {
  if (i >= len || !is_digit(p[i])) return i;
  while (true) {
    ++i;
    if (i < len && p[i] == '_') {
      if (i + 1 >= len || !is_digit(p[i + 1])) return -1;
      ++i;
    } else if (i >= len || !is_digit(p[i])) {
      return i;
    }
  }
}

// Whether p[0..len) is `word` (lower case) in any case.
__device__ bool is_word(const uint8_t* p, int len, const char* word) {
  int i = 0;
  for (; word[i] != 0; ++i) {
    if (i >= len || (p[i] | 0x20) != word[i]) return false;
  }
  return i == len;
}

// Go strconv's decimal: value = 0.d[0] d[1] ... d[nd-1] * 10^dp, digits
// as values 0-9, d[0] != 0 unless nd == 0.
constexpr int kDecCap = 800;
constexpr int kMaxShift = 60;

struct Decimal {
  uint8_t d[kDecCap + 1];
  int nd;
  int dp;
  bool trunc;  // nonzero digits were dropped past kDecCap
};

__device__ void dec_trim(Decimal* a) {
  while (a->nd > 0 && a->d[a->nd - 1] == 0) --a->nd;
  if (a->nd == 0) a->dp = 0;
}

// a /= 2^k, 0 < k <= kMaxShift (decimal.go rightShift)
__device__ void dec_right_shift(Decimal* a, int k) {
  int r = 0, w = 0;
  uint64_t n = 0;
  for (; (n >> k) == 0; ++r) {
    if (r >= a->nd) {
      if (n == 0) {
        a->nd = 0;
        return;
      }
      while ((n >> k) == 0) {
        n *= 10;
        ++r;
      }
      break;
    }
    n = n * 10 + a->d[r];
  }
  a->dp -= r - 1;
  const uint64_t mask = (uint64_t{1} << k) - 1;
  for (; r < a->nd; ++r) {
    const uint64_t c = a->d[r];
    a->d[w++] = static_cast<uint8_t>(n >> k);
    n = (n & mask) * 10 + c;
  }
  while (n > 0) {
    const uint64_t dig = n >> k;
    n &= mask;
    if (w < kDecCap) {
      a->d[w++] = static_cast<uint8_t>(dig);
    } else if (dig > 0) {
      a->trunc = true;
    }
    n *= 10;
  }
  a->nd = w;
  dec_trim(a);
}

// a *= 2^k, 0 < k <= kMaxShift (decimal.go leftShift). The product has
// D or D - 1 more digits, D those of 2^k: the digits are written as if D
// (index kDecCap is the spare place), and moved down one place where the
// top one stayed empty.
__device__ void dec_left_shift(Decimal* a, int k) {
  int D = 0;
  for (uint64_t p = uint64_t{1} << k; p > 0; p /= 10) ++D;
  int w = a->nd + D;
  uint64_t n = 0;
  for (int r = a->nd - 1; r >= 0 || n > 0; --r) {
    if (r >= 0) n += static_cast<uint64_t>(a->d[r]) << k;
    const uint64_t quo = n / 10, rem = n - 10 * quo;
    --w;
    if (w <= kDecCap) {
      a->d[w] = static_cast<uint8_t>(rem);
    } else if (rem != 0) {
      a->trunc = true;
    }
    n = quo;
  }
  int nd = a->nd + D - w;  // w is 0 or 1
  if (w == 1) {
    const int top = min(nd, kDecCap);
    for (int i = 0; i < top; ++i) a->d[i] = a->d[i + 1];
  } else if (nd > kDecCap && a->d[kDecCap] != 0) {
    a->trunc = true;
  }
  a->dp += nd - a->nd;
  a->nd = min(nd, kDecCap);
  dec_trim(a);
}

__device__ void dec_shift(Decimal* a, int k) {
  if (a->nd == 0) return;
  for (; k > kMaxShift; k -= kMaxShift) dec_left_shift(a, kMaxShift);
  for (; k < -kMaxShift; k += kMaxShift) dec_right_shift(a, kMaxShift);
  if (k > 0) dec_left_shift(a, k);
  if (k < 0) dec_right_shift(a, -k);
}

// Whether a rounded at digit nd goes up (decimal.go shouldRoundUp).
__device__ bool dec_round_up(const Decimal* a, int nd) {
  if (nd < 0 || nd >= a->nd) return false;
  if (a->d[nd] == 5 && nd + 1 == a->nd) {  // exactly halfway: to even
    if (a->trunc) return true;
    return nd > 0 && (a->d[nd - 1] & 1);
  }
  return a->d[nd] >= 5;
}

__device__ uint64_t dec_rounded_integer(const Decimal* a) {
  if (a->dp > 20) return ~uint64_t{0};
  uint64_t n = 0;
  int i = 0;
  for (; i < a->dp && i < a->nd; ++i) n = n * 10 + a->d[i];
  for (; i < a->dp; ++i) n *= 10;
  if (dec_round_up(a, a->dp)) ++n;
  return n;
}

// The bits of the double nearest a (ties to even), positive
// (decimal.go floatBits for float64: 52 mantissa bits, 11 exponent bits,
// bias -1023).
__device__ uint64_t dec_to_double(Decimal* a) {
  constexpr int kMant = 52, kBias = -1023, kExpMax = (1 << 11) - 1;
  constexpr uint64_t kInf = uint64_t{kExpMax} << kMant;
  constexpr int kPowTab[9] = {1, 3, 6, 9, 13, 16, 19, 23, 26};
  if (a->nd == 0 || a->dp < -330) return 0;
  if (a->dp > 310) return kInf;
  int exp = 0;
  while (a->dp > 0) {
    const int n = a->dp >= 9 ? 27 : kPowTab[a->dp];
    dec_shift(a, -n);
    exp += n;
  }
  while (a->dp < 0 || (a->dp == 0 && a->d[0] < 5)) {
    const int n = -a->dp >= 9 ? 27 : kPowTab[-a->dp];
    dec_shift(a, n);
    exp -= n;
  }
  --exp;  // [0.5, 1) -> [1, 2)
  if (exp < kBias + 1) {
    const int n = kBias + 1 - exp;
    dec_shift(a, -n);
    exp += n;
  }
  if (exp - kBias >= kExpMax) return kInf;
  dec_shift(a, 1 + kMant);
  uint64_t mant = dec_rounded_integer(a);
  if (mant == uint64_t{2} << kMant) {
    mant >>= 1;
    ++exp;
    if (exp - kBias >= kExpMax) return kInf;
  }
  if ((mant & (uint64_t{1} << kMant)) == 0) exp = kBias;  // subnormal
  return (mant & ((uint64_t{1} << kMant) - 1)) |
         (static_cast<uint64_t>((exp - kBias) & kExpMax) << kMant);
}

// The exact path: the decimal of a token already checked against the
// grammar (digits, '_', an optional point, an optional exponent, no sign)
// into a Decimal, as decimal.go set() reads it (but with the point placed
// by every digit read, not only the kept ones), and its double's bits.
__device__ __noinline__ uint64_t exact_decimal(const uint8_t* p, int len) {
  Decimal a;
  a.nd = 0;
  a.dp = 0;
  a.trunc = false;
  bool point = false;
  int seen = 0;  // digits from the first nonzero one, kept or not
  int i = 0;
  for (; i < len; ++i) {
    const uint8_t c = p[i];
    if (c == '_') continue;
    if (c == '.') {
      point = true;
      a.dp = seen;
      continue;
    }
    if (!is_digit(c)) break;
    if (c == '0' && a.nd == 0) {  // leading zeros
      --a.dp;
      continue;
    }
    ++seen;
    if (a.nd < kDecCap) {
      a.d[a.nd++] = c - '0';
    } else if (c != '0') {
      a.trunc = true;
    }
  }
  if (!point) a.dp = seen;
  if (i < len) {  // (e|E)[+-]digits
    ++i;
    int sign = 1;
    if (p[i] == '+' || p[i] == '-') sign = p[i++] == '-' ? -1 : 1;
    int e = 0;
    for (; i < len; ++i) {
      if (p[i] != '_' && e < kExpCap) e = e * 10 + (p[i] - '0');
    }
    a.dp += sign * e;
  }
  return dec_to_double(&a);
}

enum Conv { kConvBad = 0, kConvFast = 1, kConvExact = 2 };

// A float() token: its double (for the != 1.0 test) and its f32 bits.
__device__ Conv parse_float(const uint8_t* p, int len, double* out,
                            uint32_t* f32) {
  int i = 0;
  bool neg = false;
  if (i < len && (p[i] == '+' || p[i] == '-')) {
    neg = p[i] == '-';
    ++i;
  }
  const uint8_t* q = p + i;
  const int ql = len - i;
  if (is_word(q, ql, "inf") || is_word(q, ql, "infinity")) {
    *out = neg ? -__longlong_as_double(0x7ff0000000000000ll)
               : __longlong_as_double(0x7ff0000000000000ll);
    *f32 = (neg ? 0x80000000u : 0u) | 0x7f800000u;
    return kConvFast;
  }
  if (is_word(q, ql, "nan")) {
    *out = __longlong_as_double(0x7ff8000000000000ll);
    *f32 = (neg ? 0x80000000u : 0u) | 0x7fc00000u;
    return kConvFast;
  }
  // grammar: (digits ('.' digits?)? | '.' digits) ((e|E) [+-]? digits)?
  const int int_end = digit_run_end(p, i, len);
  if (int_end < 0) return kConvBad;
  int frac_beg = int_end, frac_end = int_end;
  if (int_end < len && p[int_end] == '.') {
    frac_beg = int_end + 1;
    frac_end = digit_run_end(p, frac_beg, len);
    if (frac_end < 0) return kConvBad;
  }
  if (int_end == i && frac_end == frac_beg) return kConvBad;  // no digits
  int j = frac_end, e = 0;
  if (j < len && (p[j] == 'e' || p[j] == 'E')) {
    ++j;
    bool eneg = false;
    if (j < len && (p[j] == '+' || p[j] == '-')) {
      eneg = p[j] == '-';
      ++j;
    }
    const int e_end = digit_run_end(p, j, len);
    if (e_end <= j) return kConvBad;
    for (; j < e_end; ++j) {
      if (p[j] != '_' && e < kExpCap) e = e * 10 + (p[j] - '0');
    }
    if (eneg) e = -e;
  }
  if (j != len) return kConvBad;
  // the fast path: M below 2^53, its trailing zeros held back in `zeros`
  uint64_t m = 0;
  int64_t zeros = 0, frac = 0;
  bool fits = true;
  for (int k = i; k < frac_end && fits; ++k) {
    const uint8_t c = p[k];
    if (c == '_' || c == '.') continue;
    if (k >= frac_beg) ++frac;
    if (c == '0') {
      zeros += m != 0;
      continue;
    }
    for (int64_t z = 0; z <= zeros && fits; ++z) {
      fits = m < kTwo53;
      m *= 10;
    }
    zeros = 0;
    m += c - '0';
  }
  int64_t e10 = e - frac + zeros;
  if (fits && m == 0) {
    *out = neg ? -0.0 : 0.0;
    *f32 = neg ? 0x80000000u : 0u;
    return kConvFast;
  }
  for (; fits && e10 > 22 && m * 10 < kTwo53; --e10) m *= 10;
  if (fits && m < kTwo53 && e10 >= -22 && e10 <= 22) {
    const double v = static_cast<double>(m);
    const double r = e10 >= 0 ? v * kPow10[e10] : v / kPow10[-e10];
    *out = neg ? -r : r;
    *f32 = __float_as_uint(__double2float_rn(*out));
    return kConvFast;
  }
  const double r = __longlong_as_double(
      static_cast<long long>(exact_decimal(p + i, len - i)));
  *out = neg ? -r : r;
  *f32 = __float_as_uint(__double2float_rn(*out));
  return kConvExact;
}

// An int() key in [0, 2^64): [+-] digits with '_' between digits.
__device__ bool parse_key(const uint8_t* p, int len, uint64_t* out) {
  int i = 0;
  bool neg = false;
  if (i < len && (p[i] == '+' || p[i] == '-')) {
    neg = p[i] == '-';
    ++i;
  }
  const int end = digit_run_end(p, i, len);
  if (end != len || end == i) return false;
  uint64_t k = 0;
  for (; i < len; ++i) {
    if (p[i] == '_') continue;
    const uint64_t d = p[i] - '0';
    if (k > (~uint64_t{0} - d) / 10) return false;
    k = k * 10 + d;
  }
  if (neg && k != 0) return false;
  *out = k;
  return true;
}

// ---------------------------------------------------------- byte classes
__device__ __forceinline__ bool is_sep(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

__device__ __forceinline__ bool is_nl(uint8_t c) {
  return c == '\n' || c == '\r';
}

__device__ __forceinline__ bool in_alphabet(uint8_t c) {
  return (c >= 0x20 && c <= 0x7e) || c == '\t' || c == '\n' || c == '\r';
}

}  // namespace
