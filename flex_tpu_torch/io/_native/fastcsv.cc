// Parallel number-line parser for the 3-line CSV CSR format.
//
// Copy of the JAX package's parser (flex_tpu/io/_native/fastcsv.cc); only
// this header comment differs.  Each of the three lines is one long
// comma-separated run (264M numbers for amazon-scale graphs), so the
// parser splits the line at comma boundaries into per-thread chunks,
// counts elements per chunk, prefix-sums the offsets, and parses every
// chunk in parallel.  NumPy's text readers measure ~16M numbers/s
// (np.loadtxt) / ~40M (np.fromstring); this runs at several hundred M/s
// across threads.
//
// Exposed via ctypes (flex_tpu_torch/io/native.py) with a pure-NumPy
// fallback.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Chunk boundaries: s_0 = 0, every later boundary advanced to just past a
// comma so each chunk holds whole elements.
std::vector<int64_t> chunk_bounds(const char* buf, int64_t len, int nt) {
  std::vector<int64_t> b;
  b.push_back(0);
  for (int t = 1; t < nt; ++t) {
    int64_t p = len * t / nt;
    if (p <= b.back()) continue;
    const void* c = memchr(buf + p, ',', static_cast<size_t>(len - p));
    int64_t q = c ? static_cast<const char*>(c) - buf + 1 : len;
    if (q > b.back() && q < len) b.push_back(q);
  }
  b.push_back(len);
  return b;
}

int64_t count_commas(const char* buf, int64_t lo, int64_t hi) {
  int64_t n = 0;
  const char* p = buf + lo;
  const char* end = buf + hi;
  while ((p = static_cast<const char*>(
              memchr(p, ',', static_cast<size_t>(end - p)))) != nullptr) {
    ++n;
    ++p;
  }
  return n;
}

// Hand-rolled number scanners: glibc strtoll/strtof cost ~240 ns per call
// (locale machinery); these run at ~5-15 ns per number.  Both take the
// cursor by reference and leave it on the first unconsumed byte.
inline int64_t scan_i64(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  // accumulate unsigned: INT64_MIN and out-of-range inputs wrap with
  // defined semantics instead of signed-overflow UB
  uint64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9')
    v = v * 10 + static_cast<uint64_t>(*p++ - '0');
  return static_cast<int64_t>(neg ? 0u - v : v);
}

inline float scan_f32(const char*& p, const char* end) {
  const char* tok = p;
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  // fast path: [digits][.digits][e±digits] with ≤ 17 mantissa digits —
  // double holds that exactly, so float(v * 10^e) is correctly rounded
  // to well within f32 precision.
  // nd counts SIGNIFICANT digits: leading zeros must not consume the
  // 17-digit budget (else 0.0000000000000000123 silently parses as 0)
  uint64_t mant = 0;
  int nd = 0, exp10 = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    any = true;
    if (mant == 0 && *p == '0') { /* leading zero: no-op */ }
    else if (nd < 17) { mant = mant * 10 + (*p - '0'); ++nd; }
    else ++exp10;
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      any = true;
      if (mant == 0 && *p == '0') --exp10;  // leading fractional zero
      else if (nd < 17) { mant = mant * 10 + (*p - '0'); ++nd; --exp10; }
      ++p;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
    int e = 0;
    while (p < end && *p >= '0' && *p <= '9') e = e * 10 + (*p++ - '0');
    exp10 += eneg ? -e : e;
  }
  if (!any && (p >= end || *p == ',')) return 0.0f;  // empty token: 0,
  // matching the i64 path's leniency (the delimiter stays unconsumed)
  if (!any || exp10 > 38 || exp10 < -46) {
    // weird token (inf/nan/huge exponent) — one strtof call
    char* q;
    float v = strtof(tok, &q);
    p = (q > tok) ? q : tok + 1;
    return v;
  }
  double v = static_cast<double>(mant);
  // exact powers of ten up to 1e22 in double; split larger exponents
  static const double P10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,
                               1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
                               1e12, 1e13, 1e14, 1e15, 1e16, 1e17,
                               1e18, 1e19, 1e20, 1e21, 1e22};
  int a = exp10;
  while (a > 22) { v *= 1e22; a -= 22; }
  while (a < -22) { v /= 1e22; a += 22; }
  v = (a >= 0) ? v * P10[a] : v / P10[-a];
  return static_cast<float>(neg ? -v : v);
}

template <class T, class Parse>
int64_t parse_line(const char* buf, int64_t len, T* out, int64_t n,
                   int nthreads, Parse parse) {
  if (len <= 0) return 0;
  int nt = std::max(1, std::min<int>(nthreads, static_cast<int>(
                                         std::min<int64_t>(64, len / 4096 + 1))));
  std::vector<int64_t> b = chunk_bounds(buf, len, nt);
  int nc = static_cast<int>(b.size()) - 1;

  // pass 1: elements per chunk = commas in chunk (+1 for the last chunk's
  // trailing element, which has no comma after it)
  std::vector<int64_t> cnt(nc);
  {
    std::vector<std::thread> th;
    for (int c = 0; c < nc; ++c)
      th.emplace_back([&, c] { cnt[c] = count_commas(buf, b[c], b[c + 1]); });
    for (auto& t : th) t.join();
  }
  cnt[nc - 1] += 1;
  std::vector<int64_t> off(nc + 1, 0);
  for (int c = 0; c < nc; ++c) off[c + 1] = off[c] + cnt[c];
  if (off[nc] > n) return -1;  // caller's buffer too small

  // pass 2: parse each chunk into its slice.  A token whose scan stops
  // before the next comma (e.g. "foo") marks the chunk bad -> the whole
  // parse returns -2 and the Python caller falls back to NumPy's parser
  // (silently emitting 0 for garbage would corrupt the graph).
  std::vector<int64_t> got(nc);
  std::vector<char> bad(nc, 0);
  {
    std::vector<std::thread> th;
    for (int c = 0; c < nc; ++c)
      th.emplace_back([&, c] {
        const char* p = buf + b[c];
        const char* end = buf + b[c + 1];
        T* o = out + off[c];
        int64_t i = 0;
        while (p < end && i < cnt[c]) {
          o[i++] = parse(p, end);
          while (p < end && (*p == ' ' || *p == '\t')) ++p;
          if (p < end && *p == ',') ++p;
          else if (p < end) {  // scan stalled mid-token: malformed input
            bad[c] = 1;
            const void* nx = memchr(p, ',', static_cast<size_t>(end - p));
            p = nx ? static_cast<const char*>(nx) + 1 : end;
          }
        }
        got[c] = i;
      });
    for (auto& t : th) t.join();
  }
  int64_t total = 0;
  bool any_bad = false;
  for (int c = 0; c < nc; ++c) {
    total += got[c];
    any_bad |= bad[c] != 0;
  }
  return (!any_bad && total == off[nc]) ? total : -2;
}

}  // namespace

extern "C" {

int64_t flex_csv_count(const char* buf, int64_t len) {
  if (len <= 0) return 0;
  unsigned hw = std::thread::hardware_concurrency();
  int nt = std::max(1u, std::min(hw ? hw : 1u, 16u));
  std::vector<int64_t> b = chunk_bounds(buf, len, nt);
  int nc = static_cast<int>(b.size()) - 1;
  std::vector<int64_t> cnt(nc);
  std::vector<std::thread> th;
  for (int c = 0; c < nc; ++c)
    th.emplace_back([&, c] { cnt[c] = count_commas(buf, b[c], b[c + 1]); });
  for (auto& t : th) t.join();
  int64_t n = 1;
  for (int c = 0; c < nc; ++c) n += cnt[c];
  return n;
}

int64_t flex_csv_parse_i64(const char* buf, int64_t len, int64_t* out,
                           int64_t n, int nthreads) {
  return parse_line<int64_t>(
      buf, len, out, n, nthreads,
      [](const char*& p, const char* end) { return scan_i64(p, end); });
}

int64_t flex_csv_parse_f32(const char* buf, int64_t len, float* out,
                           int64_t n, int nthreads) {
  return parse_line<float>(
      buf, len, out, n, nthreads,
      [](const char*& p, const char* end) { return scan_f32(p, end); });
}

}  // extern "C"
