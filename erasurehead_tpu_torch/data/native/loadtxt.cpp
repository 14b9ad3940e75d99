// Fast parser for the reference's whitespace-text matrix format
// (src/util.py:13-15, 26-36: dense .dat files written row-per-line and
// read back with np.loadtxt): the port's copy of
// erasurehead_tpu/data/native/loadtxt.cpp. A single-pass std::from_chars
// scan instead of np.loadtxt's tokenizer; chip_smoke.py's `native` phase
// times both on the same file (PERF.md).
//
// Exposed C ABI (ctypes, see data/native/__init__.py):
//   eh_parse_alloc(path, &n_vals, &n_rows): single-pass parse into a
//     malloc'd buffer (nullptr on error; code in n_vals: -1 io, -2 token).
//   eh_free(buf): release that buffer.
//
// Single malloc'd read of the whole file, then one from_chars pass. Matches
// np.loadtxt semantics for well-formed numeric matrices (incl. exponents,
// +/-inf, nan); ragged or non-numeric files report an error and the Python
// caller falls back to np.loadtxt.

#include <cctype>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

char* read_all(const char* path, long* len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(n + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  long got = static_cast<long>(std::fread(buf, 1, n, f));
  std::fclose(f);
  if (got != n) {
    std::free(buf);
    return nullptr;
  }
  buf[n] = '\0';
  *len = n;
  return buf;
}

}  // namespace

extern "C" {

// Single-pass parse: returns a malloc'd value buffer (caller frees with
// eh_free), sets *n_vals and *n_rows. nullptr on error with the code in
// *n_vals (-1 io, -2 bad token). Rows = lines containing >= 1 token.
double* eh_parse_alloc(const char* path, long* n_vals, long* n_rows) {
  long len = 0;
  char* buf = read_all(path, &len);
  *n_vals = -1;
  *n_rows = 0;
  if (!buf) return nullptr;
  long cap = 1024;
  long n = 0, rows = 0;
  double* out = static_cast<double*>(std::malloc(cap * sizeof(double)));
  if (!out) {
    std::free(buf);
    return nullptr;
  }
  const char* p = buf;
  const char* end = buf + len;
  bool line_has_token = false;
  while (true) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) {
      if (*p == '\n' && line_has_token) {
        ++rows;
        line_has_token = false;
      }
      ++p;
    }
    if (p >= end) break;
    double v;
    auto res = std::from_chars(p, end, v);
    const char* q = res.ptr;
    if (res.ec != std::errc() || q == p) {
      char* q2 = nullptr;
      v = std::strtod(p, &q2);
      if (q2 == p) {
        std::free(buf);
        std::free(out);
        *n_vals = -2;
        return nullptr;
      }
      q = q2;
    }
    if (n >= cap) {
      cap *= 2;
      double* grown =
          static_cast<double*>(std::realloc(out, cap * sizeof(double)));
      if (!grown) {
        std::free(buf);
        std::free(out);
        return nullptr;
      }
      out = grown;
    }
    out[n++] = v;
    line_has_token = true;
    p = q;
  }
  if (line_has_token) ++rows;  // final line without trailing newline
  std::free(buf);
  *n_vals = n;
  *n_rows = rows;
  return out;
}

void eh_free(double* p) { std::free(p); }

}  // extern "C"
