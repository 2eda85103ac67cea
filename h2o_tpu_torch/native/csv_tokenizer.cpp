// csv_tokenizer — native CSV hot loop of the port's parse (h2o_tpu_torch).
//
// Reference: the byte-level tokenizer the JVM runs per 4 MiB chunk inside
// MultiFileParseTask (water/parser/CsvParser.java, ParseDataset.java:623;
// SURVEY §3.2 "Hot loop: byte-level CSV tokenizer").  That loop is the
// parse bottleneck, so it stays native here too: C++ with std::thread
// chunk parallelism standing in for the per-chunk MRTask fan-out.
//
// Contract (mirrors the two-pass reference design):
//   pass 1  csv_index_lines : QUOTE-AWARE newline index — a newline inside
//                             an open RFC-4180 quoted field is data, not a
//                             row boundary.  Chunk-parallel: per-chunk
//                             quote counts give each chunk its starting
//                             parity, then boundaries are collected only
//                             at even parity.
//   pass 2  csv_parse       : per-row tokenize; numeric columns parse
//                             straight to double (caller-supplied NA
//                             strings -> NaN); non-numeric columns emit
//                             (offset, length, was_quoted) token spans so
//                             Python can build domains zero-copy from the
//                             original buffer.
//
// Quoting: RFC-4180; outer quotes are stripped from spans; doubled ""
// inside quoted fields is left in the span (Python unescapes).  Exposed
// with a plain C ABI for ctypes.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// fast strtod over a bounded, non-NUL-terminated span
inline bool parse_double(const char* p, long len, double* out) {
  while (len > 0 && (*p == ' ' || *p == '\t')) { ++p; --len; }
  while (len > 0 && (p[len-1] == ' ' || p[len-1] == '\t')) --len;
  if (len == 0 || len > 63) { return false; }
  char tmp[64];
  std::memcpy(tmp, p, static_cast<size_t>(len));
  tmp[len] = '\0';
  char* end = nullptr;
  double v = std::strtod(tmp, &end);
  if (end != tmp + len) return false;
  *out = v;
  return true;
}

struct NaSet {
  const char* blob;           // concatenated NA strings
  const int* offs;            // n+1 offsets into blob
  int n;
  bool contains(const char* p, long len) const {
    for (int i = 0; i < n; ++i) {
      long l = offs[i + 1] - offs[i];
      if (l == len && std::memcmp(blob + offs[i], p, (size_t)len) == 0)
        return true;
    }
    return false;
  }
};

struct Span { long off; int len; unsigned char quoted; };

// tokenize one line into at most ncols spans; returns tokens found
inline int tokenize_line(const char* buf, long start, long end, char sep,
                         int ncols, Span* spans) {
  int col = 0;
  long i = start;
  while (col < ncols) {
    long tok_start = i;
    long tok_end;
    unsigned char quoted = 0;
    if (i < end && buf[i] == '"') {              // quoted field
      quoted = 1;
      ++i;
      tok_start = i;
      while (i < end) {
        if (buf[i] == '"') {
          if (i + 1 < end && buf[i+1] == '"') { i += 2; continue; }
          break;
        }
        ++i;
      }
      tok_end = i;                               // excl. closing quote
      if (i < end) ++i;                          // skip closing quote
      while (i < end && buf[i] != sep) ++i;      // junk till separator
    } else {
      while (i < end && buf[i] != sep) ++i;
      tok_end = i;
      // trim CR (line ends exclude \n already)
      while (tok_end > tok_start && buf[tok_end-1] == '\r') --tok_end;
    }
    spans[col].off = tok_start;
    spans[col].len = static_cast<int>(tok_end - tok_start);
    spans[col].quoted = quoted;
    ++col;
    if (i >= end) break;
    ++i;                                         // skip separator
  }
  for (int c = col; c < ncols; ++c) {
    spans[c].off = 0; spans[c].len = 0; spans[c].quoted = 0;
  }
  return col;
}

}  // namespace

extern "C" {

// Pass 1: find line start offsets, ignoring newlines inside quoted fields.
// Returns nrows; fills offsets[] (caller allocates capacity max_rows+1;
// offsets[nrows] = buffer end sentinel).
long csv_index_lines(const char* buf, long n, long* offsets,
                     long max_rows, int nthreads) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  long chunk = (n + nthreads - 1) / nthreads;
  // phase A: quote count per chunk -> chunk-start parity
  std::vector<long> qcount(static_cast<size_t>(nthreads), 0);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t]() {
        long lo = t * chunk, hi = std::min(n, lo + chunk);
        long q = 0;
        for (long i = lo; i < hi; ++i)
          if (buf[i] == '"') ++q;
        qcount[static_cast<size_t>(t)] = q;
      });
    }
    for (auto& th : ts) th.join();
  }
  std::vector<int> start_parity(static_cast<size_t>(nthreads), 0);
  long acc = 0;
  for (int t = 0; t < nthreads; ++t) {
    start_parity[static_cast<size_t>(t)] = static_cast<int>(acc & 1);
    acc += qcount[static_cast<size_t>(t)];
  }
  // phase B: collect newline positions at even parity, chunk-parallel
  std::vector<std::vector<long>> hits(static_cast<size_t>(nthreads));
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t]() {
        long lo = t * chunk, hi = std::min(n, lo + chunk);
        int parity = start_parity[static_cast<size_t>(t)];
        auto& v = hits[static_cast<size_t>(t)];
        for (long i = lo; i < hi; ++i) {
          char c = buf[i];
          if (c == '"') parity ^= 1;
          else if (c == '\n' && parity == 0) v.push_back(i + 1);
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  long rows = 0;
  if (max_rows > 0) offsets[rows++] = 0;
  for (auto& v : hits)
    for (long s : v) {
      if (s < n && rows < max_rows) offsets[rows++] = s;
    }
  offsets[rows] = n;
  return rows;
}

// Pass 2: tokenize rows [row0, row1) in parallel.
//   is_num[c]    : 1 -> parse to double into num_out (row-major over the
//                  numeric columns only); token in the NA set or garbage
//                  -> NaN
//   else         : span into str_off/str_len/str_quoted (row-major over
//                  the non-numeric columns only)
//   na_blob/na_offs/n_nas : caller-supplied NA strings (concatenated)
// Returns 0 on success.
int csv_parse(const char* buf, long n, const long* offsets, long row0,
              long row1, char sep, int ncols,
              const unsigned char* is_num,
              const char* na_blob, const int* na_offs, int n_nas,
              double* num_out, long* str_off, int* str_len,
              unsigned char* str_quoted, int nthreads) {
  (void)n;
  NaSet nas{na_blob, na_offs, n_nas};
  int n_num = 0, n_str = 0;
  for (int c = 0; c < ncols; ++c) (is_num[c] ? n_num : n_str)++;
  std::vector<int> num_idx(static_cast<size_t>(ncols)),
      str_idx(static_cast<size_t>(ncols));
  for (int c = 0, a = 0, b = 0; c < ncols; ++c) {
    if (is_num[c]) num_idx[static_cast<size_t>(c)] = a++;
    else str_idx[static_cast<size_t>(c)] = b++;
  }
  if (nthreads < 1) nthreads = 1;
  long nrows = row1 - row0;
  long chunk = (nrows + nthreads - 1) / nthreads;
  std::atomic<int> err{0};
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, t]() {
      std::vector<Span> spans(static_cast<size_t>(ncols));
      long lo = row0 + t * chunk, hi = std::min(row1, lo + chunk);
      for (long r = lo; r < hi; ++r) {
        long start = offsets[r];
        long end = offsets[r + 1];
        if (end > start && buf[end - 1] == '\n') --end;
        tokenize_line(buf, start, end, sep, ncols, spans.data());
        long out_r = r - row0;
        for (int c = 0; c < ncols; ++c) {
          const Span& s = spans[static_cast<size_t>(c)];
          if (is_num[c]) {
            double v = NAN;
            if (!nas.contains(buf + s.off, s.len))
              if (!parse_double(buf + s.off, s.len, &v)) v = NAN;
            num_out[out_r * n_num + num_idx[static_cast<size_t>(c)]] = v;
          } else {
            long k = out_r * n_str + str_idx[static_cast<size_t>(c)];
            str_off[k] = s.off;
            str_len[k] = s.len;
            str_quoted[k] = s.quoted;
          }
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  return err.load();
}

}  // extern "C"
