// Native data loader of the port: multithreaded Criteo-format TSV parser and
// hash encoder, a copy of the JAX package's ``native/criteo_loader.cpp``
// (same code, same encoding, bit for bit), built with g++ at first use by
// ``ml_function_tpu_torch/native/__init__.py``.
//
// It parses and encodes straight from the raw byte buffer into the
// framework's layout (float32 dense block, int32 hashed sparse block,
// float32 labels) with one pass per thread and no intermediate objects,
// where the reference's input path is single-threaded pandas
// (``kon/utils/data_prepare.py:85-102``, ``example/ctr_example/un_seq.py:36-37``).
//
// Format per line (standard Criteo TSV, un_seq.py:39-40 layout):
//   label \t I1 .. I13 \t C1 .. C26 \n          (fields may be empty)
//
// Encoding spec (mirrored by features/native_loader.py::py_reference_parse
// for numeric parity tests):
//   label:  float of field 0 (empty -> 0)
//   dense:  integer/float field; missing -> 0; log1p mode -> log1p(max(v,0))
//   sparse: FNV-1a 64-bit over "<col>:<bytes>" -> 1 + h % (buckets-1)
//           (0 is reserved for missing/padding, matching SparseEncoder's
//           hash mode contract, features/encoders.py:34-41)
//
// Threading: the buffer is split into T byte-ranges snapped to newline
// boundaries; pass 1 counts rows per range (memchr), a prefix sum assigns
// each range its output row offset, pass 2 parses ranges in parallel.
// No locks, no atomics on the hot path.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t fnv1a(const char* s, size_t n, uint64_t h) {
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

constexpr uint64_t kFnvOffset = 1469598103934665603ULL;

// Parse a float field [s, e); empty -> 0.  Criteo dense fields are small
// integers, so a fast integer path covers ~all rows; fall back to strtod.
inline float parse_num(const char* s, const char* e) {
  if (s >= e) return 0.0f;
  bool neg = false;
  if (*s == '-') { neg = true; ++s; }
  int64_t v = 0;
  const char* p = s;
  while (p < e && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  if (p == e && p != s) return neg ? -static_cast<float>(v)
                                   : static_cast<float>(v);
  char tmp[64];
  size_t n = static_cast<size_t>(e - (neg ? s - 1 : s));
  if (n >= sizeof(tmp)) n = sizeof(tmp) - 1;
  std::memcpy(tmp, neg ? s - 1 : s, n);
  tmp[n] = 0;
  return static_cast<float>(strtod(tmp, nullptr));
}

struct Range { const char* begin; const char* end; int64_t row0; };

// Split [buf, buf+len) into at most t ranges snapped forward to '\n'.
std::vector<Range> split_ranges(const char* buf, int64_t len, int t) {
  std::vector<Range> out;
  const char* end = buf + len;
  const char* cur = buf;
  int64_t chunk = len / t + 1;
  while (cur < end) {
    const char* stop = cur + chunk;
    if (stop >= end) {
      stop = end;
    } else {
      const char* nl = static_cast<const char*>(
          memchr(stop, '\n', static_cast<size_t>(end - stop)));
      stop = nl ? nl + 1 : end;
    }
    out.push_back({cur, stop, 0});
    cur = stop;
  }
  return out;
}

int64_t count_lines(const char* b, const char* e) {
  int64_t n = 0;
  while (b < e) {
    const char* nl = static_cast<const char*>(
        memchr(b, '\n', static_cast<size_t>(e - b)));
    if (!nl) { ++n; break; }  // final line without trailing newline
    ++n;
    b = nl + 1;
  }
  return n;
}

struct Spec {
  int n_dense;
  int n_sparse;
  int64_t buckets;
  bool log1p;
  // Per-column hash state seeded with "<col>:" so fields with equal bytes
  // land in different buckets (same contract as SparseEncoder's salt).
  std::vector<uint64_t> col_seed;
};

void parse_range(const Range& r, const Spec& sp, float* dense,
                 int32_t* sparse, float* label) {
  const char* p = r.begin;
  const char* end = r.end;
  int64_t row = r.row0;
  const int nfields = 1 + sp.n_dense + sp.n_sparse;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    float* drow = dense + row * sp.n_dense;
    int32_t* srow = sparse + row * sp.n_sparse;
    const char* f = p;
    for (int i = 0; i < nfields && f <= line_end; ++i) {
      const char* tab = static_cast<const char*>(
          memchr(f, '\t', static_cast<size_t>(line_end - f)));
      const char* fe = tab ? tab : line_end;
      if (i == 0) {
        label[row] = parse_num(f, fe);
      } else if (i <= sp.n_dense) {
        float v = parse_num(f, fe);
        drow[i - 1] = sp.log1p ? std::log1p(v > 0.0f ? v : 0.0f) : v;
      } else {
        int j = i - 1 - sp.n_dense;
        if (f == fe) {
          srow[j] = 0;  // missing -> padding id
        } else {
          uint64_t h = fnv1a(f, static_cast<size_t>(fe - f), sp.col_seed[j]);
          srow[j] = static_cast<int32_t>(1 + h % (sp.buckets - 1));
        }
      }
      f = fe + 1;
    }
    ++row;
    if (!nl) break;
    p = nl + 1;
  }
}

}  // namespace

extern "C" {

// Rows in [buf, buf+len), counted in parallel.
int64_t mlf_count_rows(const char* buf, int64_t len, int n_threads) {
  if (len <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  auto ranges = split_ranges(buf, len, n_threads);
  std::vector<int64_t> counts(ranges.size(), 0);
  std::vector<std::thread> ts;
  for (size_t i = 0; i < ranges.size(); ++i)
    ts.emplace_back([&, i] { counts[i] = count_lines(ranges[i].begin,
                                                     ranges[i].end); });
  for (auto& t : ts) t.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  return total;
}

// Parse Criteo TSV into preallocated row-major outputs:
//   dense  (n_rows, n_dense)  float32
//   sparse (n_rows, n_sparse) int32
//   label  (n_rows,)          float32
// col_names: '\n'-joined sparse column names (hash salts).
// Returns rows written, or -1 on spec error.
int64_t mlf_parse_criteo(const char* buf, int64_t len, int n_dense,
                         int n_sparse, int64_t hash_buckets, int log1p_flag,
                         const char* col_names, float* dense_out,
                         int32_t* sparse_out, float* label_out,
                         int n_threads) {
  if (len <= 0 || n_sparse < 0 || n_dense < 0 || hash_buckets < 2) return -1;
  if (n_threads < 1) n_threads = 1;

  Spec sp;
  sp.n_dense = n_dense;
  sp.n_sparse = n_sparse;
  sp.buckets = hash_buckets;
  sp.log1p = log1p_flag != 0;
  {
    const char* c = col_names;
    for (int j = 0; j < n_sparse; ++j) {
      const char* e = strchr(c, '\n');
      size_t n = e ? static_cast<size_t>(e - c) : strlen(c);
      uint64_t seed = fnv1a(c, n, kFnvOffset);
      seed = fnv1a(":", 1, seed);
      sp.col_seed.push_back(seed);
      c += n + (e ? 1 : 0);
    }
  }

  auto ranges = split_ranges(buf, len, n_threads);
  std::vector<int64_t> counts(ranges.size(), 0);
  {
    std::vector<std::thread> ts;
    for (size_t i = 0; i < ranges.size(); ++i)
      ts.emplace_back([&, i] { counts[i] = count_lines(ranges[i].begin,
                                                       ranges[i].end); });
    for (auto& t : ts) t.join();
  }
  int64_t row0 = 0;
  for (size_t i = 0; i < ranges.size(); ++i) {
    ranges[i].row0 = row0;
    row0 += counts[i];
  }

  std::vector<std::thread> ts;
  for (auto& r : ranges)
    ts.emplace_back([&, r] { parse_range(r, sp, dense_out, sparse_out,
                                         label_out); });
  for (auto& t : ts) t.join();
  return row0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Avazu-format categorical CSV parser (r5 — BASELINE.json "AutoInt on
// Avazu"): delimiter/column-config generalization of the Criteo parser.
//
// Per line: n_fields delimiter-separated fields; one is the float label,
// one (optional) is the YYMMDDHH `hour` int, the rest are categorical.
// Output column j reads input field field_idx[j] with mode[j]:
//   0 — bytes (canonicalized to decimal when the WHOLE COLUMN is integer-
//       typed — pandas reads such columns as int64 and str() drops leading
//       zeros; the all-int flags are computed in the counting pass);
//       empty -> the literal "-1" (pandas fillna contract,
//       features/encoders.py SparseEncoder)
//   1 — hour % 100   (hour_of_day, decimal string)
//   2 — (hour / 100) % 100   (day, decimal string)
// Hash: 1 + FNV1a64("<col>:<derived string>") % (buckets-1) — the
// SparseEncoder mode="fnv" spec (exact-parity tested).
// Caveats (documented in features/native_loader.py): columns pandas would
// type as FLOAT (missing values in an int column, scientific notation)
// diverge — real Avazu has none.

namespace {

struct AvSpec {
  char delim;
  int n_fields, label_idx, hour_idx, n_out;
  const int32_t* field_idx;
  const int32_t* mode;
  int64_t buckets;
  std::vector<uint64_t> col_seed;
  std::vector<unsigned char> col_int;  // per INPUT field: all-int flag
};

inline bool field_intlike(const char* s, const char* e) {
  if (s < e && *s == '-') ++s;
  if (s >= e) return false;
  for (const char* p = s; p < e; ++p)
    if (*p < '0' || *p > '9') return false;
  return true;
}

// counting pass: rows per range + AND of per-field intlike flags
int64_t count_and_scan(const char* b, const char* e, const AvSpec& sp,
                       unsigned char* col_int /* n_fields */) {
  int64_t n = 0;
  while (b < e) {
    const char* nl = static_cast<const char*>(
        memchr(b, '\n', static_cast<size_t>(e - b)));
    const char* le = nl ? nl : e;
    if (le > b) {
      ++n;
      const char* f = b;
      for (int i = 0; i < sp.n_fields && f <= le; ++i) {
        const char* d = static_cast<const char*>(
            memchr(f, sp.delim, static_cast<size_t>(le - f)));
        const char* fe = d ? d : le;
        if (f < fe && !field_intlike(f, fe)) col_int[i] = 0;
        f = fe + 1;
      }
    }
    if (!nl) break;
    b = nl + 1;
  }
  return n;
}

inline int fmt_ll(int64_t v, char* out) {
  int n = 0;
  if (v < 0) { out[n++] = '-'; v = -v; }
  char tmp[24];
  int t = 0;
  do { tmp[t++] = static_cast<char>('0' + v % 10); v /= 10; } while (v);
  while (t) out[n++] = tmp[--t];
  return n;
}

void av_parse_range(const char* b, const char* e, int64_t row,
                    const AvSpec& sp, int32_t* sparse, float* label) {
  std::vector<const char*> fb(sp.n_fields + 1), fe(sp.n_fields + 1);
  char tmp[32];
  while (b < e) {
    const char* nl = static_cast<const char*>(
        memchr(b, '\n', static_cast<size_t>(e - b)));
    const char* le = nl ? nl : e;
    if (le == b) { if (!nl) break; b = nl + 1; continue; }
    const char* f = b;
    for (int i = 0; i < sp.n_fields; ++i) { fb[i] = le; fe[i] = le; }
    for (int i = 0; i < sp.n_fields && f <= le; ++i) {
      const char* d = static_cast<const char*>(
          memchr(f, sp.delim, static_cast<size_t>(le - f)));
      fb[i] = f;
      fe[i] = d ? d : le;
      f = fe[i] + 1;
    }
    label[row] = parse_num(fb[sp.label_idx], fe[sp.label_idx]);
    int64_t hour = 0;
    if (sp.hour_idx >= 0) {
      const char* s = fb[sp.hour_idx];
      bool neg = s < fe[sp.hour_idx] && *s == '-';
      if (neg) ++s;
      while (s < fe[sp.hour_idx] && *s >= '0' && *s <= '9')
        hour = hour * 10 + (*s++ - '0');
      if (neg) hour = -hour;
    }
    int32_t* srow = sparse + row * sp.n_out;
    for (int j = 0; j < sp.n_out; ++j) {
      const char* vs;
      size_t vn;
      if (sp.mode[j] == 1) {
        vn = static_cast<size_t>(fmt_ll(hour % 100, tmp));
        vs = tmp;
      } else if (sp.mode[j] == 2) {
        vn = static_cast<size_t>(fmt_ll((hour / 100) % 100, tmp));
        vs = tmp;
      } else {
        int i = sp.field_idx[j];
        if (fb[i] == fe[i]) {           // empty -> "-1" (pandas fillna)
          tmp[0] = '-'; tmp[1] = '1';
          vs = tmp; vn = 2;
        } else if (sp.col_int[i]) {     // int column: canonical decimal
          int64_t v = 0;
          const char* s = fb[i];
          bool neg = *s == '-';
          if (neg) ++s;
          while (s < fe[i]) v = v * 10 + (*s++ - '0');
          vn = static_cast<size_t>(fmt_ll(neg ? -v : v, tmp));
          vs = tmp;
        } else {
          vs = fb[i];
          vn = static_cast<size_t>(fe[i] - fb[i]);
        }
      }
      uint64_t h = fnv1a(vs, vn, sp.col_seed[j]);
      srow[j] = static_cast<int32_t>(1 + h % (sp.buckets - 1));
    }
    ++row;
    if (!nl) break;
    b = nl + 1;
  }
}

}  // namespace

extern "C" {

// Returns rows written, or -1 on spec error. col_names: '\n'-joined OUTPUT
// column names (hash salts), n_out of them.
int64_t mlf_parse_avazu(const char* buf, int64_t len, char delim,
                        int n_fields, int label_idx, int hour_idx,
                        int n_out, const int32_t* field_idx,
                        const int32_t* mode, int64_t hash_buckets,
                        const char* col_names, int32_t* sparse_out,
                        float* label_out, int n_threads) {
  if (len <= 0 || n_out <= 0 || hash_buckets < 2 || label_idx < 0
      || label_idx >= n_fields)
    return -1;
  if (n_threads < 1) n_threads = 1;
  AvSpec sp;
  sp.delim = delim;
  sp.n_fields = n_fields;
  sp.label_idx = label_idx;
  sp.hour_idx = hour_idx;
  sp.n_out = n_out;
  sp.field_idx = field_idx;
  sp.mode = mode;
  sp.buckets = hash_buckets;
  {
    const char* c = col_names;
    for (int j = 0; j < n_out; ++j) {
      const char* e = strchr(c, '\n');
      size_t n = e ? static_cast<size_t>(e - c) : strlen(c);
      uint64_t seed = fnv1a(c, n, kFnvOffset);
      seed = fnv1a(":", 1, seed);
      sp.col_seed.push_back(seed);
      c += n + (e ? 1 : 0);
    }
  }

  auto ranges = split_ranges(buf, len, n_threads);
  std::vector<int64_t> counts(ranges.size(), 0);
  std::vector<std::vector<unsigned char>> flags(
      ranges.size(), std::vector<unsigned char>(n_fields, 1));
  {
    std::vector<std::thread> ts;
    for (size_t i = 0; i < ranges.size(); ++i)
      ts.emplace_back([&, i] {
        counts[i] = count_and_scan(ranges[i].begin, ranges[i].end, sp,
                                   flags[i].data());
      });
    for (auto& t : ts) t.join();
  }
  sp.col_int.assign(n_fields, 1);
  for (auto& f : flags)
    for (int i = 0; i < n_fields; ++i) sp.col_int[i] &= f[i];
  int64_t row0 = 0;
  for (size_t i = 0; i < ranges.size(); ++i) {
    ranges[i].row0 = row0;
    row0 += counts[i];
  }
  std::vector<std::thread> ts;
  for (auto& r : ranges)
    ts.emplace_back([&, r] {
      av_parse_range(r.begin, r.end, r.row0, sp, sparse_out, label_out);
    });
  for (auto& t : ts) t.join();
  return row0;
}

}  // extern "C"
