// Native behavior-sequence CSV parser of the port: multithreaded parse and
// integer-bucket encode for the out-of-core behavior stream
// (features/behavior_stream.py), a copy of the JAX package's
// ``native/behavior_loader.cpp`` (same code, same encoding, bit for bit),
// built with g++ at first use by ``ml_function_tpu_torch/native/__init__.py``.
//
// It follows criteo_loader.cpp's pattern: split the byte buffer into
// newline-snapped ranges, count rows per range, prefix-sum the output
// offsets, parse ranges in parallel with no intermediate objects.
//
// Format per line (CSV; header handled by the Python side):
//   label , item , cate , hist_item , hist_cate [, hist_long]
// history cells are '|'-separated INTEGER ids.
//
// Encoding spec (mirrors behavior_stream.encode_int_ids, tested for parity):
//   id == 0            -> 0 (pad)
//   id != 0            -> 1 + (id mod (buckets-1))
//   histories keep the LAST min(len, L) tokens, right-padded with 0.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Range { const char* b; const char* e; int64_t row0; };

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
  // counts NON-EMPTY lines only — the Python engine filters blank lines
  // (`if ln`), so a trailing "\n\n" must not become a zero-filled row here
  int64_t n = 0;
  while (b < e) {
    const char* nl = static_cast<const char*>(
        memchr(b, '\n', static_cast<size_t>(e - b)));
    const char* le = nl ? nl : e;
    if (le > b) ++n;
    if (!nl) break;
    b = nl + 1;
  }
  return n;
}

inline int64_t parse_ll(const char* s, const char* e) {
  bool neg = false;
  if (s < e && *s == '-') { neg = true; ++s; }
  int64_t v = 0;
  while (s < e && *s >= '0' && *s <= '9') { v = v * 10 + (*s - '0'); ++s; }
  return neg ? -v : v;
}

inline float parse_f(const char* s, const char* e) {
  if (s >= e) return 0.0f;
  char tmp[64];
  size_t n = static_cast<size_t>(e - s);
  if (n >= sizeof(tmp)) n = sizeof(tmp) - 1;
  std::memcpy(tmp, s, n);
  tmp[n] = 0;
  return strtof(tmp, nullptr);
}

inline int32_t enc(int64_t id, int64_t buckets) {
  if (id == 0) return 0;
  int64_t m = id % (buckets - 1);
  if (m < 0) m += buckets - 1;
  return static_cast<int32_t>(m + 1);
}

// '|'-separated ints in [s, e) -> out[0..L): keep LAST min(count, L)
// tokens, right-pad with 0 (SeqEncoder.transform semantics).
void parse_hist(const char* s, const char* e, int L, int64_t buckets,
                int32_t* out) {
  int64_t cnt = 0;
  {
    const char* p = s;
    bool tok = false;
    while (p < e) {
      if (*p == '|') { if (tok) ++cnt; tok = false; }
      else tok = true;
      ++p;
    }
    if (tok) ++cnt;
  }
  int64_t skip = cnt > L ? cnt - L : 0;
  int i = 0;
  const char* p = s;
  while (p < e && i < L) {
    const char* q = static_cast<const char*>(
        memchr(p, '|', static_cast<size_t>(e - p)));
    const char* te = q ? q : e;
    if (te > p) {
      if (skip > 0) --skip;
      else out[i++] = enc(parse_ll(p, te), buckets);
    }
    p = q ? q + 1 : e;
  }
  for (; i < L; ++i) out[i] = 0;
}

struct Cols {
  int label, item, cate, hi, hc, hl;  // field indices; hl < 0 when absent
};

void parse_range(const Range& r, const Cols& c, int seq_len, int long_len,
                 int64_t item_buckets, int64_t cate_buckets,
                 float* labels, int32_t* items, int32_t* cates,
                 int32_t* hist_item, int32_t* hist_cate,
                 int32_t* hist_long) {
  const char* p = r.b;
  int64_t row = r.row0;
  int max_col = c.label;
  if (c.item > max_col) max_col = c.item;
  if (c.cate > max_col) max_col = c.cate;
  if (c.hi > max_col) max_col = c.hi;
  if (c.hc > max_col) max_col = c.hc;
  if (c.hl > max_col) max_col = c.hl;
  std::vector<const char*> fb(max_col + 2), fe(max_col + 2);
  while (p < r.e) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(r.e - p)));
    const char* le = nl ? nl : r.e;
    if (le == p) {  // blank line: no row (matches the Python `if ln` filter)
      if (!nl) break;
      p = nl + 1;
      continue;
    }
    // split the line into fields up to max_col
    int idx = 0;
    const char* fs = p;
    for (int i = 0; i <= max_col + 1; ++i) { fb[i] = le; fe[i] = le; }
    while (fs <= le && idx <= max_col) {
      const char* comma = static_cast<const char*>(
          memchr(fs, ',', static_cast<size_t>(le - fs)));
      const char* fend = comma ? comma : le;
      fb[idx] = fs;
      fe[idx] = fend;
      ++idx;
      if (!comma) break;
      fs = comma + 1;
    }
    labels[row] = parse_f(fb[c.label], fe[c.label]);
    items[row] = enc(parse_ll(fb[c.item], fe[c.item]), item_buckets);
    cates[row] = enc(parse_ll(fb[c.cate], fe[c.cate]), cate_buckets);
    parse_hist(fb[c.hi], fe[c.hi], seq_len, item_buckets,
               hist_item + row * seq_len);
    parse_hist(fb[c.hc], fe[c.hc], seq_len, cate_buckets,
               hist_cate + row * seq_len);
    if (c.hl >= 0 && hist_long) {
      parse_hist(fb[c.hl], fe[c.hl], long_len, item_buckets,
                 hist_long + row * static_cast<int64_t>(long_len));
    }
    ++row;
    if (!nl) break;
    p = nl + 1;
  }
}

}  // namespace

extern "C" {

int64_t mlfb_count_rows(const void* buf, int64_t len) {
  if (len <= 0) return 0;
  return count_lines(static_cast<const char*>(buf),
                     static_cast<const char*>(buf) + len);
}

// Parses the whole buffer (no header line). Output arrays must be sized
// for mlfb_count_rows rows. Returns the row count.
int64_t mlfb_parse_behavior(
    const void* buf, int64_t len, int seq_len, int long_len,
    int64_t item_buckets, int64_t cate_buckets,
    int col_label, int col_item, int col_cate, int col_hi, int col_hc,
    int col_hl,
    float* labels, int32_t* items, int32_t* cates,
    int32_t* hist_item, int32_t* hist_cate, int32_t* hist_long,
    int n_threads) {
  if (len <= 0) return 0;
  const char* b = static_cast<const char*>(buf);
  int t = n_threads > 0 ? n_threads
                        : static_cast<int>(std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  auto ranges = split_ranges(b, len, t);
  std::vector<int64_t> counts(ranges.size());
  {
    std::vector<std::thread> ths;
    for (size_t i = 0; i < ranges.size(); ++i)
      ths.emplace_back([&, i] { counts[i] = count_lines(ranges[i].b,
                                                        ranges[i].e); });
    for (auto& th : ths) th.join();
  }
  int64_t total = 0;
  for (size_t i = 0; i < ranges.size(); ++i) {
    ranges[i].row0 = total;
    total += counts[i];
  }
  Cols c{col_label, col_item, col_cate, col_hi, col_hc, col_hl};
  {
    std::vector<std::thread> ths;
    for (auto& r : ranges)
      ths.emplace_back([&, r] {
        parse_range(r, c, seq_len, long_len, item_buckets, cate_buckets,
                    labels, items, cates, hist_item, hist_cate, hist_long);
      });
    for (auto& th : ths) th.join();
  }
  return total;
}

}  // extern "C"
