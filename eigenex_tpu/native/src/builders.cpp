// Native host-side builders for eigenex_tpu.
//
// The reference is header-only C++ whose only "runtime" is portable
// template math (SURVEY.md §2 language note); this library keeps all
// device compute in XLA/Pallas, but the HOST-side assembly of large
// operators (COO sort/merge, BSR-ELL packing, sector-Hamiltonian
// enumeration) is O(nnz) pointer-chasing that pure Python/NumPy does
// 10-100x slower than compiled code.  These functions are that native
// runtime: a plain C ABI (no pybind11 in this image) consumed via
// ctypes with a NumPy-only fallback (eigenex_tpu/native/__init__.py).
//
// Functional analogs in the reference:
//   coo_shrink       ~ TripletsMatrix::shrink  (triplets_matrix.hpp:238-296)
//   bsr_kmax/pack    ~ (net-new: the BSR-ELL layout has no reference analog)
//   heisenberg_sector~ (net-new: BASELINE config 3 builder)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// Stable LSD radix argsort of 64-bit keys (8-bit digits, passes limited
// to the significant bytes of max(key)).  ~6-8x std::sort's indirect
// comparator path at 10^7-10^8 elements — the triplet sort was the
// second-largest pack stage after the scatter (VERDICT r4 item 2).
// idx must hold 0..n-1 (or any permutation to refine); sorted order is
// written back into idx.
void radix_argsort_u64(const uint64_t* keys, int64_t* idx, int64_t n) {
  if (n <= 1) return;
  uint64_t maxk = 0;
  for (int64_t i = 0; i < n; ++i) maxk |= keys[i];
  std::vector<int64_t> tmp(n);
  int64_t* src = idx;
  int64_t* dst = tmp.data();
  for (int shift = 0; shift < 64 && (maxk >> shift); shift += 8) {
    int64_t count[257] = {0};
    for (int64_t i = 0; i < n; ++i)
      ++count[((keys[src[i]] >> shift) & 0xff) + 1];
    for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i)
      dst[count[(keys[src[i]] >> shift) & 0xff]++] = src[i];
    std::swap(src, dst);
  }
  if (src != idx) std::memcpy(idx, src, (size_t)n * sizeof(int64_t));
}

// One stable THREADED counting pass: scatter element ids (from `src`,
// or the identity when src == nullptr) into `dst`, ordered by
// key_of[id].  Per-thread histograms + a (key, thread)-ordered offset
// scan keep it stable; the scatter's random writes split across cores.
void counting_pass_mt(const int64_t* key_of, const int64_t* src, int64_t* dst,
                      int64_t n, int64_t n_keys) {
  const unsigned hc = std::thread::hardware_concurrency();
  int64_t T = std::max<int64_t>(1, std::min<int64_t>(hc ? hc : 1, 8));
  // per-thread histograms are T * n_keys * 8 bytes of transient memory;
  // cap the total near 1 GiB so wide key ranges cannot OOM a host that
  // handled the same operator through the old comparison sort
  while (T > 1 && T * n_keys * 8 > (int64_t(1) << 30)) --T;
  std::vector<std::vector<int64_t>> hist(T);
  std::vector<std::thread> th;
  for (int64_t t = 0; t < T; ++t) {
    th.emplace_back([&, t]() {
      hist[t].assign(n_keys, 0);
      auto& h = hist[t];
      const int64_t lo = t * n / T, hi = (t + 1) * n / T;
      for (int64_t i = lo; i < hi; ++i) ++h[key_of[src ? src[i] : i]];
    });
  }
  for (auto& x : th) x.join();
  th.clear();
  int64_t run = 0;  // off[t][b] = Σ_{b'<b} total[b'] + Σ_{t'<t} hist[t'][b]
  for (int64_t b = 0; b < n_keys; ++b) {
    for (int64_t t = 0; t < T; ++t) {
      const int64_t cnt = hist[t][b];
      hist[t][b] = run;
      run += cnt;
    }
  }
  for (int64_t t = 0; t < T; ++t) {
    th.emplace_back([&, t]() {
      auto& off = hist[t];
      const int64_t lo = t * n / T, hi = (t + 1) * n / T;
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t j = src ? src[i] : i;
        dst[off[key_of[j]]++] = j;
      }
    });
  }
  for (auto& x : th) x.join();
}

// Stable argsort by (major, minor) in TWO threaded counting passes
// (LSD): when the key ranges are comparable to nnz this beats the
// byte-radix by the pass count (2 vs 5-6) — the triplet merge sort was
// the largest remaining pack stage.  Writes the order into idx.
void counting_argsort2(const int64_t* major, const int64_t* minor,
                       int64_t n_major, int64_t n_minor, int64_t n,
                       int64_t* idx) {
  std::vector<int64_t> tmp(n);
  counting_pass_mt(minor, nullptr, tmp.data(), n, n_minor);
  counting_pass_mt(major, tmp.data(), idx, n, n_major);
}

}  // namespace

extern "C" {

// Sort triplets row-major, merge duplicates, drop |v| <= threshold.
// rows/cols/vals are length nnz; outputs written in place; returns the
// merged count.  Requires rows*n_cols+cols to fit uint64 (n_rows*n_cols
// < 2^64 — always true for practical operators).
int64_t coo_shrink(int64_t* rows, int64_t* cols, double* vals, int64_t nnz,
                   int64_t n_cols, double threshold) {
  std::vector<int64_t> order(nnz);
  int64_t n_rows = 0;
  for (int64_t i = 0; i < nnz; ++i) n_rows = std::max(n_rows, rows[i] + 1);
  if (n_rows + n_cols <= 4 * nnz) {
    counting_argsort2(rows, cols, n_rows, n_cols, nnz, order.data());
  } else {  // hyper-sparse: byte radix avoids giant count arrays
    std::vector<uint64_t> key(nnz);
    for (int64_t i = 0; i < nnz; ++i)
      key[i] = (uint64_t)rows[i] * (uint64_t)n_cols + (uint64_t)cols[i];
    std::iota(order.begin(), order.end(), 0);
    radix_argsort_u64(key.data(), order.data(), nnz);
  }
  int64_t out = -1;
  int64_t prev_r = -1, prev_c = -1;
  std::vector<int64_t> r2(nnz), c2(nnz);
  std::vector<double> v2(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t j = order[i];
    if (rows[j] == prev_r && cols[j] == prev_c) {
      v2[out] += vals[j];
    } else {
      ++out;
      r2[out] = rows[j];
      c2[out] = cols[j];
      v2[out] = vals[j];
      prev_r = rows[j];
      prev_c = cols[j];
    }
  }
  const int64_t merged = out + 1;
  int64_t kept = 0;
  for (int64_t i = 0; i < merged; ++i) {
    if (std::abs(v2[i]) > threshold) {
      rows[kept] = r2[i];
      cols[kept] = c2[i];
      vals[kept] = v2[i];
      ++kept;
    }
  }
  return kept;
}

// Max number of distinct column blocks in any block row (the ELL width).
int64_t bsr_kmax(const int64_t* rows, const int64_t* cols, int64_t nnz,
                 int64_t bm, int64_t bn, int64_t nbr, int64_t nbc) {
  std::vector<std::vector<int64_t>> seen(nbr);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t br = rows[i] / bm;
    const int64_t bc = cols[i] / bn;
    if (br < 0 || br >= nbr) continue;
    auto& v = seen[br];
    if (std::find(v.begin(), v.end(), bc) == v.end()) v.push_back(bc);
  }
  int64_t kmax = 1;
  for (const auto& v : seen) kmax = std::max<int64_t>(kmax, (int64_t)v.size());
  return kmax;
}

// Pack triplets into BSR-ELL: data (nbr, kmax, bm, bn) zero-initialised by
// the caller, block_cols (nbr, kmax) zero-initialised.  Duplicates
// accumulate.  Returns 0 on success, -1 if a row exceeds kmax slots.
int64_t bsr_pack(const int64_t* rows, const int64_t* cols, const double* vals,
                 int64_t nnz, int64_t bm, int64_t bn, int64_t nbr, int64_t nbc,
                 int64_t kmax, double* data, int32_t* block_cols) {
  std::vector<std::vector<int64_t>> slot_of(nbr);  // block col per used slot
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t br = rows[i] / bm;
    const int64_t bc = cols[i] / bn;
    if (br < 0 || br >= nbr || bc < 0 || bc >= nbc) return -2;
    auto& slots = slot_of[br];
    int64_t s = -1;
    for (int64_t k = 0; k < (int64_t)slots.size(); ++k) {
      if (slots[k] == bc) { s = k; break; }
    }
    if (s < 0) {
      if ((int64_t)slots.size() >= kmax) return -1;
      s = (int64_t)slots.size();
      slots.push_back(bc);
      block_cols[br * kmax + s] = (int32_t)bc;
    }
    const int64_t ir = rows[i] % bm;
    const int64_t ic = cols[i] % bn;
    data[((br * kmax + s) * bm + ir) * bn + ic] += vals[i];
  }
  return 0;
}

static inline int popcount64(uint64_t x) {
#if defined(__GNUC__)
  return __builtin_popcountll(x);
#else
  int c = 0;
  while (x) { x &= x - 1; ++c; }
  return c;
#endif
}

// Enumerate the XXZ-chain Hamiltonian in the (L, n_up) magnetization
// sector.  Caller allocates rows/cols/vals with capacity
// dim * (1 + n_bonds); returns the actual nnz (or -1 if L > 62).
// Basis states are the bitmasks with n_up set bits, ascending; indices
// are positions in that ordering.
int64_t heisenberg_sector(int64_t L, int64_t n_up, double J, double Jz,
                          int64_t pbc, int64_t* rows, int64_t* cols,
                          double* vals) {
  if (L > 62 || n_up < 0 || n_up > L) return -1;
  // enumerate sector states (Gosper's hack for same-popcount successor)
  std::vector<uint64_t> states;
  if (n_up == 0) {
    states.push_back(0);
  } else {
    uint64_t v = (1ULL << n_up) - 1;
    const uint64_t limit = 1ULL << L;
    while (v < limit) {
      states.push_back(v);
      const uint64_t t = v | (v - 1);
      v = (t + 1) | (((~t & (t + 1)) - 1) >> (__builtin_ctzll(v) + 1));
      if (v == 0) break;
    }
  }
  const int64_t dim = (int64_t)states.size();
  // index lookup by binary search (states ascending)
  auto index_of = [&](uint64_t s) -> int64_t {
    return (int64_t)(std::lower_bound(states.begin(), states.end(), s) -
                     states.begin());
  };
  std::vector<std::pair<int, int>> bonds;
  for (int i = 0; i + 1 < L; ++i) bonds.push_back({i, i + 1});
  if (pbc && L > 2) bonds.push_back({(int)L - 1, 0});

  int64_t nnz = 0;
  for (int64_t a = 0; a < dim; ++a) {
    const uint64_t s = states[a];
    double diag = 0.0;
    for (const auto& b : bonds) {
      const double szi = ((s >> b.first) & 1) - 0.5;
      const double szj = ((s >> b.second) & 1) - 0.5;
      diag += Jz * szi * szj;
      if ((((s >> b.first) ^ (s >> b.second)) & 1) != 0) {
        const uint64_t flipped =
            s ^ ((1ULL << b.first) | (1ULL << b.second));
        rows[nnz] = index_of(flipped);
        cols[nnz] = a;
        vals[nnz] = J / 2.0;
        ++nnz;
      }
    }
    rows[nnz] = a;
    cols[nnz] = a;
    vals[nnz] = diag;
    ++nnz;
  }
  return nnz;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Matrix Market (.mtx) coordinate reader — the data-loader analog the
// reference lacks entirely (its operators are only ever built in code).
// Plain C ABI for ctypes; the Python side handles symmetry expansion and
// falls back to scipy.io for exotic variants (dense 'array' format).
// ---------------------------------------------------------------------------

#include <cctype>
#include <cstdio>

namespace {

struct MMHeader {
  int64_t rows = 0, cols = 0, nnz = 0;
  int64_t field = 0;     // 0 real, 1 integer, 2 complex, 3 pattern
  int64_t symmetry = 0;  // 0 general, 1 symmetric, 2 skew, 3 hermitian
};

// Reads the banner + size line.  Returns bytes consumed (start of data)
// on success, negative error: -1 io, -2 not coordinate MatrixMarket,
// -3 bad field, -4 bad symmetry, -5 bad size line.
int64_t parse_header(const char* buf, int64_t len, MMHeader* h) {
  int64_t pos = 0;
  auto next_line = [&](char* line, int64_t cap) -> bool {
    int64_t i = 0;
    while (pos < len && buf[pos] != '\n') {
      if (i + 1 < cap) line[i++] = buf[pos];
      ++pos;
    }
    if (pos < len) ++pos;  // swallow '\n'
    line[i] = 0;
    return i > 0 || pos < len;
  };
  char line[512];
  if (!next_line(line, sizeof line)) return -1;
  char obj[64] = {0}, fmt[64] = {0}, fld[64] = {0}, sym[64] = {0};
  if (std::sscanf(line, "%%%%MatrixMarket %63s %63s %63s %63s", obj, fmt, fld,
                  sym) != 4)
    return -2;
  for (char* s : {obj, fmt, fld, sym})
    for (char* p = s; *p; ++p) *p = (char)std::tolower(*p);
  if (std::strcmp(obj, "matrix") != 0 || std::strcmp(fmt, "coordinate") != 0)
    return -2;
  if (std::strcmp(fld, "real") == 0) h->field = 0;
  else if (std::strcmp(fld, "integer") == 0) h->field = 1;
  else if (std::strcmp(fld, "complex") == 0) h->field = 2;
  else if (std::strcmp(fld, "pattern") == 0) h->field = 3;
  else return -3;
  if (std::strcmp(sym, "general") == 0) h->symmetry = 0;
  else if (std::strcmp(sym, "symmetric") == 0) h->symmetry = 1;
  else if (std::strcmp(sym, "skew-symmetric") == 0) h->symmetry = 2;
  else if (std::strcmp(sym, "hermitian") == 0) h->symmetry = 3;
  else return -4;
  // skip comments / blank lines, then the size line
  while (true) {
    if (!next_line(line, sizeof line)) return -5;
    const char* p = line;
    while (*p && std::isspace((unsigned char)*p)) ++p;
    if (*p == 0 || *p == '%') continue;
    long long r, c, z;
    if (std::sscanf(p, "%lld %lld %lld", &r, &c, &z) != 3) return -5;
    h->rows = r; h->cols = c; h->nnz = z;
    return pos;
  }
}

// Slurp a file.  Caller frees.  Returns nullptr on failure.
char* slurp(const char* path, int64_t* out_len) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  const long long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = (char*)std::malloc((size_t)sz + 1);
  if (!buf) { std::fclose(f); return nullptr; }
  const size_t got = std::fread(buf, 1, (size_t)sz, f);
  std::fclose(f);
  buf[got] = 0;
  *out_len = (int64_t)got;
  return buf;
}

}  // namespace

extern "C" {

// out[5] = {rows, cols, nnz, field, symmetry}.  Returns 0 on success or
// the negative parse_header error.
int64_t mm_info(const char* path, int64_t* out) {
  int64_t len = 0;
  char* buf = slurp(path, &len);
  if (!buf) return -1;
  MMHeader h;
  const int64_t pos = parse_header(buf, len, &h);
  std::free(buf);
  if (pos < 0) return pos;
  out[0] = h.rows; out[1] = h.cols; out[2] = h.nnz;
  out[3] = h.field; out[4] = h.symmetry;
  return 0;
}

// Read the declared triplets (1-based in file → 0-based out).  Pattern
// entries get value 1.0; vals_im is written only for complex files.
// Returns the number of triplets read, or negative: header errors as in
// mm_info, -6 malformed/short data, -7 capacity too small, -8 index out
// of range.
int64_t mm_read(const char* path, int64_t* rows, int64_t* cols,
                double* vals_re, double* vals_im, int64_t cap) {
  int64_t len = 0;
  char* buf = slurp(path, &len);
  if (!buf) return -1;
  MMHeader h;
  const int64_t pos = parse_header(buf, len, &h);
  if (pos < 0) { std::free(buf); return pos; }
  if (h.nnz > cap) { std::free(buf); return -7; }
  const char* p = buf + pos;
  const char* end = buf + len;
  int64_t n = 0;
  for (; n < h.nnz; ++n) {
    char* q;
    const long long r = std::strtoll(p, &q, 10);
    if (q == p) { std::free(buf); return -6; }
    p = q;
    const long long c = std::strtoll(p, &q, 10);
    if (q == p) { std::free(buf); return -6; }
    p = q;
    double re = 1.0, im = 0.0;
    if (h.field != 3) {
      re = std::strtod(p, &q);
      if (q == p) { std::free(buf); return -6; }
      p = q;
      if (h.field == 2) {
        im = std::strtod(p, &q);
        if (q == p) { std::free(buf); return -6; }
        p = q;
      }
    }
    if (r < 1 || r > h.rows || c < 1 || c > h.cols) { std::free(buf); return -8; }
    rows[n] = r - 1;
    cols[n] = c - 1;
    vals_re[n] = re;
    vals_im[n] = im;
    if (p >= end) { ++n; break; }
  }
  std::free(buf);
  return n == h.nnz ? n : -6;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Round-4 additions: the scalar-sparse acceleration pipeline.
//
// The library's own physics workloads (sector Hamiltonians, .mtx imports)
// arrive as unstructured scalar COO, whose SpMV is a scalar gather +
// segment_sum.  The block routes instead want a band-reducing permutation
// (reverse Cuthill-McKee) followed by dense-block packing, after which
// effective nnz/s is the block-streaming rate x block fill.  These builders
// make that preprocessing O(nnz log nnz) in compiled code:
//   rcm_permutation       ~ scipy.sparse.csgraph.reverse_cuthill_mckee
//   blk_widths            - one sort, reused by both packers via `order`
//   bsr_pack_sorted_f32   - general BSR-ELL, f32 output
//   sym_bsr_pack_sorted_f32 - diag + strictly-upper (SymBSRMatrix) layout
// (The older bsr_kmax/bsr_pack scatter into an f64 buffer with per-triplet
// slot search; they remain for the fallback path but the sorted-run
// packers are ~50x faster and emit f32 directly.)
// ---------------------------------------------------------------------------

#include <queue>

extern "C" {

// Reverse Cuthill-McKee ordering of a symmetric-pattern graph in CSR form.
// rowptr: (n+1,), colidx: (rowptr[n],) — pattern must be symmetric (the
// caller symmetrizes).  Writes perm (n,): perm[i] = original index placed
// at new position i (A[perm][:,perm] is banded) — matching scipy's
// reverse_cuthill_mckee convention.  Returns 0.
int64_t rcm_permutation(const int64_t* rowptr, const int64_t* colidx,
                        int64_t n, int64_t* perm) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = rowptr[i + 1] - rowptr[i];
  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> level(n, -1), bfs;  // scratch BFS order
  bfs.reserve(n);

  // BFS from s over unvisited nodes; fills `bfs` and `level`, returns height.
  auto run_bfs = [&](int64_t s) -> int64_t {
    bfs.clear();
    bfs.push_back(s);
    level[s] = 0;
    int64_t height = 0;
    for (size_t q = 0; q < bfs.size(); ++q) {
      const int64_t u = bfs[q];
      for (int64_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
        const int64_t v = colidx[e];
        if (visited[v] || level[v] >= 0) continue;
        level[v] = level[u] + 1;
        height = std::max(height, level[v]);
        bfs.push_back(v);
      }
    }
    for (const int64_t u : bfs) level[u] = -1;  // reset for reuse
    return height;
  };

  int64_t out = 0;
  std::vector<int64_t> order_buf;
  for (int64_t seed = 0; seed < n; ++seed) {
    if (visited[seed]) continue;
    // component start: its min-degree node, then George-Liu iteration
    // toward a pseudo-peripheral node (min-degree node of the deepest
    // BFS level, while the eccentricity keeps growing).
    int64_t start = seed;
    {
      // find min-degree node reachable from seed (cheap scan: BFS once)
      run_bfs(seed);
      // note: run_bfs reset level[]; recompute membership via a copy
    }
    // BFS membership pass (levels kept this time)
    std::vector<int64_t> comp;
    {
      comp.push_back(seed);
      level[seed] = 0;
      for (size_t q = 0; q < comp.size(); ++q) {
        const int64_t u = comp[q];
        for (int64_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
          const int64_t v = colidx[e];
          if (visited[v] || level[v] >= 0) continue;
          level[v] = level[u] + 1;
          comp.push_back(v);
        }
      }
      for (const int64_t u : comp) level[u] = -1;
    }
    for (const int64_t u : comp)
      if (degree[u] < degree[start]) start = u;
    int64_t height = -1;
    for (int iter = 0; iter < 12; ++iter) {
      const int64_t h = run_bfs(start);
      if (h <= height) break;
      height = h;
      // bfs holds the BFS order; last level = nodes with level == h.
      // find min-degree node in the deepest level: recompute levels via
      // positions — nodes at the tail of `bfs` are deepest; walk back.
      // (re-run to get levels since run_bfs reset them)
      int64_t best = -1, best_deg = INT64_MAX;
      // recompute levels quickly
      level[start] = 0;
      std::vector<int64_t> tmp{start};
      for (size_t q = 0; q < tmp.size(); ++q) {
        const int64_t u = tmp[q];
        for (int64_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
          const int64_t v = colidx[e];
          if (visited[v] || level[v] >= 0) continue;
          level[v] = level[u] + 1;
          tmp.push_back(v);
        }
      }
      for (const int64_t u : tmp)
        if (level[u] == height && degree[u] < best_deg) {
          best_deg = degree[u];
          best = u;
        }
      for (const int64_t u : tmp) level[u] = -1;
      if (best < 0 || best == start) break;
      start = best;
    }
    // Cuthill-McKee from `start`: children appended in ascending degree.
    visited[start] = 1;
    perm[out++] = start;
    size_t q_head = out - 1;
    while (q_head < (size_t)out) {
      const int64_t u = perm[q_head++];
      order_buf.clear();
      for (int64_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
        const int64_t v = colidx[e];
        if (!visited[v]) {
          visited[v] = 1;
          order_buf.push_back(v);
        }
      }
      std::sort(order_buf.begin(), order_buf.end(),
                [&](int64_t a, int64_t b) {
                  return degree[a] != degree[b] ? degree[a] < degree[b]
                                                : a < b;
                });
      for (const int64_t v : order_buf) perm[out++] = v;
    }
  }
  // reverse (the "R" in RCM)
  for (int64_t i = 0, j = n - 1; i < j; ++i, --j) std::swap(perm[i], perm[j]);
  return 0;
}

// One sort shared by both packers: writes `order` = argsort of triplets by
// (block_row, block_col) and out[3] = {kmax, ku, reach}:
//   kmax  = max distinct blocks per block row (general ELL width)
//   ku    = max distinct strictly-UPPER blocks per block row (sym width)
//   reach = max (block_col - block_row) over upper blocks (band reach)
// ku/reach are computed for bm==bn and are 0 otherwise.  Returns 0.
int64_t blk_widths(const int64_t* rows, const int64_t* cols, int64_t nnz,
                   int64_t bm, int64_t bn, int64_t nbc, int64_t* order,
                   int64_t* out) {
  std::vector<int64_t> br(nnz), bc(nnz);
  int64_t nbr_max = 0;
  for (int64_t i = 0; i < nnz; ++i) {
    br[i] = rows[i] / bm;
    bc[i] = cols[i] / bn;
    nbr_max = std::max(nbr_max, br[i] + 1);
  }
  std::vector<int64_t> key(nnz);
  for (int64_t i = 0; i < nnz; ++i) key[i] = br[i] * nbc + bc[i];
  if (nbr_max + nbc <= 4 * nnz) {
    counting_argsort2(br.data(), bc.data(), nbr_max, nbc, nnz, order);
  } else {
    std::iota(order, order + nnz, 0);
    radix_argsort_u64((const uint64_t*)key.data(), order, nnz);
  }
  int64_t kmax = 0, ku = 0, reach = 0;
  int64_t cur_br = -1, cur_k = 0, cur_ku = 0;
  int64_t prev_key = INT64_MIN;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t k = key[order[i]];
    if (k == prev_key) continue;
    prev_key = k;
    const int64_t br = k / nbc, bc = k % nbc;
    if (br != cur_br) {
      cur_br = br;
      cur_k = 0;
      cur_ku = 0;
    }
    ++cur_k;
    kmax = std::max(kmax, cur_k);
    if (bm == bn && bc > br) {
      ++cur_ku;
      ku = std::max(ku, cur_ku);
      reach = std::max(reach, bc - br);
    }
  }
  out[0] = std::max<int64_t>(kmax, 1);
  out[1] = std::max<int64_t>(ku, 1);
  out[2] = reach;
  return 0;
}

// General BSR-ELL pack over the order from blk_widths.  data
// (nbr, kmax, bm, bn) f32 and block_cols (nbr, kmax) int32 are
// zero-initialised by the caller.  Returns 0, or -1 if kmax overflows.
int64_t bsr_pack_sorted_f32(const int64_t* rows, const int64_t* cols,
                            const double* vals, int64_t nnz,
                            const int64_t* order, int64_t bm, int64_t bn,
                            int64_t nbc, int64_t kmax, float* data,
                            int32_t* block_cols) {
  int64_t cur_br = -1, cur_bc = -1, slot = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t j = order[i];
    const int64_t br = rows[j] / bm, bc = cols[j] / bn;
    if (br != cur_br) {
      cur_br = br;
      cur_bc = -1;
      slot = -1;
    }
    if (bc != cur_bc) {
      cur_bc = bc;
      if (++slot >= kmax) return -1;
      block_cols[br * kmax + slot] = (int32_t)bc;
    }
    data[((br * kmax + slot) * bm + rows[j] % bm) * bn + cols[j] % bn] +=
        (float)vals[j];
  }
  return 0;
}

// Symmetric diag+upper pack (SymBSRMatrix layout) over the order from
// blk_widths.  Strictly-LOWER triplets are skipped (the kernel
// reconstructs them as transposes); the caller asserts symmetry.
// diag (nbr, b, b), upper (nbr, ku, b, b) f32 and ucols (nbr, ku) int32
// are zero-initialised by the caller.  Returns the number of skipped
// lower-triangle triplets, or -1 if ku overflows.
int64_t sym_bsr_pack_sorted_f32(const int64_t* rows, const int64_t* cols,
                                const double* vals, int64_t nnz,
                                const int64_t* order, int64_t b, int64_t ku,
                                float* diag, float* upper, int32_t* ucols) {
  int64_t cur_br = -1, cur_bc = -1, slot = -1;
  int64_t skipped = 0;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t j = order[i];
    const int64_t br = rows[j] / b, bc = cols[j] / b;
    if (bc < br) {
      ++skipped;
      continue;
    }
    if (br != cur_br) {
      cur_br = br;
      cur_bc = -1;
      slot = -1;
    }
    const int64_t ir = rows[j] % b, ic = cols[j] % b;
    if (bc == br) {
      diag[(br * b + ir) * b + ic] += (float)vals[j];
      continue;
    }
    if (bc != cur_bc) {
      cur_bc = bc;
      if (++slot >= ku) return -1;
      ucols[br * ku + slot] = (int32_t)bc;
    }
    upper[((br * ku + slot) * b + ir) * b + ic] += (float)vals[j];
  }
  return skipped;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Round-5 additions: threaded DIRECT-bf16 packers.
//
// The round-4 pipeline packed f32 on host, then cast to bf16 with
// numpy/ml_dtypes — measured at ~19M elements/s, i.e. 123 of the 165
// pack seconds at L=22 went into that single astype.  Emitting bf16
// straight from the packer kills the cast pass entirely AND halves the
// slot-buffer footprint (page-fault traffic was most of the remaining
// scatter time).  Both packers also shard the scatter across threads at
// block-row boundaries — the sorted order makes the partition exact.
// ---------------------------------------------------------------------------

#include <thread>

namespace {

inline uint16_t to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  if ((x & 0x7f800000u) == 0x7f800000u)  // NaN/Inf: truncate, never let the
    return (uint16_t)(x >> 16);          // rounding add wrap the exponent
  x += 0x7fffu + ((x >> 16) & 1u);  // round to nearest even
  return (uint16_t)(x >> 16);
}

inline float from_bf16(uint16_t h) {
  const uint32_t x = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

// Partition [0, nnz) into up to T ranges aligned to block-ROW changes of
// the sorted order (rows[order[i]] / b nondecreasing), so each thread
// starts at a fresh block row and the per-row slot state is private.
inline std::vector<int64_t> row_aligned_cuts(const int64_t* rows,
                                             const int64_t* order,
                                             int64_t nnz, int64_t b,
                                             int64_t T) {
  std::vector<int64_t> cuts{0};
  for (int64_t t = 1; t < T; ++t) {
    int64_t i = t * nnz / T;
    if (i <= cuts.back()) continue;
    const int64_t prev_br = rows[order[i - 1]] / b;
    while (i < nnz && rows[order[i]] / b == prev_br) ++i;
    if (i > cuts.back() && i < nnz) cuts.push_back(i);
  }
  cuts.push_back(nnz);
  return cuts;
}

int64_t hw_threads() {
  const unsigned hc = std::thread::hardware_concurrency();
  return hc ? (int64_t)hc : 1;
}

}  // namespace

extern "C" {

// bf16 twin of sym_bsr_pack_sorted_f32, threaded.  diag (nbr, b, b) and
// upper (nbr, ku, b, b) are ZERO-initialised uint16 (bf16 bit pattern);
// duplicates accumulate via f32 read-modify-write (exact for merged
// input, where every element is written once).  Returns skipped lower
// count, or -1 if ku overflows.
int64_t sym_bsr_pack_sorted_bf16(const int64_t* rows, const int64_t* cols,
                                 const double* vals, int64_t nnz,
                                 const int64_t* order, int64_t b, int64_t ku,
                                 uint16_t* diag, uint16_t* upper,
                                 int32_t* ucols) {
  const auto cuts = row_aligned_cuts(rows, order, nnz, b, hw_threads());
  const int64_t nt = (int64_t)cuts.size() - 1;
  std::vector<int64_t> rc(nt, 0);
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      int64_t cur_br = -1, cur_bc = -1, slot = -1, skipped = 0;
      for (int64_t i = cuts[t]; i < cuts[t + 1]; ++i) {
        const int64_t j = order[i];
        const int64_t br = rows[j] / b, bc = cols[j] / b;
        if (bc < br) {
          ++skipped;
          continue;
        }
        if (br != cur_br) {
          cur_br = br;
          cur_bc = -1;
          slot = -1;
        }
        const int64_t ir = rows[j] % b, ic = cols[j] % b;
        if (bc == br) {
          uint16_t* p = &diag[(br * b + ir) * b + ic];
          *p = to_bf16(from_bf16(*p) + (float)vals[j]);
          continue;
        }
        if (bc != cur_bc) {
          cur_bc = bc;
          if (++slot >= ku) {
            skipped = INT64_MIN;  // overflow marker
            break;
          }
          ucols[br * ku + slot] = (int32_t)bc;
        }
        uint16_t* p = &upper[((br * ku + slot) * b + ir) * b + ic];
        *p = to_bf16(from_bf16(*p) + (float)vals[j]);
      }
      rc[t] = skipped;
    });
  }
  for (auto& th : threads) th.join();
  int64_t skipped = 0;
  for (const int64_t s : rc) {
    if (s == INT64_MIN) return -1;
    skipped += s;
  }
  return skipped;
}

// bf16 twin of bsr_pack_sorted_f32, threaded.  data (nbr, kmax, bm, bn)
// uint16 and block_cols (nbr, kmax) int32 zero-initialised by the
// caller.  Returns 0, or -1 if kmax overflows.
int64_t bsr_pack_sorted_bf16(const int64_t* rows, const int64_t* cols,
                             const double* vals, int64_t nnz,
                             const int64_t* order, int64_t bm, int64_t bn,
                             int64_t nbc, int64_t kmax, uint16_t* data,
                             int32_t* block_cols) {
  const auto cuts = row_aligned_cuts(rows, order, nnz, bm, hw_threads());
  const int64_t nt = (int64_t)cuts.size() - 1;
  std::vector<int64_t> rc(nt, 0);
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      int64_t cur_br = -1, cur_bc = -1, slot = -1;
      for (int64_t i = cuts[t]; i < cuts[t + 1]; ++i) {
        const int64_t j = order[i];
        const int64_t br = rows[j] / bm, bc = cols[j] / bn;
        if (br != cur_br) {
          cur_br = br;
          cur_bc = -1;
          slot = -1;
        }
        if (bc != cur_bc) {
          cur_bc = bc;
          if (++slot >= kmax) {
            rc[t] = -1;
            return;
          }
          block_cols[br * kmax + slot] = (int32_t)bc;
        }
        uint16_t* p =
            &data[((br * kmax + slot) * bm + rows[j] % bm) * bn + cols[j] % bn];
        *p = to_bf16(from_bf16(*p) + (float)vals[j]);
      }
    });
  }
  for (auto& th : threads) th.join();
  for (const int64_t s : rc)
    if (s != 0) return -1;
  return 0;
}

// Threaded CSR build from UNSORTED triplets: rowptr (n+1, zeroed) and
// colidx (nnz) out.  One histogram + one scatter — no argsort and no
// gather, so it replaces the O(nnz)-gather canonical sort on the RCM
// path (the pack's own block sort never needed sorted input).  Within a
// row, colidx keeps input order (BFS adjacency doesn't care).
int64_t build_csr(const int64_t* rows, const int64_t* cols, int64_t nnz,
                  int64_t n, int64_t* rowptr, int64_t* colidx) {
  if (n <= 0) return nnz ? -1 : 0;  // empty graph: no histogram to index
  const unsigned hc = std::thread::hardware_concurrency();
  const int64_t T = std::max<int64_t>(1, std::min<int64_t>(hc ? hc : 1, 8));
  std::vector<std::vector<int64_t>> hist(T);
  std::vector<std::thread> th;
  for (int64_t t = 0; t < T; ++t) {
    th.emplace_back([&, t]() {
      hist[t].assign(n, 0);
      auto& h = hist[t];
      const int64_t lo = t * nnz / T, hi = (t + 1) * nnz / T;
      for (int64_t i = lo; i < hi; ++i) {
        if (rows[i] < 0 || rows[i] >= n) { h[0] = INT64_MIN; return; }
        ++h[rows[i]];
      }
    });
  }
  for (auto& x : th) x.join();
  th.clear();
  for (int64_t t = 0; t < T; ++t)
    if (!hist[t].empty() && hist[t][0] == INT64_MIN) return -1;
  int64_t run = 0;
  for (int64_t b = 0; b < n; ++b) {
    rowptr[b] = run;
    for (int64_t t = 0; t < T; ++t) {
      const int64_t cnt = hist[t][b];
      hist[t][b] = run;
      run += cnt;
    }
  }
  rowptr[n] = run;
  for (int64_t t = 0; t < T; ++t) {
    th.emplace_back([&, t]() {
      auto& off = hist[t];
      const int64_t lo = t * nnz / T, hi = (t + 1) * nnz / T;
      for (int64_t i = lo; i < hi; ++i) colidx[off[rows[i]]++] = cols[i];
    });
  }
  for (auto& x : th) x.join();
  return 0;
}

// Threaded f32 sym pack (same layout as sym_bsr_pack_sorted_f32) — the
// f32-target path gets the same block-row-sharded scatter.
int64_t sym_bsr_pack_sorted_f32_mt(const int64_t* rows, const int64_t* cols,
                                   const double* vals, int64_t nnz,
                                   const int64_t* order, int64_t b, int64_t ku,
                                   float* diag, float* upper, int32_t* ucols) {
  const auto cuts = row_aligned_cuts(rows, order, nnz, b, hw_threads());
  const int64_t nt = (int64_t)cuts.size() - 1;
  std::vector<int64_t> rc(nt, 0);
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      int64_t cur_br = -1, cur_bc = -1, slot = -1, skipped = 0;
      for (int64_t i = cuts[t]; i < cuts[t + 1]; ++i) {
        const int64_t j = order[i];
        const int64_t br = rows[j] / b, bc = cols[j] / b;
        if (bc < br) {
          ++skipped;
          continue;
        }
        if (br != cur_br) {
          cur_br = br;
          cur_bc = -1;
          slot = -1;
        }
        const int64_t ir = rows[j] % b, ic = cols[j] % b;
        if (bc == br) {
          diag[(br * b + ir) * b + ic] += (float)vals[j];
          continue;
        }
        if (bc != cur_bc) {
          cur_bc = bc;
          if (++slot >= ku) {
            skipped = INT64_MIN;
            break;
          }
          ucols[br * ku + slot] = (int32_t)bc;
        }
        upper[((br * ku + slot) * b + ir) * b + ic] += (float)vals[j];
      }
      rc[t] = skipped;
    });
  }
  for (auto& th : threads) th.join();
  int64_t skipped = 0;
  for (const int64_t s : rc) {
    if (s == INT64_MIN) return -1;
    skipped += s;
  }
  return skipped;
}

}  // extern "C"
