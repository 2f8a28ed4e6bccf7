// Native host raster engine for text_alignment_tpu.
//
// The reference delegated its raster work to Gamera's C++ plugins
// (SURVEY.md §2.9). The device path replaces those with XLA kernels; this
// module is the native *host* engine: a drop-in accelerated implementation
// of the numpy oracle's semantics (ops/oracle.py) used by the CPU
// fallback/baseline path and by host-side stage code. Exposed via a plain C
// ABI and loaded with ctypes (no pybind11 in this image).
//
// Semantics contract (must match ops/oracle.py exactly; tested):
// - images are uint8 row-major H x W, nonzero = black;
// - cc_label: 8-connected, labels 1..n in scan order of first pixel;
// - despeckle(k): remove black CCs with area <= k;
// - filter_runs: remove runs of `color` along `axis` with length < k;
// - projections/black area: int64 counts.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512BW__)
#include <immintrin.h>
#define TA_SIMD_RUNS 1
#endif

namespace {

// union-find over provisional labels
struct UF {
  std::vector<int32_t> parent;
  int32_t make() {
    parent.push_back((int32_t)parent.size());
    return (int32_t)parent.size() - 1;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

// one horizontal run of black pixels: [xs, xe) on row y
struct Run {
  int32_t y, xs, xe, prov;
};

// row_start[y] = index of the first run of row y in a row-major-sorted
// run list; row_start[H] = total count.
void build_row_start(const std::vector<Run>& runs, int64_t H,
                     std::vector<int64_t>& row_start) {
  row_start.assign(H + 1, 0);
  for (const auto& r : runs) row_start[r.y + 1]++;
  for (int64_t y = 0; y < H; ++y) row_start[y + 1] += row_start[y];
}

// Unite runs that touch runs of the previous row (8-connectivity widens
// the overlap window by one pixel each side); fills runs[k].prov.
void link_runs(std::vector<Run>& runs, const std::vector<int64_t>& row_start,
               int64_t H, UF& uf) {
  uf.parent.clear();
  uf.parent.reserve(runs.size());
  for (int64_t y = 0; y < H; ++y) {
    int64_t pi = (y > 0) ? row_start[y - 1] : 0;
    const int64_t pe = (y > 0) ? row_start[y] : 0;
    for (int64_t k = row_start[y]; k < row_start[y + 1]; ++k) {
      Run& r = runs[k];
      int32_t best = -1;
      // advance pi past previous-row runs that end left of our window
      while (pi < pe && runs[pi].xe < r.xs) ++pi;
      for (int64_t q = pi; q < pe && runs[q].xs <= r.xe; ++q) {
        int32_t p = runs[q].prov;
        if (best < 0) best = p;
        else uf.unite(best, p);
      }
      if (best < 0) best = uf.make();
      r.prov = best;
    }
  }
}

#ifdef TA_SIMD_RUNS
// Predicate bit-mask for one row: bit x set iff pixel x is in-run. The
// per-pixel run scan is the dominant cost of every run-domain op (the
// pages are megapixels, the runs tens of thousands), and one AVX-512
// byte compare replaces 64 scalar loads — measured 2.3 ms -> 0.3 ms on a
// 2048x1632 page. Bits at x >= W of the last word are zero.
enum RowPred { kNonZero, kZero, kLE };

template <int PRED>
inline void row_mask(const uint8_t* row, int64_t W, uint8_t t,
                     uint64_t* words) {
  const __m512i vz = _mm512_setzero_si512();
  const __m512i vt = _mm512_set1_epi8((char)t);
  int64_t x = 0, w = 0;
  for (; x + 64 <= W; x += 64, ++w) {
    const __m512i v = _mm512_loadu_si512(row + x);
    words[w] = PRED == kNonZero ? _mm512_cmpneq_epu8_mask(v, vz)
               : PRED == kZero  ? _mm512_cmpeq_epu8_mask(v, vz)
                                : _mm512_cmple_epu8_mask(v, vt);
  }
  if (x < W) {
    const __mmask64 m = (1ULL << (W - x)) - 1;  // 1 <= W-x <= 63 here
    const __m512i v = _mm512_maskz_loadu_epi8(m, row + x);
    words[w] = PRED == kNonZero ? _mm512_mask_cmpneq_epu8_mask(m, v, vz)
               : PRED == kZero  ? _mm512_mask_cmpeq_epu8_mask(m, v, vz)
                                : _mm512_mask_cmple_epu8_mask(m, v, vt);
  }
}

// Emit the runs encoded in a row's mask words. Same runs, same order as
// the scalar pixel scan: toggle bits (mask XOR its 1-shifted self) mark
// run starts and one-past-ends; all-zero / all-one words short-circuit.
template <class Emit>
inline void runs_from_words(const uint64_t* words, int64_t nw, int64_t W,
                            Emit emit) {
  int64_t open = -1;
  for (int64_t k = 0; k < nw; ++k) {
    const uint64_t m = words[k];
    if (open < 0) {
      if (!m) continue;
    } else if (m == ~0ULL) {
      continue;
    }
    const uint64_t prev = (open >= 0) ? 1ULL : 0ULL;
    uint64_t tog = m ^ ((m << 1) | prev);
    const int64_t base = k * 64;
    while (tog) {
      const int64_t b = __builtin_ctzll(tog);
      tog &= tog - 1;
      if (open < 0) {
        open = base + b;
      } else {
        emit(open, base + b);
        open = -1;
      }
    }
  }
  if (open >= 0) emit(open, W);
}
#endif  // TA_SIMD_RUNS

// extract runs of `black` pixels per row (row-major order). Rows with
// row_skip[y] != 0 are treated as entirely white (no runs emitted).
void extract_runs(const uint8_t* img, int64_t H, int64_t W, bool black,
                  std::vector<Run>& runs,
                  const uint8_t* row_skip = nullptr) {
  runs.clear();
#ifdef TA_SIMD_RUNS
  const int64_t nw = (W + 63) / 64;
  std::vector<uint64_t> words((size_t)nw);
  for (int64_t y = 0; y < H; ++y) {
    if (row_skip && row_skip[y]) {
      if (!black) runs.push_back({(int32_t)y, 0, (int32_t)W, -1});
      continue;
    }
    const uint8_t* row = img + y * W;
    if (black) row_mask<kNonZero>(row, W, 0, words.data());
    else       row_mask<kZero>(row, W, 0, words.data());
    runs_from_words(words.data(), nw, W, [&](int64_t s, int64_t e) {
      runs.push_back({(int32_t)y, (int32_t)s, (int32_t)e, -1});
    });
  }
#else
  for (int64_t y = 0; y < H; ++y) {
    if (row_skip && row_skip[y]) {
      if (!black) runs.push_back({(int32_t)y, 0, (int32_t)W, -1});
      continue;
    }
    const uint8_t* row = img + y * W;
    int64_t x = 0;
    while (x < W) {
      if ((row[x] != 0) != black) {
        ++x;
        continue;
      }
      int64_t s = x;
      while (x < W && (row[x] != 0) == black) ++x;
      runs.push_back({(int32_t)y, (int32_t)s, (int32_t)x, -1});
    }
  }
#endif
}

// Run-based 8-connected labeling: extract runs, link across rows. Pages
// are ~5-10% ink, so this visits ~n_runs << H*W union-find nodes and the
// remaining work is sequential memory sweeps. Scan-order label ids (1..n),
// identical to the per-pixel two-pass labeling it replaces.
int32_t label_runs(const uint8_t* img, int64_t H, int64_t W,
                   std::vector<Run>& runs, std::vector<int64_t>& row_start,
                   UF& uf, bool black = true,
                   const uint8_t* row_skip = nullptr) {
  extract_runs(img, H, W, black, runs, row_skip);
  build_row_start(runs, H, row_start);
  link_runs(runs, row_start, H, uf);
  return (int32_t)runs.size();
}

// renumber provisional run labels in scan order of first occurrence;
// returns component count and fills runs[k].prov with final 1-based ids.
int32_t renumber_runs(std::vector<Run>& runs, UF& uf) {
  std::vector<int32_t> remap(uf.parent.size(), 0);
  int32_t n = 0;
  for (auto& r : runs) {
    int32_t root = uf.find(r.prov);
    if (remap[root] == 0) remap[root] = ++n;
    r.prov = remap[root];
  }
  return n;
}

// two-pass 8-connected labeling; fills labels (H*W int32, 0 = background),
// returns number of components. Scan-order label ids (1..n).
int32_t label_impl(const uint8_t* img, int64_t H, int64_t W,
                   int32_t* labels) {
  std::vector<Run> runs;
  std::vector<int64_t> row_start;
  UF uf;
  label_runs(img, H, W, runs, row_start, uf);
  int32_t n = renumber_runs(runs, uf);
  std::memset(labels, 0, sizeof(int32_t) * (size_t)(H * W));
  for (const auto& r : runs) {
    int32_t* dst = labels + (int64_t)r.y * W;
    for (int32_t x = r.xs; x < r.xe; ++x) dst[x] = r.prov;
  }
  return n;
}

// clear (fill white) every run whose component satisfies pred(comp id)
template <class Pred>
void clear_runs_if(uint8_t* img, int64_t W, const std::vector<Run>& runs,
                   Pred pred) {
  for (const auto& r : runs) {
    if (!pred(r.prov)) continue;
    std::memset(img + (int64_t)r.y * W + r.xs, 0, (size_t)(r.xe - r.xs));
  }
}

}  // namespace

extern "C" {

// labels: int32[H*W] out. returns component count.
int32_t ta_cc_label(const uint8_t* img, int64_t H, int64_t W,
                    int32_t* labels) {
  return label_impl(img, H, W, labels);
}

// table: int64[max_ccs*5] out rows (uly, lry, ulx, lrx, area).
// returns count (may exceed max_ccs; only max_ccs rows written).
// Run-based: stats accumulate over runs, never a full label map.
int32_t ta_cc_stats(const uint8_t* img, int64_t H, int64_t W,
                    int64_t* table, int32_t max_ccs) {
  std::vector<Run> runs;
  std::vector<int64_t> row_start;
  UF uf;
  label_runs(img, H, W, runs, row_start, uf);
  int32_t n = renumber_runs(runs, uf);
  std::vector<int64_t> uly(n + 1, INT64_MAX), lry(n + 1, -1),
      ulx(n + 1, INT64_MAX), lrx(n + 1, -1), area(n + 1, 0);
  for (const auto& r : runs) {
    int32_t l = r.prov;
    if (r.y < uly[l]) uly[l] = r.y;
    if (r.y > lry[l]) lry[l] = r.y;
    if (r.xs < ulx[l]) ulx[l] = r.xs;
    if (r.xe - 1 > lrx[l]) lrx[l] = r.xe - 1;
    area[l] += r.xe - r.xs;
  }
  int32_t rows = n < max_ccs ? n : max_ccs;
  for (int32_t k = 1; k <= rows; ++k) {
    int64_t* r = table + (int64_t)(k - 1) * 5;
    r[0] = uly[k]; r[1] = lry[k]; r[2] = ulx[k]; r[3] = lrx[k]; r[4] = area[k];
  }
  return n;
}

// remove black CCs with area <= k, in place.
void ta_despeckle(uint8_t* img, int64_t H, int64_t W, int64_t k) {
  std::vector<Run> runs;
  std::vector<int64_t> row_start;
  UF uf;
  label_runs(img, H, W, runs, row_start, uf);
  int32_t n = renumber_runs(runs, uf);
  std::vector<int64_t> area(n + 1, 0);
  for (const auto& r : runs) area[r.prov] += r.xe - r.xs;
  clear_runs_if(img, W, runs, [&](int32_t l) { return area[l] <= k; });
}

// remove CCs with area < min_area (fill_white small-CC pass), in place.
void ta_remove_small(uint8_t* img, int64_t H, int64_t W, int64_t min_area) {
  std::vector<Run> runs;
  std::vector<int64_t> row_start;
  UF uf;
  label_runs(img, H, W, runs, row_start, uf);
  int32_t n = renumber_runs(runs, uf);
  std::vector<int64_t> area(n + 1, 0);
  for (const auto& r : runs) area[r.prov] += r.xe - r.xs;
  clear_runs_if(img, W, runs, [&](int32_t l) { return area[l] < min_area; });
}

// remove CCs whose row count exceeds max_nrows, in place.
void ta_remove_tall(uint8_t* img, int64_t H, int64_t W, int64_t max_nrows) {
  std::vector<Run> runs;
  std::vector<int64_t> row_start;
  UF uf;
  label_runs(img, H, W, runs, row_start, uf);
  int32_t n = renumber_runs(runs, uf);
  std::vector<int64_t> rmin(n + 1, INT64_MAX), rmax(n + 1, -1);
  for (const auto& r : runs) {
    if (r.y < rmin[r.prov]) rmin[r.prov] = r.y;
    if (r.y > rmax[r.prov]) rmax[r.prov] = r.y;
  }
  clear_runs_if(img, W, runs, [&](int32_t l) {
    return (rmax[l] - rmin[l] + 1) > max_nrows;
  });
}

// remove runs of `color` (1=black, 0=white) with length < k along `axis`
// (0 = vertical runs, 1 = horizontal), in place.
void ta_filter_runs(uint8_t* img, int64_t H, int64_t W, int64_t k,
                    int32_t color, int32_t axis) {
  const uint8_t target = color ? 1 : 0;
  if (axis == 1) {
    for (int64_t y = 0; y < H; ++y) {
      uint8_t* row = img + y * W;
      int64_t x = 0;
      while (x < W) {
        bool is_t = (row[x] != 0) == (target != 0);
        int64_t s = x;
        while (x < W && ((row[x] != 0) == (target != 0)) == is_t) ++x;
        if (is_t && (x - s) < k)
          for (int64_t i = s; i < x; ++i) row[i] = target ? 0 : 1;
      }
    }
  } else {
    for (int64_t x = 0; x < W; ++x) {
      int64_t y = 0;
      while (y < H) {
        bool is_t = (img[y * W + x] != 0) == (target != 0);
        int64_t s = y;
        while (y < H && ((img[y * W + x] != 0) == (target != 0)) == is_t) ++y;
        if (is_t && (y - s) < k)
          for (int64_t i = s; i < y; ++i) img[i * W + x] = target ? 0 : 1;
      }
    }
  }
}

// black pixel count per row. proj: int64[H] out.
void ta_projection_rows(const uint8_t* img, int64_t H, int64_t W,
                        int64_t* proj) {
#ifdef TA_SIMD_RUNS
  // row-mask + popcount: one 64-px compare per word instead of 64
  // widening adds (measured 0.87 -> ~0.15 ms on a 2048x1632 page)
  const int64_t nw = (W + 63) / 64;
  std::vector<uint64_t> words((size_t)nw);
  for (int64_t y = 0; y < H; ++y) {
    row_mask<kNonZero>(img + y * W, W, 0, words.data());
    int64_t s = 0;
    for (int64_t k = 0; k < nw; ++k) s += __builtin_popcountll(words[k]);
    proj[y] = s;
  }
#else
  for (int64_t y = 0; y < H; ++y) {
    int64_t s = 0;
    const uint8_t* row = img + y * W;
    for (int64_t x = 0; x < W; ++x) s += row[x] != 0;
    proj[y] = s;
  }
#endif
}

// Nearest strictly-higher neighbor indices over a float64 series via
// monotonic stacks: left[i] = largest j < i with v[j] > v[i] (else -1),
// right[i] = smallest j > i with v[j] > v[i] (else n). Exact float64
// comparisons — replaces the equivalent Python stack loops in
// ops/projections._prominences_vectorized (the ~0.5 ms/page hot spot of
// peak finding).
void ta_nearest_higher(const double* v, int64_t n, int32_t* left,
                       int32_t* right) {
  std::vector<int32_t> stack;
  stack.reserve(64);
  for (int64_t i = 0; i < n; ++i) {
    while (!stack.empty() && v[stack.back()] <= v[i]) stack.pop_back();
    left[i] = stack.empty() ? -1 : stack.back();
    stack.push_back((int32_t)i);
  }
  stack.clear();
  for (int64_t i = n - 1; i >= 0; --i) {
    while (!stack.empty() && v[stack.back()] <= v[i]) stack.pop_back();
    right[i] = stack.empty() ? (int32_t)n : stack.back();
    stack.push_back((int32_t)i);
  }
}

int64_t ta_black_area(const uint8_t* img, int64_t n) {
  int64_t s = 0;
  for (int64_t i = 0; i < n; ++i) s += img[i] != 0;
  return s;
}

// Row projections of the column-sheared image for A candidate angles
// (the skew-detection hot loop; semantics = oracle.shear_projection:
// sheared[y, x] = img[y + shifts[a, x], x] when in range).
// Sparse formulation: black pixel coordinates are extracted once, then
// each angle costs O(#black) instead of O(H*W) — manuscript pages are
// ~5-10% ink, so the 39-angle coarse-to-fine search runs ~15x faster.
// shifts: int32[A*W]; proj: int64[A*H] out, zeroed here.
void ta_shear_projections(const uint8_t* img, int64_t H, int64_t W,
                          const int32_t* shifts, int64_t A, int64_t* proj) {
  for (int64_t i = 0; i < A * H; ++i) proj[i] = 0;
  std::vector<int32_t> bx, by;
  bx.reserve(1 << 18);
  by.reserve(1 << 18);
  for (int64_t ys = 0; ys < H; ++ys) {
    const uint8_t* row = img + ys * W;
    for (int64_t x = 0; x < W; ++x)
      if (row[x]) {
        by.push_back((int32_t)ys);
        bx.push_back((int32_t)x);
      }
  }
  const int64_t n = (int64_t)bx.size();
  for (int64_t a = 0; a < A; ++a) {
    const int32_t* sh = shifts + a * W;
    int64_t* p = proj + a * H;
    for (int64_t k = 0; k < n; ++k) {
      int64_t y = by[k] - sh[bx[k]];  // destination row: y + shifts[x] == ys
      if (y >= 0 && y < H) p[y]++;
    }
  }
}

// Rotation about center onto an expanded canvas with the shared Q16
// fixed-point formulas (ops/fixedpoint.py) — bit-identical to
// oracle.rotate_onebit / the device rotate gather. out: uint8[H2*W2].
void ta_rotate_onebit(const uint8_t* img, int64_t H, int64_t W,
                      int64_t H2, int64_t W2, int32_t cfix, int32_t sfix,
                      int32_t scale_bits, uint8_t* out) {
  const int64_t S = (int64_t)1 << scale_bits;
  // incremental formulation: along a row, sx2/sy2 advance by constant
  // steps (2*cfix / -2*sfix), so the per-pixel muls become adds; the
  // numerators are identical to the closed form, hence bit-identical.
  const int64_t bx = (W - 1) * S + S, by = (H - 1) * S + S;
  for (int64_t y2 = 0; y2 < H2; ++y2) {
    const int64_t dy2 = 2 * y2 - (H2 - 1);
    uint8_t* orow = out + y2 * W2;
    int64_t sx2 = (int64_t)cfix * (-(W2 - 1)) + (int64_t)sfix * dy2;
    int64_t sy2 = -(int64_t)sfix * (-(W2 - 1)) + (int64_t)cfix * dy2;
    for (int64_t x2 = 0; x2 < W2; ++x2) {
      const int64_t src_x = (sx2 + bx) >> (scale_bits + 1);
      const int64_t src_y = (sy2 + by) >> (scale_bits + 1);
      orow[x2] =
          (src_y >= 0 && src_y < H && src_x >= 0 && src_x < W)
              ? img[src_y * W + src_x]
              : 0;
      sx2 += 2 * (int64_t)cfix;
      sy2 -= 2 * (int64_t)sfix;
    }
  }
}

// Integer luminance greyscale, exact oracle.to_greyscale semantics:
// (299 R + 587 G + 114 B + 500) / 1000, RGBA composited over white first
// ((c * a + 255 * (255 - a) + 127) / 255). C in {1, 3, 4}.
void ta_greyscale(const uint8_t* img, int64_t n_px, int32_t C,
                  uint8_t* out) {
  if (C == 1) {
    std::memcpy(out, img, (size_t)n_px);
    return;
  }
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = img + i * C;
    int32_t r = p[0], g = p[1], b = p[2];
    if (C == 4) {
      int32_t a = p[3];
      r = (r * a + 255 * (255 - a) + 127) / 255;
      g = (g * a + 255 * (255 - a) + 127) / 255;
      b = (b * a + 255 * (255 - a) + 127) / 255;
    }
    out[i] = (uint8_t)((299 * r + 587 * g + 114 * b + 500) / 1000);
  }
}

// 256-bin histogram of a uint8 image. hist: int64[256] out, zeroed here.
// Four interleaved banks break the store-forwarding dependency chain of a
// single accumulator array (identical counts, summed at the end).
void ta_grey_histogram(const uint8_t* img, int64_t n, int64_t* hist) {
  // 8 banks: the scatter increments are serially dependent only within a
  // bank, so widening 4 -> 8 hides more of the L1 store-to-load latency
  // (measured 2.3 -> 1.7 ms on a 3.3 Mpx page)
  int32_t bank[8][256] = {};
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    bank[0][img[i]]++;
    bank[1][img[i + 1]]++;
    bank[2][img[i + 2]]++;
    bank[3][img[i + 3]]++;
    bank[4][img[i + 4]]++;
    bank[5][img[i + 5]]++;
    bank[6][img[i + 6]]++;
    bank[7][img[i + 7]]++;
  }
  for (; i < n; ++i) bank[0][img[i]]++;
  for (int32_t v = 0; v < 256; ++v) {
    int64_t s = 0;
    for (int32_t b = 0; b < 8; ++b) s += bank[b][v];
    hist[v] = s;
  }
}

// RGB -> grey, 16 px per iteration: VBMI byte-gathers split the r/g/b
// planes out of 48 interleaved bytes and the weighted sum runs in 16x i32
// lanes. /1000 is EXACT in 32-bit lanes via the two-step
// floor(n/1000) == floor(floor(n/8)/125) == ((n >> 3) * 33555) >> 22:
// the numerator bound is (299+587+114)*255 + 500 = 255500, so n>>3 <=
// 31937, and the ceil-magic 33555 = ceil(2^22/125) has residual 71 with
// 31937 * 71 < 2^22 — no rounding edge exists (fuzzed against the scalar
// formula over all tail sizes).
#if defined(TA_SIMD_RUNS) && defined(__AVX512VBMI__)
static void grey_rgb_simd(const uint8_t* img, int64_t n_px, uint8_t* out) {
  alignas(64) static const uint8_t IDX[3][64] = {
#define TA_G16(o) o, o + 3, o + 6, o + 9, o + 12, o + 15, o + 18, o + 21, \
                  o + 24, o + 27, o + 30, o + 33, o + 36, o + 39, o + 42, \
                  o + 45
      {TA_G16(0)}, {TA_G16(1)}, {TA_G16(2)}
#undef TA_G16
  };
  const __m512i vIR = _mm512_load_si512(IDX[0]);
  const __m512i vIG = _mm512_load_si512(IDX[1]);
  const __m512i vIB = _mm512_load_si512(IDX[2]);
  const __m512i w299 = _mm512_set1_epi32(299), w587 = _mm512_set1_epi32(587),
                w114 = _mm512_set1_epi32(114), c500 = _mm512_set1_epi32(500),
                m125 = _mm512_set1_epi32(33555);
  const __mmask64 m48 = (1ULL << 48) - 1;
  int64_t i = 0;
  for (; i + 16 <= n_px; i += 16) {
    const __m512i v = _mm512_maskz_loadu_epi8(m48, img + 3 * i);
    const __m512i r32 = _mm512_cvtepu8_epi32(
        _mm512_castsi512_si128(_mm512_permutexvar_epi8(vIR, v)));
    const __m512i g32 = _mm512_cvtepu8_epi32(
        _mm512_castsi512_si128(_mm512_permutexvar_epi8(vIG, v)));
    const __m512i b32 = _mm512_cvtepu8_epi32(
        _mm512_castsi512_si128(_mm512_permutexvar_epi8(vIB, v)));
    const __m512i num = _mm512_add_epi32(
        _mm512_add_epi32(_mm512_mullo_epi32(r32, w299),
                         _mm512_mullo_epi32(g32, w587)),
        _mm512_add_epi32(_mm512_mullo_epi32(b32, w114), c500));
    const __m512i q32 = _mm512_srli_epi32(
        _mm512_mullo_epi32(_mm512_srli_epi32(num, 3), m125), 22);
    _mm_storeu_si128((__m128i*)(out + i), _mm512_cvtepi32_epi8(q32));
  }
  for (; i < n_px; ++i) {
    const uint8_t* p = img + i * 3;
    out[i] = (uint8_t)((299 * p[0] + 587 * p[1] + 114 * p[2] + 500) / 1000);
  }
}
#endif

// Greyscale + histogram as two streamed passes: interleaving the
// histogram scatter into the greyscale loop blocks tree-vectorization of
// the whole loop (measured 5.5 ms fused vs 0.6 + 1.5 ms split on a
// 2000x1600 RGB page). The alpha composite is branchless — the
// over-white formula is the exact identity at a == 255
// ((255 c + 127) / 255 == c) — so the C == 4 loop vectorizes too.
// Values identical to ta_greyscale + ta_grey_histogram.
void ta_greyscale_hist(const uint8_t* img, int64_t n_px, int32_t C,
                       uint8_t* out, int64_t* hist) {
  if (C == 1) {
    std::memcpy(out, img, (size_t)n_px);
  } else if (C == 3) {
#if defined(TA_SIMD_RUNS) && defined(__AVX512VBMI__)
    grey_rgb_simd(img, n_px, out);
#else
    for (int64_t i = 0; i < n_px; ++i) {
      const uint8_t* p = img + i * 3;
      out[i] =
          (uint8_t)((299 * p[0] + 587 * p[1] + 114 * p[2] + 500) / 1000);
    }
#endif
  } else {
    for (int64_t i = 0; i < n_px; ++i) {
      const uint8_t* p = img + i * 4;
      const int32_t a = p[3];
      const int32_t w = 255 * (255 - a) + 127;
      const int32_t r = (p[0] * a + w) / 255;
      const int32_t g = (p[1] * a + w) / 255;
      const int32_t b = (p[2] * a + w) / 255;
      out[i] = (uint8_t)((299 * r + 587 * g + 114 * b + 500) / 1000);
    }
  }
  ta_grey_histogram(out, n_px, hist);
}

// cc_stats of the page with rows where row_mask[y] != 0 treated as
// entirely white — the separator-erasure pass of identify_text_lines
// (textAlignPreprocessing.py:217-235) without copying or mutating the
// page: masked rows simply contribute no runs, which is exactly what
// labeling the erased copy would see.
int32_t ta_cc_stats_masked(const uint8_t* img, int64_t H, int64_t W,
                           const uint8_t* row_mask, int64_t* table,
                           int32_t max_ccs) {
  std::vector<Run> runs;
  std::vector<int64_t> row_start;
  UF uf;
  label_runs(img, H, W, runs, row_start, uf, /*black=*/true, row_mask);
  int32_t n = renumber_runs(runs, uf);
  std::vector<int64_t> uly(n + 1, INT64_MAX), lry(n + 1, -1),
      ulx(n + 1, INT64_MAX), lrx(n + 1, -1), area(n + 1, 0);
  for (const auto& r : runs) {
    int32_t l = r.prov;
    if (r.y < uly[l]) uly[l] = r.y;
    if (r.y > lry[l]) lry[l] = r.y;
    if (r.xs < ulx[l]) ulx[l] = r.xs;
    if (r.xe - 1 > lrx[l]) lrx[l] = r.xe - 1;
    area[l] += r.xe - r.xs;
  }
  int32_t rows = n < max_ccs ? n : max_ccs;
  for (int32_t k = 1; k <= rows; ++k) {
    int64_t* r = table + (int64_t)(k - 1) * 5;
    r[0] = uly[k]; r[1] = lry[k]; r[2] = ulx[k]; r[3] = lrx[k]; r[4] = area[k];
  }
  return n;
}

namespace {
// floor division for any-sign numerator, nonzero any-sign denominator
inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}
inline int64_t ceildiv(int64_t a, int64_t b) { return -floordiv(-a, b); }
}  // namespace

// Rotation of a run-encoded binary page — same Q16 inverse map as
// ta_rotate_onebit, solved per-interval instead of per-pixel. For an
// output row y2 the source row ys = floor((Q + Ay*x2) / 2^(sb+1)) is
// piecewise-constant in x2 (|sin| is small), and within such a span the
// source column sx = floor((P + Ax*x2) / 2^(sb+1)) is monotone
// nondecreasing (Ax = 2*cfix > 0), so the preimage of each black source
// run [xs, xe) is one exact x2 interval obtained by integer ceil/floor
// division — the identical inequalities the pixel loop evaluates, hence
// bit-identical output. Cost: O(spans + runs touched) per row instead of
// O(W2). runs: int32[3n] (y, xs, xe) of the H x W source, row-major.
// Requires cfix > 0 (always true for the +-6 deg skew range; the caller
// falls back to ta_rotate_onebit otherwise). out: uint8[H2*W2].
extern "C++" {
template <class Emit>
static void rotate_runs_core(const int32_t* runs, int64_t n, int64_t H,
                             int64_t W, int64_t H2, int64_t W2, int32_t cfix,
                             int32_t sfix, int32_t scale_bits, uint8_t* out,
                             Emit&& emit) {
  std::memset(out, 0, (size_t)(H2 * W2));
  if (n == 0 || W2 == 0) return;
  std::vector<int64_t> rs(H + 1, 0);
  for (int64_t k = 0; k < n; ++k) rs[runs[3 * k] + 1]++;
  for (int64_t y = 0; y < H; ++y) rs[y + 1] += rs[y];
  const int64_t S1 = (int64_t)1 << (scale_bits + 1);
  const int64_t Ax = 2 * (int64_t)cfix;
  const int64_t Ay = -2 * (int64_t)sfix;
  const int64_t bx = W * ((int64_t)1 << scale_bits);
  const int64_t by = H * ((int64_t)1 << scale_bits);
  for (int64_t y2 = 0; y2 < H2; ++y2) {
    const int64_t dy2 = 2 * y2 - (H2 - 1);
    const int64_t P = (int64_t)cfix * (-(W2 - 1)) + (int64_t)sfix * dy2 + bx;
    const int64_t Q =
        -(int64_t)sfix * (-(W2 - 1)) + (int64_t)cfix * dy2 + by;
    uint8_t* orow = out + y2 * W2;
    // per-row merged-run tracker: painted intervals arrive with
    // nondecreasing a2 (spans advance x2; in-span source runs advance
    // sx), so maximal output runs fall out of an abut/overlap merge
    int64_t open_s = -1, open_e = -1;
    int64_t x2 = 0;
    while (x2 < W2) {
      const int64_t ys = floordiv(Q + Ay * x2, S1);
      // end of the constant-ys span
      int64_t x2e;
      if (Ay == 0)
        x2e = W2;
      else if (Ay > 0)
        x2e = ceildiv((ys + 1) * S1 - Q, Ay);
      else
        x2e = ceildiv(ys * S1 - 1 - Q, Ay);
      if (x2e > W2) x2e = W2;
      if (ys >= 0 && ys < H && rs[ys] < rs[ys + 1]) {
        const int64_t sx_lo = floordiv(P + Ax * x2, S1);
        const int64_t sx_hi = floordiv(P + Ax * (x2e - 1), S1);
        // first run of row ys with xe > sx_lo
        int64_t lo = rs[ys], hi = rs[ys + 1];
        while (lo < hi) {
          const int64_t mid = (lo + hi) >> 1;
          if (runs[3 * mid + 2] > sx_lo) hi = mid;
          else lo = mid + 1;
        }
        for (int64_t k = lo; k < rs[ys + 1]; ++k) {
          const int64_t xs = runs[3 * k + 1], xe = runs[3 * k + 2];
          if (xs > sx_hi) break;
          // x2 with sx in [xs, xe): P + Ax*x2 in [xs*S1, xe*S1)
          int64_t a2 = ceildiv(xs * S1 - P, Ax);
          int64_t b2 = floordiv(xe * S1 - 1 - P, Ax);
          if (a2 < x2) a2 = x2;
          if (b2 >= x2e) b2 = x2e - 1;
          if (a2 <= b2) {
            std::memset(orow + a2, 1, (size_t)(b2 - a2 + 1));
            if (open_e == a2) {
              open_e = b2 + 1;
            } else {
              if (open_s >= 0) emit(y2, open_s, open_e);
              open_s = a2;
              open_e = b2 + 1;
            }
          }
        }
      }
      x2 = x2e;
    }
    if (open_s >= 0) emit(y2, open_s, open_e);
  }
}
}  // extern "C++"

void ta_rotate_runs(const int32_t* runs, int64_t n, int64_t H, int64_t W,
                    int64_t H2, int64_t W2, int32_t cfix, int32_t sfix,
                    int32_t scale_bits, uint8_t* out) {
  rotate_runs_core(runs, n, H, W, H2, W2, cfix, sfix, scale_bits, out,
                   [](int64_t, int64_t, int64_t) {});
}

// ta_rotate_runs + export of the rotated page's black runs (maximal,
// row-major sorted — identical to re-extracting them from `out`, without
// the page re-scan). Returns the true run count; only max_m rows of
// out_runs are written (caller retries with a larger buffer on overflow —
// the pixel page is final either way).
int64_t ta_rotate_runs2(const int32_t* runs, int64_t n, int64_t H,
                        int64_t W, int64_t H2, int64_t W2, int32_t cfix,
                        int32_t sfix, int32_t scale_bits, uint8_t* out,
                        int32_t* out_runs, int64_t max_m) {
  int64_t m = 0;
  rotate_runs_core(runs, n, H, W, H2, W2, cfix, sfix, scale_bits, out,
                   [&](int64_t y, int64_t s, int64_t e) {
                     if (m < max_m) {
                       out_runs[3 * m] = (int32_t)y;
                       out_runs[3 * m + 1] = (int32_t)s;
                       out_runs[3 * m + 2] = (int32_t)e;
                     }
                     ++m;
                   });
  return m;
}

// Extract black runs once: out_runs int32[3*max_n] rows (y, xs, xe).
// Returns run count (may exceed max_n; only max_n rows written).
int64_t ta_black_runs(const uint8_t* img, int64_t H, int64_t W,
                      int32_t* out_runs, int64_t max_n) {
  int64_t n = 0;
#ifdef TA_SIMD_RUNS
  const int64_t nw = (W + 63) / 64;
  std::vector<uint64_t> words((size_t)nw);
  for (int64_t y = 0; y < H; ++y) {
    row_mask<kNonZero>(img + y * W, W, 0, words.data());
    runs_from_words(words.data(), nw, W, [&](int64_t s, int64_t e) {
      if (n < max_n) {
        out_runs[3 * n] = (int32_t)y;
        out_runs[3 * n + 1] = (int32_t)s;
        out_runs[3 * n + 2] = (int32_t)e;
      }
      ++n;
    });
  }
#else
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* row = img + y * W;
    int64_t x = 0;
    while (x < W) {
      if (!row[x]) { ++x; continue; }
      int64_t s = x;
      while (x < W && row[x]) ++x;
      if (n < max_n) {
        out_runs[3 * n] = (int32_t)y;
        out_runs[3 * n + 1] = (int32_t)s;
        out_runs[3 * n + 2] = (int32_t)x;
      }
      ++n;
    }
  }
#endif
  return n;
}

// Shear projections replayed over black RUNS instead of pixels. The shift
// ramp changes value every >= 1/tan(angle) columns (>= ~10 px at the 6 deg
// search limit) while text runs are a few px wide, so most runs fall inside
// one shift cell and cost ONE counter increment for their whole length.
// Bit-identical to the per-pixel replay: increments are merely grouped,
// and the int32 counters are bounded by the page's ink pixel count (far
// below 2^31; the criterion widens to int64 on the host, so scores are
// exact). proj: int32[A*H] out, zeroed here.
// BB-angle blocks: each run's (y, xs, xe) is loaded once per block and
// the BB angles' counter updates are independent chains, so they
// pipeline (the loop is load-latency-bound, not ALU-bound; the runs
// array streams from L2 1/BB as often). Measured on the bench folio
// (20k runs, 51 angle rows over the 3 search rounds): BB=4 ~8.1 ms,
// BB=8 ~6.9 ms, BB=16 ~7.8 ms — 16 spills the interleaved shT row past a
// cache line and loses the gain, so 8 is the plateau.
// interleaved (x-major) shift copy: the block's BB sh[x] values share
// one or two cache lines, so the fast path costs two line touches per
// run.
extern "C++" {
template <int BB>
static void shear_proj_runs_block(const int32_t* runs, int64_t n,
                                  const int32_t* shifts, int64_t A,
                                  int64_t H, int64_t W, int32_t* proj) {
  std::vector<int32_t> shT((size_t)(BB * W));
  std::vector<int32_t> nb((size_t)(BB * W));
  for (int64_t a0 = 0; a0 < A; a0 += BB) {
    const int64_t ab = (A - a0) < BB ? (A - a0) : BB;
    const int32_t* sh[BB];
    int32_t* p[BB];
    for (int64_t j = 0; j < ab; ++j) {
      sh[j] = shifts + (a0 + j) * W;
      p[j] = proj + (a0 + j) * H;
      int32_t* nbj = nb.data() + j * W;
      nbj[W - 1] = (int32_t)W;
      for (int64_t x = W - 2; x >= 0; --x)
        nbj[x] = (sh[j][x + 1] == sh[j][x]) ? nbj[x + 1] : (int32_t)(x + 1);
    }
    for (int64_t x = 0; x < W; ++x)
      for (int64_t j = 0; j < ab; ++j) shT[BB * x + j] = sh[j][x];
    for (int64_t k = 0; k < n; ++k) {
      const int32_t y = runs[3 * k], xs = runs[3 * k + 1],
                    xe = runs[3 * k + 2];
      const int32_t* s1v = shT.data() + BB * xs;
      const int32_t* s2v = shT.data() + BB * (xe - 1);
      for (int64_t j = 0; j < ab; ++j) {
        const int32_t s1 = s1v[j], s2 = s2v[j];
        if (s1 == s2) {
          const int64_t yd = (int64_t)y - s1;
          if (yd >= 0 && yd < H) p[j][yd] += xe - xs;
          continue;
        }
        const int32_t* nbj = nb.data() + j * W;
        int32_t x = xs;
        while (x < xe) {
          const int32_t e = nbj[x] < xe ? nbj[x] : xe;
          const int64_t yd = (int64_t)y - sh[j][x];
          if (yd >= 0 && yd < H) p[j][yd] += e - x;
          x = e;
        }
      }
    }
  }
}

#if defined(TA_SIMD_RUNS) && defined(__AVX512VL__)
// 8-angle-block variant with a vector fast path. Accumulation happens in a
// TRANSPOSED tile projT[y*8 + j] so the 8 angles' counters for one run sit
// in adjacent lanes: a run whose shift ramp is constant over [xs, xe) in
// every block angle (the overwhelmingly common case — text runs are a few
// px wide while the ramp cell is >= ~10 px even at 6 deg) retires with ONE
// masked gather/add/scatter instead of an 8-iteration scalar loop. Lanes
// whose ramp steps inside the run fall back to the scalar segment walk.
// Scatter lane indices yd*8+j are pairwise distinct within an instruction
// (distinct j), so no write conflicts exist. Bit-identical to the scalar
// block: increments are merely grouped/reordered across commutative int32
// adds. Measured on the bench folio (~30k pre-despeckle runs, best-of-30
// per search round): coarse 3.65 -> 3.04 ms, fine rounds 2.70 -> 2.04 and
// 2.44 -> 1.92 ms vs the scalar 8-block — the steep coarse angles step
// their ramp inside most runs and keep more scalar lanes.
static void shear_proj_runs_block8_simd(const int32_t* runs, int64_t n,
                                        const int32_t* shifts, int64_t A,
                                        int64_t H, int64_t W, int32_t* proj) {
  std::vector<int32_t> shT((size_t)(8 * W));
  std::vector<int32_t> nb((size_t)(8 * W));
  std::vector<int32_t> projT((size_t)(8 * H));
  const __m256i lane_iota = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
  const __m256i vzero = _mm256_setzero_si256();
  const __m256i vH = _mm256_set1_epi32((int32_t)H);
  for (int64_t a0 = 0; a0 < A; a0 += 8) {
    const int64_t ab = (A - a0) < 8 ? (A - a0) : 8;
    const __mmask8 lanes = (__mmask8)((1u << ab) - 1);
    for (int64_t j = 0; j < ab; ++j) {
      const int32_t* shj = shifts + (a0 + j) * W;
      int32_t* nbj = nb.data() + j * W;
      nbj[W - 1] = (int32_t)W;
      for (int64_t x = W - 2; x >= 0; --x)
        nbj[x] = (shj[x + 1] == shj[x]) ? nbj[x + 1] : (int32_t)(x + 1);
    }
    for (int64_t x = 0; x < W; ++x)
      for (int64_t j = 0; j < 8; ++j)
        shT[8 * x + j] = (j < ab) ? shifts[(a0 + j) * W + x] : 0;
    std::memset(projT.data(), 0, sizeof(int32_t) * (size_t)(8 * H));
    for (int64_t k = 0; k < n; ++k) {
      const int32_t y = runs[3 * k], xs = runs[3 * k + 1],
                    xe = runs[3 * k + 2];
      const __m256i vs1 =
          _mm256_loadu_si256((const __m256i*)(shT.data() + 8 * xs));
      const __m256i vs2 =
          _mm256_loadu_si256((const __m256i*)(shT.data() + 8 * (xe - 1)));
      const __mmask8 eq = _mm256_mask_cmpeq_epi32_mask(lanes, vs1, vs2);
      if (eq) {
        const __m256i vyd = _mm256_sub_epi32(_mm256_set1_epi32(y), vs1);
        const __mmask8 ok =
            _mm256_mask_cmp_epi32_mask(eq, vyd, vzero, _MM_CMPINT_NLT) &
            _mm256_mask_cmp_epi32_mask(eq, vyd, vH, _MM_CMPINT_LT);
        if (ok) {
          const __m256i vidx =
              _mm256_add_epi32(_mm256_slli_epi32(vyd, 3), lane_iota);
          __m256i cur = _mm256_mmask_i32gather_epi32(vzero, ok, vidx,
                                                     projT.data(), 4);
          cur = _mm256_add_epi32(cur, _mm256_set1_epi32(xe - xs));
          _mm256_mask_i32scatter_epi32(projT.data(), ok, vidx, cur, 4);
        }
      }
      uint32_t rest = (uint32_t)(~eq) & lanes;
      while (rest) {
        const int64_t j = __builtin_ctz(rest);
        rest &= rest - 1;
        const int32_t* nbj = nb.data() + j * W;
        int32_t x = xs;
        while (x < xe) {
          const int32_t e = nbj[x] < xe ? nbj[x] : xe;
          const int64_t yd = (int64_t)y - shT[8 * x + j];
          if (yd >= 0 && yd < H) projT[yd * 8 + j] += e - x;
          x = e;
        }
      }
    }
    for (int64_t j = 0; j < ab; ++j) {
      int32_t* p = proj + (a0 + j) * H;
      for (int64_t y = 0; y < H; ++y) p[y] = projT[y * 8 + j];
    }
  }
}
#endif  // TA_SIMD_RUNS && __AVX512VL__
}  // extern "C++"

void ta_shear_projections_runs32(const int32_t* runs, int64_t n,
                                 const int32_t* shifts, int64_t A,
                                 int64_t H, int64_t W, int32_t* proj) {
  std::memset(proj, 0, sizeof(int32_t) * (size_t)(A * H));
#if defined(TA_SIMD_RUNS) && defined(__AVX512VL__)
  if (A >= 4 && n > 0) {
    shear_proj_runs_block8_simd(runs, n, shifts, A, H, W, proj);
    return;
  }
#endif
  if (A >= 8)
    shear_proj_runs_block<8>(runs, n, shifts, A, H, W, proj);
  else
    shear_proj_runs_block<4>(runs, n, shifts, A, H, W, proj);
}

// Fused k=2 erosion: filter_short_runs(2,'black') then
// filter_narrow_runs(2,'black'). A black run of length < 2 is a single
// pixel with both along-axis neighbors white, so each pass is a
// neighbor formula over the ORIGINAL pass input (the run-walking loop in
// ta_filter_runs also derives runs from pre-pass pixels) — two streamed
// row-major passes instead of a column-major walk over the whole page.
void ta_erode2(const uint8_t* img, int64_t H, int64_t W, uint8_t* out) {
  std::vector<uint8_t> tmp((size_t)(H * W));
  // vertical pass: keep black px iff a vertical neighbor is black
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* r = img + y * W;
    const uint8_t* up = (y > 0) ? r - W : nullptr;
    const uint8_t* dn = (y + 1 < H) ? r + W : nullptr;
    uint8_t* t = tmp.data() + y * W;
    if (up && dn) {
      for (int64_t x = 0; x < W; ++x)
        t[x] = r[x] && (up[x] || dn[x]);
    } else if (dn) {
      for (int64_t x = 0; x < W; ++x) t[x] = r[x] && dn[x];
    } else if (up) {
      for (int64_t x = 0; x < W; ++x) t[x] = r[x] && up[x];
    } else {
      std::memset(t, 0, (size_t)W);
    }
  }
  // horizontal pass: keep black px iff a horizontal neighbor is black
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* t = tmp.data() + y * W;
    uint8_t* o = out + y * W;
    if (W == 1) { o[0] = 0; continue; }
    o[0] = t[0] && t[1];
    for (int64_t x = 1; x < W - 1; ++x)
      o[x] = t[x] && (t[x - 1] || t[x + 1]);
    o[W - 1] = t[W - 1] && t[W - 2];
  }
}

// Threshold a greyscale image to a uint8 onebit page (1 = black = value
// <= thresh), matching oracle.to_onebit's `grey <= t`.
void ta_binarize(const uint8_t* grey, int64_t n, int32_t thresh,
                 uint8_t* out) {
  const uint8_t t = (uint8_t)thresh;
  for (int64_t i = 0; i < n; ++i) out[i] = grey[i] <= t;
}

// Fused preprocessing stage 1 (textAlignPreprocessing.py:166-178), in
// place on a uint8 page: despeckle black CCs (area <= k), despeckle white
// CCs (area <= k, the reference's invert-despeckle-invert), then remove
// CCs taller than sat_thresh rows (the nrows-as-area quirk).
//
// Entirely in the RUN domain: ONE pixel scan extracts the black runs, the
// three CC passes then label/filter/merge run lists in memory, and one
// paint writes the result — versus three full-page label scans + clears
// when the passes are chained on pixels. `out` receives the final black
// runs of the processed page, so downstream stages (skew search, rotate)
// can skip their own extraction scan. Semantics identical to the staged
// pixel ops (tested): each phase re-labels exactly the page state the
// staged version would see.
namespace {
// stage-1 pipeline over a pre-extracted black run list; paints the result
// into img (which may be uninitialized — it is fully overwritten).
int64_t stage1_from_runs(std::vector<Run>& runs, uint8_t* img, int64_t H,
                         int64_t W, int64_t k, int64_t sat_thresh,
                         std::vector<Run>& out, int64_t sat_area = 0) {
  std::vector<int64_t> rs;
  UF uf;
  build_row_start(runs, H, rs);
  link_runs(runs, rs, H, uf);
  int32_t n = renumber_runs(runs, uf);
  std::vector<int64_t> area(n + 1, 0);
  for (const auto& r : runs) area[r.prov] += r.xe - r.xs;
  // black despeckle: survivors only
  std::vector<Run> b1;
  b1.reserve(runs.size());
  for (const auto& r : runs)
    if (area[r.prov] > k) b1.push_back(r);
  // white despeckle on the despeckled page: white runs are the per-row
  // complement of b1 — no pixel rescan needed
  std::vector<int64_t> rs1;
  build_row_start(b1, H, rs1);
  std::vector<Run> wr;
  wr.reserve(b1.size() + (size_t)H + 1);
  for (int64_t y = 0; y < H; ++y) {
    int32_t x = 0;
    for (int64_t q = rs1[y]; q < rs1[y + 1]; ++q) {
      if (b1[q].xs > x) wr.push_back({(int32_t)y, x, b1[q].xs, -1});
      x = b1[q].xe;
    }
    if (x < W) wr.push_back({(int32_t)y, x, (int32_t)W, -1});
  }
  std::vector<int64_t> rsw;
  build_row_start(wr, H, rsw);
  UF ufw;
  link_runs(wr, rsw, H, ufw);
  int32_t nw = renumber_runs(wr, ufw);
  std::vector<int64_t> warea(nw + 1, 0);
  for (const auto& r : wr) warea[r.prov] += r.xe - r.xs;
  // fill small white CCs black: merge b1 with the qualifying white runs,
  // coalescing touching intervals (a filled gap bridges its black
  // neighbors exactly as the pixel fill would)
  std::vector<Run> b2;
  b2.reserve(b1.size());
  for (int64_t y = 0; y < H; ++y) {
    int64_t i = rs1[y], ie = rs1[y + 1];
    int64_t j = rsw[y], je = rsw[y + 1];
    int32_t cs = -1, ce = -1;
    auto push = [&](int32_t s, int32_t e) {
      if (ce == s) { ce = e; return; }
      if (cs >= 0) b2.push_back({(int32_t)y, cs, ce, -1});
      cs = s;
      ce = e;
    };
    while (i < ie || j < je) {
      // black and white runs of one row never share an xs
      const bool takeb = (j >= je) || (i < ie && b1[i].xs < wr[j].xs);
      if (takeb) {
        push(b1[i].xs, b1[i].xe);
        ++i;
      } else {
        if (warea[wr[j].prov] <= k) push(wr[j].xs, wr[j].xe);
        ++j;
      }
    }
    if (cs >= 0) b2.push_back({(int32_t)y, cs, ce, -1});
  }
  // remove tall CCs (relabel: the fills above may have joined components)
  std::vector<int64_t> rs2;
  build_row_start(b2, H, rs2);
  UF uf2;
  link_runs(b2, rs2, H, uf2);
  int32_t n2 = renumber_runs(b2, uf2);
  std::vector<int64_t> rmin(n2 + 1, INT64_MAX), rmax(n2 + 1, -1);
  std::vector<int64_t> area2(n2 + 1, 0);
  for (const auto& r : b2) {
    if (r.y < rmin[r.prov]) rmin[r.prov] = r.y;
    if (r.y > rmax[r.prov]) rmax[r.prov] = r.y;
    area2[r.prov] += r.xe - r.xs;
  }
  out.clear();
  out.reserve(b2.size());
  // sat_area != 0: strict=False semantics — filter on the component's
  // true pixel AREA instead of the reference's nrows-as-area quirk
  // (textAlignPreprocessing.py:174-178)
  for (const auto& r : b2) {
    const int64_t m =
        sat_area ? area2[r.prov] : rmax[r.prov] - rmin[r.prov] + 1;
    if (m <= sat_thresh) out.push_back(r);
  }
  // paint
  std::memset(img, 0, (size_t)(H * W));
  for (const auto& r : out)
    std::memset(img + (int64_t)r.y * W + r.xs, 1, (size_t)(r.xe - r.xs));
  return (int64_t)out.size();
}

int64_t stage1_runs_impl(uint8_t* img, int64_t H, int64_t W, int64_t k,
                         int64_t sat_thresh, std::vector<Run>& out,
                         int64_t sat_area = 0) {
  std::vector<Run> runs;
  extract_runs(img, H, W, true, runs);
  return stage1_from_runs(runs, img, H, W, k, sat_thresh, out, sat_area);
}
}  // namespace

void ta_preproc_stage1(uint8_t* img, int64_t H, int64_t W, int64_t k,
                       int64_t sat_thresh, int64_t sat_area) {
  std::vector<Run> out;
  stage1_runs_impl(img, H, W, k, sat_thresh, out, sat_area);
}

// stage1 + export of the processed page's black runs: out_runs int32
// [3*max_n] rows (y, xs, xe). Returns the true run count (may exceed
// max_n; only max_n rows are written — caller retries with a larger
// buffer, the image is final either way).
int64_t ta_preproc_stage1_runs(uint8_t* img, int64_t H, int64_t W,
                               int64_t k, int64_t sat_thresh,
                               int32_t* out_runs, int64_t max_n,
                               int64_t sat_area) {
  std::vector<Run> out;
  int64_t n = stage1_runs_impl(img, H, W, k, sat_thresh, out, sat_area);
  const int64_t m = n < max_n ? n : max_n;
  for (int64_t i = 0; i < m; ++i) {
    out_runs[3 * i] = out[i].y;
    out_runs[3 * i + 1] = out[i].xs;
    out_runs[3 * i + 2] = out[i].xe;
  }
  return n;
}

// Fully fused binarize + stage 1: black runs are extracted directly from
// the greyscale page (predicate grey <= thresh, = ta_binarize's output),
// so the intermediate binarized page is never materialized — one read of
// grey and one paint of the final page instead of a binarize write plus a
// re-scan. img_out: uint8[H*W], fully overwritten. Semantics identical
// to ta_binarize followed by ta_preproc_stage1_runs.
int64_t ta_preproc_grey_stage1_runs(const uint8_t* grey, int64_t H,
                                    int64_t W, int32_t thresh, int64_t k,
                                    int64_t sat_thresh, uint8_t* img_out,
                                    int32_t* out_runs, int64_t max_n,
                                    int64_t sat_area) {
  const uint8_t t = (uint8_t)thresh;
  std::vector<Run> runs;
#ifdef TA_SIMD_RUNS
  const int64_t nwords = (W + 63) / 64;
  std::vector<uint64_t> words((size_t)nwords);
  for (int64_t y = 0; y < H; ++y) {
    row_mask<kLE>(grey + y * W, W, t, words.data());
    runs_from_words(words.data(), nwords, W, [&](int64_t s, int64_t e) {
      runs.push_back({(int32_t)y, (int32_t)s, (int32_t)e, -1});
    });
  }
#else
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* row = grey + y * W;
    int64_t x = 0;
    while (x < W) {
      if (row[x] > t) {
        ++x;
        continue;
      }
      int64_t s = x;
      while (x < W && row[x] <= t) ++x;
      runs.push_back({(int32_t)y, (int32_t)s, (int32_t)x, -1});
    }
  }
#endif
  std::vector<Run> out;
  int64_t n =
      stage1_from_runs(runs, img_out, H, W, k, sat_thresh, out, sat_area);
  const int64_t m = n < max_n ? n : max_n;
  for (int64_t i = 0; i < m; ++i) {
    out_runs[3 * i] = out[i].y;
    out_runs[3 * i + 1] = out[i].xs;
    out_runs[3 * i + 2] = out[i].xe;
  }
  return n;
}

// Affine-gap Needleman-Wunsch (Gotoh 3-matrix) fill for integer
// match/mismatch scoring, on token ids. Exact reference semantics
// (textSeqCompare.py:45-88): first-max tie-breaks in the reference's
// candidate order, boundary rows use the module-global gap extend, the
// x matrix's unreachable boundary is a large negative sentinel. All
// arithmetic is int64 with the same NEG sentinel as the numpy fast fill
// (align/nw_host.py), so every comparison — hence every pointer — is
// bit-identical. Host pairs are small (chant transcripts, a few hundred
// chars); one scalar row sweep is ~5 ns/cell, far below a device
// round-trip for anything under a few Mcells.
// mat_ptr/x_ptr/y_ptr: int8[N*M] out, fully written.
//
// no-tree-vectorize: g++ 12.2 -O3 miscompiles this loop nest when the
// vectorizer runs (verified: -O0/-O2/UBSan agree, -O3 with AVX diverges on
// one tie-broken cell; the j loop carries y_cur[j-1] so there is nothing
// to vectorize legally anyway).
__attribute__((optimize("no-tree-vectorize")))
void ta_nw_fill(const int32_t* t_ids, int64_t N, const int32_t* o_ids,
                int64_t M, int64_t match, int64_t mismatch, int64_t gox,
                int64_t goy, int64_t gex, int64_t gey, int64_t boundary_ge,
                int8_t* mat_ptr, int8_t* x_ptr, int8_t* y_ptr) {
  const int64_t NEG = -((int64_t)1 << 56);
  std::vector<int64_t> m_prev(M), x_prev(M), y_prev(M), m_cur(M), x_cur(M),
      y_cur(M);
  for (int64_t j = 0; j < M; ++j) {
    m_prev[j] = boundary_ge * j;
    x_prev[j] = boundary_ge * j;
    y_prev[j] = NEG;
  }
  std::memset(mat_ptr, 0, (size_t)(N * M));
  std::memset(x_ptr, 0, (size_t)(N * M));
  std::memset(y_ptr, 0, (size_t)(N * M));
  for (int64_t i = 1; i < N; ++i) {
    m_cur[0] = boundary_ge * i;
    x_cur[0] = NEG;
    y_cur[0] = boundary_ge * i;
    const int32_t ti = t_ids[i - 1];
    int8_t* mp = mat_ptr + i * M;
    int8_t* xp = x_ptr + i * M;
    int8_t* yp = y_ptr + i * M;
    for (int64_t j = 1; j < M; ++j) {
      // mat: diagonal move from (i-1, j-1)
      const int64_t m0 = m_prev[j - 1], m1 = x_prev[j - 1],
                    m2 = y_prev[j - 1];
      int64_t mb = m0;
      int8_t mi = 0;
      if (m1 > mb) { mb = m1; mi = 1; }
      if (m2 > mb) { mb = m2; mi = 2; }
      m_cur[j] = mb + (ti == o_ids[j - 1] ? match : mismatch);
      mp[j] = mi;
      // x: vertical gap from (i-1, j); candidate order m, x, y
      const int64_t x0 = m_prev[j] + gox + gex, x1 = x_prev[j] + gex,
                    x2 = y_prev[j] + gox + gex;
      int64_t xb = x0;
      int8_t xi = 0;
      if (x1 > xb) { xb = x1; xi = 1; }
      if (x2 > xb) { xb = x2; xi = 2; }
      x_cur[j] = xb;
      xp[j] = xi;
      // y: horizontal gap from (i, j-1); candidate order m, x, y
      const int64_t y0 = m_cur[j - 1] + goy + gey,
                    y1 = x_cur[j - 1] + goy + gey, y2 = y_cur[j - 1] + gey;
      int64_t yb = y0;
      int8_t yi = 0;
      if (y1 > yb) { yb = y1; yi = 1; }
      if (y2 > yb) { yb = y2; yi = 2; }
      y_cur[j] = yb;
      yp[j] = yi;
    }
    m_prev.swap(m_cur);
    x_prev.swap(x_cur);
    y_prev.swap(y_cur);
  }
}

// OR little-endian run bits into a PRE-ZEROED packed buffer
// (np.packbits(..., bitorder="little") layout: bit (x & 7) of byte
// dest[y*stride + (x >> 3)]). Only ink bytes are touched — O(ink/8)
// instead of the full-page re-read np.packbits costs — so the skew
// upload pack (ops/skew_device.py) rides the run list stage 1 already
// exports. Rows are assumed in range (y < rows of dest).
void ta_pack_runs_into(const int32_t* runs, int64_t n, uint8_t* dest,
                       int64_t stride) {
  for (int64_t k = 0; k < n; ++k) {
    const int64_t y = runs[3 * k], xs = runs[3 * k + 1], xe = runs[3 * k + 2];
    uint8_t* row = dest + y * stride;
    const int64_t b0 = xs >> 3, b1 = (xe - 1) >> 3;
    if (b0 == b1) {
      row[b0] |= (uint8_t)((((1u << (xe - xs)) - 1u) << (xs & 7)) & 0xFFu);
    } else {
      row[b0] |= (uint8_t)(0xFFu << (xs & 7));
      if (b1 > b0 + 1) std::memset(row + b0 + 1, 0xFF, (size_t)(b1 - b0 - 1));
      row[b1] |= (uint8_t)(0xFFu >> (7 - ((xe - 1) & 7)));
    }
  }
}

// Run-domain erode2: the same two passes as ta_erode2 — vertical (keep a
// black px iff a vertical neighbor is black) then horizontal (keep iff a
// horizontal neighbor is black, i.e. drop length-1 runs) — evaluated as
// sorted-interval set algebra per row:
//   pass1[y] = runs[y] ∩ (runs[y-1] ∪ runs[y+1])
//   out[y]   = { pieces of pass1[y] with length >= 2 }
// Union intervals are coalesced, and distinct input runs are separated
// by >= 1 white px, so emitted pieces are maximal runs in row-major
// sorted order — identical to re-extracting runs from ta_erode2's page.
// proj (int64[H], zeroed here) receives the eroded per-row black counts
// (= ta_projection_rows of the eroded page). Returns the true output run
// count; only max_m rows written (caller retries on overflow).
int64_t ta_erode_runs(const int32_t* runs, int64_t n, int64_t H,
                      int32_t* out, int64_t max_m, int64_t* proj) {
  std::memset(proj, 0, sizeof(int64_t) * (size_t)H);
  std::vector<int64_t> rs(H + 1, 0);
  for (int64_t k = 0; k < n; ++k) rs[runs[3 * k] + 1]++;
  for (int64_t y = 0; y < H; ++y) rs[y + 1] += rs[y];
  std::vector<int64_t> us, ue;  // per-row union of neighbor rows
  int64_t m = 0;
  for (int64_t y = 0; y < H; ++y) {
    if (rs[y] == rs[y + 1]) continue;
    // union(runs[y-1], runs[y+1]) — two sorted disjoint lists -> merged
    us.clear();
    ue.clear();
    int64_t i = (y > 0) ? rs[y - 1] : 0;
    const int64_t iend = (y > 0) ? rs[y] : 0;
    int64_t j = (y + 1 < H) ? rs[y + 1] : n;
    const int64_t jend = (y + 1 < H) ? rs[y + 2] : n;
    while (i < iend || j < jend) {
      int64_t s, e;
      if (j >= jend || (i < iend && runs[3 * i + 1] <= runs[3 * j + 1])) {
        s = runs[3 * i + 1];
        e = runs[3 * i + 2];
        ++i;
      } else {
        s = runs[3 * j + 1];
        e = runs[3 * j + 2];
        ++j;
      }
      if (!ue.empty() && s <= ue.back()) {
        if (e > ue.back()) ue.back() = e;
      } else {
        us.push_back(s);
        ue.push_back(e);
      }
    }
    // intersect each run of row y with the union; keep pieces of len >= 2
    size_t u = 0;
    for (int64_t k = rs[y]; k < rs[y + 1]; ++k) {
      const int64_t xs = runs[3 * k + 1], xe = runs[3 * k + 2];
      while (u < ue.size() && ue[u] <= xs) ++u;
      for (size_t q = u; q < us.size() && us[q] < xe; ++q) {
        const int64_t s = us[q] > xs ? us[q] : xs;
        const int64_t e = ue[q] < xe ? ue[q] : xe;
        if (e - s >= 2) {
          if (m < max_m) {
            out[3 * m] = (int32_t)y;
            out[3 * m + 1] = (int32_t)s;
            out[3 * m + 2] = (int32_t)e;
          }
          ++m;
          proj[y] += e - s;
        }
      }
    }
  }
  return m;
}

// cc stats straight from a (row-major sorted, maximal) run list, with
// rows where row_mask[y] != 0 dropped — the run-domain twin of
// ta_cc_stats_masked, consuming ta_erode_runs/ta_rotate_runs2 output so
// the eroded page never materializes. table rows: uly lry ulx lrx area.
int32_t ta_cc_stats_from_runs(const int32_t* in_runs, int64_t n, int64_t H,
                              const uint8_t* row_mask, int64_t* table,
                              int32_t max_ccs) {
  std::vector<Run> runs;
  runs.reserve((size_t)n);
  for (int64_t k = 0; k < n; ++k) {
    const int32_t y = in_runs[3 * k];
    if (row_mask && row_mask[y]) continue;
    runs.push_back({y, in_runs[3 * k + 1], in_runs[3 * k + 2], -1});
  }
  std::vector<int64_t> row_start;
  UF uf;
  build_row_start(runs, H, row_start);
  link_runs(runs, row_start, H, uf);
  int32_t ncc = renumber_runs(runs, uf);
  std::vector<int64_t> uly(ncc + 1, INT64_MAX), lry(ncc + 1, -1),
      ulx(ncc + 1, INT64_MAX), lrx(ncc + 1, -1), area(ncc + 1, 0);
  for (const auto& r : runs) {
    int32_t l = r.prov;
    if (r.y < uly[l]) uly[l] = r.y;
    if (r.y > lry[l]) lry[l] = r.y;
    if (r.xs < ulx[l]) ulx[l] = r.xs;
    if (r.xe - 1 > lrx[l]) lrx[l] = r.xe - 1;
    area[l] += r.xe - r.xs;
  }
  const int32_t rows = ncc < max_ccs ? ncc : max_ccs;
  for (int32_t k = 1; k <= rows; ++k) {
    int64_t* r = table + (int64_t)(k - 1) * 5;
    r[0] = uly[k]; r[1] = lry[k]; r[2] = ulx[k]; r[3] = lrx[k]; r[4] = area[k];
  }
  return ncc;
}

int32_t ta_abi_version() { return 14; }

}  // extern "C"
