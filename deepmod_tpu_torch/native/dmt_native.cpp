// deepmod_tpu native host-side kernels.
//
// The reference leans on external C binaries (minimap2/bwa, samtools) and
// TF's C++ runtime for everything fast (SURVEY.md section 2b); this library
// provides the framework's own native implementations of the host-side hot
// loops that feed the TPU:
//
//   - per-event signal statistics replicating the reference's
//     round(np.mean/np.std, 3) arithmetic bit-for-bit (numpy pairwise
//     summation order + scalar-__round__ semantics), matching
//     deepmod_tpu.io.signal_norm.event_mean_std;
//   - median/MAD signal normalization with 5xMAD winsorize + round-3
//     (myDetect.py:266-282 semantics);
//   - banded edit-distance alignment with traceback (the built-in
//     aligner's inter-anchor stitching, same cost model as
//     deepmod_tpu.align.dp.global_align_ops);
//   - (k, w) minimizer extraction with the same splitmix64 hashing as
//     deepmod_tpu.align.minimizer.
//
// C ABI only; loaded via ctypes (deepmod_tpu.native.lib).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

// numpy's pairwise-summation order for a contiguous float64 add.reduce:
// sequential under 8 elements, 8 scalar accumulators up to the 128-element
// block size, recursive halving (split rounded down to a multiple of 8)
// above. This is the published Higham/numpy blocked pairwise algorithm;
// verified bit-exact against this image's numpy for every n in 1..700
// (tests/test_native.py pins it transitively through event_mean_std).
static double np_pairwise_sum(const double* a, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r0 = a[0], r1 = a[1], r2 = a[2], r3 = a[3];
    double r4 = a[4], r5 = a[5], r6 = a[6], r7 = a[7];
    int64_t i = 8;
    for (; i + 8 <= n; i += 8) {
      r0 += a[i + 0]; r1 += a[i + 1]; r2 += a[i + 2]; r3 += a[i + 3];
      r4 += a[i + 4]; r5 += a[i + 5]; r6 += a[i + 6]; r7 += a[i + 7];
    }
    double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return np_pairwise_sum(a, n2) + np_pairwise_sum(a + n2, n - n2);
}

// round(np.float64 x, 3): numpy scalar __round__ is scale-rint-unscale
// (NOT python float's correctly-rounded decimal); rint under the default
// FE_TONEAREST mode is the half-even rounding numpy uses.
static inline double np_round3(double x) {
  return std::rint(x * 1000.0) / 1000.0;
}

// The reference's per-event statistics (myDetect.py:342-343), operation
// for operation: float32 of round(np.mean(seg), 3) / round(np.std(seg), 3)
// with np.std's exact sequence (numpy _methods._var: arrmean = sum/n;
// x = seg - arrmean; var = sum(x*x)/n; sqrt). `scratch` must hold cnt
// doubles.
static void ref_event_stat(const double* seg, int64_t cnt, double* scratch,
                           float* mean_out, float* std_out) {
  const double arrmean = np_pairwise_sum(seg, cnt) / (double)cnt;
  *mean_out = (float)np_round3(arrmean);
  for (int64_t j = 0; j < cnt; ++j) {
    const double d = seg[j] - arrmean;
    scratch[j] = d * d;
  }
  const double var = np_pairwise_sum(scratch, cnt) / (double)cnt;
  *std_out = (float)np_round3(std::sqrt(var));
}

extern "C" {

// ---------------------------------------------------------------------------
// Event statistics: means/stds over [start, start+length) slices of the
// (already normalized, round-3) signal, replicating the reference's
// round(np.mean/np.std, 3) arithmetic bit-for-bit (see ref_event_stat).
// Returns number of valid events (may truncate like the python path), or
// -1 when an empty slice occurs at index <= 500 ("Less event").
int dmt_event_stats(const double* signal, int64_t n_signal,
                    const uint64_t* starts, const uint64_t* lengths,
                    int64_t n_events, float* means_out, float* stds_out) {
  // clamp to [0, n_signal]: a corrupt start wraps negative through the
  // int64 cast and must not index out of bounds
  int64_t n_valid = n_events;
  int64_t max_cnt = 0;
  for (int64_t i = 0; i < n_events; ++i) {
    int64_t s = std::max<int64_t>(
        std::min<int64_t>((int64_t)starts[i], n_signal), 0);
    int64_t e = std::max<int64_t>(
        std::min<int64_t>((int64_t)(starts[i] + lengths[i]), n_signal), 0);
    if (e <= s) {
      if (i > 500) {
        n_valid = i - 1;  // truncate (myDetect.py:337-339)
        break;
      }
      return -1;  // "Less event"
    }
    if (e - s > max_cnt) max_cnt = e - s;
  }
  std::vector<double> scratch(max_cnt);
  for (int64_t i = 0; i < n_valid; ++i) {
    const int64_t s = std::max<int64_t>(
        std::min<int64_t>((int64_t)starts[i], n_signal), 0);
    const int64_t e = std::max<int64_t>(
        std::min<int64_t>((int64_t)(starts[i] + lengths[i]), n_signal), 0);
    ref_event_stat(signal + s, e - s, scratch.data(),
                   &means_out[i], &stds_out[i]);
  }
  return (int)n_valid;
}

// ---------------------------------------------------------------------------
// Median/MAD normalization (myDetect.py:266-282): statistics over
// [span_start, span_end), transform whole array, winsorize at 5xMAD,
// round to 3 decimals. In-place on `signal`.
static double median_of(std::vector<double>& v) {
  const size_t n = v.size();
  if (n == 0) return 0.0;
  const size_t mid = n / 2;
  std::nth_element(v.begin(), v.begin() + mid, v.end());
  double hi = v[mid];
  if (n % 2 == 1) return hi;
  std::nth_element(v.begin(), v.begin() + mid - 1, v.begin() + mid);
  return 0.5 * (v[mid - 1] + hi);
}

// Fast path for the normalization statistics. Raw fast5 signals are int16
// DAC values widened to double, so the two pre-normalization selections
// (median, then median absolute deviation) reduce to one histogram fill
// plus O(range) walks instead of four O(n) nth_element passes. The two
// POST-normalization statistics are then analytically exact:
//   med(y) == 0.0 bitwise: order statistics commute with the monotone map
//     y = fl(fl(x - shift)/scale); for odd spans the median element is
//     x == shift -> 0/scale == 0.0, and for even spans the two middle
//     y values are exact negations of each other (IEEE subtraction and
//     division are symmetric under negation), so 0.5*(a + (-a)) == 0.0.
//   mad(y) == the |x-shift| order statistics pushed through fl(b/scale)
//     (|fl(z)| == fl(|z|) by rounding symmetry; fl(b/scale) is monotone
//     non-decreasing in b), i.e. fl(b_mid/scale) for odd spans (== 1.0,
//     since b_mid == scale) and 0.5*(fl(b_lo/scale) + fl(b_hi/scale))
//     for even spans.
// Returns false (caller must run the literal pass-for-pass legacy path)
// when the span is empty/non-integer/too wide or the scale is degenerate.
struct NormStats {
  double shift, scale, lo, hi;
};

// Histogram selection for integer-valued spans: fills (shift, b_lo, b_hi)
// where b_lo/b_hi are the mid-1/mid order statistics of |x - shift|
// (b_lo only set for even spans). Returns false for non-integer data or
// ranges too wide to bin.
static bool int_hist_select(const double* s, int64_t m, double* shift_out,
                            double* b_lo_out, double* b_hi_out) {
  double mn = s[0], mx = s[0];
  for (int64_t i = 0; i < m; ++i) {
    const double v = s[i];
    if (!std::isfinite(v) || v != std::floor(v)) return false;
    if (v < mn) mn = v;
    if (v > mx) mx = v;
  }
  if (mx - mn > (double)(1 << 20)) return false;
  const int64_t base = (int64_t)mn;
  const int64_t range = (int64_t)mx - base + 1;
  std::vector<int32_t> cnt(range, 0);
  for (int64_t i = 0; i < m; ++i) ++cnt[(int64_t)s[i] - base];

  // order statistics mid-1 (even spans) and mid of x
  const int64_t mid = m / 2;
  const bool even = (m % 2) == 0;
  int64_t acc = 0, lo_v = -1, hi_v = -1;
  for (int64_t b = 0; b < range; ++b) {
    acc += cnt[b];
    if (lo_v < 0 && even && acc >= mid) lo_v = b;
    if (acc >= mid + 1) { hi_v = b; break; }
  }
  const double shift =
      even ? 0.5 * ((double)(lo_v + base) + (double)(hi_v + base))
           : (double)(hi_v + base);

  // order statistics mid-1/mid of |x - shift| via an outward walk from
  // the shift. shift is integral or half-integral; both give exact
  // distance values.
  double b_lo = -1.0, b_hi = -1.0;
  acc = 0;
  const bool half = shift != std::floor(shift);
  const int64_t c = (int64_t)std::floor(shift) - base;  // center bin
  for (int64_t d = 0; b_hi < 0.0; ++d) {
    int64_t group;
    double dist;
    if (half) {
      const int64_t l = c - d, r = c + 1 + d;
      group = (l >= 0 && l < range ? cnt[l] : 0) +
              (r >= 0 && r < range ? cnt[r] : 0);
      dist = (double)d + 0.5;
    } else if (d == 0) {
      group = (c >= 0 && c < range) ? cnt[c] : 0;
      dist = 0.0;
    } else {
      const int64_t l = c - d, r = c + d;
      group = (l >= 0 && l < range ? cnt[l] : 0) +
              (r >= 0 && r < range ? cnt[r] : 0);
      dist = (double)d;
    }
    acc += group;
    if (b_lo < 0.0 && even && acc >= mid) b_lo = dist;
    if (acc >= mid + 1) b_hi = dist;
    if (d > range) return false;  // unreachable; guards the loop
  }
  *shift_out = shift;
  *b_lo_out = b_lo;
  *b_hi_out = b_hi;
  return true;
}

// nth_element selection for arbitrary finite spans: same outputs as
// int_hist_select. Two selections (median of x, then median of
// |x - shift|) instead of the legacy path's four.
static bool float_select(const double* s, int64_t m, double* shift_out,
                         double* b_lo_out, double* b_hi_out) {
  for (int64_t i = 0; i < m; ++i)
    if (!std::isfinite(s[i])) return false;
  const int64_t mid = m / 2;
  const bool even = (m % 2) == 0;
  std::vector<double> v(s, s + m);
  std::nth_element(v.begin(), v.begin() + mid, v.end());
  const double x_b = v[mid];
  double x_a = x_b;
  if (even) {
    std::nth_element(v.begin(), v.begin() + mid - 1, v.begin() + mid);
    x_a = v[mid - 1];
  }
  double shift;
  if (even) {
    // the analytic med/mad shortcut needs the two middle values'
    // midpoint to be an EXACT sum (TwoSum error == 0); otherwise the
    // normalized span's median is not exactly 0 and the legacy path
    // must run
    const double sum = x_a + x_b;
    const double ap = sum - x_b, bp = sum - ap;
    if ((x_a - ap) + (x_b - bp) != 0.0) return false;
    shift = 0.5 * sum;
  } else {
    shift = x_b;
  }
  for (int64_t i = 0; i < m; ++i) v[i] = std::fabs(s[i] - shift);
  std::nth_element(v.begin(), v.begin() + mid, v.end());
  *b_hi_out = v[mid];
  *b_lo_out = -1.0;
  if (even) {
    std::nth_element(v.begin(), v.begin() + mid - 1, v.begin() + mid);
    *b_lo_out = v[mid - 1];
  }
  *shift_out = shift;
  return true;
}

static bool fast_norm_stats(const double* x, int64_t span_start,
                            int64_t span_end, NormStats* out) {
  const int64_t m = span_end - span_start;
  if (m <= 0) return false;
  const double* s = x + span_start;
  double shift, b_lo, b_hi;
  if (!int_hist_select(s, m, &shift, &b_lo, &b_hi) &&
      !float_select(s, m, &shift, &b_lo, &b_hi))
    return false;
  const bool even = (m % 2) == 0;
  const double scale = even ? 0.5 * (b_lo + b_hi) : b_hi;
  if (!(scale > 0.0) || !std::isfinite(scale)) return false;
  const double mad =
      even ? 0.5 * (b_lo / scale + b_hi / scale) : b_hi / scale;
  out->shift = shift;
  out->scale = scale;
  // med(y) == 0.0 exactly; replicate `med - mad*5` / `med + mad*5`
  out->lo = 0.0 - mad * 5;
  out->hi = 0.0 + mad * 5;
  return true;
}

void dmt_normalize_signal(double* signal, int64_t n, int64_t span_start,
                          int64_t span_end) {
  NormStats st;
  if (fast_norm_stats(signal, span_start, span_end, &st)) {
    for (int64_t i = 0; i < n; ++i) {
      double v = (signal[i] - st.shift) / st.scale;
      if (v < st.lo) v = st.lo;
      else if (v > st.hi) v = st.hi;
      const double r = std::nearbyint(v * 1000.0);  // half-even
      signal[i] = r / 1000.0;
    }
    return;
  }
  std::vector<double> span(signal + span_start, signal + span_end);
  const double shift = median_of(span);
  for (auto& v : span) v = std::fabs(v - shift);
  const double scale = median_of(span);
  for (int64_t i = 0; i < n; ++i) signal[i] = (signal[i] - shift) / scale;
  span.assign(signal + span_start, signal + span_end);
  const double med = median_of(span);
  for (auto& v : span) v = std::fabs(v - med);
  const double mad = median_of(span);
  const double lo = med - mad * 5, hi = med + mad * 5;
  for (int64_t i = 0; i < n; ++i) {
    double v = signal[i];
    if (v < lo) v = lo;
    else if (v > hi) v = hi;
    // numpy round-half-even at 3 decimals
    const double scaled = v * 1000.0;
    double r = std::nearbyint(scaled);  // assumes FE_TONEAREST (half-even)
    signal[i] = r / 1000.0;
  }
}

// ---------------------------------------------------------------------------
// Fused normalization + event statistics: one call per read instead of a
// normalize pass plus a separate per-event stats pass. The normalization
// is operation-for-operation dmt_normalize_signal (the rounded float64
// signal is produced in place — downstream consumers read it); the
// per-event moments then replicate the reference's round(np.mean/np.std)
// arithmetic bit-for-bit over that normalized buffer (ref_event_stat).
// Returns n_valid (possibly truncated), or -1 for the "Less event"
// rejection. The signal is normalized in place in every case.
int64_t dmt_normalize_event_stats(double* signal, int64_t n,
                                  int64_t span_start, int64_t span_end,
                                  const uint64_t* starts,
                                  const uint64_t* lengths, int64_t n_events,
                                  float* means_out, float* stds_out) {
  NormStats st;
  if (fast_norm_stats(signal, span_start, span_end, &st)) {
    for (int64_t i = 0; i < n; ++i) {
      double v = (signal[i] - st.shift) / st.scale;
      if (v < st.lo) v = st.lo;
      else if (v > st.hi) v = st.hi;
      signal[i] = std::nearbyint(v * 1000.0) / 1000.0;  // half-even
    }
  } else {
    std::vector<double> span(signal + span_start, signal + span_end);
    const double shift = median_of(span);
    for (auto& v : span) v = std::fabs(v - shift);
    const double scale = median_of(span);
    for (int64_t i = 0; i < n; ++i) signal[i] = (signal[i] - shift) / scale;
    span.assign(signal + span_start, signal + span_end);
    const double med = median_of(span);
    for (auto& v : span) v = std::fabs(v - med);
    const double mad = median_of(span);
    const double lo = med - mad * 5, hi = med + mad * 5;
    for (int64_t i = 0; i < n; ++i) {
      double v = signal[i];
      if (v < lo) v = lo;
      else if (v > hi) v = hi;
      // half-even, FE_TONEAREST
      signal[i] = std::nearbyint(v * 1000.0) / 1000.0;
    }
  }
  // clamp to [0, n]: a corrupt start wraps negative through the int64
  // cast and must not index out of bounds
  int64_t n_valid = n_events;
  int64_t max_cnt = 0;
  for (int64_t i = 0; i < n_events; ++i) {
    const int64_t s = std::max<int64_t>(
        std::min<int64_t>((int64_t)starts[i], n), 0);
    const int64_t e = std::max<int64_t>(
        std::min<int64_t>((int64_t)(starts[i] + lengths[i]), n), 0);
    if (e <= s) {
      if (i > 500) {
        n_valid = i - 1;  // truncate (myDetect.py:337-339)
        break;
      }
      return -1;  // "Less event"
    }
    if (e - s > max_cnt) max_cnt = e - s;
  }
  std::vector<double> scratch(max_cnt);
  for (int64_t i = 0; i < n_valid; ++i) {
    const int64_t s = std::max<int64_t>(
        std::min<int64_t>((int64_t)starts[i], n), 0);
    const int64_t e = std::max<int64_t>(
        std::min<int64_t>((int64_t)(starts[i] + lengths[i]), n), 0);
    ref_event_stat(signal + s, e - s, scratch.data(),
                   &means_out[i], &stds_out[i]);
  }
  return n_valid;
}

// ---------------------------------------------------------------------------
// Global edit-distance alignment with traceback (cost model of
// deepmod_tpu.align.dp: mismatch=1, gap=1; diagonal preferred).
// ops_out receives a char per aligned column ('M','I','D'); returns the
// number of ops, or -1 if ops_cap is too small.
int dmt_global_align(const char* a, int na, const char* b, int nb,
                     char* ops_out, int ops_cap) {
  if (na == 0 && nb == 0) return 0;
  if ((na + nb) > ops_cap) return -1;
  if (na == 0) { memset(ops_out, 'D', nb); return nb; }
  if (nb == 0) { memset(ops_out, 'I', na); return na; }
  std::vector<int32_t> dp((size_t)(na + 1) * (nb + 1));
  const int stride = nb + 1;
  for (int j = 0; j <= nb; ++j) dp[j] = j;
  for (int i = 1; i <= na; ++i) {
    dp[(size_t)i * stride] = i;
    const char ai = a[i - 1];
    int32_t* cur = &dp[(size_t)i * stride];
    const int32_t* prev = &dp[(size_t)(i - 1) * stride];
    for (int j = 1; j <= nb; ++j) {
      int32_t best = prev[j - 1] + (b[j - 1] != ai);
      const int32_t up = prev[j] + 1;
      if (up < best) best = up;
      const int32_t left = cur[j - 1] + 1;
      if (left < best) best = left;
      cur[j] = best;
    }
  }
  // traceback into the tail of ops_out, then shift to the front
  int pos = ops_cap;
  int i = na, j = nb;
  while (i > 0 && j > 0) {
    const int32_t sub = dp[(size_t)(i - 1) * stride + (j - 1)] + (a[i - 1] != b[j - 1]);
    if (dp[(size_t)i * stride + j] == sub) {
      ops_out[--pos] = 'M'; --i; --j;
    } else if (dp[(size_t)i * stride + j] == dp[(size_t)(i - 1) * stride + j] + 1) {
      ops_out[--pos] = 'I'; --i;
    } else {
      ops_out[--pos] = 'D'; --j;
    }
  }
  while (i > 0) { ops_out[--pos] = 'I'; --i; }
  while (j > 0) { ops_out[--pos] = 'D'; --j; }
  const int len = ops_cap - pos;
  memmove(ops_out, ops_out + pos, len);
  return len;
}

// Batched gap alignment: all inter-anchor segments of one read in a single
// call (the per-call ctypes marshalling dominates at ~18 segments/read).
// Segment i aligns q[q_starts[i]:q_ends[i]] vs r[r_starts[i]:r_ends[i]];
// ops are written back-to-back into ops_out with per-segment lengths in
// seg_lens. Returns total ops or -1 on overflow.
int64_t dmt_global_align_multi(const char* q, const char* r,
                               const int64_t* q_starts, const int64_t* q_ends,
                               const int64_t* r_starts, const int64_t* r_ends,
                               int64_t n_seg, char* ops_out, int64_t ops_cap,
                               int64_t* seg_lens) {
  int64_t off = 0;
  for (int64_t s = 0; s < n_seg; ++s) {
    const int na = (int)(q_ends[s] - q_starts[s]);
    const int nb = (int)(r_ends[s] - r_starts[s]);
    const int len = dmt_global_align(q + q_starts[s], na, r + r_starts[s], nb,
                                     ops_out + off, (int)(ops_cap - off));
    if (len < 0) return -1;
    seg_lens[s] = len;
    off += len;
  }
  return off;
}

// ---------------------------------------------------------------------------
// Diagonal-band anchor chaining (align.minimizer._best_chain semantics for
// one reference sequence): histogram diagonals into `band`-wide bins
// (floor division), select the densest bin +-1 (ties -> smallest bin, like
// np.argmax over sorted unique bins), report the strongest non-adjacent
// 3-bin group as `second`, then greedily keep anchors with strictly
// increasing (q, r) scanned in stable q order. Returns the kept count.
int64_t dmt_chain_band(const int64_t* qpos, const int64_t* rpos, int64_t n,
                       int64_t band, int64_t* keep_q, int64_t* keep_r,
                       int64_t* second_out) {
  *second_out = 0;
  if (n == 0) return 0;
  std::vector<int64_t> bins(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t diag = rpos[i] - qpos[i];
    // floor division (numpy // semantics for negatives)
    int64_t b = diag / band;
    if ((diag % band != 0) && ((diag < 0) != (band < 0))) --b;
    bins[i] = b;
  }
  std::vector<int64_t> uniq(bins);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  std::vector<int64_t> counts(uniq.size(), 0);
  for (int64_t i = 0; i < n; ++i) {
    const size_t idx =
        std::lower_bound(uniq.begin(), uniq.end(), bins[i]) - uniq.begin();
    ++counts[idx];
  }
  size_t top_idx = 0;
  for (size_t i = 1; i < uniq.size(); ++i)
    if (counts[i] > counts[top_idx]) top_idx = i;
  const int64_t top = uniq[top_idx];
  auto count_of = [&](int64_t b) -> int64_t {
    const size_t idx =
        std::lower_bound(uniq.begin(), uniq.end(), b) - uniq.begin();
    return (idx < uniq.size() && uniq[idx] == b) ? counts[idx] : 0;
  };
  int64_t second = 0;
  for (size_t i = 0; i < uniq.size(); ++i) {
    const int64_t b = uniq[i];
    if (b >= top - 1 && b <= top + 1) continue;
    const int64_t group = count_of(b - 1) + count_of(b) + count_of(b + 1);
    if (group > second) second = group;
  }
  *second_out = second;
  // anchors in the selected band, stable-sorted by q
  std::vector<int64_t> sel;
  sel.reserve(n);
  for (int64_t i = 0; i < n; ++i)
    if (bins[i] >= top - 1 && bins[i] <= top + 1) sel.push_back(i);
  std::stable_sort(sel.begin(), sel.end(), [&](int64_t a, int64_t b2) {
    return qpos[a] < qpos[b2];
  });
  int64_t kept = 0;
  int64_t last_q = -1, last_r = -1;
  for (const int64_t i : sel) {
    if (rpos[i] > last_r && qpos[i] > last_q) {
      keep_q[kept] = qpos[i];
      keep_r[kept] = rpos[i];
      ++kept;
      last_q = qpos[i];
      last_r = rpos[i];
    }
  }
  return kept;
}

// ---------------------------------------------------------------------------
// Minimizers: (k, w) with splitmix64-mixed 2-bit k-mer codes, identical to
// deepmod_tpu.align.minimizer. Returns count; positions/hashes arrays must
// hold at least n entries.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

int64_t dmt_minimizers(const char* seq, int64_t n, int k, int w,
                       int64_t* pos_out, uint64_t* hash_out) {
  static const uint64_t BAD = ~0ULL;
  const int64_t nk = n - k + 1;
  if (nk <= 0) return 0;
  static int8_t code_tab[256];
  static bool init = false;
  if (!init) {
    memset(code_tab, -1, sizeof(code_tab));
    code_tab[(int)'A'] = 0; code_tab[(int)'a'] = 0;
    code_tab[(int)'C'] = 1; code_tab[(int)'c'] = 1;
    code_tab[(int)'G'] = 2; code_tab[(int)'g'] = 2;
    code_tab[(int)'T'] = 3; code_tab[(int)'t'] = 3;
    init = true;
  }
  std::vector<uint64_t> hashes(nk);
  uint64_t kmer = 0;
  int valid_run = 0;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  for (int64_t i = 0; i < n; ++i) {
    const int8_t c = code_tab[(uint8_t)seq[i]];
    if (c < 0) { valid_run = 0; kmer = 0; }
    else { kmer = ((kmer << 2) | (uint64_t)c) & mask; ++valid_run; }
    if (i >= k - 1) {
      hashes[i - k + 1] = (valid_run >= k) ? splitmix64(kmer) : BAD;
    }
  }
  int64_t count = 0;
  if (nk <= w) {
    int64_t best = 0;
    for (int64_t i = 1; i < nk; ++i)
      if (hashes[i] < hashes[best]) best = i;
    if (hashes[best] != BAD) { pos_out[count] = best; hash_out[count++] = hashes[best]; }
    return count;
  }
  // sliding-window minima via monotonic deque
  std::vector<int64_t> deque(nk);
  int64_t head = 0, tail = 0;
  int64_t last_taken = -1;
  for (int64_t i = 0; i < nk; ++i) {
    while (tail > head && hashes[deque[tail - 1]] > hashes[i]) --tail;
    deque[tail++] = i;
    const int64_t win_start = i - w + 1;
    if (win_start < 0) continue;
    while (deque[head] < win_start) ++head;
    const int64_t m = deque[head];
    if (m != last_taken && hashes[m] != BAD) {
      pos_out[count] = m;
      hash_out[count++] = hashes[m];
      last_taken = m;
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Open-addressing hash table for minimizer lookup: O(1) per query with 1-2
// cache misses, vs numpy searchsorted's O(log n) with a miss per level
// (which dominates the aligner on large genomes). Keys are already
// splitmix64-mixed, so `key & mask` distributes well; linear probing.
// The table is three numpy-owned arrays (keys / offsets into the sorted
// hit arrays / counts); empty slots have count 0 (real counts are >= 1).
// `cap` must be a power of two with cap > m.
int dmt_hash_build(const uint64_t* uniq, const int64_t* lefts,
                   const int32_t* cnts, int64_t m,
                   uint64_t* tkeys, int64_t* toffs, int32_t* tcnts,
                   int64_t cap) {
  const uint64_t mask = (uint64_t)cap - 1;
  for (int64_t i = 0; i < m; ++i) {
    uint64_t h = uniq[i] & mask;
    while (tcnts[h] != 0) h = (h + 1) & mask;
    tkeys[h] = uniq[i];
    toffs[h] = lefts[i];
    tcnts[h] = cnts[i];
  }
  return 0;
}

// For each query hash, emit up to max_hits (query_idx, source_row) pairs
// where source_row indexes the index's sorted (_rids, _positions) arrays
// — identical output order to the searchsorted path (first max_hits rows
// of each hash's run). Pass null outputs to COUNT only (the caller sizes
// exact result arrays from that instead of a nq*max_hits worst case,
// which would be ~200 MB for a 1 Mb read).
int64_t dmt_hash_lookup(const uint64_t* tkeys, const int64_t* toffs,
                        const int32_t* tcnts, int64_t cap,
                        const uint64_t* queries, int64_t nq,
                        int64_t max_hits,
                        int64_t* qidx_out, int64_t* src_out) {
  const uint64_t mask = (uint64_t)cap - 1;
  int64_t total = 0;
  const bool fill = qidx_out != 0;
  for (int64_t i = 0; i < nq; ++i) {
    const uint64_t q = queries[i];
    uint64_t h = q & mask;
    while (tcnts[h] != 0) {
      if (tkeys[h] == q) {
        int64_t c = tcnts[h];
        if (c > max_hits) c = max_hits;
        if (fill) {
          const int64_t off = toffs[h];
          for (int64_t j = 0; j < c; ++j) {
            qidx_out[total] = i;
            src_out[total] = off + j;
            ++total;
          }
        } else {
          total += c;
        }
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// %.3f text formatting of a row-major matrix, byte-identical to
// np.savetxt(fmt='%.3f') (space delimiter, '\n' after every row) — the
// reference feature-file format (myGetFeatureBasedPos.py:123). Most
// values are exact milli multiples (round-3 means/stdvs, integer
// positions/labels), formatted via integer math; anything else falls
// back to snprintf, which glibc rounds correctly like python. Returns
// bytes written or -1 when the buffer is too small.
static inline int64_t format_f3_one(double v, char* p) {
  const double scaled = v * 1000.0;
  const long long m = llround(scaled);
  if (fabs(scaled - (double)m) < 1e-6 && fabs(scaled) < 9.0e15 &&
      !(m == 0 && std::signbit(v))) {  // "-0.000" must keep its sign
    char* q = p;
    unsigned long long um = m < 0 ? (unsigned long long)(-m) : (unsigned long long)m;
    if (m < 0) *q++ = '-';
    const unsigned long long ip = um / 1000ULL;
    const unsigned fr = (unsigned)(um % 1000ULL);
    char tmp[24];
    int ti = 0;
    unsigned long long x = ip;
    do { tmp[ti++] = (char)('0' + (x % 10ULL)); x /= 10ULL; } while (x);
    while (ti) *q++ = tmp[--ti];
    *q++ = '.';
    *q++ = (char)('0' + fr / 100);
    *q++ = (char)('0' + (fr / 10) % 10);
    *q++ = (char)('0' + fr % 10);
    return q - p;
  }
  return snprintf(p, 40, "%.3f", v);
}

int64_t dmt_format_matrix_f3(const double* data, int64_t rows, int64_t cols,
                             char* out, int64_t cap) {
  int64_t off = 0;
  const int64_t n = rows * cols;
  for (int64_t i = 0; i < n; ++i) {
    if (cap - off < 48) return -1;
    off += format_f3_one(data[i], out + off);
    out[off++] = ((i + 1) % cols == 0) ? '\n' : ' ';
  }
  return off;
}

// CpG indel canonicalization (myDetect.py:680-700): the full sequential
// scan of the reference — each swap is visible to later positions.
// Codes are ASCII bytes; '-' marks a read gap.
void dmt_cpg_swap(uint8_t* ref, uint8_t* rd, int64_t n) {
  const uint8_t C = 'C', G = 'G', DASH = '-';
  for (int64_t i = 0; i < n; ++i) {
    if (ref[i] == C && rd[i] == C) {
      if (i + 1 < n && rd[i + 1] == DASH && ref[i + 1] == G) {
        int64_t add = 2;
        while (i + add < n && rd[i + add] == DASH && ref[i + add] == G) ++add;
        if (i + add < n && rd[i + add] == G && ref[i + add] == G) {
          uint8_t t = rd[i + 1];
          rd[i + 1] = rd[i + add];
          rd[i + add] = t;
        }
      }
    }
    if (ref[i] == G && rd[i] == G) {
      if (i - 1 > -1 && rd[i - 1] == DASH && ref[i - 1] == C) {
        int64_t add = 2;
        while (i - add > -1 && rd[i - add] == DASH && ref[i - add] == C) ++add;
        if (i - add > -1 && rd[i - add] == C && ref[i - add] == C) {
          uint8_t t = rd[i - 1];
          rd[i - 1] = rd[i - add];
          rd[i - add] = t;
        }
      }
    }
  }
}

}  // extern "C"
