// Streaming decision-tree histogram (Ben-Haim & Tom-Tov, "A Streaming
// Parallel Decision Tree Algorithm", JMLR 11, 2010).
//
// A copy of the JAX package's native/streaming_histogram.cpp, built by
// transmogrifai_tpu_torch/utils/streaming_histogram.py with g++: a
// fixed-size histogram sketch supporting single-pass update, mergeability,
// interpolated cumulative sums and uniform-mass bin boundaries. The raw
// feature filter sketches each numeric column with it on the host.
//
// C ABI, bound with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Bin {
  double p;  // centroid position
  double m;  // mass
};

struct SHist {
  int max_bins;
  std::vector<Bin> bins;  // sorted by p
  double total = 0.0;
  double min_v = HUGE_VAL;
  double max_v = -HUGE_VAL;
};

// Merge the two adjacent bins with the smallest gap until <= max_bins remain.
void compress(SHist* h) {
  auto& b = h->bins;
  while (static_cast<int>(b.size()) > h->max_bins) {
    size_t best = 0;
    double best_gap = HUGE_VAL;
    for (size_t i = 0; i + 1 < b.size(); ++i) {
      double gap = b[i + 1].p - b[i].p;
      if (gap < best_gap) {
        best_gap = gap;
        best = i;
      }
    }
    double m = b[best].m + b[best + 1].m;
    b[best].p = (b[best].p * b[best].m + b[best + 1].p * b[best + 1].m) / m;
    b[best].m = m;
    b.erase(b.begin() + best + 1);
  }
}

void insert_point(SHist* h, double x, double w) {
  auto& b = h->bins;
  auto it = std::lower_bound(
      b.begin(), b.end(), x,
      [](const Bin& bin, double v) { return bin.p < v; });
  if (it != b.end() && it->p == x) {
    it->m += w;
  } else {
    b.insert(it, Bin{x, w});
  }
  h->total += w;
  h->min_v = std::min(h->min_v, x);
  h->max_v = std::max(h->max_v, x);
  compress(h);
}

}  // namespace

extern "C" {

SHist* sh_create(int max_bins) {
  auto* h = new SHist();
  h->max_bins = max_bins < 2 ? 2 : max_bins;
  h->bins.reserve(h->max_bins + 1);
  return h;
}

void sh_free(SHist* h) { delete h; }

void sh_update(SHist* h, const double* xs, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    double x = xs[i];
    if (!std::isnan(x)) insert_point(h, x, 1.0);
  }
}

void sh_update_weighted(SHist* h, const double* xs, const double* ws,
                        int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (!std::isnan(xs[i]) && ws[i] > 0) insert_point(h, xs[i], ws[i]);
  }
}

// Monoid merge (paper's Merge procedure): union of bins then compress.
void sh_merge(SHist* dst, const SHist* src) {
  std::vector<Bin> merged;
  merged.reserve(dst->bins.size() + src->bins.size());
  std::merge(dst->bins.begin(), dst->bins.end(), src->bins.begin(),
             src->bins.end(), std::back_inserter(merged),
             [](const Bin& a, const Bin& b) { return a.p < b.p; });
  // coalesce identical centroids
  std::vector<Bin> out;
  for (const Bin& bin : merged) {
    if (!out.empty() && out.back().p == bin.p) {
      out.back().m += bin.m;
    } else {
      out.push_back(bin);
    }
  }
  dst->bins = std::move(out);
  dst->total += src->total;
  dst->min_v = std::min(dst->min_v, src->min_v);
  dst->max_v = std::max(dst->max_v, src->max_v);
  compress(dst);
}

// Replace the sketch's whole state (checkpoint restore / host-normalized
// merge write-back). Bins must arrive sorted by centroid; compress() keeps
// the max_bins invariant if the caller hands more.
void sh_load(SHist* h, const double* centers, const double* masses, int64_t n,
             double total, double min_v, double max_v) {
  h->bins.clear();
  h->bins.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) h->bins.push_back(Bin{centers[i], masses[i]});
  h->total = total;
  h->min_v = min_v;
  h->max_v = max_v;
  compress(h);
}

int64_t sh_num_bins(const SHist* h) {
  return static_cast<int64_t>(h->bins.size());
}

double sh_total(const SHist* h) { return h->total; }
double sh_min(const SHist* h) { return h->min_v; }
double sh_max(const SHist* h) { return h->max_v; }

void sh_get_bins(const SHist* h, double* centers, double* masses) {
  for (size_t i = 0; i < h->bins.size(); ++i) {
    centers[i] = h->bins[i].p;
    masses[i] = h->bins[i].m;
  }
}

// Paper's Sum procedure: estimated number of points <= b (trapezoid
// interpolation between adjacent centroids).
double sh_sum(const SHist* h, double b) {
  const auto& bins = h->bins;
  if (bins.empty()) return 0.0;
  if (b >= bins.back().p) {
    double s = h->total - bins.back().m / 2.0;
    // beyond the last centroid, ramp the last half-bin up to max
    if (h->max_v > bins.back().p && b < h->max_v) {
      double frac = (b - bins.back().p) / (h->max_v - bins.back().p);
      return s + bins.back().m / 2.0 * frac;
    }
    return h->total;
  }
  if (b < bins.front().p) {
    if (h->min_v < bins.front().p && b >= h->min_v) {
      double frac = (b - h->min_v) / (bins.front().p - h->min_v);
      return bins.front().m / 2.0 * frac;
    }
    return 0.0;
  }
  size_t i = 0;
  while (i + 1 < bins.size() && bins[i + 1].p <= b) ++i;
  // s(b) = sum_{j<i} m_j + m_i/2 + (m_i + m_b)/2 * (b-p_i)/(p_{i+1}-p_i)
  double s = 0.0;
  for (size_t j = 0; j < i; ++j) s += bins[j].m;
  s += bins[i].m / 2.0;
  if (i + 1 < bins.size() && bins[i + 1].p > bins[i].p) {
    double pi = bins[i].p, pj = bins[i + 1].p;
    double mi = bins[i].m, mj = bins[i + 1].m;
    double frac = (b - pi) / (pj - pi);
    double mb = mi + (mj - mi) * frac;
    s += (mi + mb) / 2.0 * frac;
  }
  return s;
}

// Paper's Uniform procedure: B-1 interior boundaries splitting mass evenly.
void sh_uniform(const SHist* h, int num_bins, double* boundaries) {
  double step = h->total / num_bins;
  int out = 0;
  for (int k = 1; k < num_bins; ++k) {
    double target = step * k;
    // binary search over sh_sum via centroid positions
    double lo = h->min_v, hi = h->max_v;
    for (int it = 0; it < 60; ++it) {
      double mid = (lo + hi) / 2.0;
      if (sh_sum(h, mid) < target) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    boundaries[out++] = (lo + hi) / 2.0;
  }
}

}  // extern "C"
