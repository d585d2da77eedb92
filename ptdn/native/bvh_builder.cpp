// Native SAH BVH builder — C++ twin of ptdn/scene/bvh.py.
//
// Same semantics as the reference builder (reference src/bvhtree.cpp:21-182)
// and bit-identical output to the Python/NumPy builder (tests assert this):
// 9-bucket SAH on the longest centroid axis, MaxPrimsInNode=10, the
// zero-left-box union quirk (boundingbox.h:36-50), STABLE partition (the
// reference's std::partition is unstable; both of our builders pick the
// stable order so trees are reproducible), preorder DFS flatten with
// left-child = i+1.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kMaxPrims = 10;
constexpr int kBuckets = 9;

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 mn{0, 0, 0}, mx{0, 0, 0};
  bool is_zero() const {
    return mn.x == 0 && mn.y == 0 && mn.z == 0 && mx.x == 0 && mx.y == 0 &&
           mx.z == 0;
  }
  // reference operator||: left zero-box is "empty" (boundingbox.h:36-50)
  Box union_quirk(const Box &b) const {
    if (is_zero()) return b;
    return {vmin(mn, b.mn), vmax(mx, b.mx)};
  }
  double area() const {
    double dx = double(mx.x) - mn.x, dy = double(mx.y) - mn.y,
           dz = double(mx.z) - mn.z;
    return 2.0 * (dx * dy + dx * dz + dy * dz);
  }
};

struct Builder {
  const float *tmin, *tmax;
  std::vector<int64_t> perm;
  std::vector<Vec3> cmin_, cmax_, centroid;
  // flat node arrays (preorder)
  std::vector<float> nmin, nmax;
  std::vector<int32_t> count, axis, poff;
  std::vector<int32_t> rchild;
  std::vector<int64_t> order;

  Vec3 pmin(int64_t i) const { return {tmin[3 * i], tmin[3 * i + 1], tmin[3 * i + 2]}; }
  Vec3 pmax(int64_t i) const { return {tmax[3 * i], tmax[3 * i + 1], tmax[3 * i + 2]}; }
  Vec3 cent(int64_t i) const {
    Vec3 a = pmin(i), b = pmax(i);
    return {0.5f * (a.x + b.x), 0.5f * (a.y + b.y), 0.5f * (a.z + b.z)};
  }

  int emit(const Vec3 &mn, const Vec3 &mx, int cnt, int ax, int off) {
    int idx = int(count.size());
    nmin.insert(nmin.end(), {mn.x, mn.y, mn.z});
    nmax.insert(nmax.end(), {mx.x, mx.y, mx.z});
    count.push_back(cnt);
    axis.push_back(ax);
    poff.push_back(off);
    rchild.push_back(-1);
    return idx;
  }

  int make_leaf(int64_t start, int64_t end, const Vec3 &mn, const Vec3 &mx) {
    int first = int(order.size());
    for (int64_t i = start; i < end; i++) order.push_back(perm[i]);
    return emit(mn, mx, int(end - start), -1, first);
  }

  int build(int64_t start, int64_t end) {
    // node bounds: plain min/max plus the zero-box quirk handling
    Vec3 bmin = pmin(perm[start]), bmax = pmax(perm[start]);
    bool seen_nonzero = false;
    bool drag_origin = false;
    // replicate the python builder's semantics exactly: union of the
    // non-zero boxes, plus the origin when a zero box follows a non-zero
    {
      Vec3 mn{0, 0, 0}, mx{0, 0, 0};
      bool have = false;
      int64_t first_nonzero = -1;
      for (int64_t i = start; i < end; i++) {
        Vec3 a = pmin(perm[i]), b = pmax(perm[i]);
        bool zero = a.x == 0 && a.y == 0 && a.z == 0 && b.x == 0 &&
                    b.y == 0 && b.z == 0;
        if (!zero) {
          if (!have) { mn = a; mx = b; have = true; first_nonzero = i; }
          else { mn = vmin(mn, a); mx = vmax(mx, b); }
        }
      }
      if (have) {
        for (int64_t i = first_nonzero + 1; i < end; i++) {
          Vec3 a = pmin(perm[i]), b = pmax(perm[i]);
          if (a.x == 0 && a.y == 0 && a.z == 0 && b.x == 0 && b.y == 0 &&
              b.z == 0) { drag_origin = true; break; }
        }
        bmin = mn; bmax = mx;
        if (drag_origin) {
          bmin = vmin(bmin, {0, 0, 0});
          bmax = vmax(bmax, {0, 0, 0});
        }
      } else {
        bmin = {0, 0, 0}; bmax = {0, 0, 0};
      }
      (void)seen_nonzero;
    }

    int64_t ntris = end - start;
    if (ntris == 1) return make_leaf(start, end, bmin, bmax);

    Vec3 cmn = cent(perm[start]), cmx = cmn;
    for (int64_t i = start; i < end; i++) {
      Vec3 c = cent(perm[i]);
      cmn = vmin(cmn, c);
      cmx = vmax(cmx, c);
    }
    // longest axis (boundingbox.cpp:30-39)
    float dx = cmx.x - cmn.x, dy = cmx.y - cmn.y, dz = cmx.z - cmn.z;
    int ax = (dx > dy && dx > dz) ? 0 : (dy > dz ? 1 : 2);
    if (cmx[ax] == cmn[ax]) return make_leaf(start, end, bmin, bmax);

    int64_t mid;
    if (ntris == 2) {
      if (cent(perm[start])[ax] > cent(perm[start + 1])[ax])
        std::swap(perm[start], perm[start + 1]);
      mid = start + 1;
    } else {
      float ext = cmx[ax] - cmn[ax];
      auto bucket_of = [&](int64_t p) {
        float c = cent(p)[ax];
        float off = ext > 0 ? (c - cmn[ax]) / ext : (c - cmn[ax]);
        int b = int(kBuckets * off);
        return b == kBuckets ? kBuckets - 1 : b;
      };
      Box reg[kBuckets];
      int64_t cnt[kBuckets] = {0};
      bool nonempty[kBuckets] = {false};
      for (int64_t i = start; i < end; i++) {
        int b = bucket_of(perm[i]);
        Vec3 a = pmin(perm[i]), bb = pmax(perm[i]);
        if (!nonempty[b]) { reg[b] = {a, bb}; nonempty[b] = true; }
        else { reg[b].mn = vmin(reg[b].mn, a); reg[b].mx = vmax(reg[b].mx, bb); }
        cnt[b]++;
      }
      double denom = Box{bmin, bmax}.area();
      double best = std::numeric_limits<double>::infinity();
      int split = 0;
      for (int i = 0; i < kBuckets - 1; i++) {
        Box A, B;
        int64_t ca = 0, cb = 0;
        for (int j = 0; j <= i; j++) {
          A = A.union_quirk(nonempty[j] ? reg[j] : Box{});
          ca += cnt[j];
        }
        for (int j = i + 1; j < kBuckets; j++) {
          B = B.union_quirk(nonempty[j] ? reg[j] : Box{});
          cb += cnt[j];
        }
        double cost = 1.0 + (ca * A.area() + cb * B.area()) / denom;
        if (cost < best) { best = cost; split = i; }
      }
      if (best < double(ntris) || ntris > kMaxPrims) {
        // STABLE partition (matches the numpy builder)
        auto it = std::stable_partition(
            perm.begin() + start, perm.begin() + end,
            [&](int64_t p) { return bucket_of(p) <= split; });
        mid = it - perm.begin();
      } else {
        return make_leaf(start, end, bmin, bmax);
      }
    }

    int node = emit(bmin, bmax, 0, ax, -1);
    build(start, mid);
    rchild[node] = build(mid, end);
    return node;
  }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2n). Output buffers must hold 2n nodes and
// n order entries.
int ptdn_build_bvh(const float *tri_min, const float *tri_max, int64_t n,
                   float *out_bmin, float *out_bmax, int32_t *out_count,
                   int32_t *out_axis, int32_t *out_poff, int32_t *out_right,
                   int64_t *out_order) {
  if (n <= 0) return 0;
  Builder b;
  b.tmin = tri_min;
  b.tmax = tri_max;
  b.perm.resize(n);
  for (int64_t i = 0; i < n; i++) b.perm[i] = i;
  b.nmin.reserve(6 * n);
  b.order.reserve(n);
  b.build(0, n);
  int nn = int(b.count.size());
  std::memcpy(out_bmin, b.nmin.data(), sizeof(float) * 3 * nn);
  std::memcpy(out_bmax, b.nmax.data(), sizeof(float) * 3 * nn);
  std::memcpy(out_count, b.count.data(), sizeof(int32_t) * nn);
  std::memcpy(out_axis, b.axis.data(), sizeof(int32_t) * nn);
  std::memcpy(out_poff, b.poff.data(), sizeof(int32_t) * nn);
  std::memcpy(out_right, b.rchild.data(), sizeof(int32_t) * nn);
  std::memcpy(out_order, b.order.data(), sizeof(int64_t) * n);
  return nn;
}
}
