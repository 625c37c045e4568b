// Host-side exact polygon geometry: IoU, overlap matrices, greedy poly-NMS.
//
// Native counterpart of the reference's C++/SWIG polyiou extension
// (DOTA_devkit/polyiou.cpp:74-127) and the Cython/CUDA poly_nms
// (DOTA_devkit/poly_nms_gpu/) — here one plain C++17 shared library with a
// C ABI, loaded via ctypes.  Algorithm: Sutherland–Hodgman convex clipping
// + shoelace areas, double precision.  A copy of the JAX package's
// native/polyiou.cpp, built with the same flags (native/__init__.py:
// g++ -O3 -shared -fPIC -std=c++17), so both libraries give the same bits.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

inline double ring_area(const Pt* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    s += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * std::abs(s);
}

inline double signed_area(const Pt* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    s += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * s;
}

// Sutherland–Hodgman: clip `subject` by convex `clip` (forced CCW).
// Output buffer must hold >= subject_n + clip_n points.
int clip_polygon(const Pt* subject, int sn, const Pt* clip_in, int cn,
                 Pt* out) {
  // ensure CCW clip ring
  std::vector<Pt> clip(clip_in, clip_in + cn);
  if (signed_area(clip.data(), cn) < 0) std::reverse(clip.begin(), clip.end());

  std::vector<Pt> cur(subject, subject + sn), nxt;
  nxt.reserve(sn + cn + 4);
  for (int e = 0; e < cn && !cur.empty(); ++e) {
    const Pt& a = clip[e];
    const Pt& b = clip[(e + 1) % cn];
    nxt.clear();
    Pt s = cur.back();
    double s_side = cross(a, b, s);
    for (const Pt& p : cur) {
      double p_side = cross(a, b, p);
      if (p_side >= 0) {
        if (s_side < 0) {
          double t = s_side / (s_side - p_side);
          nxt.push_back({s.x + t * (p.x - s.x), s.y + t * (p.y - s.y)});
        }
        nxt.push_back(p);
      } else if (s_side >= 0) {
        double t = s_side / (s_side - p_side);
        nxt.push_back({s.x + t * (p.x - s.x), s.y + t * (p.y - s.y)});
      }
      s = p;
      s_side = p_side;
    }
    cur = nxt;
  }
  int n = std::min<int>(cur.size(), sn + cn + 4);
  std::copy(cur.begin(), cur.begin() + n, out);
  return n;
}

inline double quad_iou(const double* p1, const double* p2) {
  Pt a[4] = {{p1[0], p1[1]}, {p1[2], p1[3]}, {p1[4], p1[5]}, {p1[6], p1[7]}};
  Pt b[4] = {{p2[0], p2[1]}, {p2[2], p2[3]}, {p2[4], p2[5]}, {p2[6], p2[7]}};
  Pt buf[16];
  int n = clip_polygon(a, 4, b, 4, buf);
  double inter = n >= 3 ? ring_area(buf, n) : 0.0;
  double u = ring_area(a, 4) + ring_area(b, 4) - inter;
  return u > 0 ? inter / u : 0.0;
}

}  // namespace

extern "C" {

// IoU of two flat [x1 y1 ... y4] quads.
double iou_poly(const double* p1, const double* p2) { return quad_iou(p1, p2); }

// (n,8) x (m,8) → (n*m) row-major IoU matrix (reference poly_overlaps).
void poly_overlaps(const double* polys1, int64_t n, const double* polys2,
                   int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = quad_iou(polys1 + 8 * i, polys2 + 8 * j);
}

// Greedy poly-NMS with HBB prefilter (reference py_cpu_nms_poly_fast,
// ResultMerge_multi_process.py:62-123).  `order` must be score-descending
// indices; writes keep flags (0/1) into `keep`; returns kept count.
int64_t poly_nms(const double* polys, const double* scores,
                 const int64_t* order, int64_t n, double thresh,
                 uint8_t* keep) {
  std::vector<double> x1(n), y1(n), x2(n), y2(n), area(n);
  for (int64_t i = 0; i < n; ++i) {
    const double* p = polys + 8 * i;
    double xmin = p[0], xmax = p[0], ymin = p[1], ymax = p[1];
    for (int k = 1; k < 4; ++k) {
      xmin = std::min(xmin, p[2 * k]);
      xmax = std::max(xmax, p[2 * k]);
      ymin = std::min(ymin, p[2 * k + 1]);
      ymax = std::max(ymax, p[2 * k + 1]);
    }
    x1[i] = xmin; x2[i] = xmax; y1[i] = ymin; y2[i] = ymax;
    area[i] = (xmax - xmin) * (ymax - ymin);
  }
  std::vector<uint8_t> suppressed(n, 0);
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    keep[i] = 0;
    if (suppressed[i]) continue;
    keep[i] = 1;
    ++kept;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      int64_t j = order[oj];
      if (suppressed[j]) continue;
      double iw = std::min(x2[i], x2[j]) - std::max(x1[i], x1[j]);
      double ih = std::min(y2[i], y2[j]) - std::max(y1[i], y1[j]);
      if (iw <= 0 || ih <= 0) continue;
      if (quad_iou(polys + 8 * i, polys + 8 * j) > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

}  // extern "C"
