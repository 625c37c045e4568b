// Minimum-area rectangle of a point set, as OpenCV 5.0's
// cv::boxPoints(cv::minAreaRect(points)) computes it, operation for
// operation in the same float32 / float64 types: the convex hull of
// convexHull(points, clockwise=false) (Sklansky's scan over the points
// sorted by x, then y), the rotating calipers over that hull (areas
// compared with <=, so the last minimum wins), the RotatedRect built from
// the winning caliper (centre, size, angle in degrees from atan2) and its
// four float32 corners.
//
// Built with -ffp-contract=off and without -ffast-math, so that every
// float32 product and sum rounds on its own, as in OpenCV's compiled code.
//
// C interface (ctypes):
//   int min_area_rect(const float* pts, int n, float* box, float* corners)
//     pts: (n, 2) float32; box: cx, cy, w, h, angle (degrees);
//     corners: (4, 2) float32 as cv::RotatedRect::points gives them.
//     Returns the hull's point count.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct P2 {
  float x, y;
};

inline int sign_of(float v) { return (v > 0) - (v < 0); }

// cv::CHullCmpPoints<float>: x, then y, then the address
struct CmpPts {
  bool operator()(const P2* a, const P2* b) const {
    if (a->x != b->x) return a->x < b->x;
    if (a->y != b->y) return a->y < b->y;
    return a < b;
  }
};

// cv::Sklansky_ on the sorted pointer array
int sklansky(P2** array, int start, int end, int* stack, int nsign,
             int sign2) {
  int incr = end > start ? 1 : -1;
  int pprev = start, pcur = pprev + incr, pnext = pcur + incr;
  int stacksize = 3;
  if (start == end ||
      (array[start]->x == array[end]->x && array[start]->y == array[end]->y)) {
    stack[0] = start;
    return 1;
  }
  stack[0] = pprev;
  stack[1] = pcur;
  stack[2] = pnext;
  end += incr;
  while (pnext != end) {
    float cury = array[pcur]->y;
    float nexty = array[pnext]->y;
    float by = nexty - cury;
    if (sign_of(by) != nsign) {
      float ax = array[pcur]->x - array[pprev]->x;
      float bx = array[pnext]->x - array[pcur]->x;
      float ay = cury - array[pprev]->y;
      float convexity = ay * bx - ax * by;
      if (sign_of(convexity) == sign2 && (ax != 0 || ay != 0)) {
        pprev = pcur;
        pcur = pnext;
        pnext += incr;
        stack[stacksize] = pnext;
        stacksize++;
      } else {
        if (pprev == start) {
          pcur = pnext;
          stack[1] = pcur;
          pnext += incr;
          stack[2] = pnext;
        } else {
          stack[stacksize - 2] = pnext;
          pcur = pprev;
          pprev = stack[stacksize - 4];
          stacksize--;
        }
      }
    } else {
      pnext += incr;
      stack[stacksize - 1] = pnext;
    }
  }
  return --stacksize;
}

// cv::convexHull(points, hull, clockwise=false, returnPoints=true)
std::vector<P2> convex_hull(const P2* data0, int total) {
  std::vector<P2*> pointer(total);
  std::vector<int> stack_buf(total + 2), hullbuf(total);
  int* stack = stack_buf.data();
  int nout = 0, miny_ind = 0, maxy_ind = 0;
  for (int i = 0; i < total; i++) pointer[i] = const_cast<P2*>(&data0[i]);
  std::sort(pointer.begin(), pointer.end(), CmpPts());
  for (int i = 1; i < total; i++) {
    float y = pointer[i]->y;
    if (pointer[miny_ind]->y > y) miny_ind = i;
    if (pointer[maxy_ind]->y < y) maxy_ind = i;
  }
  P2** ptr = pointer.data();
  if (ptr[0]->x == ptr[total - 1]->x && ptr[0]->y == ptr[total - 1]->y) {
    hullbuf[nout++] = 0;
  } else {
    // upper half
    int* tl_stack = stack;
    int tl_count = sklansky(ptr, 0, maxy_ind, tl_stack, -1, 1);
    int* tr_stack = stack + tl_count;
    int tr_count = sklansky(ptr, total - 1, maxy_ind, tr_stack, -1, -1);
    // counter-clockwise
    std::swap(tl_stack, tr_stack);
    std::swap(tl_count, tr_count);
    for (int i = 0; i < tl_count - 1; i++)
      hullbuf[nout++] = int(ptr[tl_stack[i]] - data0);
    for (int i = tr_count - 1; i > 0; i--)
      hullbuf[nout++] = int(ptr[tr_stack[i]] - data0);
    int stop_idx = tr_count > 2 ? tr_stack[1]
                   : tl_count > 2 ? tl_stack[tl_count - 2]
                                  : -1;
    // lower half
    int* bl_stack = stack;
    int bl_count = sklansky(ptr, 0, miny_ind, bl_stack, 1, -1);
    int* br_stack = stack + bl_count;
    int br_count = sklansky(ptr, total - 1, miny_ind, br_stack, 1, 1);
    if (stop_idx >= 0) {
      int check_idx = bl_count > 2              ? bl_stack[1]
                      : bl_count + br_count > 2 ? br_stack[2 - bl_count]
                                                : -1;
      if (check_idx == stop_idx ||
          (check_idx >= 0 && ptr[check_idx]->x == ptr[stop_idx]->x &&
           ptr[check_idx]->y == ptr[stop_idx]->y)) {
        // all the points on one line: the bottom part mirrors the top
        bl_count = std::min(bl_count, 2);
        br_count = std::min(br_count, 2);
      }
    }
    for (int i = 0; i < bl_count - 1; i++)
      hullbuf[nout++] = int(ptr[bl_stack[i]] - data0);
    for (int i = br_count - 1; i > 0; i--)
      hullbuf[nout++] = int(ptr[br_stack[i]] - data0);
    // a cyclic shift that makes the indices one ascending or descending
    // run, where one exists: it then starts at the least (ascending) or
    // the greatest (descending) index
    if (nout >= 3) {
      int min_idx = 0, max_idx = 0, up = 0;
      for (int i = 0; i < nout; i++) {
        if (hullbuf[i] < hullbuf[min_idx]) min_idx = i;
        if (hullbuf[i] > hullbuf[max_idx]) max_idx = i;
        up += hullbuf[i] < hullbuf[(i + 1) % nout];
      }
      int i0 = up == nout - 1 ? min_idx : up == 1 ? max_idx : 0;
      std::rotate(hullbuf.begin(), hullbuf.begin() + i0,
                  hullbuf.begin() + nout);
    }
  }
  std::vector<P2> hull(nout);
  for (int i = 0; i < nout; i++) hull[i] = data0[hullbuf[i]];
  return hull;
}

// cv::rotatingCalipers(..., CALIPERS_MINAREARECT, out): out = corner,
// vector 1, vector 2.  Each step turns the caliper whose next hull edge
// makes the least angle with it: the four edges, each turned by its
// caliper's quarter turn into caliper 0's frame, are compared by cross
// products (a tie keeps the earlier caliper); the turned caliper's edge,
// scaled to unit length, is the new base.  The rectangle of each step is
// kept when its area is <= the least so far, so the last minimum wins.
void rotating_calipers(const P2* points, int n, P2 out[3]) {
  std::vector<float> inv_vect_length(n);
  std::vector<P2> vect(n);
  int left = 0, bottom = 0, right = 0, top = 0;
  P2 pt0 = points[0];
  float left_x = pt0.x, right_x = pt0.x, top_y = pt0.y, bottom_y = pt0.y;
  for (int i = 0; i < n; i++) {
    if (pt0.x < left_x) left_x = pt0.x, left = i;
    if (pt0.x > right_x) right_x = pt0.x, right = i;
    if (pt0.y > top_y) top_y = pt0.y, top = i;
    if (pt0.y < bottom_y) bottom_y = pt0.y, bottom = i;
    P2 pt = points[i + 1 < n ? i + 1 : 0];
    float dx = pt.x - pt0.x, dy = pt.y - pt0.y;
    vect[i].x = dx;
    vect[i].y = dy;
    inv_vect_length[i] =
        (float)(1. / std::sqrt((double)dx * dx + (double)dy * dy));
    pt0 = pt;
  }
  int seq[4] = {bottom, right, top, left};
  float minarea = FLT_MAX;
  float best_a = 0, best_b = 0, best_w = 0, best_h = 0;
  int best_left = 0, best_bottom = 0;
  for (int k = 0; k < n; k++) {
    P2 v0 = vect[seq[0]], v1 = vect[seq[1]], v2 = vect[seq[2]],
       v3 = vect[seq[3]];
    P2 turned[3] = {v0, {v1.y, -v1.x}, {-v2.x, -v2.y}};
    float c01 = -v1.x * v0.x - v1.y * v0.y;
    int main_element = 0 > c01 ? 1 : 0;
    P2 r = turned[main_element];
    if (0 > -v2.y * r.x + v2.x * r.y) {
      main_element = 2;
      r = turned[2];
    }
    if (0 > r.x * v3.x + r.y * v3.y) main_element = 3;
    int pindex = seq[main_element];
    float lead_x = vect[pindex].x * inv_vect_length[pindex];
    float lead_y = vect[pindex].y * inv_vect_length[pindex];
    float base_a, base_b;
    switch (main_element) {
      case 0: base_a = lead_x; base_b = lead_y; break;
      case 1: base_a = lead_y; base_b = -lead_x; break;
      case 2: base_a = -lead_x; base_b = -lead_y; break;
      default: base_a = -lead_y; base_b = lead_x; break;
    }
    seq[main_element] = pindex + 1 == n ? 0 : pindex + 1;
    float dx = points[seq[1]].x - points[seq[3]].x;
    float dy = points[seq[1]].y - points[seq[3]].y;
    float width = dx * base_a + dy * base_b;
    dx = points[seq[2]].x - points[seq[0]].x;
    dy = points[seq[2]].y - points[seq[0]].y;
    float height = dy * base_a - dx * base_b;
    float area = width * height;
    if (!(minarea < area)) {
      minarea = area;
      best_left = seq[3];
      best_bottom = seq[0];
      best_a = base_a;
      best_b = base_b;
      best_w = width;
      best_h = height;
    }
  }
  float A1 = best_a, B1 = best_b, A2 = -best_b, B2 = best_a;
  float C1 = A1 * points[best_left].x + points[best_left].y * B1;
  float C2 = A2 * points[best_bottom].x + points[best_bottom].y * B2;
  float idet = 1.f / (A1 * B2 - A2 * B1);
  out[0].x = (C1 * B2 - C2 * B1) * idet;
  out[0].y = (A1 * C2 - A2 * C1) * idet;
  out[1].x = A1 * best_w;
  out[1].y = B1 * best_w;
  out[2].x = A2 * best_h;
  out[2].y = B2 * best_h;
}

}  // namespace

extern "C" int min_area_rect(const float* pts, int n, float* box,
                             float* corners) {
  const double kPi = 3.141592653589793;
  std::vector<P2> hull = convex_hull(reinterpret_cast<const P2*>(pts), n);
  int h = int(hull.size());
  float cx = 0, cy = 0, w = 0, ht = 0, angle = -90.f;
  if (h > 2) {
    P2 out[3];
    rotating_calipers(hull.data(), h, out);
    cx = out[0].x + (out[1].x + out[2].x) * 0.5f;
    cy = out[0].y + (out[1].y + out[2].y) * 0.5f;
    float len1 = (float)std::sqrt((double)out[1].x * out[1].x +
                                  (double)out[1].y * out[1].y);
    float len2 = (float)std::sqrt((double)out[2].x * out[2].x +
                                  (double)out[2].y * out[2].y);
    if (out[1].x == 0 && out[1].y > 0) {  // vector 1 points straight up
      w = len1;
      ht = len2;
    } else {
      w = len2;
      ht = len1;
      angle = (float)(std::atan2((double)out[1].x, (double)out[1].y) *
                      -180.0 / kPi);
    }
  } else if (h == 2) {
    cx = (hull[0].x + hull[1].x) * 0.5f;
    cy = (hull[0].y + hull[1].y) * 0.5f;
    float dx = hull[0].x - hull[1].x, dy = hull[0].y - hull[1].y;
    float len = (float)std::sqrt((double)dx * dx + (double)dy * dy);
    ht = len;
    if (dx == 0) {
      w = len;
      ht = 0;
    } else if (0 > dy) {
      w = len;
      ht = 0;
      angle = (float)(std::atan2((double)dy, (double)dx) * 180.0 / kPi);
    } else if (dy > 0) {
      angle = (float)(std::atan2((double)dx, (double)dy) * -180.0 / kPi);
    }
  } else if (h == 1) {
    cx = hull[0].x;
    cy = hull[0].y;
  }
  box[0] = cx;
  box[1] = cy;
  box[2] = w;
  box[3] = ht;
  box[4] = angle;
  // cv::RotatedRect::points: each corner from the centre
  double a_rad = angle * kPi / 180.;
  float b = (float)std::cos(a_rad) * 0.5f;
  float a = (float)std::sin(a_rad) * 0.5f;
  corners[0] = cx - a * ht - b * w;
  corners[1] = cy + b * ht - a * w;
  corners[2] = cx + a * ht - b * w;
  corners[3] = cy - b * ht - a * w;
  corners[4] = cx + a * ht + b * w;
  corners[5] = cy - b * ht + a * w;
  corners[6] = cx - a * ht + b * w;
  corners[7] = cy + b * ht + a * w;
  return h;
}
