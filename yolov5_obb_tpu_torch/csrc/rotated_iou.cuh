// Exact IoU of two rotated boxes [cx cy l s theta] as a __device__ function.
//
// Counterpart of the JAX package's iou_kernel._pairs_iou_math
// (yolov5_obb_tpu/ops/pallas/iou_kernel.py:33) and of its plain PyTorch
// mirror ops/rotated_iou.pairs_iou_math, step for step:
//   1. centre shift to the pair's midpoint (precision);
//   2. the 4 vertices of each box;
//   3. 16 edge-edge crossings, kept as at most 2 per edge of A (the min-t and
//      max-t hits: a segment crosses a convex quad's boundary at most twice);
//   4. the vertices of each box that lie inside the other;
//   5. the candidate points ordered by a pseudo-angle around their centroid
//      (ties by candidate index) and the shoelace area of that ring.
// One thread computes one pair in registers; nothing touches memory.
#pragma once

#define RIOU_EPS 1e-8f

__device__ __forceinline__ void riou_vertices(float cx, float cy, float l,
                                              float s, float t, float* vx,
                                              float* vy) {
  float ct = cosf(t), st = sinf(t);
  float a1x = l * 0.5f * ct, a1y = -l * 0.5f * st;  // long-edge half vector
  float b1x = -s * 0.5f * st, b1y = -s * 0.5f * ct;  // short-edge half vector
  vx[0] = cx + a1x + b1x; vy[0] = cy + a1y + b1y;
  vx[1] = cx + a1x - b1x; vy[1] = cy + a1y - b1y;
  vx[2] = cx - a1x - b1x; vy[2] = cy - a1y - b1y;
  vx[3] = cx - a1x + b1x; vy[3] = cy - a1y + b1y;
}

// 1 where each point of p lies in the convex quad q (either winding)
__device__ __forceinline__ void riou_inside(const float* px, const float* py,
                                            const float* qx, const float* qy,
                                            bool* in) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float cmin = 3.4e38f, cmax = -3.4e38f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int e1 = (e + 1) & 3;
      float ex = qx[e1] - qx[e], ey = qy[e1] - qy[e];
      float dx = px[k] - qx[e], dy = py[k] - qy[e];
      float c = ex * dy - ey * dx;
      cmin = fminf(cmin, c);
      cmax = fmaxf(cmax, c);
    }
    in[k] = (cmin >= -1e-5f) || (cmax <= 1e-5f);
  }
}

__device__ float rotated_pair_iou(float ax, float ay, float al, float as_,
                                  float at, float bx, float by, float bl,
                                  float bs, float bt) {
  float mx = (ax + bx) * 0.5f, my = (ay + by) * 0.5f;
  float pax[4], pay[4], pbx[4], pby[4];
  riou_vertices(ax - mx, ay - my, al, as_, at, pax, pay);
  riou_vertices(bx - mx, by - my, bl, bs, bt, pbx, pby);

  // candidate points: 8 crossing slots, then A's vertices, then B's
  float ptx[16], pty[16];
  bool pm[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int i1 = (i + 1) & 3;
    float rx = pax[i1] - pax[i], ry = pay[i1] - pay[i];
    float tmin = 1e30f, tmax = -1e30f;
    float t4[4], cx4[4], cy4[4];
    bool hit4[4];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int j1 = (j + 1) & 3;
      float sx = pbx[j1] - pbx[j], sy = pby[j1] - pby[j];
      float qpx = pbx[j] - pax[i], qpy = pby[j] - pay[i];
      float denom = rx * sy - ry * sx;
      bool ok = fabsf(denom) > RIOU_EPS;
      float safe = ok ? denom : 1.0f;
      float t = (qpx * sy - qpy * sx) / safe;
      float u = (qpx * ry - qpy * rx) / safe;
      bool hit = ok && t >= -RIOU_EPS && t <= 1.0f + RIOU_EPS &&
                 u >= -RIOU_EPS && u <= 1.0f + RIOU_EPS;
      t4[j] = t;
      hit4[j] = hit;
      cx4[j] = pax[i] + t * rx;
      cy4[j] = pay[i] + t * ry;
      if (hit) {
        tmin = fminf(tmin, t);
        tmax = fmaxf(tmax, t);
        ++cnt;
      }
    }
    float x0 = 0.f, y0 = 0.f, x1 = 0.f, y1 = 0.f, n0 = 0.f, n1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (hit4[j] && t4[j] == tmin) { x0 += cx4[j]; y0 += cy4[j]; n0 += 1.f; }
      if (hit4[j] && t4[j] == tmax) { x1 += cx4[j]; y1 += cy4[j]; n1 += 1.f; }
    }
    ptx[i] = x0 / fmaxf(n0, 1.f); pty[i] = y0 / fmaxf(n0, 1.f);
    ptx[4 + i] = x1 / fmaxf(n1, 1.f); pty[4 + i] = y1 / fmaxf(n1, 1.f);
    pm[i] = cnt >= 1;
    pm[4 + i] = cnt >= 2;
  }
  bool a_in_b[4], b_in_a[4];
  riou_inside(pax, pay, pbx, pby, a_in_b);
  riou_inside(pbx, pby, pax, pay, b_in_a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ptx[8 + k] = pax[k]; pty[8 + k] = pay[k]; pm[8 + k] = a_in_b[k];
    ptx[12 + k] = pbx[k]; pty[12 + k] = pby[k]; pm[12 + k] = b_in_a[k];
  }

  float n = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (pm[k]) { n += 1.f; sx += ptx[k]; sy += pty[k]; }
  }
  float inter = 0.f;
  if (n >= 3.f) {
    float inv_n = 1.0f / n;
    float cx = sx * inv_n, cy = sy * inv_n;
    // pseudo-angle: monotone in the true angle around (cx, cy), no atan2
    float ang[16];
    int ord[16];
    int m = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (!pm[k]) continue;
      float dx = ptx[k] - cx, dy = pty[k] - cy;
      float tt = dy / fmaxf(fabsf(dx) + fabsf(dy), RIOU_EPS);
      float a = dx >= 0.f ? tt : 2.0f - tt;
      // stable insertion: equal angles keep candidate order
      int p = m;
      while (p > 0 && ang[p - 1] > a) {
        ang[p] = ang[p - 1];
        ord[p] = ord[p - 1];
        --p;
      }
      ang[p] = a;
      ord[p] = k;
      ++m;
    }
    float area2 = 0.f;
    for (int k = 0; k < m; ++k) {
      int a = ord[k], b = ord[(k + 1) % m];
      area2 += ptx[a] * pty[b] - pty[a] * ptx[b];
    }
    inter = 0.5f * fabsf(area2);
  }
  float area_a = al * as_, area_b = bl * bs;
  return inter / fmaxf(area_a + area_b - inter, RIOU_EPS);
}
