// Exact IoU of rotated boxes [cx cy l s theta] as __device__ functions on
// per-box records.
//
// Counterpart of the JAX package's iou_kernel._pairs_iou_math
// (yolov5_obb_tpu/ops/pallas/iou_kernel.py:33) and of its plain PyTorch
// mirror ops/rotated_iou.pairs_iou_records (over box_records_plain), step for
// step:
//   0. per box, once (riou_record): cos and sin of theta, the half vectors of
//      the long and the short edge, the area l*s and the axis-aligned cover;
//   1. per pair: the centre shift to the pair's midpoint (precision), added
//      to the half vectors in the order the plain version adds them;
//   2. the 4 vertices of each box;
//   3. 16 edge-edge crossings, kept as at most 2 per edge of A (the min-t and
//      max-t hits: a segment crosses a convex quad's boundary at most twice);
//   4. the vertices of each box that lie inside the other;
//   5. the candidate points ordered by a pseudo-angle around their centroid
//      (ties by candidate index) and the shoelace area of that ring.
// Every array is indexed at compile time: the ordering is a sorting network
// of 63 compare-exchanges on (angle, candidate index) keys, which gives the
// stable order exactly, and the ring's wrap is a select.  The candidate
// points, their order and the ring stay in registers (no stack frame).
//
// The record of one box is 16 floats, four float4; ops/rotated_iou.py names
// the same fields (RECORD_FIELDS, REC_*):
//   [kRecPair]      cx cy a1x a1y     the pair IoU reads these two
//   [kRecPair + 1]  b1x b1y 0 0       and the area;
//   [kRecCover]     x1 y1 x2 y2       the neighbour scan reads these two:
//   [kRecScan]      area cls valid 0  the cover, the area, the class and
//                                     valid bits
#pragma once

#define RIOU_EPS 1e-8f

constexpr int kRiouRecord = 4;  // float4 of one box record
constexpr int kRecPair = 0, kRecCover = 2, kRecScan = 3;

// The record of box [cx cy l s t] of class `cls`, valid or not.
__device__ __forceinline__ void riou_record(float cx, float cy, float l,
                                            float s, float t, int cls,
                                            int valid, float4* r) {
  const float ct = cosf(t), st = sinf(t);
  const float a1x = l * 0.5f * ct, a1y = -l * 0.5f * st;  // long-edge half
  const float b1x = -s * 0.5f * st, b1y = -s * 0.5f * ct;  // short-edge half
  // the cover, as ops/geometry.hbb_cover: w = l|cos| + s|sin|, h = l|sin| +
  // s|cos|
  const float act = fabsf(ct), ast = fabsf(st);
  const float w = l * act + s * ast, h = l * ast + s * act;
  r[kRecPair] = make_float4(cx, cy, a1x, a1y);
  r[kRecPair + 1] = make_float4(b1x, b1y, 0.f, 0.f);
  r[kRecCover] = make_float4(cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2);
  r[kRecScan] = make_float4(l * s, __int_as_float(cls), __int_as_float(valid),
                            0.f);
}

__device__ __forceinline__ void riou_corners(float cx, float cy, float a1x,
                                             float a1y, float b1x, float b1y,
                                             float* vx, float* vy) {
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

// One compare-exchange of the sorting network: position I keeps the smaller
// (angle, candidate index) key; the point travels with its key.
template <int I, int J>
__device__ __forceinline__ void riou_ce(float (&key)[16], int (&id)[16],
                                        float (&x)[16], float (&y)[16]) {
  const bool sw = key[J] < key[I] || (key[J] == key[I] && id[J] < id[I]);
  const float k0 = key[I], x0 = x[I], y0 = y[I];
  const int i0 = id[I];
  key[I] = sw ? key[J] : k0; key[J] = sw ? k0 : key[J];
  id[I] = sw ? id[J] : i0;   id[J] = sw ? i0 : id[J];
  x[I] = sw ? x[J] : x0;     x[J] = sw ? x0 : x[J];
  y[I] = sw ? y[J] : y0;     y[J] = sw ? y0 : y[J];
}

// Batcher's odd-even merge sort of 16 keys (63 compare-exchanges).
__device__ __forceinline__ void riou_sort16(float (&k)[16], int (&i)[16],
                                            float (&x)[16], float (&y)[16]) {
#define RIOU_CE(a, b) riou_ce<a, b>(k, i, x, y)
  RIOU_CE(0, 1); RIOU_CE(2, 3); RIOU_CE(4, 5); RIOU_CE(6, 7);
  RIOU_CE(8, 9); RIOU_CE(10, 11); RIOU_CE(12, 13); RIOU_CE(14, 15);
  RIOU_CE(0, 2); RIOU_CE(1, 3); RIOU_CE(4, 6); RIOU_CE(5, 7);
  RIOU_CE(8, 10); RIOU_CE(9, 11); RIOU_CE(12, 14); RIOU_CE(13, 15);
  RIOU_CE(1, 2); RIOU_CE(5, 6); RIOU_CE(9, 10); RIOU_CE(13, 14);
  RIOU_CE(0, 4); RIOU_CE(1, 5); RIOU_CE(2, 6); RIOU_CE(3, 7);
  RIOU_CE(8, 12); RIOU_CE(9, 13); RIOU_CE(10, 14); RIOU_CE(11, 15);
  RIOU_CE(2, 4); RIOU_CE(3, 5); RIOU_CE(10, 12); RIOU_CE(11, 13);
  RIOU_CE(1, 2); RIOU_CE(3, 4); RIOU_CE(5, 6); RIOU_CE(9, 10);
  RIOU_CE(11, 12); RIOU_CE(13, 14);
  RIOU_CE(0, 8); RIOU_CE(1, 9); RIOU_CE(2, 10); RIOU_CE(3, 11);
  RIOU_CE(4, 12); RIOU_CE(5, 13); RIOU_CE(6, 14); RIOU_CE(7, 15);
  RIOU_CE(4, 8); RIOU_CE(5, 9); RIOU_CE(6, 10); RIOU_CE(7, 11);
  RIOU_CE(2, 4); RIOU_CE(3, 5); RIOU_CE(6, 8); RIOU_CE(7, 9);
  RIOU_CE(10, 12); RIOU_CE(11, 13);
  RIOU_CE(1, 2); RIOU_CE(3, 4); RIOU_CE(5, 6); RIOU_CE(7, 8);
  RIOU_CE(9, 10); RIOU_CE(11, 12); RIOU_CE(13, 14);
#undef RIOU_CE
}

// IoU of the boxes whose records begin (a0, a1), of area area_a, and (b0,
// b1), of area area_b.
__device__ __forceinline__ float riou_pair(float4 a0, float4 a1, float area_a,
                                           float4 b0, float4 b1,
                                           float area_b) {
  const float mx = (a0.x + b0.x) * 0.5f, my = (a0.y + b0.y) * 0.5f;
  float pax[4], pay[4], pbx[4], pby[4];
  riou_corners(a0.x - mx, a0.y - my, a0.z, a0.w, a1.x, a1.y, pax, pay);
  riou_corners(b0.x - mx, b0.y - my, b0.z, b0.w, b1.x, b1.y, pbx, pby);

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
    // the mean over max(n, 1) hits: a division by 1 is exact, so only tied
    // hits (identical points) divide
    if (n0 > 1.f) { x0 = x0 / n0; y0 = y0 / n0; }
    if (n1 > 1.f) { x1 = x1 / n1; y1 = y1 / n1; }
    ptx[i] = x0; pty[i] = y0;
    ptx[4 + i] = x1; pty[4 + i] = y1;
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
    // pseudo-angle: monotone in the true angle around (cx, cy), no atan2;
    // the points left out sort last (the plain version's 10.0)
    float key[16];
    int id[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float dx = ptx[k] - cx, dy = pty[k] - cy;
      float tt = dy / fmaxf(fabsf(dx) + fabsf(dy), RIOU_EPS);
      key[k] = pm[k] ? (dx >= 0.f ? tt : 2.0f - tt) : 10.0f;
      id[k] = k;
    }
    riou_sort16(key, id, ptx, pty);
    // the shoelace over ring positions 0 .. m-1, the last closing on 0
    const int m = (int)n;
    float area2 = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < m) {
        const float nx = k + 1 < m ? ptx[(k + 1) & 15] : ptx[0];
        const float ny = k + 1 < m ? pty[(k + 1) & 15] : pty[0];
        area2 += ptx[k] * ny - pty[k] * nx;
      }
    }
    inter = 0.5f * fabsf(area2);
  }
  return inter / fmaxf(area_a + area_b - inter, RIOU_EPS);
}

// IoU of the boxes whose records are ra and rb.
__device__ __forceinline__ float riou_records(const float4* ra,
                                              const float4* rb) {
  return riou_pair(ra[kRecPair], ra[kRecPair + 1], ra[kRecScan].x,
                   rb[kRecPair], rb[kRecPair + 1], rb[kRecScan].x);
}
