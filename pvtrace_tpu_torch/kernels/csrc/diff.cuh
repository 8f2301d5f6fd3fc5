// K15: the first-pass Beer–Lambert surrogate, per photon. Mirrors the
// plain twin pvtrace_tpu_torch/engine/absorb.py (which ports _chord_fn
// and absorbed_fraction_fn of pvtrace_tpu/diff/transport.py) operation
// for operation, in float32. Host-callable (PVT_FN), so the CPU tests
// build it with g++ and hold it to the twin.
#pragma once
#include "tracer.cuh"

// Columns of an absorbing node's float record (engine/absorb.py AF_*).
#define AF_W2L 0
#define AF_G 12
#define AF 16

// The scene's absorbing nodes (field order mirrored by ctypes): node_f
// [n, AF] (world-to-local rows, then the geometry constants: box
// half-extents; sphere r^2; cylinder half-length, r^2, -half-length),
// node_i [n] geometry types, alpha [n, grid_n] attenuation on the grid.
struct PvtAbsorbers {
  const float* node_f;
  const int* node_i;
  const float* alpha;
  int n;
  int grid_n;
  float x0;
  float dx;
};

// Straight-line chord through one node of the ray (o, d) in its local
// frame: the forward part of the interval inside it, 0 for a miss.
PVT_FN float chord_length(int gtype, const float* g, const float* o, const float* d) {
  const float big = 1e30f;
  float tmin, tmax;
  if (gtype == GEOM_BOX) {
    tmin = -PVT_INF;
    tmax = PVT_INF;
    for (int k = 0; k < 3; ++k) {
      const float safe = fabsf(d[k]) < 1e-20f ? 1e-20f : d[k];
      const float t1 = (-g[k] - o[k]) / safe, t2 = (g[k] - o[k]) / safe;
      tmin = k == 0 ? fminf(t1, t2) : fmaxf(tmin, fminf(t1, t2));
      tmax = k == 0 ? fmaxf(t1, t2) : fminf(tmax, fmaxf(t1, t2));
    }
  } else if (gtype == GEOM_SPHERE) {
    const float b = 2.0f * (d[0] * o[0] + d[1] * o[1] + d[2] * o[2]);
    const float cq = (o[0] * o[0] + o[1] * o[1] + o[2] * o[2]) - g[0];
    const float disc = b * b - 4.0f * cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    tmin = (-b - sq) / 2.0f;
    tmax = disc >= 0.0f ? (-b + sq) / 2.0f : -1.0f;
  } else {
    const float half = g[0], r2 = g[1], neg_half = g[2];
    const float a = d[0] * d[0] + d[1] * d[1];
    const float b = 2.0f * (o[0] * d[0] + o[1] * d[1]);
    const float cq = o[0] * o[0] + o[1] * o[1] - r2;
    const float disc = b * b - 4.0f * a * cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float a_safe = fmaxf(a, 1e-20f);
    const bool axial = a < 1e-20f, in_barrel = cq < 0.0f;
    const float bar_lo = axial ? (in_barrel ? -big : big) : (-b - sq) / (2.0f * a_safe);
    float bar_hi = axial ? (in_barrel ? big : -big) : (-b + sq) / (2.0f * a_safe);
    if (!axial && disc < 0.0f) bar_hi = -big;
    const float dz_safe = fabsf(d[2]) < 1e-20f ? 1e-20f : d[2];
    const float z1 = (neg_half - o[2]) / dz_safe, z2 = (half - o[2]) / dz_safe;
    const bool flat = fabsf(d[2]) < 1e-20f, in_slab = fabsf(o[2]) < half;
    const float cap_lo = flat ? (in_slab ? -big : big) : fminf(z1, z2);
    const float cap_hi = flat ? (in_slab ? big : -big) : fmaxf(z1, z2);
    tmin = fmaxf(bar_lo, cap_lo);
    tmax = fminf(bar_hi, cap_hi);
  }
  return tmax > 0.0f ? fmaxf(tmax - fmaxf(tmin, 0.0f), 0.0f) : 0.0f;
}

// Optical depth at concentration scale 1 of one photon: the sum over the
// absorbing nodes of the lerped attenuation times the chord.
PVT_FN float absorbed_depth(const PvtAbsorbers& a, const float* pos, const float* dir,
                            float wav) {
  const float posf = clampf((wav - a.x0) / a.dx, 0.0f, (float)a.grid_n - 1.0f);
  int i0 = (int)posf;
  i0 = i0 < 0 ? 0 : (i0 > a.grid_n - 2 ? a.grid_n - 2 : i0);
  const float frac = posf - (float)i0;
  float depth = 0.0f;
  for (int n = 0; n < a.n; ++n) {
    const float* f = a.node_f + n * AF;
    const float* R = f + AF_W2L;
    float o[3], d[3];
    for (int k = 0; k < 3; ++k) {
      o[k] = (R[4 * k] * pos[0] + R[4 * k + 1] * pos[1] + R[4 * k + 2] * pos[2]) + R[4 * k + 3];
      d[k] = R[4 * k] * dir[0] + R[4 * k + 1] * dir[1] + R[4 * k + 2] * dir[2];
    }
    const float* row = a.alpha + (size_t)n * a.grid_n;
    const float alpha = row[i0] * (1.0f - frac) + row[i0 + 1] * frac;
    depth = depth + alpha * chord_length(a.node_i[n], f + AF_G, o, d);
  }
  return depth;
}

// pvt_absorbed, photon i: its optical depth and its absorbed weight
// 1 - exp(-c * depth) at the concentration scale *c.
PVT_FN void absorbed_lane(const PvtAbsorbers& a, const float* pos, const float* dir,
                          const float* wav, const float* c, long long i, float* w,
                          float* depth) {
  const float dep = absorbed_depth(a, pos + 3 * i, dir + 3 * i, wav[i]);
  depth[i] = dep;
  w[i] = 1.0f - expf(-*c * dep);
}

// The backward pass of photon i in log_concentration:
// grad_w[i] * c * depth[i] * exp(-c * depth[i]).
PVT_FN float absorbed_grad_lane(const float* depth, const float* grad_w, float c, long long i) {
  const float cd = c * depth[i];
  return grad_w[i] * (cd * expf(-c * depth[i]));
}
