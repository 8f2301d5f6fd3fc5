// K15: the first-pass Beer–Lambert surrogate, per photon. Mirrors the
// plain twin pvtrace_tpu_torch/engine/absorb.py (which ports _chord_fn
// and absorbed_fraction_fn of pvtrace_tpu/diff/transport.py) operation
// for operation, in the build's real type pvt_real (float, or double in
// the float64 build, diff_f64). The constants are the twin's table's:
// float32 values widened where the JAX package rounds them to float32,
// doubles where it keeps Python floats (engine/absorb.py table), and the
// cylinder's `big` is 1e30 rounded to float32 in both builds, as the JAX
// package's jnp.float32(1e30). Host-callable (PVT_FN), so the CPU tests
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
  const pvt_real* node_f;
  const int* node_i;
  const pvt_real* alpha;
  int n;
  int grid_n;
  pvt_real x0;
  pvt_real dx;
};

// Straight-line chord through one node of the ray (o, d) in its local
// frame: the forward part of the interval inside it, 0 for a miss.
PVT_FN pvt_real chord_length(int gtype, const pvt_real* g, const pvt_real* o,
                             const pvt_real* d) {
  const pvt_real big = 1e30f;  // a float32 in both builds
  pvt_real tmin, tmax;
  if (gtype == GEOM_BOX) {
    tmin = -PVT_INF;
    tmax = PVT_INF;
    for (int k = 0; k < 3; ++k) {
      const pvt_real safe = pvt_fabs(d[k]) < PVT_R(1e-20) ? PVT_R(1e-20) : d[k];
      const pvt_real t1 = (-g[k] - o[k]) / safe, t2 = (g[k] - o[k]) / safe;
      tmin = k == 0 ? pvt_fmin(t1, t2) : pvt_fmax(tmin, pvt_fmin(t1, t2));
      tmax = k == 0 ? pvt_fmax(t1, t2) : pvt_fmin(tmax, pvt_fmax(t1, t2));
    }
  } else if (gtype == GEOM_SPHERE) {
    const pvt_real b = PVT_R(2.0) * (d[0] * o[0] + d[1] * o[1] + d[2] * o[2]);
    const pvt_real cq = (o[0] * o[0] + o[1] * o[1] + o[2] * o[2]) - g[0];
    const pvt_real disc = b * b - PVT_R(4.0) * cq;
    const pvt_real sq = pvt_sqrt(pvt_fmax(disc, PVT_R(0.0)));
    tmin = (-b - sq) / PVT_R(2.0);
    tmax = disc >= PVT_R(0.0) ? (-b + sq) / PVT_R(2.0) : -PVT_R(1.0);
  } else {
    const pvt_real half = g[0], r2 = g[1], neg_half = g[2];
    const pvt_real a = d[0] * d[0] + d[1] * d[1];
    const pvt_real b = PVT_R(2.0) * (o[0] * d[0] + o[1] * d[1]);
    const pvt_real cq = o[0] * o[0] + o[1] * o[1] - r2;
    const pvt_real disc = b * b - PVT_R(4.0) * a * cq;
    const pvt_real sq = pvt_sqrt(pvt_fmax(disc, PVT_R(0.0)));
    const pvt_real a_safe = pvt_fmax(a, PVT_R(1e-20));
    const bool axial = a < PVT_R(1e-20), in_barrel = cq < PVT_R(0.0);
    const pvt_real bar_lo =
        axial ? (in_barrel ? -big : big) : (-b - sq) / (PVT_R(2.0) * a_safe);
    pvt_real bar_hi = axial ? (in_barrel ? big : -big) : (-b + sq) / (PVT_R(2.0) * a_safe);
    if (!axial && disc < PVT_R(0.0)) bar_hi = -big;
    const pvt_real dz_safe = pvt_fabs(d[2]) < PVT_R(1e-20) ? PVT_R(1e-20) : d[2];
    const pvt_real z1 = (neg_half - o[2]) / dz_safe, z2 = (half - o[2]) / dz_safe;
    const bool flat = pvt_fabs(d[2]) < PVT_R(1e-20), in_slab = pvt_fabs(o[2]) < half;
    const pvt_real cap_lo = flat ? (in_slab ? -big : big) : pvt_fmin(z1, z2);
    const pvt_real cap_hi = flat ? (in_slab ? big : -big) : pvt_fmax(z1, z2);
    tmin = pvt_fmax(bar_lo, cap_lo);
    tmax = pvt_fmin(bar_hi, cap_hi);
  }
  return tmax > PVT_R(0.0) ? pvt_fmax(tmax - pvt_fmax(tmin, PVT_R(0.0)), PVT_R(0.0))
                           : PVT_R(0.0);
}

// Optical depth at concentration scale 1 of one photon: the sum over the
// absorbing nodes of the lerped attenuation times the chord.
PVT_FN pvt_real absorbed_depth(const PvtAbsorbers& a, const pvt_real* pos, const pvt_real* dir,
                               pvt_real wav) {
  const pvt_real posf =
      clampf((wav - a.x0) / a.dx, PVT_R(0.0), (pvt_real)a.grid_n - PVT_R(1.0));
  int i0 = (int)posf;
  i0 = i0 < 0 ? 0 : (i0 > a.grid_n - 2 ? a.grid_n - 2 : i0);
  const pvt_real frac = posf - (pvt_real)i0;
  pvt_real depth = PVT_R(0.0);
  for (int n = 0; n < a.n; ++n) {
    const pvt_real* f = a.node_f + n * AF;
    const pvt_real* R = f + AF_W2L;
    pvt_real o[3], d[3];
    for (int k = 0; k < 3; ++k) {
      o[k] = (R[4 * k] * pos[0] + R[4 * k + 1] * pos[1] + R[4 * k + 2] * pos[2]) + R[4 * k + 3];
      d[k] = R[4 * k] * dir[0] + R[4 * k + 1] * dir[1] + R[4 * k + 2] * dir[2];
    }
    const pvt_real* row = a.alpha + (size_t)n * a.grid_n;
    const pvt_real alpha = row[i0] * (PVT_R(1.0) - frac) + row[i0 + 1] * frac;
    depth = depth + alpha * chord_length(a.node_i[n], f + AF_G, o, d);
  }
  return depth;
}

// pvt_absorbed, photon i: its optical depth and its absorbed weight
// 1 - exp(-c * depth) at the concentration scale *c.
PVT_FN void absorbed_lane(const PvtAbsorbers& a, const pvt_real* pos, const pvt_real* dir,
                          const pvt_real* wav, const pvt_real* c, long long i, pvt_real* w,
                          pvt_real* depth) {
  const pvt_real dep = absorbed_depth(a, pos + 3 * i, dir + 3 * i, wav[i]);
  depth[i] = dep;
  w[i] = PVT_R(1.0) - pvt_exp(-*c * dep);
}

// The backward pass of photon i in log_concentration:
// grad_w[i] * c * depth[i] * exp(-c * depth[i]).
PVT_FN pvt_real absorbed_grad_lane(const pvt_real* depth, const pvt_real* grad_w, pvt_real c,
                                   long long i) {
  const pvt_real cd = c * depth[i];
  return grad_w[i] * (cd * pvt_exp(-c * depth[i]));
}
