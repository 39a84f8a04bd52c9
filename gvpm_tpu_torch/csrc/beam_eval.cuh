// Per-pair math of the beam / plane pair sweeps (ops/beam_sweep.py): one
// (camera query, photon beam or plane) pair of each of the three primal
// estimators of gvpm_tpu/integrators/estimators.py, as __host__
// __device__ functors.
//
//   Beam1D  — beam_beam_gather (:481): closest approach, 1D kernel
//   Beam3D  — beam_point_gather (:262): chord through the kernel sphere
//             around a distance sample, one threefry-drawn sample on it
//   Plane0D — plane_gather (:401): Moller-Trumbore against the plane
//
// Every formula mirrors the plain PyTorch version (ops/beam_sweep.py
// _beam1d / _beam3d / _plane0d) operation by operation, in the same
// order, so that a build without FMA contraction (-fmad=false) takes the
// same accept decisions (the accepted-pair counts match exactly) and the
// sums agree to the rounding of expf. `pair` returns whether the pair is
// accepted and, if so, its contribution; a rejected pair adds nothing,
// as the JAX package's where(ok, ., 0). The header also compiles as
// plain host C++ (with __host__/__device__ defined away), which is how
// the CPU tests exercise this source, threefry included.
#pragma once

#include <stdint.h>
#include <string.h>
#ifndef __CUDACC__
#include <cmath>
#endif

namespace beam {

// query-row and beam-row slots (ops/beam_sweep.QSLOT / BSLOT)
enum QSlot : int {
  Q_O = 0, Q_D = 3, Q_LEN = 6, Q_MED = 7, Q_VALID = 8, Q_ST = 9, Q_SS = 12,
  Q_W = 15, Q_G = 16, Q_PT = 17, QW = 20
};
enum BSlot : int {
  B_O = 0, B_D = 3, B_LEN = 6, B_MED = 7, B_ALPHA = 8, B_SIG = 11, B_W1 = 12,
  B_L1 = 15, BW = 16
};

constexpr int PHASE_HG = 1, PHASE_RAYLEIGH = 2;   // scene/types.py
// python-double constants rounded once to float, as torch does
constexpr float INV_FOURPI = (float)(1.0 / (4.0 * 3.141592653589793));
constexpr float RAYLEIGH_K = (float)(3.0 / (16.0 * 3.141592653589793));

struct V3 {
  float x, y, z;
};

__host__ __device__ inline V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__host__ __device__ inline V3 scale3(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__host__ __device__ inline V3 madd3(V3 o, V3 d, float t) {
  return {o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
}
__host__ __device__ inline float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__host__ __device__ inline V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
// torch.clamp(min=) / torch.minimum semantics: NaN propagates
__host__ __device__ inline float cmin_(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}
__host__ __device__ inline float minimum_(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__host__ __device__ inline V3 ld3(const float* r, int k) {
  return {r[k], r[k + 1], r[k + 2]};
}

// one camera query (a row of pack_queries) and its index
struct Query {
  V3 o, d;
  float len, med, st[3], ss[3], w, g;
  int pt;
  bool valid;
  uint32_t m;
};

__host__ __device__ inline Query load_query(const float* r, uint32_t m) {
  Query q;
  q.o = ld3(r, Q_O);
  q.d = ld3(r, Q_D);
  q.len = r[Q_LEN];
  q.med = r[Q_MED];
  q.valid = r[Q_VALID] > 0.5f;
  for (int c = 0; c < 3; ++c) {
    q.st[c] = r[Q_ST + c];
    q.ss[c] = r[Q_SS + c];
  }
  q.w = r[Q_W];
  q.g = r[Q_G];
  q.pt = (int)r[Q_PT];
  q.m = m;
  return q;
}

struct Params {
  float r2, k;       // r^2; K1 (beam1d) or K3 (beam3d)
  uint32_t tile;     // beam3d's tile of the random layout
};

// render/phase.eval_phase from the propagation cosine (warp.hg_pdf,
// rayleigh_pdf, isotropic)
__host__ __device__ inline float phase(float c, float g, int pt) {
  if (pt == PHASE_HG) {
    float denom = 1.0f + g * g - 2.0f * g * c;
    return INV_FOURPI * (1.0f - g * g) /
           cmin_(denom * sqrtf(cmin_(denom, 0.0f)), 1e-12f);
  }
  if (pt == PHASE_RAYLEIGH) return RAYLEIGH_K * (1.0f + c * c);
  return INV_FOURPI;
}

// estimators.survival_prob with the query's medium
__host__ __device__ inline float survival(const Query& q, float t) {
  float e0 = expf(-q.st[0] * t), e1 = expf(-q.st[1] * t),
        e2 = expf(-q.st[2] * t);
  return (1.0f - q.w) + q.w * ((e0 + e1 + e2) / 3.0f);
}

// ------------------------------------------------------------ threefry

__host__ __device__ inline uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// threefry2x32, 20 rounds (core/rng.threefry2x32)
__host__ __device__ inline void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// core/rng.counter_uniform: the float jax.random.uniform draws at flat
// position ctr of its shape
__host__ __device__ inline float counter_uniform(uint32_t k0, uint32_t k1,
                                                 uint32_t ctr) {
  uint32_t x0 = 0u, x1 = ctr;
  threefry2x32(k0, k1, x0, x1);
  uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
#ifdef __CUDA_ARCH__
  float f = __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof(f));
#endif
  return cmin_(f - 1.0f, 0.0f);
}

// ------------------------------------------------------- pair functors
// pair(q, b, key, p, c): b is the beam row (BW floats), key its
// beam_keys row (k1, k2, lane, 0; beam3d only). Returns whether the pair
// is accepted; then c holds its contribution.

struct Beam1D {
  static constexpr bool RANDOM = false;
  __host__ __device__ static bool pair(const Query& q, const float* b,
                                       const int* /*key*/, const Params& p,
                                       float c[3]) {
    if (b[B_MED] != q.med) return false;
    V3 ob = ld3(b, B_O), db = ld3(b, B_D);
    V3 w0 = sub3(q.o, ob);
    float bb = dot3(q.d, db);
    float f1 = -dot3(w0, q.d);
    float f2 = -dot3(w0, db);
    float denom = 1.0f - bb * bb;
    bool parallel = fabsf(denom) < 1e-8f;
    float den = parallel ? 1.0f : denom;
    float tc = (f1 - bb * f2) / den;
    float tb = (bb * f1 - f2) / den;
    if (parallel || !(tc > 1e-5f) || !(tc < q.len) || !(tb > 1e-5f) ||
        !(tb < b[B_LEN]))
      return false;
    V3 delta = sub3(madd3(q.o, q.d, tc), madd3(ob, db, tb));
    if (!(dot3(delta, delta) < p.r2)) return false;
    float sin_t = sqrtf(cmin_(denom, 1e-12f));
    float pf = phase(-bb, q.g, q.pt);
    float s = pf * p.k / (sin_t * cmin_(survival(q, tb), 1e-9f));
    for (int ch = 0; ch < 3; ++ch)
      c[ch] = b[B_ALPHA + ch] * (s * expf(-q.st[ch] * tc) *
                                 expf(-q.st[ch] * tb) * q.ss[ch]);
    return true;
  }
};

struct Beam3D {
  static constexpr bool RANDOM = true;
  __host__ __device__ static bool pair(const Query& q, const float* b,
                                       const int* key, const Params& p,
                                       float c[3]) {
    if (b[B_MED] != q.med) return false;
    V3 ob = ld3(b, B_O), db = ld3(b, B_D);
    V3 rel = sub3(q.o, ob);
    float s_mid = dot3(rel, db);
    V3 perp = sub3(rel, scale3(db, s_mid));
    float half = sqrtf(cmin_(p.r2 - dot3(perp, perp), 0.0f));
    float s0 = cmin_(s_mid - half, 0.0f);
    float s1 = minimum_(s_mid + half, b[B_LEN]);
    float chord = cmin_(s1 - s0, 0.0f);
    if (!(chord > 0.0f)) return false;
    float us = counter_uniform((uint32_t)key[0], (uint32_t)key[1],
                               q.m * p.tile + (uint32_t)key[2]);
    float s = s0 + us * chord;
    V3 e = sub3(q.o, madd3(ob, db, s));
    if (!(dot3(e, e) < p.r2)) return false;
    float pf = phase(-dot3(db, q.d), q.g, q.pt);
    float sc = chord * p.k * pf / cmin_(survival(q, s), 1e-9f);
    for (int ch = 0; ch < 3; ++ch)
      c[ch] = b[B_ALPHA + ch] * expf(-q.st[ch] * s) * sc;
    return true;
  }
};

struct Plane0D {
  static constexpr bool RANDOM = false;
  __host__ __device__ static bool pair(const Query& q, const float* b,
                                       const int* /*key*/,
                                       const Params& /*p*/, float c[3]) {
    if (b[B_MED] != q.med) return false;
    V3 pw0 = ld3(b, B_D), pw1 = ld3(b, B_W1);
    float pl0 = b[B_LEN], pl1 = b[B_L1];
    V3 e0 = scale3(pw0, pl0), e1 = scale3(pw1, pl1);
    V3 pv = cross3(q.d, e1);
    float det = dot3(e0, pv);
    if (!(fabsf(det) > 1e-7f)) return false;
    float inv_det = 1.0f / det;
    V3 tt = sub3(q.o, ld3(b, B_O));
    float t0 = dot3(tt, pv) * inv_det;
    V3 qq = cross3(tt, e0);
    float t1 = dot3(q.d, qq) * inv_det;
    float tcam = dot3(e1, qq) * inv_det;
    if (!(t0 >= 0.0f) || !(t0 <= 1.0f) || !(t1 >= 0.0f) || !(t1 <= 1.0f) ||
        !(tcam > 1e-5f) || !(tcam < q.len))
      return false;
    t0 = t0 * pl0;
    t1 = t1 * pl1;
    float pf = phase(-dot3(pw1, q.d), q.g, q.pt);
    float surv1 = expf(-b[B_SIG] * t1);
    float jac = fabsf(dot3(pw0, cross3(pw1, q.d)));
    float sc = pf / (cmin_(survival(q, t0), 1e-9f) * cmin_(surv1, 1e-9f) *
                     cmin_(jac, 1e-6f));
    for (int ch = 0; ch < 3; ++ch)
      c[ch] = b[B_ALPHA + ch] *
              (expf(-q.st[ch] * tcam) * expf(-q.st[ch] * t0) *
               expf(-q.st[ch] * t1) * q.ss[ch] * q.ss[ch] * sc);
    return true;
  }
};

}  // namespace beam
