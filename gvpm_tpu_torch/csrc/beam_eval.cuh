// Per-pair math of the beam / plane pair sweeps (ops/beam_sweep.py): one
// (camera query, photon beam or plane) pair of each of the three primal
// estimators of gvpm_tpu/integrators/estimators.py, and of their G-VPM
// gradient versions, as __host__ __device__ functors.
//
//   Beam1D  — beam_beam_gather (:481): closest approach, 1D kernel
//   Beam3D  — beam_point_gather (:262): chord through the kernel sphere
//             around a distance sample, one threefry-drawn sample on it
//   Plane0D — plane_gather (:401): Moller-Trumbore against the plane
//
// Every formula mirrors the plain PyTorch version (ops/beam_sweep.py
// _beam1d / _beam3d / _plane0d, and the _g* functions) operation by
// operation, in the same order, so that a build without FMA contraction
// (-fmad=false) takes the same accept decisions (the accepted-pair
// counts match exactly) and the sums agree to the rounding of expf.
// Every functor comes in the test / base (gradient: and shift) parts of
// csrc/gsweep.cu's queued sweep; a primal functor's test reads the
// floats its stage puts in the sweep's beam tile. The header also
// compiles as plain host C++ (with __host__/__device__ defined away),
// which is how the CPU tests exercise this source, threefry included.
#pragma once

#include <stdint.h>
#include <string.h>

#include "shift_math.cuh"

namespace beam {

using namespace gvpm;  // V3 and its helpers, phase_params, parent_lobe

// query-row and beam-row slots (ops/beam_sweep.QSLOT / BSLOT)
enum QSlot : int {
  Q_O = 0, Q_D = 3, Q_LEN = 6, Q_MED = 7, Q_VALID = 8, Q_ST = 9, Q_SS = 12,
  Q_W = 15, Q_G = 16, Q_PT = 17, QW = 20
};
enum BSlot : int {
  B_O = 0, B_D = 3, B_LEN = 6, B_MED = 7, B_ALPHA = 8, B_SIG = 11, B_W1 = 12,
  B_L1 = 15, BW = 16
};

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
  // Beam1D's pre-test radius^2 (pre_r2 below): +inf lets every pair in the
  // medium through to the exact test
  float pre_r2 = INFINITY;
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

// ------------------------------------------------------------ geometry
// shared by the primal and the gradient functors (and by the gradient
// ones' identity shifts)

// closest approach of the lines o + t d and ob + s db
// (rayIntersectInternal1D): the directions' cosine bb, 1 - bb^2, whether
// they are parallel, and the two line parameters
struct Closest {
  float bb, denom, tc, tb;
  bool parallel;
};
__host__ __device__ inline Closest closest(V3 o, V3 d, V3 ob, V3 db) {
  Closest r;
  V3 w0 = sub3(o, ob);
  r.bb = dot3(d, db);
  float f1 = -dot3(w0, d);
  float f2 = -dot3(w0, db);
  r.denom = 1.0f - r.bb * r.bb;
  r.parallel = fabsf(r.denom) < 1e-8f;
  float den = r.parallel ? 1.0f : r.denom;
  r.tc = (f1 - r.bb * f2) / den;
  r.tb = (r.bb * f1 - f2) / den;
  return r;
}

// the chord of the beam ob + s db, s in [0, lb], through the sphere of
// squared radius r2 around x, in two halves: chord_perp the beam's
// parameter s_mid nearest x and the squared distance pp of x from its
// line; chord_clip the chord's length, and its start in s0
struct Perp {
  float s_mid, pp;
};
__host__ __device__ inline Perp chord_perp(V3 x, V3 ob, V3 db) {
  V3 rel = sub3(x, ob);
  float s_mid = dot3(rel, db);
  V3 perp = sub3(rel, scale3(db, s_mid));
  return {s_mid, dot3(perp, perp)};
}
__host__ __device__ inline float chord_clip(Perp h, float lb, float r2,
                                            float& s0) {
  float half = sqrtf(cmin_(r2 - h.pp, 0.0f));
  s0 = cmin_(h.s_mid - half, 0.0f);
  float s1 = minimum_(h.s_mid + half, lb);
  return cmin_(s1 - s0, 0.0f);
}
__host__ __device__ inline float chord(V3 x, V3 ob, V3 db, float lb,
                                       float r2, float& s0) {
  return chord_clip(chord_perp(x, ob, db), lb, r2, s0);
}

// beam3d's test (Beam3D, GBeam3DT): the medium match and the chord test,
// with no early return. chord's clip (its sqrtf and clamps) runs only
// where x is within r of the beam's line: elsewhere half is 0 and the
// chord empty (s0 = max(s_mid, 0) >= min(s_mid, lb) = s1), so the
// decision is chord's, bit for bit. The threefry word (~123 integer
// operations) is left to the queued pairs (chord_sample).
struct Chord {
  float s0, ch;   // the chord's start and length
};
__host__ __device__ inline bool chord_finish(const Perp& h, const Query& q,
                                             const float* b, const Params& p,
                                             Chord& g) {
  g.s0 = 0.0f;
  g.ch = 0.0f;
  if (h.pp < p.r2) g.ch = chord_clip(h, b[B_LEN], p.r2, g.s0);
  return (b[B_MED] == q.med) & (g.ch > 0.0f);
}
__host__ __device__ inline bool chord_test(const Query& q, const float* b,
                                           const Params& p, Chord& g) {
  return chord_finish(chord_perp(q.o, ld3(b, B_O), ld3(b, B_D)), q, b, p, g);
}
// the chord sample of a pair past chord_test: its word us (key: the
// beam's beam_keys row, counter m * tile + lane), its distance s along
// the beam, and the point it returns
__host__ __device__ inline V3 chord_sample(const Query& q, const float* b,
                                           const int* key, const Params& p,
                                           const Chord& g, float& us,
                                           float& s) {
  us = counter_uniform((uint32_t)key[0], (uint32_t)key[1],
                       q.m * p.tile + (uint32_t)key[2]);
  s = g.s0 + us * g.ch;
  return madd3(ld3(b, B_O), ld3(b, B_D), s);
}

// Beam1D's pre-test bound. |o|_inf + |length| of a line: a query's, or
// over a tile of beams max |ob|_inf + max |lb| (NaN propagates).
__host__ __device__ inline float line_scale(V3 o, float len) {
  return maximum_(maximum_(fabsf(o.x), fabsf(o.y)), fabsf(o.z)) +
         fabsf(len);
}
// The pre-test's squared radius for a query and beams whose line scales
// add to at most `scale`: (1.1 r)^2 where the rounding bound of
// Beam1D::test holds (scale 2^-13 <= r), else +inf (every pair goes on to
// the exact test; also for a NaN or infinite scale).
__host__ __device__ inline float pre_r2(float r2, float scale) {
  const float g = scale * 0x1p-13f;
  return g * g <= r2 ? 1.21f * r2 : INFINITY;
}

// Moller-Trumbore of the ray o + t d against the parallelogram po + u0 e0
// + u1 e1 (intersectPlane0D): false when |det| <= 1e-7, else u0, u1, t
__host__ __device__ inline bool plane_hit(V3 o, V3 d, V3 po, V3 e0, V3 e1,
                                          float& u0, float& u1, float& t) {
  V3 pv = cross3(d, e1);
  float det = dot3(e0, pv);
  if (!(fabsf(det) > 1e-7f)) return false;
  float inv_det = 1.0f / det;
  V3 tt = sub3(o, po);
  u0 = dot3(tt, pv) * inv_det;
  V3 qq = cross3(tt, e0);
  u1 = dot3(d, qq) * inv_det;
  t = dot3(e1, qq) * inv_det;
  return true;
}

// ------------------------------------------------------- pair functors
// Beam1D, Beam3D and Plane0D, in the parts of csrc/gsweep.cu's queued
// sweep: stage(b, s) the SW floats of a beam row b (BW floats) that the
// sweep's tile holds, computed once a tile; test(q, s, p, g) the sweep's
// test on those floats, run on every pair of a valid query, leaving in g
// what base reuses; test_u the same test of U beams (s[v]), written so
// that the U tests interleave; base(q, b, key, p, g, s) a queued pair's
// contribution in s.c (b: the whole beam row; key: the beam's beam_keys
// row, k1, k2, lane, 0; Beam3D's only), returning whether the pair is
// accepted. test_row below runs stage and test on a whole row; pair_body
// strings test and base together.

// Beam1D's and Beam3D's staged floats: the line's o, d, length and medium
// (B_O .. B_MED, the row's first 8)
struct LineStage {
  static constexpr int SW = 8;
  __host__ __device__ static void stage(const float* b, float* s) {
    for (int c = 0; c < SW; ++c) s[c] = b[c];
  }
};

struct Beam1D : LineStage {
  static constexpr bool RANDOM = false, ME = false, PRIMAL = true,
                        PRETEST = true;
  static constexpr int NF = 3, NC = 1, NF_SUM = 3;
  struct Geo {};
  // The medium match and a pre-test with no division: the squared
  // distance between the two lines, (w0 . n)^2 / |n|^2 with n = d x db,
  // against (1.1 r)^2 (p.pre_r2), the pair passed on wherever n . n <= 1e-2
  // (near-parallel lines). It only rejects pairs that base's exact test
  // (the plain version's closest approach) rejects, for unit directions
  // (to a few ulp, as the estimators pack them) and lines whose scales
  // (line_scale) add to A with A 2^-13 <= r (pre_r2; +inf elsewhere).
  // Rounding bound, u = 2^-24: the exact test accepts only with
  // 1e-5 < tc < len and 1e-5 < tb < lb, so every component of o + d tc
  // and of ob + db tb is within A and their computed difference within
  // 5.3 u A of the exact one, whose length is at least the lines'
  // distance D: accepted means D < r (1 + 2u) + 5.3 u A. The computed n
  // is within 3.5 u of the exact cross product (|n| >= 0.0999 past the
  // near-parallel test) and w0 within sqrt(3) u A, so the computed w0 . n
  // is within 13.0 u A of the exact D |n|, and its square stays below
  // 1.21 r2 n . n as computed whenever 18.3 u A <= 0.00999 r, i.e. A <=
  // 9,150 r, which the guard's 8,192 r keeps with room for its own
  // rounding. No early return: the sweep's tests of several beams
  // interleave.
  __host__ __device__ static bool test(const Query& q, const float* b,
                                       const Params& p, Geo& /*g*/) {
    V3 w0 = sub3(q.o, ld3(b, B_O));
    V3 n = cross3(q.d, ld3(b, B_D));
    float s = dot3(w0, n);
    float nn = dot3(n, n);
    return (b[B_MED] == q.med) & ((nn <= 1e-2f) | (s * s <= p.pre_r2 * nn));
  }
  template <int U>
  __host__ __device__ static void test_u(const Query& q, const float (*b)[SW],
                                         const Params& p, Geo* g,
                                         bool* pass) {
    for (int v = 0; v < U; ++v) pass[v] = test(q, b[v], p, g[v]);
  }
  // the exact test of a pair past the pre-test (the plain version's,
  // with its two IEEE divisions): every value computed and every
  // condition evaluated
  __host__ __device__ static bool exact(const Query& q, const float* b,
                                        const Params& p, Closest& h) {
    V3 ob = ld3(b, B_O), db = ld3(b, B_D);
    h = closest(q.o, q.d, ob, db);
    V3 delta = sub3(madd3(q.o, q.d, h.tc), madd3(ob, db, h.tb));
    return !h.parallel & (h.tc > 1e-5f) & (h.tc < q.len) & (h.tb > 1e-5f) &
           (h.tb < b[B_LEN]) & (dot3(delta, delta) < p.r2);
  }
  struct Base {
    float c[3];
  };
  __host__ __device__ static bool base(const Query& q, const float* b,
                                       const int* /*key*/, const Params& p,
                                       const Geo& /*g*/, Base& s) {
    Closest h;
    const bool ok = exact(q, b, p, h);
    float sin_t = sqrtf(cmin_(h.denom, 1e-12f));
    float pf = phase(-h.bb, q.g, q.pt);
    float sc = pf * p.k / (sin_t * cmin_(survival(q, h.tb), 1e-9f));
    for (int ch = 0; ch < 3; ++ch)
      s.c[ch] = b[B_ALPHA + ch] * (sc * expf(-q.st[ch] * h.tc) *
                                   expf(-q.st[ch] * h.tb) * q.ss[ch]);
    return ok;
  }
};

struct Beam3D : LineStage {
  static constexpr bool RANDOM = true, ME = false, PRIMAL = true,
                        PRETEST = false;
  static constexpr int NF = 3, NC = 1, NF_SUM = 3;
  using Geo = Chord;
  __host__ __device__ static bool test(const Query& q, const float* b,
                                       const Params& p, Geo& g) {
    return chord_test(q, b, p, g);
  }
  // every beam's distance from the line first, then the clips: the clip
  // is a branch (its sqrtf has a slow path), which the U beams' loads and
  // products then do not wait for
  template <int U>
  __host__ __device__ static void test_u(const Query& q, const float (*b)[SW],
                                         const Params& p, Geo* g,
                                         bool* pass) {
    Perp h[U];
    for (int v = 0; v < U; ++v)
      h[v] = chord_perp(q.o, ld3(b[v], B_O), ld3(b[v], B_D));
    for (int v = 0; v < U; ++v) pass[v] = chord_finish(h[v], q, b[v], p, g[v]);
  }
  struct Base {
    float c[3];
  };
  // false when the sample falls outside the kernel sphere, which only
  // rounding at the chord's ends does: the pair then adds nothing
  __host__ __device__ static bool base(const Query& q, const float* b,
                                       const int* key, const Params& p,
                                       const Geo& g, Base& s) {
    float us, sd;
    const V3 e = sub3(q.o, chord_sample(q, b, key, p, g, us, sd));
    float pf = phase(-dot3(ld3(b, B_D), q.d), q.g, q.pt);
    float sc = g.ch * p.k * pf / cmin_(survival(q, sd), 1e-9f);
    for (int ch = 0; ch < 3; ++ch)
      s.c[ch] = b[B_ALPHA + ch] * expf(-q.st[ch] * sd) * sc;
    return dot3(e, e) < p.r2;
  }
};

// Plane0D's pre-test bounds: the exact test's u0, u1 in [0, 1] and
// 1e-5 < tcam < len widened by PLANE_M = 8 u (u = 2^-24), relative
constexpr float PLANE_M = 0x1p-21f;
constexpr float PLANE_HI = 1.0f + PLANE_M;    // exact
constexpr float PLANE_T0 = 0x1.4f8b4ep-17f;   // 1e-5f (1 - PLANE_M), rounded

struct Plane0D {
  static constexpr bool RANDOM = false, ME = false, PRIMAL = true,
                        PRETEST = false;
  static constexpr int NF = 3, NC = 1, NF_SUM = 3, SW = 12;
  // the staged floats: the plane's origin po, its medium, its edges
  // e0 = w0 l0 and e1 = w1 l1 (the products plane_hit's caller forms, so
  // the same bits), two unused
  enum : int { S_O = 0, S_MED = 3, S_E0 = 4, S_E1 = 8 };
  struct Geo {};
  __host__ __device__ static void stage(const float* b, float* s) {
    const V3 e0 = scale3(ld3(b, B_D), b[B_LEN]);
    const V3 e1 = scale3(ld3(b, B_W1), b[B_L1]);
    const float v[SW] = {b[B_O], b[B_O + 1], b[B_O + 2], b[B_MED],
                         e0.x,   e0.y,       e0.z,       0.0f,
                         e1.x,   e1.y,       e1.z,       0.0f};
    for (int c = 0; c < SW; ++c) s[c] = v[c];
  }
  // The medium match and a pre-test with no division and no early
  // return: plane_hit's det, a = tt . pv, b = d . qq and c = e1 . qq,
  // computed as plane_hit computes them (the same bits), then, with
  // s = sign(det), s a and s b against [-m |det|, (1 + m) |det|] and s c
  // against (PLANE_T0 |det|, (len (1 + m)) |det|), m = PLANE_M, and
  // |det| > 1e-7 as plane_hit tests it. It only rejects pairs that
  // plane_hit and the six range tests (base) reject. Rounding argument,
  // u = 2^-24: plane_hit's u0 = fl(a fl(1 / det)) = (a / det)(1 + e)
  // with |e| <= 2.0001 u (two roundings; 1 / det is normal for 1e-7 <
  // |det| < 2^126, edges far below 2^63), and the same for u1 and tcam.
  // So u0 <= 1 means s a <= |det| (1 + 2.0002 u), below fl((1 + m) |det|)
  // >= (1 + 8u)(1 - u) |det|; u0 >= 0 means s a >= 0, or a product that
  // rounds to -0 (|s a| < 2^-149 |det|), both above -fl(m |det|); tcam >
  // 1e-5 means s c > 1e-5 |det| (1 - 2.0001 u), above fl(PLANE_T0 |det|)
  // <= 1e-5 |det| (1 - 8u)(1 + u)^2; tcam < len means s c < len |det| (1
  // + 2.0002 u), below fl(fl(len (1 + m)) |det|) >= len |det| (1 + 8u)(1
  // - u)^2. The margins let through the pairs within a few ulp of an
  // edge, which base's exact test then rejects. No guard is needed: a, b,
  // c and det are the exact test's own values, so only the rounding of
  // 1 / det and of the final product separates the two tests.
  __host__ __device__ static bool test(const Query& q, const float* s,
                                       const Params& /*p*/, Geo& /*g*/) {
    const V3 e0 = ld3(s, S_E0), e1 = ld3(s, S_E1);
    const V3 pv = cross3(q.d, e1);
    const float det = dot3(e0, pv);
    const V3 tt = sub3(q.o, ld3(s, S_O));
    const V3 qq = cross3(tt, e0);
    const float sg = det < 0.0f ? -1.0f : 1.0f, ad = fabsf(det);
    const float a = sg * dot3(tt, pv), b = sg * dot3(q.d, qq),
                c = sg * dot3(e1, qq);
    const float lo = PLANE_M * ad, hi = PLANE_HI * ad;
    return (s[S_MED] == q.med) & (ad > 1e-7f) & (a >= -lo) & (a <= hi) &
           (b >= -lo) & (b <= hi) & (c > PLANE_T0 * ad) &
           (c < q.len * PLANE_HI * ad);
  }
  template <int U>
  __host__ __device__ static void test_u(const Query& q, const float (*s)[SW],
                                         const Params& p, Geo* g,
                                         bool* pass) {
    for (int v = 0; v < U; ++v) pass[v] = test(q, s[v], p, g[v]);
  }
  struct Base {
    float c[3];
  };
  // the exact test (plane_hit, with its IEEE division, and the six range
  // tests) and the contribution; a pair that the pre-test let through and
  // this test rejects adds nothing
  __host__ __device__ static bool base(const Query& q, const float* b,
                                       const int* /*key*/,
                                       const Params& /*p*/, const Geo& /*g*/,
                                       Base& s) {
    V3 pw0 = ld3(b, B_D), pw1 = ld3(b, B_W1);
    float pl0 = b[B_LEN], pl1 = b[B_L1];
    float t0 = 0.0f, t1 = 0.0f, tcam = 0.0f;
    const bool hit = plane_hit(q.o, q.d, ld3(b, B_O), scale3(pw0, pl0),
                               scale3(pw1, pl1), t0, t1, tcam);
    const bool ok = hit & (t0 >= 0.0f) & (t0 <= 1.0f) & (t1 >= 0.0f) &
                    (t1 <= 1.0f) & (tcam > 1e-5f) & (tcam < q.len);
    t0 = t0 * pl0;
    t1 = t1 * pl1;
    float pf = phase(-dot3(pw1, q.d), q.g, q.pt);
    float surv1 = expf(-b[B_SIG] * t1);
    float jac = fabsf(dot3(pw0, cross3(pw1, q.d)));
    float sc = pf / (cmin_(survival(q, t0), 1e-9f) * cmin_(surv1, 1e-9f) *
                     cmin_(jac, 1e-6f));
    for (int ch = 0; ch < 3; ++ch)
      s.c[ch] = b[B_ALPHA + ch] *
                (expf(-q.st[ch] * tcam) * expf(-q.st[ch] * t0) *
                 expf(-q.st[ch] * t1) * q.ss[ch] * q.ss[ch] * sc);
    return ok;
  }
};

// ----------------------------------------------------- gradient functors
// The G-VPM beam and plane gathers of gvpm_tpu/integrators/
// gradient_gather.py:
//
//   GBeam1D  — beam_gradient_gather (:1232)
//   GBeam3D  — beam3d_gradient_gather (:1580)
//   GPlane0D — plane_gradient_gather (:1960)
//
// each a template on ME (use_manifold): GBeam1D = GBeam1DT<false> etc.
// are the use_manifold=False sweeps, GBeam1DME = GBeam1DT<true> etc. the
// ME instantiations, which also collect each query's manifold pairs for
// the host's ME stage (gradient_gather.py:1346-1355, 1710-1720,
// 2091-2100). A beam is ME-eligible when its origin is a delta surface
// that cannot reconnect (_beam_me_elig, :1215). The flag is folded into
// the tail's reconnectable slot, which an ME sweep's tails hold as -1
// for an eligible beam (eligibility implies not reconnectable; the ME-off
// tails hold 0 / 1 and never read it). An accepted pair on an eligible
// beam takes no identity shift (the reference's ~me_t in ok_id: S gets 0,
// W the base at weight 1); the ME stage resolves the first such pair of
// each query. Two more counts a query: cnt[C_KEY], the lowest packed
// index of an eligible beam among its accepted pairs (ME_NONE if none;
// the kernel reduces it by min over the beam splits), and cnt[C_ME], the
// number of those pairs (a sum); GBeam3D<ME> also returns the chosen
// pair's chord point y in out[NF_SUM .. NF_SUM + 2], which gsweep.cu
// recomputes (GBeam3DT::point) once the key is final, so the host never
// does. All three come in test / base / shift parts for gsweep.cu's
// queued sweep (pair_body below), where the ME key is a min over all of
// a query's eligible pairs.
//
// The base test and term are the primal estimator's (with the gradient
// gathers' phase_params). A pair that passes it reads the beam's
// gradient tail (TSlot: the shift caches of the vertex that emits the
// beam and its baked material) and the query's four offset rays (XSlot),
// and shifts the pair to each offset: by
// reconnection at the beam's origin when that lobe is reconnectable
// (beam1d / beam3d: re-emit the beam through the mapped point; plane0d:
// rotate the plane about its origin), else by the identity (the same
// beam or plane against the offset ray). Pairwise MIS between base and
// offset densities, 1 on the image border. Per query: acc[0..2] the base
// sum, acc[3 + 3i + c] the shifted sum S_i and acc[15 + 3i + c] the
// MIS-weighted base sum W_i of offset i; cnt[0] the accepted pairs
// (visits), cnt[1] the successful reconnections (shift_ok). The camera
// throughputs (base, and each offset's) are per query and applied by the
// caller. The plain version is ops/beam_sweep.py's _g* functions, in the
// same operation order.

constexpr int NF_GRAD = 27;             // base, S 4 x 3, W 4 x 3
constexpr int C_KEY = 2, C_ME = 3;      // the ME counts' slots
constexpr int ME_NONE = 0x7fffffff;     // ops/fused_gather.ME_NONE

// the query's offset rays (ops/beam_sweep.XSLOT): offset i at XSTRIDE i
// — origin (beam3d: the offset distance sample), direction, length,
// validity (beam3d: cam_ok), camera pdf ratio (beam3d: pr_cam), border
enum XSlot : int {
  X_O = 0, X_D = 3, X_LEN = 6, X_OK = 7, X_SENS = 8, X_BORDER = 9,
  XSTRIDE = 10, XW = 40
};
// a beam's (or plane's) gradient tail (ops/beam_sweep.TSLOT)
enum TSlot : int {
  T_PP = 0, T_PWI = 3, T_PNS = 6, T_SC = 9, T_ALB = 12, T_SPEC = 15,
  T_ETA3 = 18, T_SIGS = 21, T_PDF = 24, T_PTYPE = 25, T_RECONN = 26,
  T_BTYPE = 27, T_ALPHA = 28, T_ETA1 = 29, T_G = 30, T_MPTYPE = 31, TW = 32
};

// the vertex that emits the beam: its shift caches and material
struct Parent {
  V3 A, pwi, pns, sigs;
  float sc_old[3], pdf_old, sc_old_max, g;
  int ptype, mptype;
  bool reconn;
  BsdfParams bpar;
};

__host__ __device__ inline Parent load_parent(const float* t) {
  Parent r;
  r.A = ld3(t, T_PP);
  r.pwi = ld3(t, T_PWI);
  r.pns = ld3(t, T_PNS);
  r.sigs = ld3(t, T_SIGS);
  for (int c = 0; c < 3; ++c) r.sc_old[c] = t[T_SC + c];
  r.sc_old_max = maximum_(maximum_(r.sc_old[0], r.sc_old[1]), r.sc_old[2]);
  r.pdf_old = t[T_PDF];
  r.g = t[T_G];
  r.ptype = (int)t[T_PTYPE];
  r.mptype = (int)t[T_MPTYPE];
  r.reconn = t[T_RECONN] > 0.5f;
  r.bpar = {(int)t[T_BTYPE], ld3(t, T_ALB), ld3(t, T_SPEC), ld3(t, T_ETA3),
            t[T_ALPHA], t[T_ETA1]};
  return r;
}

// the lobe at the beam's origin toward w_new; ok_rc's lobe terms; sc_r
// the per-channel scatter ratio (0 unless ok)
__host__ __device__ inline bool lobe_ratio(const Parent& a, V3 w_new,
                                           float sc_r[3], float& pdf_new) {
  float sc[3];
  bool ok_sc = parent_lobe(a.ptype, a.pwi, a.pns, a.bpar, a.sigs, a.g,
                           a.mptype, w_new, sc, pdf_new);
  bool ok = ok_sc && (a.sc_old_max > 0.0f) && (a.pdf_old > 1e-20f) &&
            (pdf_new > 0.0f);
  for (int c = 0; c < 3; ++c) sc_r[c] = sc[c] / cmin_(a.sc_old[c], 1e-20f);
  return ok;
}

// MIS weight of offset i: pairwise between the base and the offset
// densities, 1 on the image border
__host__ __device__ inline float mis_weight(bool ok_sh, float pr_l,
                                            float sens, bool border) {
  float w = 1.0f / (1.0f + clip_(pr_l * sens, 0.0f, 1e12f));
  w = clip_(ok_sh ? w : 1.0f, 0.0f, 1.0f);
  return border ? 1.0f : w;
}

// The gradient functors come in three parts, for the queued sweep of
// csrc/gsweep.cu: test(q, b, p, g) is the sweep's test (run on every
// pair) and leaves in g what the rest reuses; base(q, b, key, p, g, s)
// the base term of a queued pair and what its shifts share (key: the
// beam's beam_keys row, GBeam3DT's only), returning whether the pair is
// accepted: GBeam1DT's and GPlane0DT's test is their whole base test,
// GBeam3DT's base still draws the chord sample and tests it; shift(q,
// b, tail, me, x, p, g, s, c_sh, pr_l) one offset's shift (x: the
// offset's XSTRIDE floats), returning ok_sh; it loads the parent from
// the tail in its reconnection branch only, so the parent's ~30 values
// are not live across the four shifts. pair_body below strings them
// together in the order of the reference's per-pair terms.

template <bool ME_>
struct GBeam1DT {
  static constexpr bool RANDOM = false, ME = ME_, PRIMAL = false,
                        PRETEST = false;
  static constexpr int NF = NF_GRAD, NC = ME ? 4 : 2, NF_SUM = NF_GRAD;
  struct Geo {
    Closest h;
  };
  // every value computed and every condition evaluated (no early
  // return), so that the sweep's tests of several beams interleave
  __host__ __device__ static bool test(const Query& q, const float* b,
                                       const Params& p, Geo& g) {
    V3 ob = ld3(b, B_O), db = ld3(b, B_D);
    g.h = closest(q.o, q.d, ob, db);
    const float tc = g.h.tc, tb = g.h.tb;
    V3 delta = sub3(madd3(q.o, q.d, tc), madd3(ob, db, tb));
    return (b[B_MED] == q.med) & !g.h.parallel & (tc > 1e-5f) &
           (tc < q.len) & (tb > 1e-5f) & (tb < b[B_LEN]) &
           (dot3(delta, delta) < p.r2);
  }
  struct Base {
    float c[3], tr_c[3], sin_t, surv_b;
    V3 delta;
  };
  __host__ __device__ static bool base(const Query& q, const float* b,
                                       const int* /*key*/, const Params& p,
                                       const Geo& g, Base& s) {
    const Closest& h = g.h;
    V3 ob = ld3(b, B_O), db = ld3(b, B_D);
    s.delta = sub3(madd3(q.o, q.d, h.tc), madd3(ob, db, h.tb));
    s.sin_t = sqrtf(cmin_(h.denom, 1e-12f));
    s.surv_b = survival(q, h.tb);
    float s_b = phase_params(-h.bb, q.g, q.pt) * p.k /
                (s.sin_t * cmin_(s.surv_b, 1e-9f));
    for (int c = 0; c < 3; ++c) {
      s.tr_c[c] = expf(-q.st[c] * h.tc);
      s.c[c] = b[B_ALPHA + c] *
               (s_b * s.tr_c[c] * expf(-q.st[c] * h.tb) * q.ss[c]);
    }
    return true;
  }
  __host__ __device__ static bool shift(const Query& q, const float* b,
                                        const float* tail, bool me,
                                        const float* x, const Params& p,
                                        const Geo& g, const Base& s,
                                        float c_sh[3], float& pr_l) {
    const float tc = g.h.tc, tb = g.h.tb, lb = b[B_LEN];
    V3 so = ld3(x, X_O), sd = ld3(x, X_D);
    const float slen = x[X_LEN];
    const bool sval = x[X_OK] > 0.5f;
    bool ok_sh;
    if (tail[T_RECONN] > 0.5f) {
      // re-emit the beam from its origin through y_i = pc_i - delta
      const Parent a = load_parent(tail);
      V3 dv = sub3(sub3(madd3(so, sd, tc), s.delta), a.A);
      float t_new2 = cmin_(dot3(dv, dv), 1e-12f);
      float t_new = sqrtf(t_new2);
      V3 w_new = {dv.x / t_new, dv.y / t_new, dv.z / t_new};
      float sc_r[3], pdf_new;
      bool ok_l = lobe_ratio(a, w_new, sc_r, pdf_new);
      float cos_x = w_new.x * sd.x + w_new.y * sd.y + w_new.z * sd.z;
      float sin_n = sqrtf(cmin_(1.0f - cos_x * cos_x, 1e-8f));
      float surv_n = survival(q, t_new);
      ok_sh = ok_l && sval && (tc < slen) && (t_new < lb);
      float s_n = phase_params(-cos_x, q.g, q.pt) * p.k /
                  (sin_n * cmin_(surv_n, 1e-9f));
      for (int c = 0; c < 3; ++c)
        c_sh[c] = ok_sh ? b[B_ALPHA + c] * sc_r[c] *
                              (s_n * s.tr_c[c] * expf(-q.st[c] * t_new) *
                               q.ss[c])
                        : 0.0f;
      pr_l = pdf_new / cmin_(a.pdf_old, 1e-20f) *
             (surv_n / cmin_(s.surv_b, 1e-9f)) * (tb * tb / t_new2) *
             (s.sin_t / sin_n);
    } else if (me) {
      // resolved by the ME stage: no identity shift
      ok_sh = false;
      c_sh[0] = c_sh[1] = c_sh[2] = 0.0f;
      pr_l = 1.0f;
    } else {
      // identity: the same beam against the offset ray
      V3 ob = ld3(b, B_O), db = ld3(b, B_D);
      const Closest hi = closest(so, sd, ob, db);
      const float tci = hi.tc, tbi = hi.tb;
      V3 di = sub3(madd3(so, sd, tci), madd3(ob, db, tbi));
      ok_sh = !hi.parallel && sval && (tci > 1e-5f) && (tci < slen) &&
              (tbi > 1e-5f) && (tbi < lb) && (dot3(di, di) < p.r2);
      float sin_i = sqrtf(cmin_(hi.denom, 1e-12f));
      float s_i = phase_params(-hi.bb, q.g, q.pt) * p.k /
                  (sin_i * cmin_(survival(q, tbi), 1e-9f));
      for (int c = 0; c < 3; ++c)
        c_sh[c] = ok_sh ? b[B_ALPHA + c] *
                              (s_i * expf(-q.st[c] * tci) *
                               expf(-q.st[c] * tbi) * q.ss[c])
                        : 0.0f;
      pr_l = 1.0f;
    }
    return ok_sh;
  }
};

template <bool ME_>
struct GBeam3DT {
  static constexpr bool RANDOM = true, ME = ME_, PRIMAL = false,
                        PRETEST = false;
  static constexpr int NF = ME ? NF_GRAD + 3 : NF_GRAD, NC = ME ? 4 : 2,
                       NF_SUM = NF_GRAD;
  using Geo = Chord;
  // the chord test (chord_test); the threefry word is left to base, which
  // runs on the queued pairs only, 8 of them side by side in a batch
  __host__ __device__ static bool test(const Query& q, const float* b,
                                       const Params& p, Geo& g) {
    return chord_test(q, b, p, g);
  }
  // gbeam3d_me's chord point of a query's ME pair: the point base placed,
  // by the same code
  __host__ __device__ static V3 point(const Query& q, const float* b,
                                      const int* key, const Params& p) {
    Geo g;
    test(q, b, p, g);
    float us, s;
    return chord_sample(q, b, key, p, g, us, s);
  }
  struct Base {
    float c[3], us, s, surv_b;
    V3 yx;   // y - x
  };
  // false when the sample falls outside the kernel sphere, which only
  // rounding at the chord's ends does: the pair then adds nothing
  __host__ __device__ static bool base(const Query& q, const float* b,
                                       const int* key, const Params& p,
                                       const Geo& g, Base& s) {
    const V3 y = chord_sample(q, b, key, p, g, s.us, s.s);
    const V3 e = sub3(q.o, y);
    s.yx = sub3(y, q.o);
    s.surv_b = survival(q, s.s);
    float k_b = g.ch * p.k * phase_params(-dot3(ld3(b, B_D), q.d), q.g, q.pt) /
                cmin_(s.surv_b, 1e-9f);
    for (int c = 0; c < 3; ++c)
      s.c[c] = b[B_ALPHA + c] * expf(-q.st[c] * s.s) * k_b;
    return dot3(e, e) < p.r2;
  }
  __host__ __device__ static bool shift(const Query& q, const float* b,
                                        const float* tail, bool me,
                                        const float* x, const Params& p,
                                        const Geo& g, const Base& s,
                                        float c_sh[3], float& pr_l) {
    const float lb = b[B_LEN];
    V3 xs = ld3(x, X_O), sd = ld3(x, X_D);
    const bool cam_ok = x[X_OK] > 0.5f;
    bool ok_sh;
    if (tail[T_RECONN] > 0.5f) {
      // re-emit the beam from its origin through y_i = xs_i + (y - x)
      const Parent a = load_parent(tail);
      V3 dv = sub3(add3(xs, s.yx), a.A);
      float t_new2 = cmin_(dot3(dv, dv), 1e-12f);
      float t_new = sqrtf(t_new2);
      V3 w_new = {dv.x / t_new, dv.y / t_new, dv.z / t_new};
      float sc_r[3], pdf_new;
      bool ok_l = lobe_ratio(a, w_new, sc_r, pdf_new);
      // the new beam's chord inside the offset kernel sphere
      V3 rel_n = sub3(xs, a.A);
      float sm_n = rel_n.x * w_new.x + rel_n.y * w_new.y + rel_n.z * w_new.z;
      float d2p_n = dot3(rel_n, rel_n) - sm_n * sm_n;
      float half_n = sqrtf(cmin_(p.r2 - d2p_n, 0.0f));
      float s0n = cmin_(sm_n - half_n, 0.0f);
      float s1n = minimum_(sm_n + half_n, lb);
      float chord_n = cmin_(s1n - s0n, 0.0f);
      float cos_x = w_new.x * sd.x + w_new.y * sd.y + w_new.z * sd.z;
      float surv_n = survival(q, t_new);
      ok_sh = ok_l && cam_ok && (chord_n > 0.0f) && (t_new >= s0n) &&
              (t_new <= s1n);
      float k_n = chord_n * p.k * phase_params(-cos_x, q.g, q.pt) /
                  cmin_(surv_n, 1e-9f);
      for (int c = 0; c < 3; ++c)
        c_sh[c] = ok_sh ? b[B_ALPHA + c] * sc_r[c] * expf(-q.st[c] * t_new) *
                              k_n
                        : 0.0f;
      pr_l = pdf_new / cmin_(a.pdf_old, 1e-20f) *
             (surv_n / cmin_(s.surv_b, 1e-9f)) * (s.s * s.s / t_new2) *
             (g.ch / cmin_(chord_n, 1e-12f));
    } else if (me) {
      // resolved by the ME stage: no identity shift
      ok_sh = false;
      c_sh[0] = c_sh[1] = c_sh[2] = 0.0f;
      pr_l = 1.0f;
    } else {
      // identity: the same beam's chord around the offset sample, at the
      // base pair's chord fraction us
      V3 ob = ld3(b, B_O), db = ld3(b, B_D);
      float s0i;
      const float chord_i = chord(xs, ob, db, lb, p.r2, s0i);
      float s_id = s0i + s.us * chord_i;
      V3 ei = sub3(xs, madd3(ob, db, s_id));
      ok_sh = cam_ok && (chord_i > 0.0f) && (dot3(ei, ei) < p.r2);
      float k_i = chord_i * p.k * phase_params(-dot3(db, sd), q.g, q.pt) /
                  cmin_(survival(q, s_id), 1e-9f);
      for (int c = 0; c < 3; ++c)
        c_sh[c] = ok_sh ? b[B_ALPHA + c] * expf(-q.st[c] * s_id) * k_i : 0.0f;
      pr_l = 1.0f;
    }
    return ok_sh;
  }
};

// v rotated about the unit axis k by the angle of (cos_r, sin_r)
__host__ __device__ inline V3 rodrigues(V3 v, V3 k, float cos_r,
                                        float sin_r) {
  float kdv = k.x * v.x + k.y * v.y + k.z * v.z;
  float cx = k.y * v.z - k.z * v.y;
  float cy = k.z * v.x - k.x * v.z;
  float cz = k.x * v.y - k.y * v.x;
  float f = kdv * (1.0f - cos_r);
  return {v.x * cos_r + cx * sin_r + k.x * f,
          v.y * cos_r + cy * sin_r + k.y * f,
          v.z * cos_r + cz * sin_r + k.z * f};
}

template <bool ME_>
struct GPlane0DT {
  static constexpr bool RANDOM = false, ME = ME_, PRIMAL = false,
                        PRETEST = false;
  static constexpr int NF = NF_GRAD, NC = ME ? 4 : 2, NF_SUM = NF_GRAD;
  struct Geo {
    float u0, u1, tcam;
  };
  // plane_hit's arithmetic with every value computed and every
  // condition evaluated (no early return), as GBeam1DT::test
  __host__ __device__ static bool test(const Query& q, const float* b,
                                       const Params& /*p*/, Geo& g) {
    V3 e0 = scale3(ld3(b, B_D), b[B_LEN]), e1 = scale3(ld3(b, B_W1), b[B_L1]);
    V3 pv = cross3(q.d, e1);
    float det = dot3(e0, pv);
    float inv_det = 1.0f / det;
    V3 tt = sub3(q.o, ld3(b, B_O));
    g.u0 = dot3(tt, pv) * inv_det;
    V3 qq = cross3(tt, e0);
    g.u1 = dot3(q.d, qq) * inv_det;
    g.tcam = dot3(e1, qq) * inv_det;
    return (b[B_MED] == q.med) & (fabsf(det) > 1e-7f) & (g.u0 >= 0.0f) &
           (g.u0 <= 1.0f) & (g.u1 >= 0.0f) & (g.u1 <= 1.0f) &
           (g.tcam > 1e-5f) & (g.tcam < q.len);
  }
  struct Base {
    float c[3], tr_cam[3], t0, t1, surv0, surv1, jac, lb_r;
    V3 a_dir;
  };
  __host__ __device__ static bool base(const Query& q, const float* b,
                                       const int* /*key*/,
                                       const Params& /*p*/, const Geo& g,
                                       Base& s) {
    V3 pw0 = ld3(b, B_D), pw1 = ld3(b, B_W1);
    s.t0 = g.u0 * b[B_LEN];
    s.t1 = g.u1 * b[B_L1];
    s.surv0 = survival(q, s.t0);
    s.surv1 = expf(-b[B_SIG] * s.t1);
    s.jac = fabsf(dot3(pw0, cross3(pw1, q.d)));
    float k_b = phase_params(-dot3(pw1, q.d), q.g, q.pt) /
                (cmin_(s.surv0, 1e-9f) * cmin_(s.surv1, 1e-9f) *
                 cmin_(s.jac, 1e-6f));
    for (int c = 0; c < 3; ++c) {
      s.tr_cam[c] = expf(-q.st[c] * g.tcam);
      s.c[c] = b[B_ALPHA + c] *
               (s.tr_cam[c] * expf(-q.st[c] * s.t0) *
                expf(-q.st[c] * s.t1) * q.ss[c] * q.ss[c] * k_b);
    }
    // the base point's direction from the plane's origin
    V3 rel_b = sub3(madd3(q.o, q.d, g.tcam), ld3(b, B_O));
    s.lb_r = sqrtf(cmin_(dot3(rel_b, rel_b), 1e-16f));
    s.a_dir = {rel_b.x / s.lb_r, rel_b.y / s.lb_r, rel_b.z / s.lb_r};
    return true;
  }
  __host__ __device__ static bool shift(const Query& q, const float* b,
                                        const float* tail, bool me,
                                        const float* x, const Params& /*p*/,
                                        const Geo& g, const Base& s,
                                        float c_sh[3], float& pr_l) {
    V3 po = ld3(b, B_O), pw0 = ld3(b, B_D), pw1 = ld3(b, B_W1);
    const float pl0 = b[B_LEN], pl1 = b[B_L1], psig = b[B_SIG];
    const float tcam = g.tcam;
    V3 so = ld3(x, X_O), sd = ld3(x, X_D);
    const float slen = x[X_LEN];
    const bool sval = x[X_OK] > 0.5f;
    bool ok_sh;
    if (tail[T_RECONN] > 0.5f) {
      // rotate the plane about its origin so that it holds the offset
      // point at the same camera distance
      const Parent a = load_parent(tail);
      V3 rel_o = sub3(madd3(so, sd, tcam), po);
      float lo_r = sqrtf(cmin_(dot3(rel_o, rel_o), 1e-16f));
      V3 b_dir = {rel_o.x / lo_r, rel_o.y / lo_r, rel_o.z / lo_r};
      float cos_r = dot3(s.a_dir, b_dir);
      V3 ax = cross3(s.a_dir, b_dir);
      float sin_r = sqrtf(cmin_(dot3(ax, ax), 0.0f));
      bool safe = sin_r > 1e-7f;
      float sk = cmin_(sin_r, 1e-7f);
      V3 k_hat = {ax.x / sk, ax.y / sk, ax.z / sk};
      V3 w0_r = safe ? rodrigues(pw0, k_hat, cos_r, sin_r) : pw0;
      V3 w1_r = safe ? rodrigues(pw1, k_hat, cos_r, sin_r) : pw1;
      float scale = lo_r / s.lb_r;
      float t0_n = s.t0 * scale, t1_n = s.t1 * scale;
      bool ok_geo = (safe || (cos_r > 0.0f)) && (t0_n <= pl0) &&
                    (t1_n <= pl1);
      float sc_r[3], pdf_new;
      bool ok_l = lobe_ratio(a, w0_r, sc_r, pdf_new);
      float cos_ci = w1_r.x * sd.x + w1_r.y * sd.y + w1_r.z * sd.z;
      float surv0n = survival(q, t0_n);
      float surv1n = expf(-psig * t1_n);
      V3 cw = cross3(w1_r, sd);
      float jac_n = fabsf(w0_r.x * cw.x + w0_r.y * cw.y + w0_r.z * cw.z);
      ok_sh = ok_l && sval && ok_geo && (tcam < slen) && (jac_n > 1e-6f);
      float k_n = phase_params(-cos_ci, q.g, q.pt) /
                  (cmin_(surv0n, 1e-9f) * cmin_(surv1n, 1e-9f) *
                   cmin_(jac_n, 1e-6f));
      for (int c = 0; c < 3; ++c)
        c_sh[c] = ok_sh ? b[B_ALPHA + c] * sc_r[c] *
                              (s.tr_cam[c] * expf(-q.st[c] * t0_n) *
                               expf(-q.st[c] * t1_n) * q.ss[c] * q.ss[c] *
                               k_n)
                        : 0.0f;
      pr_l = pdf_new / cmin_(a.pdf_old, 1e-20f) *
             (surv0n / cmin_(s.surv0, 1e-9f)) *
             (surv1n / cmin_(s.surv1, 1e-9f)) *
             (s.jac / cmin_(jac_n, 1e-6f)) / cmin_(scale * scale, 1e-12f);
    } else if (me) {
      // resolved by the ME stage: no identity shift
      ok_sh = false;
      c_sh[0] = c_sh[1] = c_sh[2] = 0.0f;
      pr_l = 1.0f;
    } else {
      // identity: the same plane against the offset ray
      V3 e0 = scale3(pw0, pl0), e1 = scale3(pw1, pl1);
      float u0i = 0.0f, u1i = 0.0f, tci = 0.0f;
      const bool oki = plane_hit(so, sd, po, e0, e1, u0i, u1i, tci);
      ok_sh = oki && sval && (u0i >= 0.0f) && (u0i <= 1.0f) &&
              (u1i >= 0.0f) && (u1i <= 1.0f) && (tci > 1e-5f) &&
              (tci < slen);
      float t0i = u0i * pl0, t1i = u1i * pl1;
      float jaci = fabsf(dot3(pw0, cross3(pw1, sd)));
      float k_i = phase_params(-dot3(pw1, sd), q.g, q.pt) /
                  (cmin_(survival(q, t0i), 1e-9f) *
                   cmin_(expf(-psig * t1i), 1e-9f) * cmin_(jaci, 1e-6f));
      for (int c = 0; c < 3; ++c)
        c_sh[c] = ok_sh ? b[B_ALPHA + c] *
                              (expf(-q.st[c] * tci) * expf(-q.st[c] * t0i) *
                               expf(-q.st[c] * t1i) * q.ss[c] * q.ss[c] *
                               k_i)
                        : 0.0f;
      pr_l = 1.0f;
    }
    return ok_sh;
  }
};

// F's test of a pair from its whole beam row b (BW floats): a primal
// functor's on the floats its stage takes from the row
template <class F>
__host__ __device__ inline bool test_row(const Query& q, const float* b,
                                         const Params& p,
                                         typename F::Geo& g) {
  if constexpr (F::PRIMAL) {
    float s[F::SW];
    F::stage(b, s);
    return F::test(q, s, p, g);
  } else {
    return F::test(q, b, p, g);
  }
}

// One queued pair of a test / base / shift functor F in a shift batch:
// its base term, then its shifts to the offsets i = first, first +
// STRIDE, ... < 4 (STRIDE 1: all four in one lane; 4: one offset a
// lane). Its sums leave through the sink: base(c, v) the base term,
// offset(3 + 3i + c, v) / offset(15 + 3i + c, v) S_i and W_i, visit(ok,
// me, j) whether the pair was accepted, and its ME count and key (j: the
// beam's packed index), reconnected(n) its successful reconnections. A
// pair that base rejects (GBeam3DT's sample outside the sphere) writes
// zeros and no visit, as the reference's okb excludes it. The sink keeps
// one lane's share of each pair's base, visit and ME counts. A primal
// functor's pair (F::PRIMAL: Beam1D, Beam3D, Plane0D) is its base term
// and visit alone: no tail, no offsets (both may be null), STRIDE 1; a
// pair that its base rejects (Beam1D's and Plane0D's exact test, Beam3D's
// sample) adds nothing.
template <class F, int STRIDE, class Sink>
__host__ __device__ inline void pair_body(const Query& q, const float* b,
                                          const int* key, const float* tail,
                                          const float* qx, const Params& p,
                                          const typename F::Geo& g,
                                          int first, int j, Sink& sink) {
  typename F::Base s;
  const bool ok = F::base(q, b, key, p, g, s);
  const bool me = F::ME && tail[T_RECONN] < -0.5f;
  for (int c = 0; c < 3; ++c) sink.base(c, ok ? s.c[c] : 0.0f);
  sink.visit(ok, me, j);
  if constexpr (!F::PRIMAL) {
    int n_rc = 0;
#pragma unroll 1
    for (int k = 0; k < 4 / STRIDE; ++k) {
      const int i = first + k * STRIDE;
      const float* x = qx + XSTRIDE * i;
      float c_sh[3] = {0.0f, 0.0f, 0.0f}, w = 0.0f;
      if (ok) {
        float pr_l;
        const bool ok_sh = F::shift(q, b, tail, me, x, p, g, s, c_sh, pr_l);
        n_rc += (tail[T_RECONN] > 0.5f && ok_sh) ? 1 : 0;
        w = mis_weight(ok_sh, pr_l, x[X_SENS], x[X_BORDER] > 0.5f);
      }
      for (int c = 0; c < 3; ++c) {
        sink.offset(3 + 3 * i + c, w * c_sh[c]);
        sink.offset(15 + 3 * i + c, ok ? w * s.c[c] : 0.0f);
      }
    }
    sink.reconnected(n_rc);
  }
}

using GBeam1D = GBeam1DT<false>;
using GBeam3D = GBeam3DT<false>;
using GPlane0D = GPlane0DT<false>;
using GBeam1DME = GBeam1DT<true>;
using GBeam3DME = GBeam3DT<true>;
using GPlane0DME = GPlane0DT<true>;

}  // namespace beam
