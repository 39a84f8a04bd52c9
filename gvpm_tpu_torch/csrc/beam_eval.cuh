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
// squared radius r2 around x: its length, and its start in s0
__host__ __device__ inline float chord(V3 x, V3 ob, V3 db, float lb,
                                       float r2, float& s0) {
  V3 rel = sub3(x, ob);
  float s_mid = dot3(rel, db);
  V3 perp = sub3(rel, scale3(db, s_mid));
  float half = sqrtf(cmin_(r2 - dot3(perp, perp), 0.0f));
  s0 = cmin_(s_mid - half, 0.0f);
  float s1 = minimum_(s_mid + half, lb);
  return cmin_(s1 - s0, 0.0f);
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
    const Closest h = closest(q.o, q.d, ob, db);
    const float tc = h.tc, tb = h.tb;
    if (h.parallel || !(tc > 1e-5f) || !(tc < q.len) || !(tb > 1e-5f) ||
        !(tb < b[B_LEN]))
      return false;
    V3 delta = sub3(madd3(q.o, q.d, tc), madd3(ob, db, tb));
    if (!(dot3(delta, delta) < p.r2)) return false;
    float sin_t = sqrtf(cmin_(h.denom, 1e-12f));
    float pf = phase(-h.bb, q.g, q.pt);
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
    float s0;
    const float ch = chord(q.o, ob, db, b[B_LEN], p.r2, s0);
    if (!(ch > 0.0f)) return false;
    float us = counter_uniform((uint32_t)key[0], (uint32_t)key[1],
                               q.m * p.tile + (uint32_t)key[2]);
    float s = s0 + us * ch;
    V3 e = sub3(q.o, madd3(ob, db, s));
    if (!(dot3(e, e) < p.r2)) return false;
    float pf = phase(-dot3(db, q.d), q.g, q.pt);
    float sc = ch * p.k * pf / cmin_(survival(q, s), 1e-9f);
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
    float t0, t1, tcam;
    if (!plane_hit(q.o, q.d, ld3(b, B_O), scale3(pw0, pl0), scale3(pw1, pl1),
                   t0, t1, tcam))
      return false;
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

// ------------------------------------------------------- primal visit
// The sweep kernel's interface (beam_sweep.cu): visit(q, b, key, tail,
// qx, p, acc, cnt, j) adds the pair of the query and beam j (its index
// among the packed beams) to the query's NF float and NC integer
// accumulators, of which the first NF_SUM floats and every count but an
// ME instantiation's key are sums. A primal pair adds its contribution
// and one count.

template <class P>
struct Primal {
  static constexpr bool RANDOM = P::RANDOM, GRAD = false, ME = false;
  static constexpr int NF = 3, NC = 1, NF_SUM = 3;
  __host__ __device__ static void visit(const Query& q, const float* b,
                                        const int* key, const float*,
                                        const float*, const Params& p,
                                        float* acc, int* cnt, int = 0) {
    float c[3];
    if (P::pair(q, b, key, p, c)) {
      acc[0] += c[0];
      acc[1] += c[1];
      acc[2] += c[2];
      ++cnt[0];
    }
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
// number of those pairs (a sum); GBeam3D<ME> also keeps the chosen
// pair's chord point y in acc[NF_SUM .. NF_SUM + 2], taken from the
// split that holds the key, so the host never recomputes it.
//
// The base test and term are the primal estimator's (with the gradient
// gathers' phase_params). A pair that passes it reads the beam's
// gradient tail (TSlot: the shift caches of the vertex that emits the
// beam and its baked material) and the query's four offset rays (XSlot)
// from device memory, and shifts the pair to each offset: by
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

// an accepted pair on an ME-eligible beam j: count it; true when it is
// the query's first (each thread visits its beams in increasing j)
__host__ __device__ inline bool me_first(int j, int* cnt) {
  ++cnt[C_ME];
  if (cnt[C_KEY] != ME_NONE) return false;
  cnt[C_KEY] = j;
  return true;
}

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

// MIS weight of offset i and the pair's S_i / W_i terms
__host__ __device__ inline void add_offset(int i, bool ok_sh, float pr_l,
                                           float sens, bool border,
                                           const float c_sh[3],
                                           const float c_base[3],
                                           float* acc) {
  float w = 1.0f / (1.0f + clip_(pr_l * sens, 0.0f, 1e12f));
  w = clip_(ok_sh ? w : 1.0f, 0.0f, 1.0f);
  w = border ? 1.0f : w;
  for (int c = 0; c < 3; ++c) {
    acc[3 + 3 * i + c] += w * c_sh[c];
    acc[15 + 3 * i + c] += w * c_base[c];
  }
}

template <bool ME_>
struct GBeam1DT {
  static constexpr bool RANDOM = false, GRAD = true, ME = ME_;
  static constexpr int NF = NF_GRAD, NC = ME ? 4 : 2, NF_SUM = NF_GRAD;
  __host__ __device__ static void visit(const Query& q, const float* b,
                                        const int*, const float* tail,
                                        const float* qx, const Params& p,
                                        float* acc, int* cnt, int j = 0) {
    if (b[B_MED] != q.med) return;
    V3 ob = ld3(b, B_O), db = ld3(b, B_D);
    const float lb = b[B_LEN];
    const Closest h = closest(q.o, q.d, ob, db);
    const float tc = h.tc, tb = h.tb;
    if (h.parallel || !(tc > 1e-5f) || !(tc < q.len) || !(tb > 1e-5f) ||
        !(tb < lb))
      return;
    V3 delta = sub3(madd3(q.o, q.d, tc), madd3(ob, db, tb));
    if (!(dot3(delta, delta) < p.r2)) return;
    // ---- base term ----
    float sin_t = sqrtf(cmin_(h.denom, 1e-12f));
    float surv_b = survival(q, tb);
    float s_b = phase_params(-h.bb, q.g, q.pt) * p.k /
                (sin_t * cmin_(surv_b, 1e-9f));
    float tr_c[3], c_base[3];
    for (int c = 0; c < 3; ++c) {
      tr_c[c] = expf(-q.st[c] * tc);
      c_base[c] = b[B_ALPHA + c] *
                  (s_b * tr_c[c] * expf(-q.st[c] * tb) * q.ss[c]);
      acc[c] += c_base[c];
    }
    ++cnt[0];
    const bool me = ME && tail[T_RECONN] < -0.5f;
    if (me) me_first(j, cnt);
    // ---- the four shifts ----
    const Parent a = load_parent(tail);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* x = qx + XSTRIDE * i;
      V3 so = ld3(x, X_O), sd = ld3(x, X_D);
      const float slen = x[X_LEN];
      const bool sval = x[X_OK] > 0.5f;
      float c_sh[3], pr_l;
      bool ok_sh;
      if (a.reconn) {
        // re-emit the beam from its origin through y_i = pc_i - delta
        V3 dv = sub3(sub3(madd3(so, sd, tc), delta), a.A);
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
                                (s_n * tr_c[c] * expf(-q.st[c] * t_new) *
                                 q.ss[c])
                          : 0.0f;
        pr_l = pdf_new / cmin_(a.pdf_old, 1e-20f) *
               (surv_n / cmin_(surv_b, 1e-9f)) * (tb * tb / t_new2) *
               (sin_t / sin_n);
        cnt[1] += ok_sh ? 1 : 0;
      } else if (me) {
        // resolved by the ME stage: no identity shift
        ok_sh = false;
        c_sh[0] = c_sh[1] = c_sh[2] = 0.0f;
        pr_l = 1.0f;
      } else {
        // identity: the same beam against the offset ray
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
      add_offset(i, ok_sh, pr_l, x[X_SENS], x[X_BORDER] > 0.5f, c_sh,
                 c_base, acc);
    }
  }
};

template <bool ME_>
struct GBeam3DT {
  static constexpr bool RANDOM = true, GRAD = true, ME = ME_;
  static constexpr int NF = ME ? NF_GRAD + 3 : NF_GRAD, NC = ME ? 4 : 2,
                       NF_SUM = NF_GRAD;
  __host__ __device__ static void visit(const Query& q, const float* b,
                                        const int* key, const float* tail,
                                        const float* qx, const Params& p,
                                        float* acc, int* cnt, int j = 0) {
    if (b[B_MED] != q.med) return;
    V3 ob = ld3(b, B_O), db = ld3(b, B_D);
    const float lb = b[B_LEN];
    float s0;
    const float ch = chord(q.o, ob, db, lb, p.r2, s0);
    if (!(ch > 0.0f)) return;
    float us = counter_uniform((uint32_t)key[0], (uint32_t)key[1],
                               q.m * p.tile + (uint32_t)key[2]);
    float s = s0 + us * ch;
    V3 y = madd3(ob, db, s);
    V3 e = sub3(q.o, y);
    if (!(dot3(e, e) < p.r2)) return;
    // ---- base term ----
    float surv_b = survival(q, s);
    float k_b = ch * p.k * phase_params(-dot3(db, q.d), q.g, q.pt) /
                cmin_(surv_b, 1e-9f);
    float c_base[3];
    for (int c = 0; c < 3; ++c) {
      c_base[c] = b[B_ALPHA + c] * expf(-q.st[c] * s) * k_b;
      acc[c] += c_base[c];
    }
    ++cnt[0];
    const bool me = ME && tail[T_RECONN] < -0.5f;
    if (me && me_first(j, cnt)) {
      acc[NF_SUM] = y.x;
      acc[NF_SUM + 1] = y.y;
      acc[NF_SUM + 2] = y.z;
    }
    V3 yx = sub3(y, q.o);
    // ---- the four shifts ----
    const Parent a = load_parent(tail);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* x = qx + XSTRIDE * i;
      V3 xs = ld3(x, X_O), sd = ld3(x, X_D);
      const bool cam_ok = x[X_OK] > 0.5f;
      float c_sh[3], pr_l;
      bool ok_sh;
      if (a.reconn) {
        // re-emit the beam from its origin through y_i = xs_i + (y - x)
        V3 dv = sub3(add3(xs, yx), a.A);
        float t_new2 = cmin_(dot3(dv, dv), 1e-12f);
        float t_new = sqrtf(t_new2);
        V3 w_new = {dv.x / t_new, dv.y / t_new, dv.z / t_new};
        float sc_r[3], pdf_new;
        bool ok_l = lobe_ratio(a, w_new, sc_r, pdf_new);
        // the new beam's chord inside the offset kernel sphere
        V3 rel_n = sub3(xs, a.A);
        float sm_n = rel_n.x * w_new.x + rel_n.y * w_new.y +
                     rel_n.z * w_new.z;
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
          c_sh[c] = ok_sh ? b[B_ALPHA + c] * sc_r[c] *
                                expf(-q.st[c] * t_new) * k_n
                          : 0.0f;
        pr_l = pdf_new / cmin_(a.pdf_old, 1e-20f) *
               (surv_n / cmin_(surv_b, 1e-9f)) * (s * s / t_new2) *
               (ch / cmin_(chord_n, 1e-12f));
        cnt[1] += ok_sh ? 1 : 0;
      } else if (me) {
        // resolved by the ME stage: no identity shift
        ok_sh = false;
        c_sh[0] = c_sh[1] = c_sh[2] = 0.0f;
        pr_l = 1.0f;
      } else {
        // identity: the same beam's chord around the offset sample, at
        // the base pair's chord fraction us
        float s0i;
        const float chord_i = chord(xs, ob, db, lb, p.r2, s0i);
        float s_id = s0i + us * chord_i;
        V3 ei = sub3(xs, madd3(ob, db, s_id));
        ok_sh = cam_ok && (chord_i > 0.0f) && (dot3(ei, ei) < p.r2);
        float k_i = chord_i * p.k * phase_params(-dot3(db, sd), q.g, q.pt) /
                    cmin_(survival(q, s_id), 1e-9f);
        for (int c = 0; c < 3; ++c)
          c_sh[c] = ok_sh ? b[B_ALPHA + c] * expf(-q.st[c] * s_id) * k_i
                          : 0.0f;
        pr_l = 1.0f;
      }
      add_offset(i, ok_sh, pr_l, x[X_SENS], x[X_BORDER] > 0.5f, c_sh,
                 c_base, acc);
    }
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
  static constexpr bool RANDOM = false, GRAD = true, ME = ME_;
  static constexpr int NF = NF_GRAD, NC = ME ? 4 : 2, NF_SUM = NF_GRAD;
  __host__ __device__ static void visit(const Query& q, const float* b,
                                        const int*, const float* tail,
                                        const float* qx, const Params& p,
                                        float* acc, int* cnt, int j = 0) {
    if (b[B_MED] != q.med) return;
    V3 po = ld3(b, B_O), pw0 = ld3(b, B_D), pw1 = ld3(b, B_W1);
    const float pl0 = b[B_LEN], pl1 = b[B_L1], psig = b[B_SIG];
    V3 e0 = scale3(pw0, pl0), e1 = scale3(pw1, pl1);
    float u0, u1, tcam;
    if (!plane_hit(q.o, q.d, po, e0, e1, u0, u1, tcam)) return;
    if (!(u0 >= 0.0f) || !(u0 <= 1.0f) || !(u1 >= 0.0f) || !(u1 <= 1.0f) ||
        !(tcam > 1e-5f) || !(tcam < q.len))
      return;
    // ---- base term ----
    const float t0 = u0 * pl0, t1 = u1 * pl1;
    float surv0 = survival(q, t0);
    float surv1 = expf(-psig * t1);
    float jac = fabsf(dot3(pw0, cross3(pw1, q.d)));
    float k_b = phase_params(-dot3(pw1, q.d), q.g, q.pt) /
                (cmin_(surv0, 1e-9f) * cmin_(surv1, 1e-9f) *
                 cmin_(jac, 1e-6f));
    float tr_cam[3], c_base[3];
    for (int c = 0; c < 3; ++c) {
      tr_cam[c] = expf(-q.st[c] * tcam);
      c_base[c] = b[B_ALPHA + c] *
                  (tr_cam[c] * expf(-q.st[c] * t0) * expf(-q.st[c] * t1) *
                   q.ss[c] * q.ss[c] * k_b);
      acc[c] += c_base[c];
    }
    ++cnt[0];
    const bool me = ME && tail[T_RECONN] < -0.5f;
    if (me) me_first(j, cnt);
    // the base point's direction from the plane's origin
    V3 rel_b = sub3(madd3(q.o, q.d, tcam), po);
    float lb_r = sqrtf(cmin_(dot3(rel_b, rel_b), 1e-16f));
    V3 a_dir = {rel_b.x / lb_r, rel_b.y / lb_r, rel_b.z / lb_r};
    // ---- the four shifts ----
    const Parent a = load_parent(tail);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* x = qx + XSTRIDE * i;
      V3 so = ld3(x, X_O), sd = ld3(x, X_D);
      const float slen = x[X_LEN];
      const bool sval = x[X_OK] > 0.5f;
      float c_sh[3], pr_l;
      bool ok_sh;
      if (a.reconn) {
        // rotate the plane about its origin so that it holds the offset
        // point at the same camera distance
        V3 rel_o = sub3(madd3(so, sd, tcam), po);
        float lo_r = sqrtf(cmin_(dot3(rel_o, rel_o), 1e-16f));
        V3 b_dir = {rel_o.x / lo_r, rel_o.y / lo_r, rel_o.z / lo_r};
        float cos_r = dot3(a_dir, b_dir);
        V3 ax = cross3(a_dir, b_dir);
        float sin_r = sqrtf(cmin_(dot3(ax, ax), 0.0f));
        bool safe = sin_r > 1e-7f;
        float sk = cmin_(sin_r, 1e-7f);
        V3 k_hat = {ax.x / sk, ax.y / sk, ax.z / sk};
        V3 w0_r = safe ? rodrigues(pw0, k_hat, cos_r, sin_r) : pw0;
        V3 w1_r = safe ? rodrigues(pw1, k_hat, cos_r, sin_r) : pw1;
        float scale = lo_r / lb_r;
        float t0_n = t0 * scale, t1_n = t1 * scale;
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
                                (tr_cam[c] * expf(-q.st[c] * t0_n) *
                                 expf(-q.st[c] * t1_n) * q.ss[c] * q.ss[c] *
                                 k_n)
                          : 0.0f;
        pr_l = pdf_new / cmin_(a.pdf_old, 1e-20f) *
               (surv0n / cmin_(surv0, 1e-9f)) *
               (surv1n / cmin_(surv1, 1e-9f)) * (jac / cmin_(jac_n, 1e-6f)) /
               cmin_(scale * scale, 1e-12f);
        cnt[1] += ok_sh ? 1 : 0;
      } else if (me) {
        // resolved by the ME stage: no identity shift
        ok_sh = false;
        c_sh[0] = c_sh[1] = c_sh[2] = 0.0f;
        pr_l = 1.0f;
      } else {
        // identity: the same plane against the offset ray
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
      add_offset(i, ok_sh, pr_l, x[X_SENS], x[X_BORDER] > 0.5f, c_sh,
                 c_base, acc);
    }
  }
};

using GBeam1D = GBeam1DT<false>;
using GBeam3D = GBeam3DT<false>;
using GPlane0D = GPlane0DT<false>;
using GBeam1DME = GBeam1DT<true>;
using GBeam3DME = GBeam3DT<true>;
using GPlane0DME = GPlane0DT<true>;

}  // namespace beam
