// The Newton solve of a manifold (ME) shift for ONE lane, as
// __host__ __device__ functions: the device side of
// integrators/manifold.py's `_newton3_plain` (volume and beam targets, 3
// unknowns: the anchor direction's two tangent offsets and the final
// distance t) and `_newton2_plain` (surface target, 2 unknowns: the exit
// ray is hit again on the photon's own primitive and the residual is
// taken in the target's tangent frame).
//
// The plain version takes each Jacobian with torch.func.jvp over the
// lanes repeated once per unknown. Here a lane carries its unknowns as
// forward-mode dual numbers, D<N>: a value and its N tangents, so one
// pass through the chain gives the residual and its whole Jacobian. Each
// operation's tangent is the one PyTorch's forward-mode formula gives
// (mul: b'a + a'b; div: (a' - b' q) / b; sqrt: x' / (2 sqrt x); abs: x'
// sign x; clamp: x' where the value was not clamped, else 0), and a
// `torch.where` takes the tangent of the branch it selects. Every
// formula follows the plain version operation by operation, in the same
// order (coordinate_system, _w1_of, _prim_hit with the plane of a
// triangle and the sphere root chosen by `enter`, _bounce, _retrace, the
// adjugate solve, _trust_step, the convergence test), so that a build
// without FMA contraction (-fmad=false) takes the same decisions.
//
// The header also compiles as plain host C++ (with __host__/__device__
// defined away), which is how the CPU tests exercise this source.
#pragma once

#include "shift_math.cuh"

namespace gvpm {
namespace me {

// integrators/manifold.py's constants, rounded once to float as torch
// does when it compares a float32 tensor with them
constexpr int K_MAX = 3;                   // longest specular chain
constexpr float NEWTON_EPS = (float)1e-4;  // residual tolerance / scene scale
constexpr float MAX_STEP = (float)0.15;    // trust region of a step
constexpr float MAX_DEV = (float)0.35;     // largest direction deviation
constexpr float DET_EPS = (float)1e-18;    // a step needs |det J| above it

constexpr int TARGET_VOLUME = 0, TARGET_BEAM = 1, TARGET_SURFACE = 2;

// The inputs of one launch: the chain dict of manifold.pull_chains as it
// stands (slot-major [K_MAX, L] arrays, bools one byte each), the targets
// and the scene's analytic primitives. ops/me_newton.py fills it.
struct In {
  long long L;                 // lanes
  int target;                  // TARGET_*
  int n_iters;                 // Newton steps
  const float* scale;          // scene_scale: one float
  const long long* k;          // [L] chain length
  const long long* prim;       // [K_MAX, L] chain prims
  const unsigned char* enter;  // [K_MAX, L] sphere-root selector
  const unsigned char* refl;   // [K_MAX, L] base took the reflection
  const float* eta;            // [K_MAX, L]
  const unsigned char* diel;   // [K_MAX, L]
  const float* anchor_p;       // [L, 3]
  const float* w1_base;        // [L, 3]
  const float* t_last;         // [L]
  const float* c_target;       // [L, 3]
  const long long* ph_prim;    // [L] surface: the photon's primitive
  const float* ph_ns;          // [L, 3] surface: its shading normal
  const unsigned char* ph_enter;  // [L] surface: its sphere-root selector
  const float* tri_p0;         // [T, 3]
  const float* tri_e1;         // [T, 3]
  const float* tri_e2;         // [T, 3]
  const float* sph_c;          // [S, 3]
  const float* sph_r;          // [S]
  long long n_tris, n_sph;
};

// The outputs, which the wrapper allocates; N unknowns (3 or 2).
struct Out {
  float* u;               // [L, N] the solution
  unsigned char* conv;    // [L] converged
  float* rho_off;         // [L] |det J| / (1 + a^2 + b^2)^-1.5 at the solution
  float* rho_base;        // [L] |det J| at u = (0, 0[, t_last])
  unsigned char* ok_tr;   // [L] the chain (and the final hit) at the solution
  float* F;               // [K_MAX, L] Fresnel terms at the solution
  float* len;             // [K_MAX, L] segment lengths at the solution
  float* w1;              // [L, 3] anchor direction at the solution
  float* exit_d;          // [L, 3] exit direction
  float* exit_p;          // [L, 3] beam: exit point (else null)
  float* t_end;           // [L] surface: distance to the final hit (else null)
  float* jac0;            // [L, N, N] the first Jacobian, or null
  int* steps;             // [L] bit i: step i was taken, or null
};

// ------------------------------------------------------------ dual numbers

template <int N>
struct D {
  float v, t[N];
};

template <int N>
__host__ __device__ inline D<N> lift(float v) {
  D<N> r;
  r.v = v;
  for (int i = 0; i < N; ++i) r.t[i] = 0.0f;
  return r;
}
// an unknown: value v, tangent the unit vector e_i
template <int N>
__host__ __device__ inline D<N> unknown(float v, int i) {
  D<N> r = lift<N>(v);
  r.t[i] = 1.0f;
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator+(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v + b.v;
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] + b.t[i];
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator+(float a, const D<N>& b) {
  D<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator-(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v - b.v;
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] - b.t[i];
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator-(const D<N>& a, float b) {
  D<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator-(float a, const D<N>& b) {
  D<N> r;
  r.v = a - b.v;
  for (int i = 0; i < N; ++i) r.t[i] = -b.t[i];
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator-(const D<N>& a) {
  D<N> r;
  r.v = -a.v;
  for (int i = 0; i < N; ++i) r.t[i] = -a.t[i];
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator*(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v * b.v;
  for (int i = 0; i < N; ++i) r.t[i] = b.t[i] * a.v + a.t[i] * b.v;
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator*(const D<N>& a, float s) {
  D<N> r;
  r.v = a.v * s;
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * s;
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator/(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v / b.v;
  for (int i = 0; i < N; ++i) r.t[i] = (a.t[i] - b.t[i] * r.v) / b.v;
  return r;
}
template <int N>
__host__ __device__ inline D<N> operator/(const D<N>& a, float s) {
  D<N> r;
  r.v = a.v / s;
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] / s;
  return r;
}
template <int N>
__host__ __device__ inline D<N> dsqrt(const D<N>& a) {
  D<N> r;
  r.v = sqrtf(a.v);
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] / (2.0f * r.v);
  return r;
}
template <int N>
__host__ __device__ inline D<N> dabs(const D<N>& a) {
  D<N> r;
  r.v = fabsf(a.v);
  const float s = sign_(a.v);
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * s;
  return r;
}
// torch.clamp(x, min=lo): the tangent passes where x >= lo
template <int N>
__host__ __device__ inline D<N> dclamp_min(const D<N>& a, float lo) {
  D<N> r = a;
  r.v = cmin_(a.v, lo);
  if (!(a.v >= lo))
    for (int i = 0; i < N; ++i) r.t[i] = 0.0f;
  return r;
}

// a 3-vector of duals
template <int N>
struct DV {
  D<N> x, y, z;
};

template <int N>
__host__ __device__ inline DV<N> lift3(V3 a) {
  return {lift<N>(a.x), lift<N>(a.y), lift<N>(a.z)};
}
template <int N>
__host__ __device__ inline V3 val(const DV<N>& a) {
  return {a.x.v, a.y.v, a.z.v};
}
template <int N>
__host__ __device__ inline DV<N> operator+(const DV<N>& a, const DV<N>& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <int N>
__host__ __device__ inline DV<N> operator-(const DV<N>& a, const DV<N>& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <int N>
__host__ __device__ inline DV<N> operator-(const DV<N>& a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <int N>
__host__ __device__ inline DV<N> operator-(V3 a, const DV<N>& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <int N>
__host__ __device__ inline DV<N> operator*(const DV<N>& a, const D<N>& s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <int N>
__host__ __device__ inline DV<N> operator*(const DV<N>& a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <int N>
__host__ __device__ inline DV<N> operator/(const DV<N>& a, const D<N>& s) {
  return {a.x / s, a.y / s, a.z / s};
}
template <int N>
__host__ __device__ inline DV<N> operator/(const DV<N>& a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
// (a * b).sum(-1)
template <int N>
__host__ __device__ inline D<N> ddot(const DV<N>& a, const DV<N>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <int N>
__host__ __device__ inline D<N> ddot(const DV<N>& a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
// manifold._norm: sqrt((v * v).sum(-1))
template <int N>
__host__ __device__ inline D<N> dnorm(const DV<N>& a) {
  return dsqrt(ddot(a, a));
}

// ------------------------------------------------------------ the chain

__host__ __device__ inline long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int N>
struct Hit {
  D<N> t;
  DV<N> n;
  bool ok;
};

// manifold._prim_hit: the analytic hit of a KNOWN primitive, the plane
// of a triangle or the sphere root matching the base chain (`enter`),
// falling to the other root where the chosen one lies behind.
template <int N>
__host__ __device__ inline Hit<N> prim_hit(const In& in, long long prim,
                                           const DV<N>& p, const DV<N>& d,
                                           bool enter) {
  Hit<N> h;
  const bool is_tri = prim < in.n_tris;
  if (is_tri && in.n_tris > 0) {
    const long long ti = clampll(prim, 0, in.n_tris - 1);
    const V3 p0 = ld3(in.tri_p0, 3 * ti);
    V3 n = cross3(ld3(in.tri_e1, 3 * ti), ld3(in.tri_e2, 3 * ti));
    const float nl = cmin_(sqrtf(dot3(n, n)), 1e-12f);
    n = {n.x / nl, n.y / nl, n.z / nl};
    const D<N> denom = ddot(d, n);
    const bool big = fabsf(denom.v) > 1e-9f;
    h.t = ddot(p0 - p, n) / (big ? denom : lift<N>(1e-9f));
    h.ok = big && h.t.v > 1e-5f;
    h.n = lift3<N>(n);
  } else if (!is_tri && in.n_sph > 0) {
    const long long si = clampll(prim - in.n_tris, 0, in.n_sph - 1);
    const V3 c = ld3(in.sph_c, 3 * si);
    const float r = in.sph_r[si];
    const DV<N> oc = p - c;
    const D<N> b = ddot(oc, d);
    const D<N> cq = ddot(oc, oc) - r * r;
    const D<N> disc = b * b - cq;
    const D<N> sq = dsqrt(dclamp_min(disc, 0.0f));
    const D<N> t_near = -b - sq, t_far = -b + sq;
    const D<N>& t_sel = enter ? t_near : t_far;
    const D<N>& other = enter ? t_far : t_near;
    h.t = t_sel.v > 1e-5f ? t_sel : (other.v > 1e-5f ? other : lift<N>(-1.0f));
    h.ok = disc.v > 0.0f && h.t.v > 1e-5f;
    h.n = (p + d * h.t - c) / cmin_(r, 1e-12f);
  } else {
    // the plain version's fillers: a triangle slot of a scene without
    // triangles never hits (t = inf), a sphere slot of one without
    // spheres neither (t = -1)
    h.t = lift<N>(is_tri ? INFINITY : -1.0f);
    h.n = lift3<N>({0.0f, 0.0f, 0.0f});
    h.ok = false;
  }
  return h;
}

template <int N>
struct Bounce {
  DV<N> d;
  D<N> cos_i;
  bool ok;
};

// manifold._bounce: reflect or refract d at n, the base chain's branch
template <int N>
__host__ __device__ inline Bounce<N> bounce(const DV<N>& d, const DV<N>& n,
                                            float eta, bool diel, bool refl) {
  Bounce<N> o;
  o.cos_i = -ddot(d, n);
  if (refl || !diel) {
    o.d = d + n * (o.cos_i * 2.0f);
    o.ok = true;
    return o;
  }
  const float rel_eta = o.cos_i.v > 0.0f ? eta : 1.0f / eta;
  const DV<N> nf = n * sign_(o.cos_i.v);
  const D<N> ci = dabs(o.cos_i);
  const D<N> sin2_t = dclamp_min(1.0f - ci * ci, 0.0f) / (rel_eta * rel_eta);
  const D<N> cos_t = dsqrt(dclamp_min(1.0f - sin2_t, 0.0f));
  const DV<N> dr = (d + nf * ci) / rel_eta - nf * cos_t;
  o.d = dr / dclamp_min(dnorm(dr), 1e-12f);
  o.ok = !(sin2_t.v >= 1.0f);
  return o;
}

template <int N>
struct Trace {
  DV<N> p, d;             // exit point and direction
  bool ok;
  float F[K_MAX], len[K_MAX];
};

// manifold._retrace: the lane's chain from its anchor along w1
template <int N>
__host__ __device__ inline Trace<N> retrace(const In& in, long long l,
                                            const DV<N>& w1) {
  Trace<N> tr;
  tr.p = lift3<N>(ld3(in.anchor_p, 3 * l));
  tr.d = w1;
  tr.ok = true;
  const long long k = in.k[l];
  for (int j = 0; j < K_MAX; ++j) {
    tr.F[j] = 1.0f;
    tr.len[j] = 0.0f;
    if (j >= k) continue;
    const long long s = j * in.L + l;
    const float eta = in.eta[s];
    const bool diel = in.diel[s] != 0;
    const Hit<N> h = prim_hit(in, in.prim[s], tr.p, tr.d, in.enter[s] != 0);
    const Bounce<N> b = bounce(tr.d, h.n, eta, diel, in.refl[s] != 0);
    tr.F[j] = diel ? fresnel_dielectric(b.cos_i.v, eta) : 1.0f;
    tr.len[j] = h.t.v;
    tr.ok = tr.ok && h.ok && b.ok;
    tr.p = tr.p + tr.d * h.t;
    tr.d = b.d;
  }
  return tr;
}

// manifold._w1_of: the anchor direction at offsets (a, b)
template <int N>
__host__ __device__ inline DV<N> w1_of(V3 wb, V3 sa, V3 ta, const D<N>& a,
                                       const D<N>& b) {
  const DV<N> w = {wb.x + a * sa.x + b * ta.x, wb.y + a * sa.y + b * ta.y,
                   wb.z + a * sa.z + b * ta.z};
  return w / dclamp_min(dnorm(w), 1e-12f);
}

// One evaluation of a lane's chain map at u: the residual's value and
// Jacobian J[i][j] = d r_i / d u_j, and what the solution hands on.
template <int N>
struct Point {
  float r[N], J[N][N];
  bool ok;
  float F[K_MAX], len[K_MAX];
  V3 w1, exit_p, exit_d;
  float t_end;
};

template <int N>
__host__ __device__ inline void keep_chain(Point<N>& pt, const Trace<N>& tr,
                                           const DV<N>& w1) {
  for (int j = 0; j < K_MAX; ++j) {
    pt.F[j] = tr.F[j];
    pt.len[j] = tr.len[j];
  }
  pt.w1 = val(w1);
  pt.exit_p = val(tr.p);
  pt.exit_d = val(tr.d);
}

// volume and beam: r = exit point + t * exit direction - c_target
__host__ __device__ inline Point<3> eval3(const In& in, long long l, V3 sa,
                                          V3 ta, const float u[3]) {
  const DV<3> w1 = w1_of(ld3(in.w1_base, 3 * l), sa, ta, unknown<3>(u[0], 0),
                         unknown<3>(u[1], 1));
  const Trace<3> tr = retrace(in, l, w1);
  const DV<3> c = tr.p + tr.d * unknown<3>(u[2], 2);
  const V3 ct = ld3(in.c_target, 3 * l);
  Point<3> pt;
  const D<3>* ci[3] = {&c.x, &c.y, &c.z};
  const float cv[3] = {ct.x, ct.y, ct.z};
  for (int i = 0; i < 3; ++i) {
    pt.r[i] = ci[i]->v - cv[i];
    for (int j = 0; j < 3; ++j) pt.J[i][j] = ci[i]->t[j];
  }
  pt.ok = tr.ok;
  pt.t_end = 0.0f;
  keep_chain(pt, tr, w1);
  return pt;
}

// surface: the exit ray hit again on the photon's primitive, the
// residual and Jacobian in the target's tangent frame (ts, tt)
__host__ __device__ inline Point<2> eval2(const In& in, long long l, V3 sa,
                                          V3 ta, V3 ts, V3 tt,
                                          const float u[2]) {
  const DV<2> w1 = w1_of(ld3(in.w1_base, 3 * l), sa, ta, unknown<2>(u[0], 0),
                         unknown<2>(u[1], 1));
  const Trace<2> tr = retrace(in, l, w1);
  const Hit<2> h = prim_hit(in, in.ph_prim[l], tr.p, tr.d, in.ph_enter[l] != 0);
  const DV<2> pe = tr.p + tr.d * h.t;
  const V3 v = sub3(val(pe), ld3(in.c_target, 3 * l));
  Point<2> pt;
  pt.r[0] = dot3(v, ts);
  pt.r[1] = dot3(v, tt);
  for (int j = 0; j < 2; ++j) {
    pt.J[0][j] = pe.x.t[j] * ts.x + pe.y.t[j] * ts.y + pe.z.t[j] * ts.z;
    pt.J[1][j] = pe.x.t[j] * tt.x + pe.y.t[j] * tt.y + pe.z.t[j] * tt.z;
  }
  pt.ok = tr.ok && h.ok;
  pt.t_end = h.t.v;
  keep_chain(pt, tr, w1);
  return pt;
}

__host__ __device__ inline float det3(const float J[3][3]) {
  const float a = J[0][0], b = J[0][1], c = J[0][2];
  const float d = J[1][0], e = J[1][1], f = J[1][2];
  const float g = J[2][0], h = J[2][1], i = J[2][2];
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

__host__ __device__ inline float det2(const float J[2][2]) {
  return J[0][0] * J[1][1] - J[0][1] * J[1][0];
}

// J^-1 r by the adjugate over det (manifold._solve3)
__host__ __device__ inline void solve3(const float J[3][3], float det,
                                       const float r[3], float x[3]) {
  const float a = J[0][0], b = J[0][1], c = J[0][2];
  const float d = J[1][0], e = J[1][1], f = J[1][2];
  const float g = J[2][0], h = J[2][1], i = J[2][2];
  x[0] = ((e * i - f * h) * r[0] + (c * h - b * i) * r[1] + (b * f - c * e) * r[2]) / det;
  x[1] = ((f * g - d * i) * r[0] + (a * i - c * g) * r[1] + (c * d - a * f) * r[2]) / det;
  x[2] = ((d * h - e * g) * r[0] + (b * g - a * h) * r[1] + (a * e - b * d) * r[2]) / det;
}

// u -= du with the trust region on the two direction components
// (manifold._trust_step; MAX_STEP / x is torch's reciprocal(x) * MAX_STEP)
template <int N>
__host__ __device__ inline void trust_step(float u[N], const float du[N]) {
  const float dn = sqrtf(du[0] * du[0] + du[1] * du[1]);
  const float lim = cmax_((1.0f / cmin_(dn, 1e-12f)) * MAX_STEP, 1.0f);
  for (int i = 0; i < N; ++i) u[i] = u[i] - du[i] * (i < 2 ? lim : 1.0f);
}

template <int N>
__host__ __device__ inline float det_n(const float J[N][N]) {
  if constexpr (N == 3) return det3(J);
  else return det2(J);
}

// fr: the anchor frame (sa, ta) and, for the surface, the target's (ts, tt)
template <int N>
__host__ __device__ inline Point<N> evaluate(const In& in, long long l,
                                             const V3 fr[4], const float u[N]) {
  if constexpr (N == 3) return eval3(in, l, fr[0], fr[1], u);
  else return eval2(in, l, fr[0], fr[1], fr[2], fr[3], u);
}

// One lane's whole solve: n_iters + 1 evaluations from u = (0, 0[,
// t_last]), each step taken where |det J| > DET_EPS; the convergence
// test and the geometric terms from the first and last Jacobians.
template <int N>
__host__ __device__ inline void solve_lane(const In& in, const Out& out,
                                           long long l) {
  static_assert(N == 2 || N == 3, "2 unknowns (surface) or 3");
  V3 fr[4];
  frame_planar(ld3(in.w1_base, 3 * l), fr[0], fr[1]);
  float u[N];
  u[0] = u[1] = 0.0f;
  if constexpr (N == 3) u[2] = in.t_last[l];
  else frame_planar(ld3(in.ph_ns, 3 * l), fr[2], fr[3]);
  Point<N> pt = evaluate<N>(in, l, fr, u);
  float J0[N][N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) J0[i][j] = pt.J[i][j];
  int steps = 0;
  for (int it = 0; it < in.n_iters; ++it) {
    const float det = det_n<N>(pt.J);
    if (fabsf(det) > DET_EPS) {
      float du[N];
      if constexpr (N == 3) {
        solve3(pt.J, det, pt.r, du);
      } else {
        du[0] = (pt.J[1][1] * pt.r[0] - pt.J[0][1] * pt.r[1]) / det;
        du[1] = (-pt.J[1][0] * pt.r[0] + pt.J[0][0] * pt.r[1]) / det;
      }
      trust_step<N>(u, du);
      if (it < 31) steps |= 1 << it;
    }
    pt = evaluate<N>(in, l, fr, u);
  }
  float rr = 0.0f;
  for (int i = 0; i < N; ++i) rr = rr + pt.r[i] * pt.r[i];
  const float s_off = powf(1.0f + u[0] * u[0] + u[1] * u[1], -1.5f);
  for (int i = 0; i < N; ++i) out.u[l * N + i] = u[i];
  out.conv[l] = sqrtf(rr) < NEWTON_EPS * in.scale[0] &&
                sqrtf(u[0] * u[0] + u[1] * u[1]) < MAX_DEV;
  out.rho_off[l] = fabsf(det_n<N>(pt.J)) / cmin_(s_off, 1e-12f);
  out.rho_base[l] = fabsf(det_n<N>(J0));
  out.ok_tr[l] = pt.ok;
  for (int j = 0; j < K_MAX; ++j) {
    out.F[j * in.L + l] = pt.F[j];
    out.len[j * in.L + l] = pt.len[j];
  }
  const float w1[3] = {pt.w1.x, pt.w1.y, pt.w1.z};
  const float ed[3] = {pt.exit_d.x, pt.exit_d.y, pt.exit_d.z};
  const float ep[3] = {pt.exit_p.x, pt.exit_p.y, pt.exit_p.z};
  for (int c = 0; c < 3; ++c) {
    out.w1[3 * l + c] = w1[c];
    out.exit_d[3 * l + c] = ed[c];
    if (out.exit_p) out.exit_p[3 * l + c] = ep[c];
  }
  if (out.t_end) out.t_end[l] = pt.t_end;
  if (out.jac0)
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j) out.jac0[(l * N + i) * N + j] = J0[i][j];
  if (out.steps) out.steps[l] = steps;
}

}  // namespace me
}  // namespace gvpm
