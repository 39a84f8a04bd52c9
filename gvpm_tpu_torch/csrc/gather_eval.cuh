// Per-pair math of the fused photon gather: the two eval bodies of
// ops/fused_gather.py (volume and surface) for ONE (query, photon-row)
// pair, as __host__ __device__ functions.
//
// Every formula mirrors the plain PyTorch version operation by
// operation (integrators/planar.py and integrators/gradient_gather.py),
// in the same order, so that a build without FMA contraction
// (-fmad=false) takes the same ball-test and shift-validity decisions:
// `visits` and `shift_ok` match exactly, and the sums agree to the
// rounding of expf/powf. The slot layouts below are those of
// gradient_gather.SLOT / VOL_QSLOTS / SUR_QSLOTS.
//
// The header also compiles as plain host C++ (with __host__/__device__
// defined away), which is how the CPU tests exercise this source.
#pragma once

#ifndef __CUDACC__
#include <cmath>
#endif

namespace gvpm {

constexpr int N_ACC = 29;      // primal 3, S 4x3, W 4x3, visits, shift_ok
constexpr int VOL_N_OUT = 30;  // N_ACC + dropped (always 0: exact runs)
constexpr int SUR_N_OUT = 30;
constexpr int N_RUNS = 9;

// photon-row slots (gradient_gather.SLOT)
enum RowSlot : int {
  R_P = 0, R_WI = 3, R_ALPHA = 6, R_PARENT_P = 9, R_PARENT_WI = 12,
  R_PARENT_NS = 15, R_SCATTER_BASE = 18, R_NS = 21, R_ST = 24,
  R_PM_ALB = 27, R_PM_SPEC = 30, R_PM_ETA3 = 33, R_PM_SIGS = 36,
  R_PDF_DIR_BASE = 39, R_PARENT_TYPE = 40, R_RECONN = 43, R_VTYPE = 44,
  R_DEPTH = 47, R_PM_BTYPE = 48, R_PM_ALPHA = 49, R_PM_ETA1 = 50,
  R_PM_G = 51, R_PM_PTYPE = 52
};
// volume query slots (gradient_gather.VOL_QSLOTS); shifted i at +3i / +i
enum VolSlot : int {
  V_X = 0, V_D = 3, V_XS = 6, V_SD = 18, V_G = 30, V_PT = 31, V_SOK = 32,
  V_DEPTH = 33, V_CAM_OK = 34, V_PRC = 38, V_BORDER = 42, V_WIDTH = 64
};
// surface query slots (gradient_gather.SUR_QSLOTS); shifted gather
// point i: p, ns, s, t, wo at S_SH + 15i + {0, 3, 6, 9, 12}
enum SurSlot : int {
  S_P = 0, S_NS = 3, S_S = 6, S_T = 9, S_WO = 12, S_ALB = 15, S_SPEC = 18,
  S_ETA3 = 21, S_SH = 24, S_BTYPE = 84, S_ALPHA_B = 85, S_ETA1 = 86,
  S_R2 = 87, S_VALID = 88, S_DEPTH = 89, S_COMP = 90, S_SENS = 94,
  S_BORDER = 98, S_WIDTH = 128
};

// scene type ids (scene/types.py)
constexpr int BSDF_DIFFUSE = 0, BSDF_ROUGH_CONDUCTOR = 3, BSDF_PHONG = 6,
              BSDF_PLASTIC = 7;
constexpr int PHASE_HG = 1, PHASE_RAYLEIGH = 2;
constexpr int VERT_EMITTER = 0, VERT_SURFACE = 1, VERT_MEDIUM = 2;

// python-double constants rounded once to float, as torch does
constexpr float INV_PI = (float)(1.0 / 3.141592653589793);
constexpr float INV_FOURPI = (float)(1.0 / (4.0 * 3.141592653589793));
constexpr float HALF_INV_PI = (float)(0.5 * (1.0 / 3.141592653589793));
constexpr float RAYLEIGH_K = (float)(3.0 / (16.0 * 3.141592653589793));
constexpr float PI_F = (float)3.141592653589793;

struct V3 {
  float x, y, z;
};

__host__ __device__ inline V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__host__ __device__ inline V3 add3(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__host__ __device__ inline float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__host__ __device__ inline V3 scale3(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__host__ __device__ inline V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }

// torch.clamp / torch.maximum semantics: NaN propagates
__host__ __device__ inline float cmin_(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}
__host__ __device__ inline float cmax_(float x, float hi) {
  return (x != x) ? x : (x > hi ? hi : x);
}
__host__ __device__ inline float clip_(float x, float lo, float hi) {
  return cmax_(cmin_(x, lo), hi);
}
__host__ __device__ inline float maximum_(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__host__ __device__ inline float sign_(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// one photon row of the feature-major table [F, P]
struct RowRef {
  const float* t;
  long long P;
  long long i;
  __host__ __device__ float f1(int k) const { return t[(long long)k * P + i]; }
  __host__ __device__ V3 f3(int k) const { return {f1(k), f1(k + 1), f1(k + 2)}; }
};

__host__ __device__ inline V3 qf3(const float* q, int k) {
  return {q[k], q[k + 1], q[k + 2]};
}

// ---------------------------------------------------------------- planar

__host__ __device__ inline void frame_planar(V3 n, V3& s, V3& t) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float b = n.x * n.y * a;
  s = {1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  t = {b, sign + n.y * n.y * a, -n.y};
}

__host__ __device__ inline V3 to_local(V3 n, V3 s, V3 t, V3 w) {
  return {dot3(s, w), dot3(t, w), dot3(n, w)};
}

__host__ __device__ inline float hg_phase(float c, float g) {
  float denom = 1.0f + g * g - 2.0f * g * c;
  return INV_FOURPI * (1.0f - g * g) /
         cmin_(denom * sqrtf(cmin_(denom, 1e-12f)), 1e-12f);
}

__host__ __device__ inline float phase_params(float c, float g, int ptype) {
  float hg = hg_phase(c, g);
  float ray = RAYLEIGH_K * (1.0f + c * c);
  return ptype == PHASE_HG ? hg : (ptype == PHASE_RAYLEIGH ? ray : INV_FOURPI);
}

__host__ __device__ inline float fresnel_dielectric(float cos_i, float eta) {
  float rel_eta = cos_i > 0.0f ? eta : 1.0f / eta;
  float abs_ci = fabsf(cos_i);
  float sin2_t = (1.0f - abs_ci * abs_ci) / (rel_eta * rel_eta);
  float abs_ct = sqrtf(cmin_(1.0f - sin2_t, 0.0f));
  float r_s = (abs_ci - rel_eta * abs_ct) / cmin_(abs_ci + rel_eta * abs_ct, 1e-12f);
  float r_p = (rel_eta * abs_ci - abs_ct) / cmin_(rel_eta * abs_ci + abs_ct, 1e-12f);
  float F = 0.5f * (r_s * r_s + r_p * r_p);
  return sin2_t >= 1.0f ? 1.0f : F;
}

__host__ __device__ inline float smith_g1(float cv, float v_dot_m, float alpha) {
  bool back = (v_dot_m * cv) <= 0.0f;
  float tan_t = sqrtf(cmin_(1.0f - cv * cv, 0.0f)) / cmin_(fabsf(cv), 1e-9f);
  float a = 1.0f / cmin_(alpha * tan_t, 1e-9f);
  float rational = (3.535f * a + 2.181f * a * a) / (1.0f + 2.276f * a + 2.577f * a * a);
  float g = a < 1.6f ? rational : 1.0f;
  return back ? 0.0f : g;
}

struct BsdfParams {
  int btype;
  V3 alb, spec, eta3;
  float alpha, eta1;
};

__host__ __device__ inline float fres_c(float eta, float k, float wi_m) {
  float ci2 = clip_(wi_m * wi_m, 0.0f, 1.0f);
  float aci = sqrtf(ci2);
  float e2k2 = eta * eta + k * k;
  float t0 = e2k2 * ci2;
  float two = 2.0f * eta * aci;
  float r_par2 = (t0 - two + 1.0f - ci2 + ci2 * ci2) /
                 cmin_(t0 + two + 1.0f - ci2 + ci2 * ci2, 1e-12f);
  float r_perp2 = (e2k2 - two + ci2) / cmin_(e2k2 + two + ci2, 1e-12f);
  return clip_(0.5f * (r_par2 + r_perp2), 0.0f, 1.0f);
}

// planar.eval_bsdf_pdf_params: f (3 channels) and pdf of the
// reconnectable reflective lobes; 0 for the others
__host__ __device__ inline void eval_bsdf_pdf(const BsdfParams& bp, V3 wi, V3 wo,
                                              float f[3], float& pdf) {
  float ci = wi.z, co = wo.z;
  bool upper = (ci > 0.0f) && (co > 0.0f);
  f[0] = f[1] = f[2] = 0.0f;
  pdf = 0.0f;
  if (!upper) return;
  float pdf_diff = (ci * co) > 0.0f ? fabsf(co) * INV_PI : 0.0f;
  const float alb[3] = {bp.alb.x, bp.alb.y, bp.alb.z};
  const float spec[3] = {bp.spec.x, bp.spec.y, bp.spec.z};
  const float eta3[3] = {bp.eta3.x, bp.eta3.y, bp.eta3.z};
  if (bp.btype == BSDF_DIFFUSE) {
    for (int c = 0; c < 3; ++c) f[c] = alb[c] * INV_PI;
    pdf = pdf_diff;
  } else if (bp.btype == BSDF_ROUGH_CONDUCTOR) {
    float hx = wi.x + wo.x, hy = wi.y + wo.y, hz = ci + co;
    float hl = sqrtf(cmin_(hx * hx + hy * hy + hz * hz, 1e-18f));
    float sgn = sign_(hz / hl);
    sgn = sgn == 0.0f ? 1.0f : sgn;
    float mx = sgn * hx / hl, my = sgn * hy / hl, mz = sgn * hz / hl;
    float c2 = clip_(mz * mz, 1e-9f, 1.0f);
    float t2 = (1.0f - c2) / c2;
    float a2 = bp.alpha * bp.alpha;
    float D = expf(-t2 / a2) / (PI_F * a2 * c2 * c2);
    float wi_m = wi.x * mx + wi.y * my + ci * mz;
    float wo_m = wo.x * mx + wo.y * my + co * mz;
    float G = smith_g1(ci, wi_m, bp.alpha) * smith_g1(co, wo_m, bp.alpha);
    float denom = 4.0f * cmin_(fabsf(ci) * fabsf(co), 1e-9f);
    float f_rc_s = D * G / denom;
    for (int c = 0; c < 3; ++c) f[c] = alb[c] * f_rc_s * fres_c(eta3[c], spec[c], wi_m);
    pdf = D * fabsf(mz) / cmin_(4.0f * fabsf(wi_m), 1e-9f);
  } else if (bp.btype == BSDF_PHONG) {
    float cos_r = clip_(-wi.x * wo.x - wi.y * wo.y + ci * co, 0.0f, 1.0f);
    float n_exp = bp.alpha;
    float pw = powf(cos_r, n_exp);
    float ph_spec = (n_exp + 2.0f) * HALF_INV_PI * pw;
    float lum_d = (alb[0] + alb[1] + alb[2]) / 3.0f;
    float lum_s = (spec[0] + spec[1] + spec[2]) / 3.0f;
    float w_spec = lum_s / cmin_(lum_d + lum_s, 1e-9f);
    for (int c = 0; c < 3; ++c) f[c] = alb[c] * INV_PI + spec[c] * ph_spec;
    pdf = (1.0f - w_spec) * pdf_diff + w_spec * (n_exp + 1.0f) * HALF_INV_PI * pw;
  } else if (bp.btype == BSDF_PLASTIC) {
    float Fi = fresnel_dielectric(fabsf(ci), bp.eta1);
    float Fo = fresnel_dielectric(fabsf(co), bp.eta1);
    float f_pl_s = (1.0f - Fi) * (1.0f - Fo) * INV_PI;
    for (int c = 0; c < 3; ++c) f[c] = alb[c] * f_pl_s;
    pdf = (1.0f - Fi) * pdf_diff;
  }
}

// ------------------------------------------------- reconnection shift

struct ShiftCache {
  V3 bp, pwi, pns, sc_old, alpha, st, w_old, ns_p;
  int ptype;
  float pdf_old, d2_old, l_old;
  bool reconn;
  BsdfParams bpar;
  V3 sigs;
  float g;
  int mptype;
};

__host__ __device__ inline ShiftCache shift_caches(const RowRef& r, bool surface_target) {
  ShiftCache c;
  V3 ph_p = r.f3(R_P);
  c.bp = r.f3(R_PARENT_P);
  c.ptype = (int)r.f1(R_PARENT_TYPE);
  c.pwi = r.f3(R_PARENT_WI);
  c.pns = r.f3(R_PARENT_NS);
  c.sc_old = r.f3(R_SCATTER_BASE);
  c.pdf_old = r.f1(R_PDF_DIR_BASE);
  c.alpha = r.f3(R_ALPHA);
  c.reconn = r.f1(R_RECONN) > 0.5f;
  c.st = r.f3(R_ST);
  c.bpar = {(int)r.f1(R_PM_BTYPE), r.f3(R_PM_ALB), r.f3(R_PM_SPEC),
            r.f3(R_PM_ETA3), r.f1(R_PM_ALPHA), r.f1(R_PM_ETA1)};
  c.sigs = r.f3(R_PM_SIGS);
  c.g = r.f1(R_PM_G);
  c.mptype = (int)r.f1(R_PM_PTYPE);
  V3 d_old = sub3(ph_p, c.bp);
  c.d2_old = cmin_(dot3(d_old, d_old), 1e-12f);
  c.l_old = sqrtf(c.d2_old);
  c.w_old = scale3(d_old, 1.0f / c.l_old);
  c.ns_p = surface_target ? r.f3(R_NS) : V3{0.0f, 0.0f, 0.0f};
  return c;
}

// planar.parent_scatter_params: scatter value + direction pdf at the
// photon's parent toward w_new
__host__ __device__ inline bool parent_scatter(const ShiftCache& c, V3 w_new,
                                               float sc[3], float& pdf) {
  float cos_e = dot3(c.pns, w_new);
  float sc_em = cmin_(cos_e, 0.0f);
  float pdf_em = sc_em * INV_PI;
  V3 nwi = neg3(c.pwi);
  float flip = sign_(dot3(c.pns, nwi));
  flip = flip == 0.0f ? 1.0f : flip;
  V3 nsf = scale3(c.pns, flip);
  V3 s_ax, t_ax;
  frame_planar(nsf, s_ax, t_ax);
  V3 wi_l = to_local(nsf, s_ax, t_ax, nwi);
  V3 wo_l = to_local(nsf, s_ax, t_ax, w_new);
  float f[3], pdf_b;
  eval_bsdf_pdf(c.bpar, wi_l, wo_l, f, pdf_b);
  float acos_ = fabsf(wo_l.z);
  float cos_ph = dot3(nwi, w_new);
  float pv = phase_params(-cos_ph, c.g, c.mptype);
  const float sig[3] = {c.sigs.x, c.sigs.y, c.sigs.z};
  bool is_em = c.ptype == VERT_EMITTER, is_md = c.ptype == VERT_MEDIUM;
  for (int k = 0; k < 3; ++k)
    sc[k] = is_em ? sc_em : (is_md ? sig[k] * pv : f[k] * acos_);
  pdf = is_em ? pdf_em : (is_md ? pv : pdf_b);
  return (!is_em) || (cos_e > 1e-6f);
}

// gradient_gather._reconnect_planar; returns ok, fills a_sh / pdf_ratio
// (both zeroed when not ok) and w_new
__host__ __device__ inline bool reconnect(const ShiftCache& c, V3 new_p,
                                          bool target_is_volume, float a_sh[3],
                                          float& pdf_ratio, V3& w_new) {
  V3 d_new = sub3(new_p, c.bp);
  float d2_new = cmin_(dot3(d_new, d_new), 1e-12f);
  float l_new = sqrtf(d2_new);
  w_new = scale3(d_new, 1.0f / l_new);
  float s[3], pdf_new;
  bool ok_sc = parent_scatter(c, w_new, s, pdf_new);
  const float st[3] = {c.st.x, c.st.y, c.st.z};
  float dd = l_new - c.l_old;
  float tr_ratio[3];
  for (int k = 0; k < 3; ++k) tr_ratio[k] = expf(-st[k] * dd);
  float pdf_dist_ratio, cos_ratio = 1.0f;
  if (target_is_volume) {
    float dens_new = (st[0] * expf(-st[0] * l_new) + st[1] * expf(-st[1] * l_new) +
                      st[2] * expf(-st[2] * l_new)) / 3.0f;
    float dens_old = (st[0] * expf(-st[0] * c.l_old) + st[1] * expf(-st[1] * c.l_old) +
                      st[2] * expf(-st[2] * c.l_old)) / 3.0f;
    pdf_dist_ratio = dens_old > 1e-20f ? dens_new / cmin_(dens_old, 1e-20f) : 1.0f;
  } else {
    float f_new = (expf(-st[0] * l_new) + expf(-st[1] * l_new) + expf(-st[2] * l_new)) / 3.0f;
    float f_old = (expf(-st[0] * c.l_old) + expf(-st[1] * c.l_old) +
                   expf(-st[2] * c.l_old)) / 3.0f;
    pdf_dist_ratio = f_old > 1e-20f ? f_new / cmin_(f_old, 1e-20f) : 1.0f;
    float cos_new = fabsf(dot3(c.ns_p, w_new));
    float cos_old = cmin_(fabsf(dot3(c.ns_p, c.w_old)), 1e-6f);
    cos_ratio = cos_new / cos_old;
    bool par_sf = c.ptype == VERT_SURFACE;
    bool sign_ok = dot3(c.pns, w_new) * dot3(c.pns, c.w_old) > 0.0f;
    ok_sc = ok_sc && ((!par_sf) || sign_ok);
  }
  float geo = c.d2_old / d2_new * cos_ratio;
  const float sc_old[3] = {c.sc_old.x, c.sc_old.y, c.sc_old.z};
  const float alpha[3] = {c.alpha.x, c.alpha.y, c.alpha.z};
  float pr = pdf_new / cmin_(c.pdf_old, 1e-20f) * pdf_dist_ratio *
             (c.d2_old / d2_new) * cos_ratio;
  float sc_old_max = maximum_(maximum_(sc_old[0], sc_old[1]), sc_old[2]);
  bool ok = ok_sc && c.reconn && (sc_old_max > 0.0f) && (c.pdf_old > 1e-20f) &&
            (pdf_new > 0.0f);
  for (int k = 0; k < 3; ++k)
    a_sh[k] = ok ? alpha[k] * (s[k] / cmin_(sc_old[k], 1e-20f)) * tr_ratio[k] * geo : 0.0f;
  pdf_ratio = ok ? pr : 0.0f;
  return ok;
}

__host__ __device__ inline float mis(float prl, float prc, bool ok) {
  float w = 1.0f / (1.0f + prl * prc);
  return clip_(ok ? w : 1.0f, 0.0f, 1.0f);
}

// ------------------------------------------------------ the eval bodies
//
// A pair that fails the ball test contributes exactly zero in the plain
// version (every term is multiplied by a zeroed kernel weight), so both
// bodies return before the shift math for it. Rows that could turn that
// zero into NaN (dead lanes holding inf) are scrubbed by pack_photons.

struct VolumeEval {
  static constexpr int QW = V_WIDTH;
  static constexpr int N_OUT = VOL_N_OUT;
  __host__ __device__ static void pair(const float* q, const RowRef& r, int min_depth,
                                       float r2, float k3, float* acc) {
    V3 rel = sub3(r.f3(R_P), qf3(q, V_X));
    float d2 = dot3(rel, rel);
    bool inside = (r.f1(R_VTYPE) == 2.0f) && (d2 < r2) && (q[V_SOK] > 0.5f);
    if (min_depth > 0)
      inside = inside && (r.f1(R_DEPTH) + q[V_DEPTH] + 1.0f >= (float)min_depth);
    if (!inside) return;
    float g = q[V_G];
    int pt = (int)q[V_PT];
    float pf = phase_params(-dot3(r.f3(R_WI), qf3(q, V_D)), g, pt);
    float kw = pf * k3;
    V3 a = r.f3(R_ALPHA);
    const float cb[3] = {a.x * kw, a.y * kw, a.z * kw};
    ShiftCache c = shift_caches(r, false);
    for (int k = 0; k < 3; ++k) acc[k] += cb[k];
    for (int i = 0; i < 4; ++i) {
      V3 new_p = add3(qf3(q, V_XS + 3 * i), rel);
      float a_sh[3], pr_l;
      V3 w_new;
      bool ok_s = reconnect(c, new_p, true, a_sh, pr_l, w_new);
      float pf_s = phase_params(-dot3(w_new, qf3(q, V_SD + 3 * i)), g, pt);
      bool ok_i = ok_s && (q[V_CAM_OK + i] > 0.5f);
      float w = mis(pr_l, q[V_PRC + i], ok_i);
      w = q[V_BORDER + i] > 0.5f ? 1.0f : w;
      float kwi = (ok_i ? pf_s * k3 : 0.0f) * w;
      for (int k = 0; k < 3; ++k) acc[3 + 3 * i + k] += a_sh[k] * kwi;
      for (int k = 0; k < 3; ++k) acc[15 + 3 * i + k] += w * cb[k];
      acc[28] += ok_i ? 1.0f : 0.0f;
    }
    acc[27] += 1.0f;
  }
};

struct SurfaceEval {
  static constexpr int QW = S_WIDTH;
  static constexpr int N_OUT = SUR_N_OUT;
  __host__ __device__ static void pair(const float* q, const RowRef& r, int min_depth,
                                       float, float, float* acc) {
    float r2 = q[S_R2];
    V3 ns = qf3(q, S_NS);
    V3 rel = sub3(r.f3(R_P), qf3(q, S_P));
    float d2 = dot3(rel, rel);
    V3 nwi = neg3(r.f3(R_WI));
    bool front = dot3(ns, nwi) > 1e-4f;
    bool inside = (r.f1(R_VTYPE) == 1.0f) && (d2 < r2) && front && (q[S_VALID] > 0.5f);
    if (min_depth > 0)
      inside = inside && (r.f1(R_DEPTH) + q[S_DEPTH] >= (float)min_depth);
    if (!inside) return;
    V3 wi_l = to_local(ns, qf3(q, S_S), qf3(q, S_T), nwi);
    BsdfParams bp = {(int)q[S_BTYPE], qf3(q, S_ALB), qf3(q, S_SPEC),
                     qf3(q, S_ETA3), q[S_ALPHA_B], q[S_ETA1]};
    float f[3], pdf_unused;
    eval_bsdf_pdf(bp, qf3(q, S_WO), wi_l, f, pdf_unused);
    float k2 = INV_PI / cmin_(r2, 1e-12f);
    float kw = k2;
    V3 a = r.f3(R_ALPHA);
    const float cb[3] = {a.x * f[0] * kw, a.y * f[1] * kw, a.z * f[2] * kw};
    ShiftCache c = shift_caches(r, true);
    for (int k = 0; k < 3; ++k) acc[k] += cb[k];
    for (int i = 0; i < 4; ++i) {
      const int sh = S_SH + 15 * i;
      V3 new_p = add3(qf3(q, sh), rel);
      float a_sh[3], pr_l;
      V3 w_new;
      bool ok_s = reconnect(c, new_p, false, a_sh, pr_l, w_new);
      V3 wi_ls = to_local(qf3(q, sh + 3), qf3(q, sh + 6), qf3(q, sh + 9), neg3(w_new));
      float fs[3], pdf_s;
      eval_bsdf_pdf(bp, qf3(q, sh + 12), wi_ls, fs, pdf_s);
      bool ok_i = ok_s && (q[S_COMP + i] > 0.5f);
      float w = mis(pr_l, q[S_SENS + i], ok_i);
      w = q[S_BORDER + i] > 0.5f ? 1.0f : w;
      float kwi = (ok_i ? k2 : 0.0f) * w;
      for (int k = 0; k < 3; ++k) acc[3 + 3 * i + k] += a_sh[k] * fs[k] * kwi;
      for (int k = 0; k < 3; ++k) acc[15 + 3 * i + k] += w * cb[k];
      acc[28] += ok_i ? 1.0f : 0.0f;
    }
    acc[27] += 1.0f;
  }
};

}  // namespace gvpm
