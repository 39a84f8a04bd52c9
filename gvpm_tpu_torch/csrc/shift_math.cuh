// Vector helpers, phase functions and BSDF lobes shared by the per-pair
// math of the photon gather (gather_eval.cuh) and of the beam / plane
// sweeps (beam_eval.cuh): the device side of integrators/planar.py and
// render/bsdf.py's eval_bsdf_pdf_params, in the same operation order as
// the plain PyTorch versions. Compiles as CUDA and, with __host__ /
// __device__ defined away, as plain host C++ (the CPU tests).
#pragma once

#ifndef __CUDACC__
#include <cmath>
#endif

namespace gvpm {

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
__host__ __device__ inline V3 madd3(V3 o, V3 d, float t) {
  return {o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
}
__host__ __device__ inline V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__host__ __device__ inline V3 ld3(const float* r, int k) {
  return {r[k], r[k + 1], r[k + 2]};
}

// torch.clamp / torch.maximum / torch.minimum semantics: NaN propagates
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
__host__ __device__ inline float minimum_(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__host__ __device__ inline float sign_(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
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

// render/bsdf.py eval_bsdf_pdf_params: f (3 channels) and pdf of the
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

// planar.parent_scatter_params: the scatter value (3 channels) and the
// direction pdf of a light vertex's lobe toward w_new. The vertex is
// its type `ptype` (emitter, surface, medium), incoming direction pwi,
// shading normal pns, and its material: the BSDF parameters of a
// surface, sigma_s / g / phase type of a medium. Returns ok (an
// emitter's cosine is positive).
__host__ __device__ inline bool parent_lobe(int ptype, V3 pwi, V3 pns,
                                            const BsdfParams& bpar, V3 sigs,
                                            float g, int mptype, V3 w_new,
                                            float sc[3], float& pdf) {
  float cos_e = dot3(pns, w_new);
  float sc_em = cmin_(cos_e, 0.0f);
  float pdf_em = sc_em * INV_PI;
  V3 nwi = neg3(pwi);
  float flip = sign_(dot3(pns, nwi));
  flip = flip == 0.0f ? 1.0f : flip;
  V3 nsf = scale3(pns, flip);
  V3 s_ax, t_ax;
  frame_planar(nsf, s_ax, t_ax);
  V3 wi_l = to_local(nsf, s_ax, t_ax, nwi);
  V3 wo_l = to_local(nsf, s_ax, t_ax, w_new);
  float f[3], pdf_b;
  eval_bsdf_pdf(bpar, wi_l, wo_l, f, pdf_b);
  float acos_ = fabsf(wo_l.z);
  float cos_ph = dot3(nwi, w_new);
  float pv = phase_params(-cos_ph, g, mptype);
  const float sig[3] = {sigs.x, sigs.y, sigs.z};
  bool is_em = ptype == VERT_EMITTER, is_md = ptype == VERT_MEDIUM;
  for (int k = 0; k < 3; ++k)
    sc[k] = is_em ? sc_em : (is_md ? sig[k] * pv : f[k] * acos_);
  pdf = is_em ? pdf_em : (is_md ? pv : pdf_b);
  return (!is_em) || (cos_e > 1e-6f);
}

}  // namespace gvpm
