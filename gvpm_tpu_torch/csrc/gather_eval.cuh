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
// Each eval is two functions. `inside` is the ball test of a candidate
// pair: it reads the query row and the 8-float head of the photon row
// (HeadSlot: position, vertex type, incoming direction, depth) and says
// whether the pair is a visit. `body<ME>` is everything after it, for a
// pair that passed: the base term and the four reconnection shifts. It
// reads the query row and the whole photon row and hands each of the
// pair's N_ACC terms to a sink (`sink.add(column, value)`; every pair
// calls it for the same columns in the same order, so a sink may reduce
// across the lanes of a warp). With ME it also returns whether the pair
// is eligible for a manifold (ME) shift -- not reconnectable, parent a
// delta surface (and, for surface photons, the photon's own BSDF not
// delta). The mask is discrete row slots, so it is exact; body<false> is
// the body without that tail.
//
// The header also compiles as plain host C++ (with __host__/__device__
// defined away), which is how the CPU tests exercise this source.
#pragma once

#include "shift_math.cuh"

namespace gvpm {

constexpr int N_ACC = 29;      // primal 3, S 4x3, W 4x3, visits, shift_ok
constexpr int VOL_N_OUT = 30;  // N_ACC + dropped (always 0: exact runs)
constexpr int SUR_N_OUT = 30;
constexpr int N_RUNS = 9;
constexpr int ME_NONE = 0x7fffffff;  // ME row key of a query with no ME pair

// photon-row slots (gradient_gather.SLOT); rows are row-major, R_LOAD
// floats of each are read (the 55 slots rounded up to whole float4s)
enum RowSlot : int {
  R_P = 0, R_WI = 3, R_ALPHA = 6, R_PARENT_P = 9, R_PARENT_WI = 12,
  R_PARENT_NS = 15, R_SCATTER_BASE = 18, R_NS = 21, R_ST = 24,
  R_PM_ALB = 27, R_PM_SPEC = 30, R_PM_ETA3 = 33, R_PM_SIGS = 36,
  R_PDF_DIR_BASE = 39, R_PARENT_TYPE = 40, R_RECONN = 43, R_VTYPE = 44,
  R_DEPTH = 47, R_PM_BTYPE = 48, R_PM_ALPHA = 49, R_PM_ETA1 = 50,
  R_PM_G = 51, R_PM_PTYPE = 52, R_PM_DELTA = 53, R_OWN_DELTA = 54,
  R_LOAD = 56
};
// head of a photon row: what the ball tests read. fused_gather.row_heads
// keeps it as two planes of four floats a row, [2, P, 4]: (position,
// vertex type) and (incoming direction, depth)
enum HeadSlot : int { H_P = 0, H_VTYPE = 3, H_WI = 4, H_DEPTH = 7, H_WIDTH = 8 };
// volume query slots (gradient_gather.VOL_QSLOTS); shifted i at +3i / +i;
// the first V_USED floats of the V_WIDTH-wide row are read
enum VolSlot : int {
  V_X = 0, V_D = 3, V_XS = 6, V_SD = 18, V_G = 30, V_PT = 31, V_SOK = 32,
  V_DEPTH = 33, V_CAM_OK = 34, V_PRC = 38, V_BORDER = 42, V_USED = 46,
  V_WIDTH = 64
};
// surface query slots (gradient_gather.SUR_QSLOTS); shifted gather
// point i: p, ns, s, t, wo at S_SH + 15i + {0, 3, 6, 9, 12}; the first
// S_USED floats of the S_WIDTH-wide row are read
enum SurSlot : int {
  S_P = 0, S_NS = 3, S_S = 6, S_T = 9, S_WO = 12, S_ALB = 15, S_SPEC = 18,
  S_ETA3 = 21, S_SH = 24, S_BTYPE = 84, S_ALPHA_B = 85, S_ETA1 = 86,
  S_R2 = 87, S_VALID = 88, S_DEPTH = 89, S_COMP = 90, S_SENS = 94,
  S_BORDER = 98, S_USED = 102, S_WIDTH = 128
};

// one photon row of the row-major table [P, F] (or a copy of its first
// R_LOAD floats)
struct RowRef {
  const float* r;
  __host__ __device__ float f1(int k) const { return r[k]; }
  __host__ __device__ V3 f3(int k) const { return {r[k], r[k + 1], r[k + 2]}; }
};

// the sink of a sequential caller: one query's accumulators
struct AccSink {
  float* acc;
  __host__ __device__ void add(int c, float v) { acc[c] += v; }
};

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

// planar.parent_scatter_params at the photon's parent (shift_math.cuh)
__host__ __device__ inline bool parent_scatter(const ShiftCache& c, V3 w_new,
                                               float sc[3], float& pdf) {
  return parent_lobe(c.ptype, c.pwi, c.pns, c.bpar, c.sigs, c.g, c.mptype,
                     w_new, sc, pdf);
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

// gradient_gather's ME mask of a pair inside the ball: the photon cannot
// reconnect and its parent is a delta (conductor / dielectric) surface
__host__ __device__ inline bool me_eligible(const ShiftCache& c, const RowRef& r) {
  return (!c.reconn) && (c.ptype == VERT_SURFACE) && (r.f1(R_PM_DELTA) > 0.5f);
}

// ------------------------------------------------------ the eval bodies
//
// A pair that fails the ball test contributes exactly zero in the plain
// version (every term is multiplied by a zeroed kernel weight), so only
// pairs that pass `inside` reach `body`. Rows that could turn that zero
// into NaN (dead lanes holding inf) are scrubbed by pack_photons.
//
// Per eval: QW the query-row width, QUSED the leading floats of it that
// are read, HEAD_FLOATS the leading floats of a row head that `inside`
// reads when min_depth is 0 (with min_depth > 0 it reads all H_WIDTH).

struct VolumeEval {
  static constexpr int QW = V_WIDTH;
  static constexpr int QUSED = V_USED;
  static constexpr int N_OUT = VOL_N_OUT;
  static constexpr int HEAD_FLOATS = 4;

  __host__ __device__ static bool inside(const float* q, const float* h, int min_depth,
                                         float r2) {
    V3 rel = sub3(ld3(h, H_P), ld3(q, V_X));
    float d2 = dot3(rel, rel);
    bool in = (h[H_VTYPE] == 2.0f) && (d2 < r2) && (q[V_SOK] > 0.5f);
    if (min_depth > 0) in = in && (h[H_DEPTH] + q[V_DEPTH] + 1.0f >= (float)min_depth);
    return in;
  }

  template <bool ME, class Sink>
  __host__ __device__ static bool body(const float* q, const RowRef& r, float,
                                       float k3, Sink& sink) {
    V3 rel = sub3(r.f3(R_P), ld3(q, V_X));
    float g = q[V_G];
    int pt = (int)q[V_PT];
    float pf = phase_params(-dot3(r.f3(R_WI), ld3(q, V_D)), g, pt);
    float kw = pf * k3;
    V3 a = r.f3(R_ALPHA);
    const float cb[3] = {a.x * kw, a.y * kw, a.z * kw};
    ShiftCache c = shift_caches(r, false);
    for (int k = 0; k < 3; ++k) sink.add(k, cb[k]);
    float n_ok = 0.0f;
    for (int i = 0; i < 4; ++i) {
      V3 new_p = add3(ld3(q, V_XS + 3 * i), rel);
      float a_sh[3], pr_l;
      V3 w_new;
      bool ok_s = reconnect(c, new_p, true, a_sh, pr_l, w_new);
      float pf_s = phase_params(-dot3(w_new, ld3(q, V_SD + 3 * i)), g, pt);
      bool ok_i = ok_s && (q[V_CAM_OK + i] > 0.5f);
      float w = mis(pr_l, q[V_PRC + i], ok_i);
      w = q[V_BORDER + i] > 0.5f ? 1.0f : w;
      float kwi = (ok_i ? pf_s * k3 : 0.0f) * w;
      for (int k = 0; k < 3; ++k) sink.add(3 + 3 * i + k, a_sh[k] * kwi);
      for (int k = 0; k < 3; ++k) sink.add(15 + 3 * i + k, w * cb[k]);
      n_ok += ok_i ? 1.0f : 0.0f;
    }
    sink.add(27, 1.0f);
    sink.add(28, n_ok);
    if constexpr (ME) return me_eligible(c, r);
    return false;
  }
};

struct SurfaceEval {
  static constexpr int QW = S_WIDTH;
  static constexpr int QUSED = S_USED;
  static constexpr int N_OUT = SUR_N_OUT;
  static constexpr int HEAD_FLOATS = 8;

  __host__ __device__ static bool inside(const float* q, const float* h, int min_depth,
                                         float) {
    V3 rel = sub3(ld3(h, H_P), ld3(q, S_P));
    float d2 = dot3(rel, rel);
    V3 nwi = neg3(ld3(h, H_WI));
    bool front = dot3(ld3(q, S_NS), nwi) > 1e-4f;
    bool in = (h[H_VTYPE] == 1.0f) && (d2 < q[S_R2]) && front && (q[S_VALID] > 0.5f);
    if (min_depth > 0) in = in && (h[H_DEPTH] + q[S_DEPTH] >= (float)min_depth);
    return in;
  }

  template <bool ME, class Sink>
  __host__ __device__ static bool body(const float* q, const RowRef& r, float, float,
                                       Sink& sink) {
    float r2 = q[S_R2];
    V3 ns = ld3(q, S_NS);
    V3 rel = sub3(r.f3(R_P), ld3(q, S_P));
    V3 nwi = neg3(r.f3(R_WI));
    V3 wi_l = to_local(ns, ld3(q, S_S), ld3(q, S_T), nwi);
    BsdfParams bp = {(int)q[S_BTYPE], ld3(q, S_ALB), ld3(q, S_SPEC),
                     ld3(q, S_ETA3), q[S_ALPHA_B], q[S_ETA1]};
    float f[3], pdf_unused;
    eval_bsdf_pdf(bp, ld3(q, S_WO), wi_l, f, pdf_unused);
    float k2 = INV_PI / cmin_(r2, 1e-12f);
    float kw = k2;
    V3 a = r.f3(R_ALPHA);
    const float cb[3] = {a.x * f[0] * kw, a.y * f[1] * kw, a.z * f[2] * kw};
    ShiftCache c = shift_caches(r, true);
    for (int k = 0; k < 3; ++k) sink.add(k, cb[k]);
    float n_ok = 0.0f;
    for (int i = 0; i < 4; ++i) {
      const int sh = S_SH + 15 * i;
      V3 new_p = add3(ld3(q, sh), rel);
      float a_sh[3], pr_l;
      V3 w_new;
      bool ok_s = reconnect(c, new_p, false, a_sh, pr_l, w_new);
      V3 wi_ls = to_local(ld3(q, sh + 3), ld3(q, sh + 6), ld3(q, sh + 9), neg3(w_new));
      float fs[3], pdf_s;
      eval_bsdf_pdf(bp, ld3(q, sh + 12), wi_ls, fs, pdf_s);
      bool ok_i = ok_s && (q[S_COMP + i] > 0.5f);
      float w = mis(pr_l, q[S_SENS + i], ok_i);
      w = q[S_BORDER + i] > 0.5f ? 1.0f : w;
      float kwi = (ok_i ? k2 : 0.0f) * w;
      for (int k = 0; k < 3; ++k) sink.add(3 + 3 * i + k, a_sh[k] * fs[k] * kwi);
      for (int k = 0; k < 3; ++k) sink.add(15 + 3 * i + k, w * cb[k]);
      n_ok += ok_i ? 1.0f : 0.0f;
    }
    sink.add(27, 1.0f);
    sink.add(28, n_ok);
    // a surface photon that sits on a delta BSDF itself contributes
    // nothing to this gather and takes no ME shift
    if constexpr (ME) return me_eligible(c, r) && !(r.f1(R_OWN_DELTA) > 0.5f);
    return false;
  }
};

}  // namespace gvpm
