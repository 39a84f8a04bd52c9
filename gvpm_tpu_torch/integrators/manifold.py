"""Manifold (ME) shift: specular-chain photon shifts (mirrors
gvpm_tpu/integrators/manifold.py: the volume, surface and beam targets).

A photon whose parent chain crosses delta (mirror / glass) vertices
cannot take the diffuse reconnection shift. A pure-delta chain is a
DETERMINISTIC map from the outgoing direction at the diffuse anchor b
(2 dof) [+ the final propagated distance t for volume photons (1 dof)]
to the photon position c, so the shift Newton-solves the anchor
direction:

    find u = (a, b[, t]) s.t. retrace(b, w1(u)) lands on c'

where retrace() intersects each chain primitive analytically (the prims
are known from the photon's stored provenance, parent_idx) and
reflects/refracts with the SAME discrete branch as the base chain.

Where the JAX module vmaps a per-lane solve and takes jax.jacfwd of the
residual, this one works on whole lane batches: the residual of a lane
depends on that lane's unknowns only, so one forward-mode product
(torch.func.jvp) over the lanes replicated once per unknown, each
replica with its own unit tangent, yields every column of every lane's
Jacobian at once. The 3x3 / 2x2 solves and determinants are closed-form
tensor expressions (no LU, no host sync). The fixed iteration count
(max_manifold_iterations, default 5) is a Python loop with masked lanes.
That is the plain version (`_newton3_plain`, `_newton2_plain`), which
CPU tensors take. On CUDA tensors the whole solve of a shift call is one
kernel launch (ops/me_newton.py, csrc/me_newton.cuh): one thread a lane,
its Jacobians carried as forward-mode dual numbers in registers, in the
plain version's operation order.

The same Jacobian at the solution and at u=0 yields the generalized
geometric terms rho = |dc/d(omega, t)| whose ratio is the manifold
determinant, used both in the shifted throughput and in the MIS pdf
ratio. Chain segment transmittances are recomputed exactly per segment
with the stored seg_med (homogeneous media).
"""

from __future__ import annotations

import torch

from ..core.logging import StatsCounter
from ..core.logging import span as _span
from ..core.math import (coordinate_system, cross, dot, fresnel_dielectric,
                         normalize)
from ..ops import me_newton
from ..scene.intersect import intersect
from ..scene.types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_NULL,
                           Scene)
from . import shift

K_MAX = 3          # maximum specular chain length (paper scenes need <= 2)
NEWTON_EPS = 1e-4  # residual tolerance, relative to scene scale
MAX_STEP = 0.15    # trust-region bound per Newton step (tangent units)
FOLD_EPS = 3e-3    # dimensionless Jacobian floor: |dX/d(omega,t)| / t^2.
                   # Near caustic FOLDS the manifold determinant -> 0 and
                   # the rho ratio is numerically meaningless; such lanes
                   # fall to the unilateral weight
MAX_DEV = 0.35     # max total direction-parameter deviation: near
                   # caustic folds the inverse map is multi-valued and an
                   # unbounded Newton jumps to a DIFFERENT chain solution

# chain-dict entries whose leading axis is the chain slot, [K, L, ...]
_SLOT_MAJOR = ("prim", "enter", "branch_refl", "eta", "is_diel", "seg_med",
               "base_pos")


# --------------------------------------------------------------------------
# chain extraction
# --------------------------------------------------------------------------

def pull_chains(scene: Scene, pv, idx=None, virt=None):
    """Walk parent_idx from each photon up to K_MAX specular parents.

    pv: flattened photon dict (original order); idx: [L] photon indices
    (all in range). virt (in place of idx): dict of [L] tensors standing
    for the START vertex's record — a VIRTUAL photon with no stored
    record. Keys: p (position), seg_med, parent_idx, reconnectable,
    parent_type, parent_bsdf. The beam ME shift uses it: the virtual
    photon is a point y on the beam and its parent the beam's origin
    vertex (shiftBeamME, shift_volume_beams.cpp:748). Returns a dict of
    tensors with lane dim L:
      ok          — photon admits an ME shift (pure-delta chain of length
                    1..K_MAX ending at a reconnectable anchor)
      k           — chain length
      prim[K]     — chain prims, anchor-to-photon order (slot j >= k: -1)
      enter[K]    — sphere-root selector: base ray entered the prim
      branch_refl[K] — base took the reflection branch at this vertex
      eta[K]      — dielectric int/ext IOR of the prim's bsdf
      is_diel[K]  — dielectric (vs conductor)
      seg_med[K+1]— medium of segment j (anchor->s1, ..., sk->photon)
      anchor_*    — anchor vertex data (from the FIRST chain vertex's
                    parent_* caches): p, ns, wi, type, bsdf, med
      sc_base     — cached scatter value at the anchor toward s1 [L,3]
      pdf_dir_base— cached direction pdf at the anchor [L]
      w1_base     — base outgoing direction at the anchor [L,3]
      t_last      — base length of the final segment (sk -> photon) [L]
    """
    start = virt["p"] if virt is not None else idx
    L = start.shape[0]
    dev = start.device
    n = pv["p"].shape[0]
    nb = scene.bsdf_type.shape[0]

    def vfield(name, j):
        # parent links of -1 and dead slots clamp into range; every such
        # read is masked out below
        return pv[name][torch.clamp(j, 0, n - 1)]

    def startf(name, cur):
        return virt[name] if virt is not None else vfield(name, cur)

    # walk up: cur starts at the (possibly virtual) photon
    start_idx = idx if virt is None else torch.zeros(
        (L,), dtype=torch.int64, device=dev)
    cur = start_idx
    chain_idx = []          # photon-to-anchor order while walking
    alive = torch.ones((L,), dtype=torch.bool, device=dev)
    done = torch.zeros((L,), dtype=torch.bool, device=dev)
    for step in range(K_MAX):
        field = startf if step == 0 else vfield
        par = field("parent_idx", cur)
        rec = field("reconnectable", cur)
        ptype = field("parent_type", cur)
        pbsdf = field("parent_bsdf", cur)
        bty = scene.bsdf_type[torch.clamp(pbsdf, 0, nb - 1)]
        is_delta = (bty == BSDF_CONDUCTOR) | (bty == BSDF_DIELECTRIC)
        step_ok = alive & ~done & ~rec & (ptype == shift.VERT_SURFACE) \
            & is_delta & (par >= 0)
        chain_idx.append((torch.where(step_ok, par, -1), step_ok))
        # after stepping to the parent, check if ITS parent reconnects
        nxt_rec = vfield("reconnectable", par)
        done = done | (step_ok & nxt_rec)
        alive = alive & step_ok
        cur = torch.where(step_ok, par, cur)

    # chain length: number of successful steps until `done`
    k = torch.zeros((L,), dtype=torch.int64, device=dev)
    for j, (_ci, sok) in enumerate(chain_idx):
        take = sok & (k == j)  # contiguous prefix
        k = torch.where(take, j + 1, k)
    ok_steps = done & (k >= 1)

    # walked[m] = vertex m steps above the photon; slot j (0-based from
    # the anchor) is the vertex (k-1-j) steps above the photon
    cur = start_idx
    walked = [cur]
    for ci, _sok in chain_idx:
        cur = torch.where(ci >= 0, ci, cur)
        walked.append(cur)
    slots = []
    for j in range(K_MAX):
        sel = torch.zeros((L,), dtype=torch.int64, device=dev)
        for m in range(1, K_MAX + 1):
            sel = torch.where(k - 1 - j == m - 1, walked[m], sel)
        slots.append(torch.where(j < k, sel, -1))
    slots = torch.stack(slots)                         # [K, L]
    live = slots >= 0

    first = slots[0]  # s_1, whose parent is the anchor
    firstc = torch.clamp(first, 0, n - 1)

    def chain(name):
        return torch.stack([vfield(name, slots[j]) for j in range(K_MAX)])

    prim = torch.where(live, chain("prim"), -1)

    # per-slot geometry flags from the BASE chain
    pos = chain("p")                                   # [K,L,3]
    wi_ch = chain("wi")                                # [K,L,3] arriving
    ns_ch = chain("ns")
    # outgoing dir at slot j: toward slot j+1 (or the photon for j=k-1)
    photon_p = virt["p"] if virt is not None else pv["p"][idx]
    nxt = torch.cat([pos[1:], photon_p[None]], dim=0)
    is_last = torch.arange(K_MAX, device=dev)[:, None] == (k - 1)[None, :]
    nxt = torch.where(is_last[..., None], photon_p[None], nxt)
    wo_ch = normalize(nxt - pos)
    enter = dot(wi_ch, ns_ch) < 0.0                    # entering the prim
    branch_refl = (dot(wo_ch, ns_ch) * dot(-wi_ch, ns_ch)) > 0.0

    bsdf_ch = torch.where(live, chain("bsdf"), 0)
    bc = torch.clamp(bsdf_ch, 0, nb - 1)
    is_diel = scene.bsdf_type[bc] == BSDF_DIELECTRIC
    eta = scene.bsdf_eta[bc]

    seg_med_last = virt["seg_med"] if virt is not None \
        else pv["seg_med"][idx]
    seg_med = torch.cat([chain("seg_med"), seg_med_last[None]])
    seg_med = torch.where(
        torch.cat([live, torch.ones((1, L), dtype=torch.bool, device=dev)]),
        seg_med, -1)

    last = torch.clamp(k - 1, 0, K_MAX - 1)[None, :, None].expand(1, L, 3)
    t_last = torch.linalg.norm(photon_p - pos.gather(0, last)[0], dim=-1)

    return dict(
        ok=ok_steps, k=k, prim=prim, enter=enter,
        branch_refl=branch_refl, eta=eta, is_diel=is_diel,
        seg_med=seg_med,
        anchor_p=pv["parent_p"][firstc],
        anchor_ns=pv["parent_ns"][firstc],
        anchor_wi=pv["parent_wi"][firstc],
        anchor_type=pv["parent_type"][firstc],
        anchor_bsdf=pv["parent_bsdf"][firstc],
        anchor_med=pv["parent_med"][firstc],
        sc_base=pv["scatter_base"][firstc],
        pdf_dir_base=pv["pdf_dir_base"][firstc],
        w1_base=normalize(pos[0] - pv["parent_p"][firstc]),
        t_last=t_last,
        base_pos=pos,
    )


def tile_chains(ch, n):
    """The chain dict with its lanes repeated n times (lane blocks in
    order), so one shift call serves n targets per photon."""
    return {name: (v.repeat((1, n) + (1,) * (v.dim() - 2))
                   if name in _SLOT_MAJOR
                   else v.repeat((n,) + (1,) * (v.dim() - 1)))
            for name, v in ch.items()}


# --------------------------------------------------------------------------
# deterministic chain retrace (lane batches)
# --------------------------------------------------------------------------

def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _prim_hit(scene: Scene, prim, p, d, enter):
    """Analytic intersection with a KNOWN primitive, per lane. Triangles
    use their infinite plane (the Newton walk may momentarily leave the
    footprint); spheres pick the entering/exiting root matching the base
    chain. Slots without a prim (-1) clamp to prim 0 and are masked by
    the caller. Returns (t [N], n_geo [N,3], ok [N])."""
    T = scene.n_tris
    is_tri = prim < T
    ti = torch.clamp(prim, 0, max(T - 1, 0))
    si = torch.clamp(prim - T, 0, max(scene.n_spheres - 1, 0))

    if T > 0:
        p0 = scene.tri_p0[ti]
        n_t = cross(scene.tri_e1[ti], scene.tri_e2[ti])
        n_t = n_t / torch.clamp(_norm(n_t), min=1e-12)[..., None]
        denom = (d * n_t).sum(-1)
        t_tri = ((p0 - p) * n_t).sum(-1) / torch.where(
            torch.abs(denom) > 1e-9, denom, 1e-9)
        ok_tri = (torch.abs(denom) > 1e-9) & (t_tri > 1e-5)
    else:
        n_t = torch.zeros_like(p)
        t_tri = torch.full_like(p[..., 0], torch.inf)
        ok_tri = torch.zeros_like(is_tri)

    if scene.n_spheres > 0:
        c = scene.sph_center[si]
        r = scene.sph_radius[si]
        oc = p - c
        b = (oc * d).sum(-1)
        cq = (oc * oc).sum(-1) - r * r
        disc = b * b - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_near = -b - sq
        t_far = -b + sq
        t_sph = torch.where(enter, t_near, t_far)
        # if the selected root is behind, fall to the other
        other = torch.where(enter, t_far, t_near)
        t_sph = torch.where(t_sph > 1e-5, t_sph,
                            torch.where(other > 1e-5, other, -1.0))
        ok_sph = (disc > 0.0) & (t_sph > 1e-5)
        n_s = (p + d * t_sph[..., None] - c) \
            / torch.clamp(r, min=1e-12)[..., None]
    else:
        n_s = torch.zeros_like(p)
        t_sph = torch.full_like(p[..., 0], -1.0)
        ok_sph = torch.zeros_like(is_tri)

    t = torch.where(is_tri, t_tri, t_sph)
    n = torch.where(is_tri[..., None], n_t, n_s)
    return t, n, torch.where(is_tri, ok_tri, ok_sph)


def _bounce(d, n, eta, is_diel, refl):
    """Reflect/refract d at normal n, same branch as the base chain.
    Returns (d_new, cos_i_signed, ok). cos_i is wrt the OUTWARD normal
    (sign tells inside/outside, feeding the Fresnel)."""
    cos_i = -(d * n).sum(-1)               # >0: arriving from outside
    d_refl = d + 2.0 * cos_i[..., None] * n
    rel_eta = torch.where(cos_i > 0.0, eta, 1.0 / eta)
    # refract (Snell), normal flipped to the incoming side
    nf = n * torch.sign(cos_i)[..., None]
    ci = torch.abs(cos_i)
    sin2_t = torch.clamp(1.0 - ci * ci, min=0.0) / (rel_eta * rel_eta)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    d_refr = (d + nf * ci[..., None]) / rel_eta[..., None] \
        - nf * cos_t[..., None]
    d_refr = d_refr / torch.clamp(_norm(d_refr), min=1e-12)[..., None]
    use_refl = refl | ~is_diel
    d_new = torch.where(use_refl[..., None], d_refl, d_refr)
    ok = use_refl | ~tir
    return d_new, cos_i, ok


def _retrace(scene: Scene, chl, w1, want_pos=False):
    """Trace the delta chains from their anchors along w1 [N,3].
    chl: lane-major chain dict (`_lanes`); returns (exit_p [N,3],
    exit_d [N,3], ok [N], fres [K,N], cos_i [K,N], seg_len [K,N]
    [, pos [N,K,3]])."""
    p = chl["anchor_p"]
    d = w1
    ok = torch.ones_like(chl["k"], dtype=torch.bool)
    fres, coss, lens, poss = [], [], [], []
    for j in range(K_MAX):
        live = j < chl["k"]
        eta, is_diel = chl["eta"][:, j], chl["is_diel"][:, j]
        t, n, hok = _prim_hit(scene, chl["prim"][:, j], p, d,
                              chl["enter"][:, j])
        p_new = p + d * t[..., None]
        d_new, cos_i, bok = _bounce(d, n, eta, is_diel,
                                    chl["branch_refl"][:, j])
        F = torch.where(is_diel, fresnel_dielectric(cos_i, eta)[0], 1.0)
        ok = ok & ((hok & bok) | ~live)
        fres.append(torch.where(live, F, 1.0))
        coss.append(torch.where(live, cos_i, 1.0))
        lens.append(torch.where(live, t, 0.0))
        p = torch.where(live[..., None], p_new, p)
        d = torch.where(live[..., None], d_new, d)
        poss.append(p)
    out = (p, d, ok, torch.stack(fres), torch.stack(coss),
           torch.stack(lens))
    if want_pos:
        out = out + (torch.stack(poss, dim=1),)
    return out


def _lanes(ch):
    """Lane-major view of the chain dict: the slot-major [K, L, ...]
    entries move the lane axis first."""
    return {name: (v.movedim(1, 0) if name in _SLOT_MAJOR else v)
            for name, v in ch.items() if name != "ok"}


def _rep(tree, n):
    """Every tensor of a lane-major dict repeated n times along lanes."""
    return {name: v.repeat((n,) + (1,) * (v.dim() - 1))
            for name, v in tree.items()}


def _lane_jacobian(fn, u):
    """Value, per-lane Jacobian and aux of `fn` at u [L, n].

    fn maps [n*L, n] unknowns (the lanes repeated n times, block-wise)
    to ([n*L, m] values, aux tuple of lane-major tensors), each lane
    independent of the others. One forward-mode product with block j carrying the unit
    tangent e_j gives column j of every lane's Jacobian. Returns
    (value [L, m], J [L, m, n] with J[l, i, j] = d value_i / d u_j,
    aux of the first block)."""
    L, n = u.shape
    tang = torch.eye(n, dtype=u.dtype, device=u.device).repeat_interleave(
        L, dim=0)
    val, dval, aux = torch.func.jvp(fn, (u.repeat(n, 1),), (tang,),
                                    has_aux=True)
    J = dval.reshape(n, L, -1).permute(1, 2, 0)
    return val[:L], J, tuple(a[:L] for a in aux)


def _det2(J):
    return J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]


def _det3(J):
    a, b, c = J[:, 0, 0], J[:, 0, 1], J[:, 0, 2]
    d, e, f = J[:, 1, 0], J[:, 1, 1], J[:, 1, 2]
    g, h, i = J[:, 2, 0], J[:, 2, 1], J[:, 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _solve3(J, det, r):
    """J^-1 r by the adjugate over `det` (the caller's guarded
    determinant)."""
    a, b, c = J[:, 0, 0], J[:, 0, 1], J[:, 0, 2]
    d, e, f = J[:, 1, 0], J[:, 1, 1], J[:, 1, 2]
    g, h, i = J[:, 2, 0], J[:, 2, 1], J[:, 2, 2]
    r0, r1, r2 = r[:, 0], r[:, 1], r[:, 2]
    x0 = (e * i - f * h) * r0 + (c * h - b * i) * r1 + (b * f - c * e) * r2
    x1 = (f * g - d * i) * r0 + (a * i - c * g) * r1 + (c * d - a * f) * r2
    x2 = (d * h - e * g) * r0 + (b * g - a * h) * r1 + (a * e - b * d) * r2
    return torch.stack([x0, x1, x2], dim=-1) / det[:, None]


# --------------------------------------------------------------------------
# occlusion of the shifted chain
# --------------------------------------------------------------------------

def _occluded_non_null(scene: Scene, a, b, eps=2e-3):
    """Shadow test a->b that looks THROUGH null-BSDF boundaries (medium
    hulls): up to two null crossings are skipped per segment."""
    seg = b - a
    dist = torch.sqrt(torch.clamp((seg * seg).sum(-1), min=1e-20))
    d = seg / dist[:, None]
    o = a + d * (eps * dist)[:, None]
    t_rem = dist * (1.0 - 2.0 * eps)
    blocked = torch.zeros_like(dist, dtype=torch.bool)
    nb = scene.bsdf_type.shape[0]
    for _ in range(3):
        hit = intersect(scene, o, d, t_max=t_rem)
        bi = torch.clamp(scene.prim_bsdf(hit.prim), 0, nb - 1)
        is_null = scene.bsdf_type[bi] == BSDF_NULL
        blocked = blocked | (hit.valid & ~is_null)
        adv = torch.where(hit.valid & is_null, hit.t + eps * dist, t_rem)
        o = o + d * adv[:, None]
        t_rem = torch.clamp(t_rem - adv, min=0.0)
    return blocked


def chain_occluded(scene: Scene, ch, w1_new, end_p):
    """One occlusion sweep over the SHIFTED chain segments at the Newton
    solution: the walk re-hits only the stored chain primitives, so
    without this a shifted chain passing through a blocker would be
    accepted. Returns blocked [L]."""
    poss = _retrace(scene, _lanes(ch), w1_new, want_pos=True)[-1]  # [L,K,3]
    L = w1_new.shape[0]
    starts = torch.cat([ch["anchor_p"][:, None], poss], dim=1)
    ends_d = torch.cat([poss, poss[:, -1:]], dim=1)
    jj = torch.arange(K_MAX + 1, device=w1_new.device)[None, :]
    k = ch["k"][:, None]
    ends = torch.where((jj == k)[..., None], end_p[:, None], ends_d)
    live = jj <= k                                # segments 0..k
    blocked_seg = _occluded_non_null(
        scene, starts.reshape(-1, 3), ends.reshape(-1, 3))
    return (blocked_seg.reshape(L, K_MAX + 1) & live).any(dim=1)


# --------------------------------------------------------------------------
# the ME shifts
# --------------------------------------------------------------------------

def _sigma_t(scene: Scene, med_idx):
    mi = torch.clamp(med_idx, 0, scene.med_sigma_a.shape[0] - 1)
    st = scene.med_sigma_a[mi] + scene.med_sigma_s[mi]
    return torch.where((med_idx >= 0)[..., None], st, 0.0)


def _w1_of(chl, sa, ta, u):
    w1 = chl["w1_base"] + u[:, 0:1] * sa + u[:, 1:2] * ta
    return w1 / torch.clamp(_norm(w1), min=1e-12)[..., None]


def _trust_step(du, n_dir):
    """Trust region on the first n_dir (direction) components of du."""
    dn = torch.sqrt((du[:, :n_dir] ** 2).sum(-1))
    lim = torch.clamp(MAX_STEP / torch.clamp(dn, min=1e-12), max=1.0)
    scale = torch.ones_like(du)
    scale[:, :n_dir] = lim[:, None]
    return du * scale


def _chain_ratios(scene, ch, w1_new, F_off, len_off, t_off, rho_off,
                  rho_base, conv, target, end_p, span=_span):
    """Everything after the Newton solve, common to the three targets
    ("volume", "surface", "beam"): base chain retrace, anchor scatter,
    Fresnel / transmittance / distance-pdf / measure ratios, the validity
    mask and the occlusion sweep of the shifted chain up to end_p. A
    beam's final segment (its origin to the target) is the beam itself,
    which the beam estimator re-evaluates: it takes no final-segment
    transmittance or distance-pdf ratio here. `span` as in
    me_shift_volume."""
    with span("me:ratios"):
        alpha_ratio, pdf_ratio, ok = _ratios(
            scene, ch, w1_new, F_off, len_off, t_off, rho_off, rho_base,
            conv, target)
    with span("me:occlusion"):
        ok = ok & ~chain_occluded(scene, ch, w1_new, end_p)
    return (torch.where(ok[..., None], alpha_ratio, 0.0),
            torch.where(ok, pdf_ratio, 0.0), ok)


def _ratios(scene, ch, w1_new, F_off, len_off, t_off, rho_off, rho_base,
            conv, target):
    """_chain_ratios' ratios before the occlusion sweep: (alpha_ratio,
    pdf_ratio, ok)."""
    chl = _lanes(ch)
    _, _, ok_b, F_base, _, len_base = _retrace(scene, chl, chl["w1_base"])

    # scatter + pdf at the anchor toward the new direction
    sc_new, pdf_new, ok_an = shift.parent_scatter(
        scene, ch["anchor_type"], ch["anchor_wi"], ch["anchor_ns"],
        ch["anchor_bsdf"], ch["anchor_med"], w1_new)
    sc_ratio = sc_new / torch.clamp(ch["sc_base"], min=1e-20)
    pdf_dir_ratio = pdf_new / torch.clamp(ch["pdf_dir_base"], min=1e-20)

    # Fresnel/branch-probability ratios per chain vertex
    live = torch.arange(K_MAX, device=w1_new.device)[:, None] \
        < ch["k"][None]
    refl = ch["branch_refl"]
    f_vert_base = torch.where(refl, F_base, 1.0 - F_base)
    f_vert_off = torch.where(refl, F_off, 1.0 - F_off)
    # conductors: F ratio; dielectrics: F (or 1-F) appears in BOTH the
    # value and the discrete branch pdf
    fr = f_vert_off / torch.clamp(f_vert_base, min=1e-12)
    f_chain_ratio = torch.where(live, fr, 1.0).prod(dim=0)
    pdf_chain_ratio = torch.where(live & ch["is_diel"], fr, 1.0).prod(dim=0)

    # transmittance (+ final-distance-pdf) ratios, exact per segment
    if target == "beam":
        dlen = len_off - len_base                             # [K, L]
        st = _sigma_t(scene, ch["seg_med"][:K_MAX].t())       # [L,K,3]
    else:
        dlen = torch.cat([len_off - len_base,
                          (t_off - ch["t_last"])[None]], dim=0)  # [K+1, L]
        st = _sigma_t(scene, ch["seg_med"].t())               # [L,K+1,3]
    tr_ratio = torch.exp(-(st * dlen.t()[..., None]).sum(dim=1))

    rho_ratio = rho_base / torch.clamp(rho_off, min=1e-20)   # alpha factor
    alpha_ratio = sc_ratio * f_chain_ratio[..., None] * tr_ratio \
        * rho_ratio[..., None]
    pdf_ratio = pdf_dir_ratio * pdf_chain_ratio
    if target != "beam":
        stl = _sigma_t(scene, ch["seg_med"][-1])
        e_new = torch.exp(-stl * t_off[..., None])
        e_old = torch.exp(-stl * ch["t_last"][..., None])
        if target == "surface":   # pdf_failure ratio (reaching the surface)
            dens_new, dens_old = e_new.mean(-1), e_old.mean(-1)
        else:
            dens_new = (stl * e_new).mean(-1)
            dens_old = (stl * e_old).mean(-1)
        pdf_ratio = pdf_ratio * torch.where(
            dens_old > 1e-20, dens_new / torch.clamp(dens_old, min=1e-20),
            1.0)
    pdf_ratio = pdf_ratio * rho_ratio
    t2 = torch.clamp(t_off, min=1e-3) ** 2
    t2b = torch.clamp(ch["t_last"], min=1e-3) ** 2
    ok = (ch["ok"] & conv & ok_b & ok_an
          & (ch["pdf_dir_base"] > 1e-20) & (pdf_new > 0.0)
          & (rho_off > FOLD_EPS * t2) & (rho_base > FOLD_EPS * t2b))
    if target == "beam":
        ok = ok & (t_off > 1e-5)
    return alpha_ratio, pdf_ratio, ok


def me_shift_volume(scene: Scene, ch, c_target, n_iters=5,
                    scene_scale=1.0, span=_span):
    """Shift photons with delta parent chains to c_target (volume photon).

    ch: chain dict from pull_chains (lane dim L); c_target: [L,3].
    Returns (alpha_ratio [L,3], pdf_ratio [L], ok [L], wi_new [L,3]):
    multiply the photon's stored alpha by alpha_ratio; pdf_ratio feeds
    the pairwise MIS; wi_new is the incident direction at the shifted
    photon. `span(name)` opens the spans of the Newton solve
    ("me:newton": one kernel launch on the card, the plain version's
    n_iters + 1 Jacobian evaluations on the CPU), the ratios
    ("me:ratios") and the occlusion sweep ("me:occlusion")
    (core.logging.span; a pass gives its PhaseClock's, which times
    them)."""
    with span("me:newton"):
        u, conv, rho_off, rho_base, aux = _newton3(
            scene, ch, c_target, n_iters, scene_scale, "volume")
    ok_tr, F_off, len_off, w1_new, wi_new = aux
    return _chain_ratios(scene, ch, w1_new, F_off.t(), len_off.t(), u[:, 2],
                         rho_off, rho_base, conv & ok_tr, "volume",
                         c_target, span) + (wi_new,)


def _newton3(scene, ch, c_target, n_iters, scene_scale, target):
    """Newton solve of the exit point + t * exit direction = c_target in
    the unknowns u = (a, b, t) from (0, 0, t_last), for the "volume" and
    "beam" targets: one kernel launch for CUDA tensors
    (ops/me_newton.solve), else `_newton3_plain`. Returns (u, converged,
    rho_off, rho_base, aux at the solution: ok, F [L,K], len [L,K], w1
    [, the beam's exit point], exit direction)."""
    if c_target.device.type == "cuda":
        return me_newton.solve(target, scene, ch, c_target, n_iters,
                               scene_scale)
    StatsCounter.get("me/newton_plain_lanes").add(c_target.shape[0])
    return _newton3_plain(scene, ch, c_target, n_iters, scene_scale, target)


def _newton3_plain(scene, ch, c_target, n_iters, scene_scale, target):
    """_newton3 in PyTorch: each Jacobian by one forward-mode product over
    the lanes repeated 3 times (_lane_jacobian)."""
    s_ax, t_ax = coordinate_system(ch["w1_base"])
    chl3 = _rep(_lanes(ch), 3)
    sa3, ta3 = s_ax.repeat(3, 1), t_ax.repeat(3, 1)

    def c_of(u):
        w1 = _w1_of(chl3, sa3, ta3, u)
        ep, ed, ok, F, _ci, ln = _retrace(scene, chl3, w1)
        exit_p = (ep,) if target == "beam" else ()
        return ep + ed * u[:, 2:3], (ok, F.t(), ln.t(), w1) + exit_p + (ed,)

    u = torch.stack([torch.zeros_like(ch["t_last"]),
                     torch.zeros_like(ch["t_last"]), ch["t_last"]], dim=-1)
    c, J, aux = _lane_jacobian(c_of, u)
    J_base = J
    for _ in range(n_iters):
        r = c - c_target
        det = _det3(J)
        ok_step = torch.abs(det) > 1e-18
        du = _solve3(J, torch.where(ok_step, det, 1.0), r)
        # trust region on the direction parameters (du[2] is the
        # free-flight distance, scene-scaled: left unclamped)
        u = torch.where(ok_step[:, None], u - _trust_step(du, 2), u)
        c, J, aux = _lane_jacobian(c_of, u)
    conv = (_norm(c - c_target) < NEWTON_EPS * scene_scale) \
        & (torch.sqrt(u[:, 0] ** 2 + u[:, 1] ** 2) < MAX_DEV)
    # geometric expansion |dc/d(a,b,t)| at the solution and at base;
    # direction-parameterization measure: w1(u) = norm(w0+a s+b t),
    # d(omega)/d(a,b) = (1+a^2+b^2)^(-3/2)
    s_off = (1.0 + u[:, 0] ** 2 + u[:, 1] ** 2) ** -1.5
    rho_off = torch.abs(_det3(J)) / torch.clamp(s_off, min=1e-12)
    return u, conv, rho_off, torch.abs(_det3(J_base)), aux


def me_shift_surface(scene: Scene, ch, photon_prim, photon_ns,
                     photon_enter, c_target, n_iters=5, scene_scale=1.0,
                     span=_span):
    """ME shift of SURFACE photons: the chain exit ray is intersected
    with the photon's own primitive, so the unknowns are just the anchor
    direction (2 dof) and the measure is area. photon_enter: sphere-root
    selector for the final hit (True when the base segment arrived from
    outside). `span` as in me_shift_volume.

    Returns (alpha_ratio [L,3], pdf_ratio [L], ok [L], wi_new [L,3])."""
    with span("me:newton"):
        u, conv, rho_off, rho_base, aux = _newton2(
            scene, ch, photon_prim, photon_ns, photon_enter, c_target,
            n_iters, scene_scale)
    ok_tr, F_off, len_off, w1_new, t_end, wi_new = aux
    return _chain_ratios(scene, ch, w1_new, F_off.t(), len_off.t(), t_end,
                         rho_off, rho_base, conv & ok_tr, "surface",
                         c_target, span) + (wi_new,)


def _newton2(scene, ch, photon_prim, photon_ns, photon_enter, c_target,
             n_iters, scene_scale):
    """Newton solve of the surface target in the unknowns u = (a, b) from
    0, the residual in the target's tangent frame: one kernel launch for
    CUDA tensors (ops/me_newton.solve), else `_newton2_plain`. Returns
    (u, converged, rho_off, rho_base, aux at the solution: ok, F [L,K],
    len [L,K], w1, t_end, exit direction)."""
    if c_target.device.type == "cuda":
        return me_newton.solve("surface", scene, ch, c_target, n_iters,
                               scene_scale,
                               (photon_prim, photon_ns, photon_enter))
    StatsCounter.get("me/newton_plain_lanes").add(c_target.shape[0])
    return _newton2_plain(scene, ch, photon_prim, photon_ns, photon_enter,
                          c_target, n_iters, scene_scale)


def _newton2_plain(scene, ch, photon_prim, photon_ns, photon_enter,
                   c_target, n_iters, scene_scale):
    """_newton2 in PyTorch: each Jacobian by one forward-mode product over
    the lanes repeated twice (_lane_jacobian)."""
    s_ax, t_ax = coordinate_system(ch["w1_base"])
    # tangent frame at the target surface for the 2D residual
    ts_ax, tt_ax = coordinate_system(photon_ns)
    chl2 = _rep(_lanes(ch), 2)
    sa2, ta2 = s_ax.repeat(2, 1), t_ax.repeat(2, 1)
    prim2, ent2 = photon_prim.repeat(2), photon_enter.repeat(2)

    def p_of(u):
        w1 = _w1_of(chl2, sa2, ta2, u)
        ep, ed, ok, F, _ci, ln = _retrace(scene, chl2, w1)
        t_end, _n_end, hok = _prim_hit(scene, prim2, ep, ed, ent2)
        return (ep + ed * t_end[..., None],
                (ok & hok, F.t(), ln.t(), w1, t_end, ed))

    def tangent2(v):
        return torch.stack([(v * ts_ax).sum(-1), (v * tt_ax).sum(-1)],
                           dim=-1)

    def jac(u):
        # the residual and the tangent-plane position differ by a
        # constant, so one Jacobian serves the solve and the measure
        p_end, Jp, aux = _lane_jacobian(p_of, u)          # Jp [L,3,2]
        J = torch.stack([(Jp * ts_ax[..., None]).sum(1),
                         (Jp * tt_ax[..., None]).sum(1)], dim=1)
        return tangent2(p_end - c_target), J, aux

    u = torch.zeros((c_target.shape[0], 2), dtype=c_target.dtype,
                    device=c_target.device)
    r, J, aux = jac(u)
    J_base = J
    for _ in range(n_iters):
        det = _det2(J)
        inv_ok = torch.abs(det) > 1e-18
        dsafe = torch.where(inv_ok, det, 1.0)
        du = torch.stack(
            [(J[:, 1, 1] * r[:, 0] - J[:, 0, 1] * r[:, 1]) / dsafe,
             (-J[:, 1, 0] * r[:, 0] + J[:, 0, 0] * r[:, 1]) / dsafe],
            dim=-1)
        u = torch.where(inv_ok[:, None], u - _trust_step(du, 2), u)
        r, J, aux = jac(u)
    conv = (_norm(r) < NEWTON_EPS * scene_scale) & (_norm(u) < MAX_DEV)
    s_off = (1.0 + u[:, 0] ** 2 + u[:, 1] ** 2) ** -1.5
    rho_off = torch.abs(_det2(J)) / torch.clamp(s_off, min=1e-12)
    return u, conv, rho_off, torch.abs(_det2(J_base)), aux


def me_shift_beam(scene: Scene, ch, y_target, n_iters=5, scene_scale=1.0,
                  span=_span):
    """ME shift of a BEAM pair (shiftBeamME, shift_volume_beams.h:440 /
    shift_volume_beams.cpp:748).

    ch: chain dict from pull_chains(..., virt=...) whose virtual photon
    is the base point y on the beam, so the final chain vertex is the
    beam's (delta) origin A. Newton solves the chain so that the new
    beam A' + t dir' passes exactly through y_target (unknowns: the
    anchor direction's two tangent offsets and the beam parameter t).
    The ratios cover the anchor scatter, the chain's Fresnel terms and
    transmittances and the manifold measure; the beam segment A' -> y'
    is the beam estimator's to re-evaluate. `span` as in
    me_shift_volume.

    Returns (origin_new [L,3], dir_new [L,3], t_new [L], alpha_ratio
    [L,3], pdf_ratio [L], ok [L])."""
    with span("me:newton"):
        u, conv, rho_off, rho_base, aux = _newton3(
            scene, ch, y_target, n_iters, scene_scale, "beam")
    ok_tr, F_off, len_off, w1_new, org_new, dir_new = aux
    t_new = u[:, 2]
    ar, pr, ok = _chain_ratios(scene, ch, w1_new, F_off.t(), len_off.t(),
                               t_new, rho_off, rho_base, conv & ok_tr,
                               "beam", org_new, span)
    return org_new, dir_new, t_new, ar, pr, ok
