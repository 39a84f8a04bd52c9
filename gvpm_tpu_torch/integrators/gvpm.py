"""G-VPM: gradient-domain volumetric photon density estimation
(mirrors gvpm_tpu/integrators/gvpm.py: the `distance` and `bre` volume
estimators, and the photon beams and planes `beam1d`, `beam3d` and
`plane0d`, each with and without manifold shifts).

Each progressive pass computes, besides the primal photon-density
estimate, finite-difference gradients to the 4 neighbour pixels by
shifting every (camera path, photon) pair: the camera subpath is
retraced through the offset pixel with the same random numbers, and the
photon is reconnected to a target that preserves the kernel-local
offset. Per pixel: primal flux, and per direction d in
{right,left,down,up} the shifted flux S_d and weighted base flux W_d
(computeGradient, gvpm.cpp:1205-1306):

  Gx[x] = (S_right[x] - W_right[x]) + (W_left[x+1] - S_left[x+1])
  Gy[y] = (S_down[y] - W_down[y]) + (W_up[y+1] - S_up[y+1])

The final image is the screened-Poisson reconstruction (ops/poisson.py)
of the averaged primal + gradients.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import GradientConfig
from ..core.logging import PhaseClock, StatsCounter, log, span
from ..ops import cellgrid, hashgrid, poisson
from ..scene.camera import pixel_grid
from ..scene.types import Scene
from ..utils import checkpoint as ckpt
from . import estimators, gatherpoint, gradient_gather, ptracer, sppm

# shift directions: (dx, dy) in image coords (gbdpt_proc.cpp:103)
OFFSETS = ((1, 0), (-1, 0), (0, 1), (0, -1))
RIGHT, LEFT, DOWN, UP = 0, 1, 2, 3
CAMERA_FIELDS = ("valid", "o", "d", "length", "med", "thr", "pdf_prod",
                 "depth")


def assemble_gradients(primal_px, S_px, W_px, H, W_img):
    """computeGradient (gvpm.cpp:1205-1306) on [H,W,...] buffers; the
    span `film`."""
    def img(a):
        return a.reshape(H, W_img, 3)

    with span("film"):
        S = [img(S_px[i]) for i in range(4)]
        Wb = [img(W_px[i]) for i in range(4)]
        gx = S[RIGHT] - Wb[RIGHT]
        gx[:, :-1] += Wb[LEFT][:, 1:] - S[LEFT][:, 1:]
        gy = S[DOWN] - Wb[DOWN]
        gy[:-1, :] += Wb[UP][1:, :] - S[UP][1:, :]
        return img(primal_px), gx, gy


def _flat_segments(cbeams, scene: Scene, pix_id):
    """[S, n] camera segments of one pixel group -> flat [S*n] dict with
    the (pixel, step) lane id `gid` that keys the distance randoms."""
    n_steps = cbeams.valid.shape[0]
    cd = {f: getattr(cbeams, f).reshape((-1,) + getattr(cbeams, f).shape[2:])
          for f in CAMERA_FIELDS}
    steps = torch.arange(n_steps, device=pix_id.device)[:, None]
    cd["gid"] = (steps * (scene.width * scene.height)
                 + pix_id[None, :]).reshape(-1)
    return cd


def pass_buffers(scene: Scene, cfg: GradientConfig, volume, n_photons,
                 photons, beams, k_cam, k_gather, px, py, border, surf_scale,
                 vol_scale, r_vol_base, timings=None, emission_scale=1.0):
    """The per-pixel gradient pass core: camera traces (base + 4
    offsets), surface + volume gathers with shifts. Returns flat
    (primal [n,3], S [4,n,3], W [4,n,3], stats) for the given pixels.
    photons, beams: the dicts of sppm.shoot_photons (beams, read by the
    beam and plane volumes and by the camera_sphere cull, may be None
    otherwise). `timings`, when given, receives each phase's seconds (the
    phases end in a device synchronize); with cfg.use_manifold the ME
    stages of the gathers are phases of their own (surface_me,
    volume_me) and their parts are listed beside them under "me:..."
    keys (compact, chains, newton, ratios, occlusion), which the two
    phases include (a beam or plane volume runs its volume_me phase once
    per segment chunk). The volume estimator is `distance`, `bre`, or one
    of the beams and planes (sppm.BEAM_VOLUMES); with cfg.beams > 0 these
    read the beam map of sppm.select_beams (the phase beam_select) and
    divide by its paths, not by n_photons. emission_scale weighs
    the directly seen emission, the one term that reads no photon: a ring
    pass (parallel.dist) adds the photon terms once for each partition
    and passes 1 / partitions."""
    if volume not in ("distance", "bre") + sppm.BEAM_VOLUMES:
        raise ValueError(volume)
    dev = scene.device
    n = px.shape[0]
    clock = PhaseClock(dev, timings)
    # the light paths the volume estimate divides by
    beams, n_vol = sppm.beam_map(cfg, volume, beams, n_photons, clock)

    # base + 4 offset camera paths with the SAME random numbers, traced
    # as one [5n]-ray wavefront
    with clock.span("camera_trace"):
        px5 = torch.cat([px] + [px + dx for dx, _ in OFFSETS])
        py5 = torch.cat([py] + [py + dy for _, dy in OFFSETS])
        gp5, cb5 = gatherpoint.trace(scene, cfg, k_cam, px5, py5,
                                     rand_tile=5)
        base = gp5.map(lambda a: a[:n])
        sgps = [gp5.map(lambda a, i=i: a[i * n:(i + 1) * n])
                for i in range(1, 5)]
        cam_groups = [cb5.map(lambda a, i=i: a[:, i * n:(i + 1) * n])
                      for i in range(5)]

    with clock.span("surface_grid"):
        pp = photons["p"]
        # cameraSphere: drop photons stored within a sensor-centred
        # sphere (gvpm_accel.h:221 isValidPhoton) and beams whose segment
        # crosses it (gvpm_beams.h:90)
        surf_valid = photons["vtype"] == ptracer.VERT_SURFACE
        med_valid = photons["vtype"] == ptracer.VERT_MEDIUM
        if cfg.camera_sphere > 0.0:
            cam_o = scene.cam_to_world[:3, 3]
            keep = ((pp - cam_o[None]) ** 2).sum(-1) \
                > cfg.camera_sphere ** 2
            surf_valid, med_valid = surf_valid & keep, med_valid & keep
            t_cl = torch.clamp(
                ((cam_o[None] - beams["o"]) * beams["d"]).sum(-1),
                torch.zeros_like(beams["length"]), beams["length"])
            cl = beams["o"] + beams["d"] * t_cl[..., None]
            beams = dict(beams, valid=beams["valid"] & (
                ((cl - cam_o[None]) ** 2).sum(-1) > cfg.camera_sphere ** 2))
        # nullShift debug mode (GPMConfig nullShift): force every light
        # shift to the identity/unilateral branch by clearing the
        # reconnectable flags end to end
        if cfg.shift_null:
            photons = dict(photons, reconnectable=torch.zeros_like(
                photons["reconnectable"]))
            if beams is not None:
                beams = dict(beams, reconnectable=torch.zeros_like(
                    beams["reconnectable"]))
        me_kw = dict(use_manifold=cfg.use_manifold, pv_chain=photons,
                     me_budget=cfg.me_pair_budget,
                     me_iters=cfg.max_manifold_iterations, span=clock.span)

        pix_id = py.to(torch.int64) * scene.width + px.to(torch.int64)

        def pack_rows(sel):
            ph = {f: v[sel] for f, v in photons.items()}
            return gradient_gather.pack_photons(
                scene, ph, valid=ph["vtype"] != ptracer.VERT_NONE)

        # ---- surface photons ----
        f32 = dict(dtype=torch.float32, device=dev)
        r_surf = base.radius * torch.tensor(surf_scale, **f32)
        base_s = base.replace(radius=r_surf)
        cell = torch.clamp(torch.where(base.valid, r_surf, 0.0).amax(),
                           min=1e-5)
        grid_s, sel_s = cellgrid.build_cells(
            pp, surf_valid, scene.world_lo, scene.world_hi, cell,
            cfg.grid_dims, max_rows=cfg.grid_surface_rows)
        packed_s = pack_rows(sel_s)
    # the gather opens its spans: surface_gather, and surface_me with ME
    p_s, S_s, W_s, v_s, so_s, dr_s, med_s, mep_s = \
        gradient_gather.surface_gather(
            scene, base_s, sgps, grid_s, packed_s, n_photons, border,
            min_depth=cfg.min_depth, **me_kw)

    # ---- volume (VPM distance | BRE | beams and planes) ----
    with clock.span("volume_grid"):
        visits = v_s.sum()
        shift_ok = so_s.sum()
        dropped = dr_s
        r_vol = torch.tensor(r_vol_base, **f32) \
            * torch.tensor(vol_scale, **f32)
        if volume == "distance":
            grid_v, sel_v = cellgrid.build_cells(
                pp, med_valid, scene.medium_lo, scene.medium_hi, r_vol,
                cfg.grid_dims, max_rows=cfg.grid_volume_rows)
            packed_v = pack_rows(sel_v)
        elif volume == "bre":
            # BRE stays on the hash grid: its step membership is no
            # ball, so it needs the 27-stencil's exact cell fingerprints
            grid_v, packed_v = hashgrid.build_sorted(
                pp, med_valid, scene.medium_lo, 2.0 * r_vol,
                dict(rows=gradient_gather.pack_photons(
                    scene, photons,
                    valid=photons["vtype"] != ptracer.VERT_NONE)),
                hash_size=cfg.grid_hash_size, max_rows=cfg.grid_volume_rows)
            packed_v = packed_v["rows"]
        cb = _flat_segments(cam_groups[0], scene, pix_id)
        scb_list = [_flat_segments(c, scene, pix_id) for c in cam_groups[1:]]
        n_steps = cam_groups[0].valid.shape[0]
        lane_full = torch.arange(n, device=dev).repeat(n_steps)
        # compact valid medium segments to a fixed per-pixel budget (a
        # stable sort keeps the JAX package's segment order)
        budget = min(cb["valid"].shape[0], n * cfg.vol_segments_per_pixel)
        order = torch.argsort((~cb["valid"]).to(torch.int8), stable=True)
        order = order[:budget]
        cb = {k: v[order] for k, v in cb.items()}
        scb_list = [{k: v[order] for k, v in s.items()} for s in scb_list]
        lane = lane_full[order]
        border_lane = torch.stack([border[i][lane] for i in range(4)])
    # the gathers but bre's open their spans: volume_gather, volume_me
    if volume == "distance":
        p_v, S_v, W_v, v_v, so_v, dr_v, med_v, mep_v = \
            gradient_gather.volume_gather(
                scene, cb, scb_list, grid_v, packed_v, n_photons, r_vol,
                k_gather, border_lane, n_samples=cfg.volume_samples,
                min_depth=cfg.min_depth, **me_kw)
    elif volume == "bre":
        with clock.span("volume_gather"):
            p_v, S_v, W_v, v_v, so_v = gradient_gather.bre_gather(
                scene, cb, scb_list, grid_v, packed_v, n_photons, r_vol,
                border_lane, max_per_cell=cfg.grid_max_photons_per_cell,
                min_depth=cfg.min_depth)
            med_v = mep_v = torch.zeros((), dtype=torch.int64, device=dev)
    elif volume == "beam1d":
        p_v, S_v, W_v, v_v, so_v, med_v, mep_v = \
            gradient_gather.beam_gradient_gather(
                scene, cb, scb_list, beams, n_vol, r_vol,
                border_lane, seg_tile=cfg.beam_seg_tile, **me_kw)
    elif volume == "beam3d":
        p_v, S_v, W_v, v_v, so_v, med_v, mep_v = \
            gradient_gather.beam3d_gradient_gather(
                scene, cb, scb_list, beams, n_vol, r_vol, k_gather,
                border_lane, n_samples=cfg.volume_samples,
                tile=cfg.beam_tile, seg_tile=cfg.beam_seg_tile, **me_kw)
    else:
        with clock.span("volume_gather"):
            planes = estimators.make_planes(scene, beams, k_gather)
        p_v, S_v, W_v, v_v, so_v, med_v, mep_v = \
            gradient_gather.plane_gradient_gather(
                scene, cb, scb_list, planes, n_vol, border_lane,
                seg_tile=cfg.beam_seg_tile, **me_kw)

    with clock.span("splat"):
        if volume != "distance":
            dr_v = torch.zeros((), dtype=torch.int64, device=dev)
        visits = visits + v_v.sum()
        shift_ok = shift_ok + so_v.sum()
        dropped = dropped + dr_v

        # splat per-segment results back to pixel lanes
        def to_px(a):
            return torch.zeros((n, 3), **f32).index_add_(0, lane, a)

        p_s = p_s + to_px(p_v)
        S_s = S_s + torch.stack([to_px(S_v[i]) for i in range(4)])
        W_s = W_s + torch.stack([to_px(W_v[i]) for i in range(4)])

        # ---- directly-seen emission (directTracing, gvpm.cpp:1231-1240)
        p_s = p_s + emission_scale * base.emission
        for i in range(4):
            w = torch.where(border[i], 1.0, 0.5)[..., None] * emission_scale
            S_s[i] += w * sgps[i].emission
            W_s[i] += w * base.emission
    stats = dict(visits=visits, shift_ok=shift_ok, win_dropped=dropped,
                 me_dropped=med_s + med_v, me_pairs=mep_s + mep_v)
    return p_s, S_s, W_s, stats


def reject_heterogeneous(scene: Scene):
    """The gradient shifts use homogeneous closed forms (exp(-sigma_t*d)
    transmittance ratios along reconnected segments); on a heterogeneous
    medium they would be silently biased. The reference has the same
    limitation (its README lists G-VPM heterogeneous as missing), and the
    JAX package rejects such scenes with this error."""
    if scene.het_medium >= 0:
        raise ValueError(
            "gradient-domain integrators do not support heterogeneous "
            "media: the reconnection/ME shifts use homogeneous "
            "closed-form transmittance ratios and would be biased "
            "(reference parity: README.md:66). Render this scene with "
            "the primal integrators (volpath/sppm) instead.")


def prepare_pass(scene: Scene):
    """What every gradient pass does first: refuse a heterogeneous medium,
    and keep the card's float32 matmuls out of TF32, as the JAX package
    computes them."""
    reject_heterogeneous(scene)
    if scene.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def reads_beams(cfg: GradientConfig, volume):
    """Whether a pass reads the light beams: the beam and plane volumes,
    and the distance and bre passes only to cull them at the camera
    sphere."""
    return volume in sppm.BEAM_VOLUMES or cfg.camera_sphere > 0.0


def pixel_border(scene: Scene, px, py):
    """[4, n] bool: whether offset i (+x, -x, +y, -y) of each pixel leaves
    the film."""
    xi, yi = px.to(torch.int64), py.to(torch.int64)
    return torch.stack([xi == scene.width - 1, xi == 0,
                        yi == scene.height - 1, yi == 0])


def render_pass(scene: Scene, cfg: GradientConfig, volume, n_photons,
                seed, it, surf_scale, vol_scale, r_vol_base, timings=None):
    """One gradient pass. Returns (primal, gx, gy, stats): images
    [H,W,3] plus stats {visits, shift_ok, win_dropped, me_dropped,
    me_pairs, light_lanes_live, light_lanes}: real photon visits (pairs
    passing the kernel test), successful shifts (reconnection + ME), the
    ME pairs dropped by / taken within the per-gather budget, and the
    light pass's lanes (sppm.light_lanes).
    The pass is the span `pass`, and holds light_trace, the spans of
    pass_buffers and film; `timings` (optional dict) collects the
    seconds of each span that pass_buffers times, and light_trace's."""
    with span("pass"):
        prepare_pass(scene)
        dev = scene.device
        H, W = scene.height, scene.width
        k_cam = rng.pass_key(seed, it, rng.STREAM_CAMERA, dev)
        k_light = rng.pass_key(seed, it, rng.STREAM_LIGHT, dev)
        k_gather = rng.pass_key(seed, it, rng.STREAM_GATHER, dev)
        px, py = pixel_grid(scene)

        clock = PhaseClock(dev, timings)
        with clock.span("light_trace"):
            photons, beams = sppm.shoot_photons(
                scene, cfg, n_photons, k_light,
                with_beams=reads_beams(cfg, volume))
            lanes = sppm.light_lanes(photons)
        p_s, S_s, W_s, stats = pass_buffers(
            scene, cfg, volume, n_photons, photons, beams, k_cam, k_gather,
            px, py, pixel_border(scene, px, py), surf_scale, vol_scale,
            r_vol_base, timings=timings)
        primal, gx, gy = assemble_gradients(p_s, S_s, W_s, H, W)
    return primal, gx, gy, dict(stats, **lanes)


def render(scene: Scene, cfg: GradientConfig = GradientConfig(),
           volume="distance", seed=0, passes=None, callback=None,
           checkpoint_path=None, checkpoint_every=10, timings=None):
    """Progressive G-VPM loop + screened-Poisson reconstruction.

    checkpoint_path: if set, the accumulation state is written atomically
    every `checkpoint_every` passes and the loop resumes from an existing
    checkpoint. Per-pass visits and shift success feed StatsCounter.
    `callback(it, primal_mean_so_far, stats)` runs after each pass."""
    n_passes = passes if passes is not None else cfg.max_passes
    n_photons = max(cfg.volume_photons, cfg.surface_photons)
    r_vol_base = sppm.base_volume_radius(scene, cfg)
    dim = sppm.KERNEL_DIM.get(volume, 3)
    dev = scene.device
    H, W = scene.height, scene.width
    f32 = dict(dtype=torch.float32, device=dev)
    acc_p = torch.zeros((H, W, 3), **f32)
    acc_gx = torch.zeros((H, W, 3), **f32)
    acc_gy = torch.zeros((H, W, 3), **f32)
    surf_scale, vol_scale = 1.0, 1.0
    it0 = 0
    if checkpoint_path:
        state = ckpt.load(checkpoint_path)
        if state is not None:
            it0, bufs, scal = state
            it0 += 1
            acc_p, acc_gx, acc_gy = (
                torch.as_tensor(bufs[k], dtype=torch.float32, device=dev)
                for k in ("acc_p", "acc_gx", "acc_gy"))
            surf_scale = scal["surf_scale"]
            vol_scale = scal["vol_scale"]
            log.info("resumed from %s at pass %d", checkpoint_path, it0)

    c_visits = StatsCounter.get("gvpm/photon_visits", "value")
    c_shift = StatsCounter.get("gvpm/shift_success", "percentage")
    c_drop = StatsCounter.get("gvpm/window_dropped_rows", "value")
    c_medrop = StatsCounter.get("gvpm/me_dropped_pairs", "value")

    for it in range(it0, n_passes):
        p, gx, gy, stats = render_pass(scene, cfg, volume, n_photons, seed,
                                       it, surf_scale, vol_scale,
                                       r_vol_base, timings=timings)
        acc_p, acc_gx, acc_gy = acc_p + p, acc_gx + gx, acc_gy + gy
        v = int(stats["visits"])
        c_visits.add(v)
        c_shift.add(int(stats["shift_ok"]), max(4 * v, 1))
        c_drop.add(int(stats["win_dropped"]))
        c_medrop.add(int(stats["me_dropped"]))
        surf_scale, vol_scale = sppm.next_scales(it, cfg, dim, surf_scale,
                                                 vol_scale)
        if checkpoint_path and ((it + 1) % checkpoint_every == 0
                                or it == n_passes - 1):
            ckpt.save(checkpoint_path, it,
                      dict(acc_p=acc_p.cpu().numpy(),
                           acc_gx=acc_gx.cpu().numpy(),
                           acc_gy=acc_gy.cpu().numpy()),
                      dict(surf_scale=surf_scale, vol_scale=vol_scale))
        if callback is not None:
            callback(it, acc_p / (it + 1), stats)

    inv = 1.0 / n_passes
    primal = acc_p * inv
    gx = acc_gx * inv
    gy = acc_gy * inv
    recon = poisson.solve(primal, gx, gy, alpha=cfg.recon_alpha,
                          iters=cfg.recon_iters,
                          irls_iters=cfg.recon_irls_iters, l1=cfg.recon_l1)
    return dict(image=recon, primal=primal, gx=gx, gy=gy,
                passes=n_passes)
