"""Scene representation: flat structure-of-arrays tables
(mirrors gvpm_tpu/scene/types.py).

A global prim id is a triangle index in [0, T) or T + sphere index.
Float tables are float32, id tables int64, all on one device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.struct import TensorStruct

# BSDF type ids (bsdf_type table values)
BSDF_DIFFUSE = 0
BSDF_CONDUCTOR = 1
BSDF_DIELECTRIC = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_ROUGH_DIELECTRIC = 4
BSDF_NULL = 5
BSDF_PHONG = 6
BSDF_PLASTIC = 7

# Phase function ids
PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2

# Delta/infinite emitter type ids (de_type table values)
DE_POINT = 0
DE_SPOT = 1
DE_DIRECTIONAL = 2

NO_MEDIUM = -1
NO_EMITTER = -1
NO_BSDF = -1

# non-tensor fields: static metadata
STATIC_FIELDS = ("width", "height", "cam_aperture", "cam_focus",
                 "het_medium")


@dataclasses.dataclass
class Scene(TensorStruct):
    # --- triangles: p(u,v) = p0 + u*e1 + v*e2 ---
    tri_p0: torch.Tensor        # [T,3]
    tri_e1: torch.Tensor        # [T,3]
    tri_e2: torch.Tensor        # [T,3]
    tri_vn: torch.Tensor        # [T,3,3] per-vertex shading normals
    tri_bsdf: torch.Tensor      # [T]
    tri_emitter: torch.Tensor   # [T] (-1 none)
    tri_med_in: torch.Tensor    # [T] interior medium (-1 none)
    tri_med_out: torch.Tensor   # [T] exterior medium (-1 none)
    # --- spheres ---
    sph_center: torch.Tensor    # [S,3]
    sph_radius: torch.Tensor    # [S]
    sph_bsdf: torch.Tensor
    sph_emitter: torch.Tensor
    sph_med_in: torch.Tensor
    sph_med_out: torch.Tensor
    # --- BSDF table ---
    bsdf_type: torch.Tensor     # [B]
    bsdf_albedo: torch.Tensor   # [B,3]
    bsdf_eta: torch.Tensor      # [B]
    bsdf_k: torch.Tensor        # [B,3]
    bsdf_eta3: torch.Tensor     # [B,3]
    bsdf_alpha: torch.Tensor    # [B]
    # --- media table (homogeneous) ---
    med_sigma_a: torch.Tensor   # [M,3]
    med_sigma_s: torch.Tensor   # [M,3]
    med_g: torch.Tensor         # [M]
    med_phase: torch.Tensor     # [M]
    # --- heterogeneous medium grid ((0,0,0) = none) ---
    het_density: torch.Tensor
    het_lo: torch.Tensor
    het_hi: torch.Tensor
    het_sigma_scale: torch.Tensor
    het_albedo: torch.Tensor
    het_majorant: torch.Tensor
    # --- area emitters ---
    em_radiance: torch.Tensor   # [E,3]
    em_prim: torch.Tensor       # [Te] global prim id of emissive prim
    em_prim_area: torch.Tensor  # [Te]
    em_cdf: torch.Tensor        # [Te] inclusive flux CDF
    em_power: torch.Tensor      # [] total emitted power
    # --- delta emitters ---
    de_type: torch.Tensor
    de_p: torch.Tensor
    de_dir: torch.Tensor
    de_intensity: torch.Tensor
    de_cos_cutoff: torch.Tensor
    de_cos_falloff: torch.Tensor
    de_medium: torch.Tensor
    de_cdf: torch.Tensor
    # --- environment ---
    env_radiance: torch.Tensor  # [3]
    env_map: torch.Tensor       # [He,We,3]
    env_row_cdf: torch.Tensor
    env_cond_cdf: torch.Tensor
    env_mean_lum: torch.Tensor
    # --- group pick probabilities: (area, delta, env) ---
    light_group_p: torch.Tensor  # [3]
    # --- camera ---
    cam_to_world: torch.Tensor  # [4,4]
    cam_tan_half_fov_x: torch.Tensor  # []
    cam_medium: torch.Tensor    # []
    # --- bounds ---
    world_lo: torch.Tensor
    world_hi: torch.Tensor
    medium_lo: torch.Tensor
    medium_hi: torch.Tensor
    # --- static metadata ---
    width: int = 256
    height: int = 256
    cam_aperture: float = 0.0
    cam_focus: float = 1.0
    het_medium: int = -1

    @property
    def device(self):
        return self.tri_p0.device

    def tensors(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in STATIC_FIELDS}

    @property
    def n_tris(self):
        return self.tri_p0.shape[0]

    @property
    def n_spheres(self):
        return self.sph_center.shape[0]

    def prim_attr(self, tri_tab, sph_tab, prim):
        """Per-global-prim attribute lookup."""
        ti = torch.clamp(prim, 0, self.n_tris - 1)
        if self.n_spheres == 0:
            return tri_tab[ti]
        si = torch.clamp(prim - self.n_tris, 0, self.n_spheres - 1)
        is_tri = prim < self.n_tris
        tv = tri_tab[ti]
        if tv.dim() > is_tri.dim():
            is_tri = is_tri[..., None]
        return torch.where(is_tri, tv, sph_tab[si])

    def prim_bsdf(self, prim):
        return self.prim_attr(self.tri_bsdf, self.sph_bsdf, prim)

    def prim_emitter(self, prim):
        return self.prim_attr(self.tri_emitter, self.sph_emitter, prim)

    def prim_med_in(self, prim):
        return self.prim_attr(self.tri_med_in, self.sph_med_in, prim)

    def prim_med_out(self, prim):
        return self.prim_attr(self.tri_med_out, self.sph_med_out, prim)
