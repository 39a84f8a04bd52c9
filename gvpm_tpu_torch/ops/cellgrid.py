"""Linear cell grid over the photon map (mirrors the CellGrid /
build_cells / anchor_ids27 slice of gvpm_tpu/ops/cellgrid.py).

Photons are bucketed by a row-major linear cell id over a grid with
static dims (Nx, Ny, Nz); each query's 3x3x3 stencil (cell >= r)
decomposes into nine contiguous row runs of three x-adjacent cells.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.struct import TensorStruct


@dataclasses.dataclass
class CellGrid(TensorStruct):
    origin: torch.Tensor        # [3]
    cell_size: torch.Tensor     # [3] per axis (>= r, >= extent/dims)
    bucket_start: torch.Tensor  # [Nx*Ny*Nz + 1] row range per cell id
    sorted_idx: torch.Tensor    # [P'] original photon index per row
    dims: tuple = (64, 64, 64)

    @property
    def n_rows(self):
        return self.sorted_idx.shape[0]


def build_cells(positions, valid, lo, hi, min_cell, dims, max_rows=0):
    """Bucket photons by row-major linear cell id.

    positions [P,3]; valid [P]; lo/hi: domain AABB; min_cell: scalar
    tensor; dims: static (Nx,Ny,Nz). max_rows > 0 keeps the first
    max_rows rows of the stable cell order (invalid rows sort last, so
    the cap only drops real photons when more are stored — and then the
    top z-slabs first). Returns (CellGrid, order [P'] photon index per
    row) — the caller permutes its payload with `order`.
    """
    Nx, Ny, Nz = dims
    dev = positions.device
    n_cells = Nx * Ny * Nz
    extent = torch.clamp(hi - lo, min=1e-6)
    cell = torch.maximum(min_cell.to(torch.float32),
                         extent / torch.tensor([Nx, Ny, Nz],
                                               dtype=torch.float32,
                                               device=dev))
    g = torch.floor((positions - lo) / cell)
    # dead lanes may hold inf/NaN positions: clamp before the int cast
    g = torch.nan_to_num(g, nan=0.0, posinf=float(max(dims)),
                         neginf=-1.0)
    c = torch.clamp(g, -1.0, float(max(dims))).to(torch.int64)
    c = torch.minimum(torch.clamp(c, min=0),
                      torch.tensor([Nx - 1, Ny - 1, Nz - 1], device=dev))
    cid = (c[..., 2] * Ny + c[..., 1]) * Nx + c[..., 0]
    cid = torch.where(valid, cid, n_cells)
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    bucket_start = torch.searchsorted(
        cid_sorted, torch.arange(n_cells + 1, device=dev))
    if max_rows and max_rows < positions.shape[0]:
        order = order[:max_rows]
        bucket_start = torch.clamp(bucket_start, max=max_rows)
    return CellGrid(origin=lo, cell_size=cell, bucket_start=bucket_start,
                    sorted_idx=order, dims=tuple(dims)), order


def anchor_ids27(grid: CellGrid, x):
    """Row-major id of each query's 3x3x3 stencil anchor (cell >= r)."""
    Nx, Ny, Nz = grid.dims
    g = (x - grid.origin) / grid.cell_size
    g = torch.nan_to_num(torch.floor(g), nan=0.0,
                         posinf=float(max(grid.dims)), neginf=-2.0)
    a = torch.clamp(g, -2.0, float(max(grid.dims))).to(torch.int64) - 1
    a = torch.minimum(torch.clamp(a, min=0), torch.tensor(
        [Nx - 3, Ny - 3, Nz - 3], device=x.device))
    return (a[..., 2] * Ny + a[..., 1]) * Nx + a[..., 0]
