"""Static voxel binning — the leaf table that replaces the PCL octree.

The port of `gp_compressor_tpu.geometry.voxel` (main-path part): voxel keys
are a quantisation, the leaf table is the sorted set of occupied linear
keys (static `max_patches` bound), and the radius search becomes a lookup
over each point's 27-neighbourhood. Leaf order, and so gp_index numbering
and first-claim, is lexicographic in (kx, ky, kz).

Division by the voxel edge is written as multiplication by its float32
reciprocal: XLA folds `x / res` into `x * (1 / res)` for a compile-time
constant `res`, and the port reproduces the JAX package's voxel keys bit
for bit only with the same arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

SQRT3_2 = 0.8660254037844386  # sqrt(3)/2

# 27 neighbour offsets in lexicographic (dx, dy, dz) order
OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]

# ---- octant-reduced candidacy (see the JAX module for the proof) -------
# Of a point's 27 neighbour voxels only the 8 in its home octant
# {0, s_0} x {0, s_1} x {0, s_2}, s_i = sign(f_i), can pass the radius test.
# OCT_SIGNS[o]: octant sign vector, bit 4/2/1 of o = (f_x, f_y, f_z) >= 0.
# OCT_CAND_OFFS[o, k]: offset of candidate k (k = 0 is the home voxel).
# OCT_CAND_27[o, k]: that offset's index into OFFSETS.
OCT_SIGNS = np.asarray(
    [[1 if o & 4 else -1, 1 if o & 2 else -1, 1 if o & 1 else -1]
     for o in range(8)], np.int32)
OCT_CAND_OFFS = np.asarray(
    [[[OCT_SIGNS[o, 0] if k & 4 else 0,
       OCT_SIGNS[o, 1] if k & 2 else 0,
       OCT_SIGNS[o, 2] if k & 1 else 0] for k in range(8)]
     for o in range(8)], np.int32)
OCT_CAND_27 = np.asarray(
    [[(OCT_CAND_OFFS[o, k, 0] + 1) * 9 + (OCT_CAND_OFFS[o, k, 1] + 1) * 3
      + (OCT_CAND_OFFS[o, k, 2] + 1) for k in range(8)]
     for o in range(8)], np.int32)

FILL = int(np.iinfo(np.int32).max)


def octant_of(rel: torch.Tensor) -> torch.Tensor:
    """[..., 3] offsets from the home-voxel CENTER -> octant id 0..7."""
    b = (rel >= 0).to(torch.int32)
    return b[..., 0] * 4 + b[..., 1] * 2 + b[..., 2]


class VoxelGrid(NamedTuple):
    """Sorted leaf table over a point cloud.

    keys:      [max_patches] int32 linear voxel keys, ascending; FILL padding
    n_leaves:  0-dim int32 — number of real leaves
    origin:    [3] grid origin (min corner)
    dims:      [3] int32 grid extents
    res:       0-dim voxel edge
    table:     optional [max_cells] int32 dense linear-key -> leaf map (-1 = none)
    """

    keys: torch.Tensor
    n_leaves: torch.Tensor
    origin: torch.Tensor
    dims: torch.Tensor
    res: torch.Tensor
    table: Optional[torch.Tensor] = None


def point_keys(points: torch.Tensor, origin: torch.Tensor,
               res: torch.Tensor) -> torch.Tensor:
    """[N, 3] float -> [N, 3] int32 voxel keys."""
    return torch.floor((points - origin) * (1.0 / res)).to(torch.int32)


def linearize(keys3: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """[.., 3] int keys -> linear key; invalid (out-of-grid) -> FILL."""
    ok = torch.all((keys3 >= 0) & (keys3 < dims), dim=-1)
    lin = (keys3[..., 0] * dims[1] + keys3[..., 1]) * dims[2] + keys3[..., 2]
    return torch.where(ok, lin, FILL)


def delinearize(lin: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    kz = lin % dims[2]
    rem = torch.div(lin, dims[2], rounding_mode='floor')
    ky = rem % dims[1]
    kx = torch.div(rem, dims[1], rounding_mode='floor')
    return torch.stack([kx, ky, kz], dim=-1)


def build_grid(points: torch.Tensor, valid: torch.Tensor, res,
               max_patches: int, max_cells: int = 0) -> VoxelGrid:
    """Construct the leaf table. points: [N, 3], valid: [N] bool.
    max_cells > 0 additionally builds the dense lookup table.

    Host syncs: the dense-or-sorted choice reads the grid extents, and the
    sorted form's `torch.unique` has a data-dependent size."""
    dt, dev = points.dtype, points.device
    res = torch.as_tensor(res, dtype=dt, device=dev)
    big = torch.finfo(dt).max
    p_lo = torch.amin(torch.where(valid[:, None], points, big), dim=0)
    p_hi = torch.amax(torch.where(valid[:, None], points, -big), dim=0)
    dims = torch.clamp(
        torch.floor((p_hi - p_lo) * (1.0 / res)).to(torch.int32) + 1, min=1)
    keys3 = point_keys(points, p_lo, res)
    lin = torch.where(valid, linearize(keys3, dims), FILL)
    slot = torch.arange(max_patches, device=dev, dtype=torch.int32)

    d0, d1, d2 = (int(v) for v in dims.tolist())
    if max_cells > 0 and d0 * d1 * d2 <= max_cells:
        # presence histogram + cumsum compaction: the b-th leaf key is the
        # first cell whose running count reaches b + 1. Keys outside the
        # budget (FILL) land in a dump cell past the end.
        tgt = torch.where((lin >= 0) & (lin < max_cells), lin, max_cells)
        presence = torch.zeros(max_cells + 1, dtype=torch.int32, device=dev)
        presence[tgt] = 1
        rank = torch.cumsum(presence[:max_cells], 0, dtype=torch.int32)
        n = torch.clamp(rank[-1], max=max_patches).to(torch.int32)
        uniq = torch.searchsorted(rank, slot + 1, side='left').to(torch.int32)
        uniq = torch.where(slot < n, uniq, FILL)
    else:
        u = torch.unique(lin)[:max_patches].to(torch.int32)
        uniq = torch.full((max_patches,), FILL, dtype=torch.int32, device=dev)
        uniq[:u.shape[0]] = u
        n = torch.sum(uniq != FILL).to(torch.int32)
    table = None
    if max_cells > 0:
        real = uniq != FILL
        tgt = torch.where(real & (uniq < max_cells), uniq, max_cells)
        table = torch.full((max_cells + 1,), -1, dtype=torch.int32, device=dev)
        table[tgt] = slot
        table = table[:max_cells]
    return VoxelGrid(keys=uniq, n_leaves=n, origin=p_lo, dims=dims, res=res,
                     table=table)


def lookup(grid: VoxelGrid, lin: torch.Tensor):
    """Linear keys -> (leaf index a.k.a. gp_index, exists mask)."""
    if grid.table is not None:
        nc = grid.table.shape[0]
        idx = grid.table[torch.clamp(lin, 0, nc - 1).long()]
        in_table = (lin >= 0) & (lin < nc) & (lin != FILL)
        exists = in_table & (idx >= 0)
        return torch.where(exists, idx, 0).to(torch.int32), exists
    idx = torch.searchsorted(grid.keys, lin.contiguous())
    idx = torch.clamp(idx, max=grid.keys.shape[0] - 1)
    exists = (grid.keys[idx] == lin) & (lin != FILL)
    return idx.to(torch.int32), exists


def voxel_centers(grid: VoxelGrid) -> torch.Tensor:
    """[max_patches, 3] centers of the leaf voxels."""
    keys3 = delinearize(torch.clamp(grid.keys, max=FILL - 1), grid.dims)
    return grid.origin + (keys3.to(grid.origin.dtype) + 0.5) * grid.res

