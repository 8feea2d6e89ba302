"""Patch construction: project a cloud into per-voxel 2.5-D GP patches.

The port of the main-path part of `gp_compressor_tpu.geometry.patches`:

  1. moments  — per-leaf 4x4 homogeneous second moments over each leaf's
     search sphere (float64 accumulation) -> batched Jacobi -> rotations.
  2. claiming — a point is claimed by the lowest-ordered candidate leaf
     whose sphere contains it and whose local clip test passes.
  3. scatter  — sort the per-point payload by (claim, bank rank) and
     scatter it into capacity-padded [max_patches, max_points] banks.

Scatter indices are never left out of range: what JAX drops with
`mode='drop'` goes to an extra dump row here, which is sliced off. Only
the deterministic bank orders are kept.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.config import PatchConfig
from portbench.reference.geometry import rotation, voxel
from portbench.reference.geometry.voxel import VoxelGrid


class PatchBatch(NamedTuple):
    """Everything the workloads need, statically shaped.

    B = max_patches, P = max_points_per_patch, G = sz*sz.
    """

    grid: VoxelGrid
    rotations: torch.Tensor    # [B, 3, 3] local frames (col 0 = normal)
    means: torch.Tensor        # [B, 3]   patch centers (depth-mean adjusted)
    rgb_means: torch.Tensor    # [B, 3]   per-patch color means
    W: torch.Tensor            # [B, G] bool occupancy mask
    X: torch.Tensor            # [B, P, 2] local (u, v)
    y: torch.Tensor            # [B, P, 1] demeaned depth
    rgb: torch.Tensor          # [B, P, 3] demeaned colors
    mask: torch.Tensor         # [B, P] bool point validity
    counts: torch.Tensor       # [B] int32 claimed points per patch (pre-truncation)
    claims: torch.Tensor       # [N] int32 gp_index claiming each point (-1 = none)
    n_leaves: torch.Tensor     # 0-dim int32


# upper triangle of a symmetric 4x4, row-major: the 10 unique homogeneous
# second moments (xx xy xz x | yy yz y | zz z | 1)
_SYM_I = [i for i in range(4) for j in range(i, 4)]
_SYM_J = [j for i in range(4) for j in range(i, 4)]
_SYM_POS = np.zeros((4, 4), np.int64)
for _k, (_i, _j) in enumerate(zip(_SYM_I, _SYM_J)):
    _SYM_POS[_i, _j] = _SYM_POS[_j, _i] = _k

# the octant-resolution sphere moments: for each neighbour offset, the
# octants of that neighbour inside the home voxel's search sphere,
# |d + c_o| <= sqrt(3)/2 (res units) with octant centres c_o = +-0.25
_OCT_C = np.array([[(0.25 if b & 4 else -0.25), (0.25 if b & 2 else -0.25),
                    (0.25 if b & 1 else -0.25)] for b in range(8)])
_APPROX_SEL = [(k, np.nonzero(np.linalg.norm(np.asarray(off, float)[None, :]
                                             + _OCT_C, axis=1)
                              <= voxel.SQRT3_2)[0])
               for k, off in enumerate(voxel.OFFSETS)]
_APPROX_SEL = [(k, sel) for k, sel in _APPROX_SEL if len(sel)]


@functools.lru_cache(maxsize=None)
def _const(name: str, k: int, device: torch.device) -> torch.Tensor:
    """The module's index tables on `device`, copied once (a copy from host
    memory synchronises the stream)."""
    table = {"sym_i": _SYM_I, "sym_j": _SYM_J, "sym_pos": _SYM_POS,
             "offsets": voxel.OFFSETS,
             "approx_sel": dict(_APPROX_SEL).get(k)}[name]
    return torch.as_tensor(np.asarray(table), device=device)


def _sym10_to_44(m10: torch.Tensor) -> torch.Tensor:
    """[..., 10] packed symmetric moments -> [..., 4, 4]."""
    return m10[..., _const("sym_pos", 0, m10.device)]


def _segment_sum(data: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum over rows; seg in [0, num_segments)."""
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, seg.long(), data)


def sort_by_claim(claim: torch.Tensor, claimed: torch.Tensor, cols: tuple,
                  n_segments: int, rank: torch.Tensor = None):
    """Sort per-point payload columns by claim id (unclaimed last), and
    within a claim by `rank` ascending when given (ties keep point order).

    Returns (sorted cols tuple, starts [B+1] int32 window offsets: patch b
    owns rows starts[b]:starts[b+1], segs [N] int32 sorted claim ids)."""
    B = n_segments
    seg_u = torch.where(claimed, claim, B)
    if rank is None:
        order = torch.argsort(seg_u, stable=True)
    else:
        # two stable sorts = one lexicographic sort on (segment, rank)
        by_rank = torch.argsort(rank, stable=True)
        order = by_rank[torch.argsort(seg_u[by_rank], stable=True)]
    segs = seg_u[order].to(torch.int32)
    starts = torch.searchsorted(
        segs, torch.arange(B + 1, dtype=torch.int32, device=segs.device))
    return tuple(c[order] for c in cols), starts.to(torch.int32), segs


def bank_rank(loc_claim: torch.Tensor, order: str, claim=None, claimed=None,
              n_segments: int = 0):
    """Secondary sort key implementing PatchConfig.bank_order (None for
    'shuffle' and 'native', which need no rank key)."""
    if order in ("shuffle", "native"):
        return None
    d2 = loc_claim[:, 1] ** 2 + loc_claim[:, 2] ** 2
    if order == "center_out":
        return d2
    if order == "edge_in":
        return -d2
    if order == "far_center":
        # each patch's farthest point first, then ascending d2
        seg = torch.where(claimed, claim, n_segments).long()
        hi = torch.full((n_segments + 1,), -torch.inf, dtype=d2.dtype,
                        device=d2.device).scatter_reduce(
            0, seg, torch.where(claimed, d2, -torch.inf), "amax")
        is_far = claimed & (d2 >= hi[torch.where(claimed, claim, 0).long()])
        return torch.where(is_far, -1.0, d2)
    raise ValueError(f"unknown bank_order {order!r}")


def grid_cell(uv: torch.Tensor, res, sz: int) -> torch.Tensor:
    """Local (u, v) -> flattened sz x sz cell index (ind = sz*x + y, x from
    u, y from v), clamped at the +res/2 border."""
    inv = 1.0 / res
    cx = torch.clamp((sz * (uv[..., 0] * inv + 0.5)).to(torch.int32), 0, sz - 1)
    cy = torch.clamp((sz * (uv[..., 1] * inv + 0.5)).to(torch.int32), 0, sz - 1)
    return sz * cx + cy


def sphere_moments(grid: VoxelGrid, points: torch.Tensor, valid: torch.Tensor,
                   cfg: PatchConfig):
    """Per-leaf 4x4 homogeneous second moments over each leaf's search-
    sphere support. Returns (M [B, 4, 4] float64, counts [B] int32).

    Accumulated in float64 always: the scatter matrix mixes |p|^2-scale
    entries with the plane signal at patch-variance scale, so the small
    eigenpair amplifies summation rounding ~1e3x, and CUDA atomics change
    the order of the sums from run to run. Only the octant-resolution
    single-scatter approximation (cfg.approx_sphere_moments) is kept."""
    B = grid.keys.shape[0]
    dt = points.dtype
    dev = points.device
    N = points.shape[0]
    h = torch.cat([points.double(),
                   torch.ones((N, 1), dtype=torch.float64, device=dev)], -1)
    hh = h[:, _const("sym_i", 0, dev)] * h[:, _const("sym_j", 0, dev)]  # [N,10]
    if not cfg.approx_sphere_moments:
        raise ValueError("the reference keeps the octant sphere moments")
    # one scatter of per-(voxel, octant) moments; the radius filter
    # becomes a static [27 offsets x 8 octants] inclusion table
    keys3 = voxel.point_keys(points, grid.origin, grid.res)
    idx, exists = voxel.lookup(grid, voxel.linearize(keys3, grid.dims))
    frac = (points - grid.origin) * (1.0 / grid.res) - keys3.to(dt)
    oct_id = ((frac[:, 0] >= 0.5).to(torch.int32) * 4
              + (frac[:, 1] >= 0.5).to(torch.int32) * 2
              + (frac[:, 2] >= 0.5).to(torch.int32))
    seg = torch.where(exists & valid, idx * 8 + oct_id, B * 8)
    Mv8 = _segment_sum(hh, seg, B * 8 + 1)[:B * 8].reshape(B, 8, 10)

    # octant o of the neighbour at offset d is in the sphere iff
    # |d + c_o| <= sqrt(3)/2 (_APPROX_SEL)
    leaf3 = voxel.delinearize(torch.clamp(grid.keys, max=2 ** 30),
                              grid.dims)
    offs = _const("offsets", 0, dev).to(torch.int32)
    M = torch.zeros((B, 10), dtype=torch.float64, device=dev)
    for k, _ in _APPROX_SEL:
        nb3 = leaf3 + offs[k]
        nb_idx, nb_ok = voxel.lookup(grid,
                                     voxel.linearize(nb3, grid.dims))
        part = torch.sum(Mv8[:, _const("approx_sel", k, dev)], dim=1)
        M = M + torch.where(nb_ok[:, None], part[nb_idx.long()], 0.0)
    M = _sym10_to_44(M)
    sphere_counts = M[:, 3, 3].to(torch.int32)
    return M, sphere_counts


def claim_points(points: torch.Tensor, valid: torch.Tensor, cfg: PatchConfig):
    """Passes 1+2: plane fits and first-claim.

    Returns (grid, R [B,3,3], centers_all [B,3], claim [N], loc_claim [N,3],
    claimed [N])."""
    B = cfg.max_patches
    dt = points.dtype
    dev = points.device
    N = points.shape[0]

    grid = voxel.build_grid(points, valid, cfg.res, B, cfg.max_cells)
    res = grid.res
    M, sphere_counts = sphere_moments(grid, points, valid, cfg)
    R = rotation.rotation_from_moment_batch(
        M, sphere_counts, cfg.min_points_for_rotation).to(dt)

    # ---- pass 2: claiming. Per-leaf candidate tables keyed by the point's
    # home octant (8 reachable candidates of 27), then one row gather per
    # point; local coords in each candidate frame are clipped to the voxel
    # footprint and the first (lowest-slot) passing candidate claims.
    half = res / 2.0
    offs = torch.tensor(voxel.OFFSETS, dtype=torch.int32, device=dev)
    leaf3 = voxel.delinearize(torch.clamp(grid.keys, max=2 ** 30), grid.dims)
    nb3 = leaf3[:, None, :] + offs[None]                          # [B,27,3]
    nb_idx, nb_ok = voxel.lookup(grid, voxel.linearize(nb3, grid.dims))
    Rrows = torch.where(nb_ok[..., None],
                        R[nb_idx.long()].reshape(B, 27, 9), 0.0)
    cand_idx = torch.where(nb_ok, nb_idx, B).to(torch.int32)      # [B,27]
    sel = torch.as_tensor(voxel.OCT_CAND_27, device=dev).long()   # [8,8]
    R8 = Rrows[:, sel].reshape(B * 8, 8 * 9)
    cidx8 = cand_idx[:, sel].reshape(B * 8, 8)

    keys3 = voxel.point_keys(points, grid.origin, res)
    h, h_ok = voxel.lookup(grid, voxel.linearize(keys3, grid.dims))
    # a valid point's home voxel always exists unless it fell off the
    # max_patches budget — those points go unclaimed
    home_center = grid.origin + (keys3.to(dt) + 0.5) * res
    relh = points - home_center                                   # [N,3]
    oct_id = voxel.octant_of(relh)
    row = (torch.where(h_ok, h, 0) * 8 + oct_id).long()
    co = torch.as_tensor(voxel.OCT_CAND_OFFS, device=dev).to(dt)[oct_id.long()] \
        * res                                                     # [N,8,3]
    rel = relh[:, None, :] - co
    d2 = torch.sum(rel * rel, dim=-1)
    Rk = R8[row].reshape(N, 8, 3, 3)
    cidx = cidx8[row]
    loc = torch.sum(Rk * rel[..., None], dim=2)                   # R^T rel
    ok = (h_ok & valid)[:, None] & (d2 <= (voxel.SQRT3_2 * res) ** 2)
    clip_ok = ((loc[..., 1] <= half) & (loc[..., 1] >= -half)
               & (loc[..., 2] <= half) & (loc[..., 2] >= -half))
    masked = torch.where(ok & clip_ok, cidx, B)
    # candidates are distinct leaves, so a claimed point has one winner
    claim = torch.amin(masked, dim=1)
    claimed = claim < B
    win = masked == claim[:, None]
    loc_claim = torch.sum(torch.where(win[..., None], loc, 0.0), dim=1)
    loc_claim = torch.where(claimed[:, None], loc_claim, 0.0)
    centers_all = voxel.voxel_centers(grid)
    return grid, R, centers_all, claim, loc_claim, claimed


def build_patches(points: torch.Tensor, colors: torch.Tensor,
                  valid: torch.Tensor, cfg: PatchConfig) -> PatchBatch:
    """points: [N, 3], colors: [N, 3] (0..255 floats), valid: [N] bool.

    Each patch's claim-sorted window (ordered by cfg.bank_order's rank
    key) lands in its bank row by row."""
    if cfg.bank_order == "shuffle":
        raise ValueError("the reference keeps the deterministic bank orders")
    grid, R, centers_all, claim, loc_claim, claimed = claim_points(
        points, valid, cfg)
    banks = _fill_banks(claim, claimed, loc_claim, colors, R, centers_all,
                        grid.res, cfg)
    return PatchBatch(grid=grid, n_leaves=grid.n_leaves,
                      claims=torch.where(claimed, claim, -1).to(torch.int32),
                      **banks)


def _fill_banks(claim, claimed, loc_claim, colors, R, centers, res,
                cfg: PatchConfig) -> dict:
    """The patch-banked leaves of PatchBatch for B = R.shape[0] patches
    from the points' claims (segment ids in [0, B)), local coordinates
    and colours."""
    B, P, sz = R.shape[0], cfg.max_points_per_patch, cfg.sz
    dt = loc_claim.dtype
    dev = loc_claim.device
    N = claim.shape[0]
    rank = bank_rank(loc_claim, cfg.bank_order, claim=claim,
                     claimed=claimed, n_segments=B)
    (u_s, v_s, d_s, rgb_s), starts, segs = sort_by_claim(
        claim, claimed, (loc_claim[:, 1], loc_claim[:, 2], loc_claim[:, 0],
                         colors), B, rank=rank)
    counts_i = starts[1:] - starts[:-1]
    mb = torch.arange(P, dtype=torch.int32, device=dev)[None, :] \
        < torch.clamp(counts_i, max=P)[:, None]
    safe = torch.clamp(counts_i.to(dt), min=1.0)

    # per-leaf depth/color means from prefix-sum differences over the
    # sorted columns, in float64 so the scan order (which differs between
    # devices) cannot move them. The scan runs along the contiguous inner
    # dimension of a [4, N] array: CUDA scans a [N, 4] array's outer
    # dimension with 4-way parallelism (~48 ms at N = 300k on an H100).
    Z = torch.cumsum(torch.cat([d_s[None], rgb_s.T]).double(), dim=1)
    Z = torch.cat([torch.zeros((4, 1), dtype=Z.dtype, device=dev), Z], 1)
    seg_sums = (Z[:, starts[1:].long()]
                - Z[:, starts[:-1].long()]).T.to(dt)                    # [B,4]
    mn = seg_sums[:, 0] / safe                                          # [B]
    c_mn = seg_sums[:, 1:] / safe[:, None]                              # [B,3]

    means = centers + mn[:, None] * R[:, :, 0]       # center += mn * normal

    # W occupancy mask; unclaimed points go to a dump cell
    cell = grid_cell(loc_claim[:, 1:], res, sz)
    wseg = torch.where(claimed, claim * sz * sz + cell, B * sz * sz)
    W = torch.zeros(B * sz * sz + 1, dtype=torch.bool, device=dev)
    W[wseg.long()] = True
    W = W[:B * sz * sz].reshape(B, sz * sz)
    leaves = dict(rotations=R, means=means, rgb_means=c_mn, W=W,
                  counts=counts_i)

    # banks: ONE [N, 6] scatter from the sorted payload (row i of segment
    # b lands at slot (b, i - starts[b])); rows past P and unclaimed rows
    # go to the dump row B*P
    rk_row = torch.arange(N, dtype=torch.int32, device=dev) \
        - starts[torch.clamp(segs, 0, B).long()]
    okb = (segs < B) & (rk_row < P)
    tgt = torch.where(okb, segs * P + rk_row, B * P)
    payload = torch.cat([u_s[:, None], v_s[:, None], d_s[:, None], rgb_s], -1)
    flat = torch.zeros((B * P + 1, 6), dtype=dt, device=dev)
    flat[tgt.long()] = torch.where(okb[:, None], payload, 0.0)
    flat = flat[:B * P]
    Xb = flat[:, :2].reshape(B, P, 2).contiguous()   # the kernel's layout
    yb = torch.where(mb[..., None],
                     (flat[:, 2].reshape(B, P) - mn[:, None])[..., None], 0.0)
    cb = torch.where(mb[..., None],
                     flat[:, 3:].reshape(B, P, 3) - c_mn[:, None, :], 0.0)
    return dict(leaves, X=Xb, y=yb, rgb=cb, mask=mb)


def prediction_grid(cfg: PatchConfig, dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    """The sz*sz local query grid of load_compressed: row m has
    x = m % sz, y = m // sz and (u, v) = res*((x, y) + 0.5)/sz - res/2.
    The division by sz is a multiplication by its reciprocal, as XLA folds
    it."""
    sz = cfg.sz
    m = torch.arange(sz * sz, device=device)
    inv = 1.0 / torch.full((), float(sz), dtype=dtype, device=device)
    x = (m % sz).to(dtype)
    y = torch.div(m, sz, rounding_mode='floor').to(dtype)
    res = torch.full((), cfg.res, dtype=dtype, device=device)
    u = res * ((x + 0.5) * inv - 0.5)
    v = res * ((y + 0.5) * inv - 0.5)
    return torch.stack([u, v], dim=-1)


def reproject(batch, depth: torch.Tensor,
              grid_uv: torch.Tensor) -> torch.Tensor:
    """Rotate per-patch grid predictions back to world coordinates:
    p = R [f, u, v]^T + mean. batch: a PatchBatch; depth: [B, G];
    grid_uv: [G, 2] -> [B, G, 3]."""
    B, G = depth.shape
    local = torch.cat([depth[..., None], grid_uv.expand(B, G, 2)], dim=-1)
    return torch.matmul(local, batch.rotations.transpose(1, 2)) \
        + batch.means[:, None, :]
