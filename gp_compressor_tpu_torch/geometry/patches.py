"""Patch construction: project a cloud into per-voxel 2.5-D GP patches.

The port of the main-path part of `gp_compressor_tpu.geometry.patches`:

  1. moments  — per-leaf 4x4 homogeneous second moments over each leaf's
     search sphere (float64 accumulation) -> batched Jacobi -> rotations.
  2. claiming — a point is claimed by the lowest-ordered candidate leaf
     whose sphere contains it and whose local clip test passes.
  3. scatter  — sort the per-point payload by (claim, bank rank) and
     scatter it into capacity-padded [max_patches, max_points] banks.

With `mesh=` (a (data, chain) `DeviceMesh`, see `parallel.mesh`) the
points are this rank's block of the cloud: the grid and the plane fits are
the whole cloud's on every rank (their bounds, leaf keys and moments are
collectives over the data group), the claims are per point and stay
local, and each claimed point is routed to the rank that owns its patch
row, which sorts, counts and banks the points of its rows alone.

Scatter indices are never left out of range: what JAX drops with
`mode='drop'` goes to an extra dump row here, which is sliced off. The
`shuffle` bank order takes its random source explicitly: a
`torch.Generator`, or the [B, P] 32-bit values themselves (the tests feed
the bits JAX drew). The K-SVD codec's raster patches share the plane fits
and claims (build_raster_patches).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gp_compressor_tpu_torch.config import PatchConfig
from gp_compressor_tpu_torch.geometry import rotation, voxel
from gp_compressor_tpu_torch.geometry.voxel import VoxelGrid
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib
from gp_compressor_tpu_torch.utils.profiling import span


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

    @property
    def n_dropped(self):
        """Points lost to the static max_points_per_patch bound."""
        cap = self.mask.shape[1]
        return torch.sum(torch.clamp(self.counts - cap, min=0))


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


def draw_shuffle_bits(B: int, P: int, device="cuda",
                      generator: torch.Generator = None) -> torch.Tensor:
    """[B, P] uniform 32-bit values as int64 in [0, 2^32), the random
    source of the `shuffle` bank order (int64 because sorting uint32 is
    not dependable in torch)."""
    return torch.randint(0, 1 << 32, (B, P), generator=generator,
                         device=device, dtype=torch.int64)


def _bank_perm(bits: torch.Tensor) -> torch.Tensor:
    """Per-patch uniform permutation of [0, P): a stable argsort of each
    row of random bits (Fisher-Yates equivalent)."""
    return torch.argsort(bits, dim=1, stable=True).to(torch.int32)


def _bank_ranks(B: int, P: int, device, shuffle_bits=None) -> torch.Tensor:
    """[B, P] int32 rank inside its segment that slot (b, p) reads: p, or
    the per-patch permutation of shuffle_bits."""
    if shuffle_bits is not None:
        return _bank_perm(shuffle_bits)
    return torch.arange(P, dtype=torch.int32, device=device).expand(B, P)


def bank_windows(starts: torch.Tensor, B: int, P: int, shuffle_bits=None):
    """[B, P] positions into claim-sorted arrays + validity + counts.

    Slot (b, p) reads sorted row starts[b] + rk(b, p) with rk = p, or a
    per-patch uniform permutation of [0, P) when shuffle_bits [B, P] is
    given — the same kept/dropped set either way (rank < P)."""
    counts = starts[1:] - starts[:-1]                      # [B]
    rk = _bank_ranks(B, P, starts.device, shuffle_bits)
    valid = rk < torch.clamp(counts, max=P)[:, None]
    N = torch.clamp(starts[-1], min=1)
    pos = torch.minimum(starts[:B, None] + rk, N - 1)
    return pos, valid, counts


def gather_bank_indices(claim: torch.Tensor, claimed: torch.Tensor,
                        n_segments: int, P: int, shuffle_bits=None,
                        counts=None):
    """Bank building in gather form: (src [B, P] int32 indices into the
    point axis, valid [B, P]). Slot (b, p) draws the point of stable
    claim-order rank rk(b, p) inside segment b, rk as in bank_windows."""
    N = claim.shape[0]
    B = n_segments
    dev = claim.device
    segs_u = torch.where(claimed, claim, B)
    order = torch.argsort(segs_u, stable=True).to(torch.int32)
    segs = segs_u[order.long()].to(torch.int32)
    offset = torch.searchsorted(
        segs, torch.arange(B, dtype=torch.int32, device=dev)).to(torch.int32)
    if counts is None:
        counts = _segment_sum(claimed.to(torch.int32),
                              torch.where(claimed, claim, B), B + 1)[:B]
    rk = _bank_ranks(B, P, dev, shuffle_bits)
    valid = rk < torch.clamp(counts.to(torch.int32), max=P)[:, None]
    src = order[torch.clamp(offset[:, None] + rk, 0, N - 1).long()]
    return src, valid


def grid_cell(uv: torch.Tensor, res, sz: int) -> torch.Tensor:
    """Local (u, v) -> flattened sz x sz cell index (ind = sz*x + y, x from
    u, y from v), clamped at the +res/2 border."""
    inv = 1.0 / res
    cx = torch.clamp((sz * (uv[..., 0] * inv + 0.5)).to(torch.int32), 0, sz - 1)
    cy = torch.clamp((sz * (uv[..., 1] * inv + 0.5)).to(torch.int32), 0, sz - 1)
    return sz * cx + cy


def sphere_moments(grid: VoxelGrid, points: torch.Tensor, valid: torch.Tensor,
                   cfg: PatchConfig, mesh=None):
    """Per-leaf 4x4 homogeneous second moments over each leaf's search-
    sphere support. Returns (M [B, 4, 4] float64, counts [B] int32).

    Accumulated in float64 always: the scatter matrix mixes |p|^2-scale
    entries with the plane signal at patch-variance scale, so the small
    eigenpair amplifies summation rounding ~1e3x, and CUDA atomics change
    the order of the sums from run to run. cfg.approx_sphere_moments
    switches to the octant-resolution single-scatter approximation.

    mesh: points is this rank's block; the per-(leaf, octant) sums (per
    leaf on the exact path) are all-reduced over the data group, so every
    rank holds the whole cloud's moments, summed in another order than
    one process sums them."""
    B = grid.keys.shape[0]
    dt = points.dtype
    dev = points.device
    N = points.shape[0]
    h = torch.cat([points.double(),
                   torch.ones((N, 1), dtype=torch.float64, device=dev)], -1)
    hh = h[:, _const("sym_i", 0, dev)] * h[:, _const("sym_j", 0, dev)]  # [N,10]
    if cfg.approx_sphere_moments:
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
        if mesh is not None:
            Mv8 = mesh_lib.all_reduce_sum(Mv8, mesh)

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
    else:
        M = torch.zeros((B, 10), dtype=torch.float64, device=dev)
        sphere_counts = torch.zeros((B,), dtype=torch.int32, device=dev)
        for off in voxel.OFFSETS:
            idx, ok, _ = voxel.candidate_at_offset(grid, points, valid, off)
            seg = torch.where(ok, idx, B)
            M = M + _segment_sum(hh, seg, B + 1)[:B]
            sphere_counts = sphere_counts + _segment_sum(
                ok.to(torch.int32), seg, B + 1)[:B]
        if mesh is not None:
            M = mesh_lib.all_reduce_sum(M, mesh)
            sphere_counts = mesh_lib.all_reduce_sum(sphere_counts, mesh)
        M = _sym10_to_44(M)
    return M, sphere_counts


def claim_points(points: torch.Tensor, valid: torch.Tensor, cfg: PatchConfig,
                 mesh=None):
    """Passes 1+2: plane fits and first-claim.

    Returns (grid, R [B,3,3], centers_all [B,3], claim [N], loc_claim [N,3],
    claimed [N]). mesh: points is this rank's block; the grid, R and the
    centers are the whole cloud's (build_grid, sphere_moments), and the
    claims, each a function of its point and of those, are this block's."""
    B = cfg.max_patches
    with span("front_end.grid"):
        grid = voxel.build_grid(points, valid, cfg.res, B, cfg.max_cells,
                                mesh=mesh)
    with span("front_end.moments"):
        M, sphere_counts = sphere_moments(grid, points, valid, cfg,
                                          mesh=mesh)
    with span("front_end.frames"):
        R = rotation.rotation_from_moment_batch(
            M, sphere_counts, cfg.min_points_for_rotation).to(points.dtype)
    with span("front_end.claims"):
        claim, loc_claim, claimed = _claim(grid, R, points, valid, B)
    return grid, R, voxel.voxel_centers(grid), claim, loc_claim, claimed


def _claim(grid: VoxelGrid, R: torch.Tensor, points: torch.Tensor,
           valid: torch.Tensor, B: int):
    """claim_points' pass 2: (claim [N], loc_claim [N, 3], claimed [N])."""
    dt = points.dtype
    dev = points.device
    N = points.shape[0]
    res = grid.res

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
    return claim, loc_claim, claimed


def build_patches(points: torch.Tensor, colors: torch.Tensor,
                  valid: torch.Tensor, cfg: PatchConfig,
                  generator: torch.Generator = None,
                  shuffle_bits: torch.Tensor = None,
                  mesh=None) -> PatchBatch:
    """points: [N, 3], colors: [N, 3] (0..255 floats), valid: [N] bool.

    Deterministic bank orders fill the banks in the scatter form: each
    patch's claim-sorted window (ordered by cfg.bank_order's rank key)
    lands in its bank row by row. With cfg.bank_order == "shuffle" and a
    random source (`generator`, or `shuffle_bits` [B, P] int64 in
    [0, 2^32)), each patch's points land in a uniformly random order
    through the gather form; without one the banks keep the native order,
    as the JAX package's build_patches does without a key.

    mesh: points, colors and valid are this rank's block of the cloud
    (parallel.mesh point_rows, padded rows invalid). The result holds the
    rank's rows (patch_rows) of the patch-banked leaves, its block's
    claims, and the whole grid and n_leaves; the random source is whole
    ([B, P], the same on every rank) and each rank uses its rows."""
    B, P = cfg.max_patches, cfg.max_points_per_patch
    grid, R, centers_all, claim, loc_claim, claimed = claim_points(
        points, valid, cfg, mesh=mesh)
    with span("front_end.banks"):
        if cfg.bank_order != "shuffle":
            shuffle_bits = None
        elif shuffle_bits is None and generator is not None:
            shuffle_bits = draw_shuffle_bits(B, P, points.device, generator)
        if mesh is None:
            banks = _fill_banks(claim, claimed, loc_claim, colors, R,
                                centers_all, grid.res, cfg, shuffle_bits)
        else:
            banks = _owner_banks(claim, claimed, loc_claim, colors, R,
                                 centers_all, grid.res, cfg, shuffle_bits,
                                 mesh)
    return PatchBatch(grid=grid, n_leaves=grid.n_leaves,
                      claims=torch.where(claimed, claim, -1).to(torch.int32),
                      **banks)


def _owner_banks(claim, claimed, loc_claim, colors, R, centers, res,
                 cfg: PatchConfig, shuffle_bits, mesh) -> dict:
    """The banks of this rank's patch rows from every rank's claimed
    points: each is sent to the owner of its patch row, which receives
    them in the cloud's point order (the blocks are contiguous and in
    order), so its stable claim sort, rank keys, counts, W and banks are
    the single process's for those rows. Only the means differ in
    rounding: their float64 sums run over the owner's points alone."""
    rows = mesh_lib.patch_rows(R.shape[0], mesh)
    sel = torch.nonzero(claimed).squeeze(1)
    c = claim[sel]
    dest = torch.div(c, rows.stop - rows.start, rounding_mode="floor")
    loc, col, c = mesh_lib.all_to_all_rows(
        (loc_claim[sel], colors[sel], c), dest, mesh)
    # plus one unclaimed row (sorted last, in no window), so the gather
    # form has a row to read on a rank that received no point
    pad = lambda t: torch.cat([t, t.new_zeros((1,) + t.shape[1:])])
    real = torch.ones(c.shape[0] + 1, dtype=torch.bool, device=c.device)
    real[-1] = False
    bits = None if shuffle_bits is None else shuffle_bits[rows]
    return _fill_banks(pad(c - rows.start), real, pad(loc), pad(col),
                       R[rows].clone(), centers[rows].clone(), res, cfg,
                       bits)


def _fill_banks(claim, claimed, loc_claim, colors, R, centers, res,
                cfg: PatchConfig, shuffle_bits) -> dict:
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

    if shuffle_bits is not None:
        # gather form: slot (b, p) reads the window row of rank rk(b, p)
        pos, mb, _ = bank_windows(starts, B, P, shuffle_bits=shuffle_bits)
        pos = pos.long()
        Xb = torch.where(mb[..., None],
                         torch.stack([u_s[pos], v_s[pos]], dim=-1), 0.0)
        yb = torch.where(mb, d_s[pos] - mn[:, None], 0.0)[..., None]
        cb = torch.where(mb[..., None], rgb_s[pos] - c_mn[:, None, :], 0.0)
        return dict(leaves, X=Xb, y=yb, rgb=cb, mask=mb)

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


class RasterBatch(NamedTuple):
    """Rasterized patch images for the K-SVD codec. Claimed points go to
    their grid cell with a per-cell mean, and each patch is demeaned by
    its mean over ALL sz*sz cells, the empty ones included: a reference
    quirk kept exactly (src/pointcloud_compressor.cpp:92-116)."""

    grid: VoxelGrid
    rotations: torch.Tensor    # [B, 3, 3]
    means: torch.Tensor        # [B, 3] centers (cell-mean adjusted)
    rgb_means: torch.Tensor    # [B, 3] per-channel means over all cells
    S: torch.Tensor            # [B, G] demeaned cell depth image
    RGB: torch.Tensor          # [B, G, 3] demeaned cell colour image
    W: torch.Tensor            # [B, G] bool occupancy
    n_leaves: torch.Tensor     # 0-dim int32
    # per point, for the in-sample RMS (compute_rms_error,
    # src/pointcloud_compressor.cpp:182-205)
    claims: torch.Tensor       # [N] int32 gp_index or -1
    cells: torch.Tensor        # [N] int32 flattened cell of each point
    depth_demeaned: torch.Tensor  # [N] local depth minus the patch mean


def build_raster_patches(points: torch.Tensor, colors: torch.Tensor,
                         valid: torch.Tensor, cfg: PatchConfig) -> RasterBatch:
    """pointcloud_compressor::project_points: plane fits and claims as in
    build_patches, then per-cell sums over B*G cells plus one overflow
    row that takes the unclaimed points."""
    B, sz = cfg.max_patches, cfg.sz
    G = sz * sz
    grid, R, centers_all, claim, loc_claim, claimed = claim_points(
        points, valid, cfg)
    ones = claimed.to(points.dtype)
    cell = grid_cell(loc_claim[:, 1:], grid.res, sz)
    flat = torch.where(claimed, claim * G + cell, B * G)
    payload = torch.cat([ones[:, None], (loc_claim[:, 0] * ones)[:, None],
                         colors * ones[:, None]], 1)               # [N, 5]
    sums = _segment_sum(payload, flat, B * G + 1)[:B * G]
    cnt = sums[:, 0]
    safe = torch.clamp(cnt, min=1.0)
    S = (sums[:, 1] / safe).reshape(B, G)
    RGB = (sums[:, 2:] / safe[:, None]).reshape(B, G, 3)
    W = (cnt > 0).reshape(B, G)
    mn = torch.mean(S, dim=1)                                       # [B]
    cmn = torch.mean(RGB, dim=1)                                    # [B, 3]
    depth_dm = loc_claim[:, 0] - mn[torch.where(claimed, claim, 0).long()]
    return RasterBatch(
        grid=grid, rotations=R, means=centers_all + mn[:, None] * R[:, :, 0],
        rgb_means=cmn, S=S - mn[:, None], RGB=RGB - cmn[:, None, :], W=W,
        n_leaves=grid.n_leaves,
        claims=torch.where(claimed, claim, -1).to(torch.int32),
        cells=cell.to(torch.int32), depth_demeaned=depth_dm)


def raster_reproject(batch: RasterBatch, S_rec: torch.Tensor,
                     RGB_rec: torch.Tensor, sz: int, res: float):
    """pointcloud_decompressor::reproject_cloud: one world point per
    OCCUPIED cell, at the cell centre, with the reconstructed depth and
    colours (non-finite colours become 255, then all are clamped to
    [0, 255]). S_rec: [B, G]; RGB_rec: [B, G, 3] demeaned. Returns
    (points [B*G, 3], colors [B*G, 3], valid [B*G])."""
    B, G = S_rec.shape
    dt, dev = S_rec.dtype, S_rec.device
    m = torch.arange(G, device=dev)
    x = torch.div(m, sz, rounding_mode='floor').to(dt)     # cell = sz*x + y
    y = (m % sz).to(dt)
    u = res * (x + 0.5) / sz - res / 2.0
    v = res * (y + 0.5) / sz - res / 2.0
    world = reproject(batch, S_rec, torch.stack([u, v], dim=-1))
    colors = RGB_rec + batch.rgb_means[:, None, :]
    colors = torch.clamp(torch.where(torch.isfinite(colors), colors, 255.0),
                         0.0, 255.0)
    okp = batch.W & (torch.arange(B, device=dev)[:, None] < batch.n_leaves)
    return (world.reshape(B * G, 3), colors.reshape(B * G, 3),
            okp.reshape(B * G))


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
    p = R [f, u, v]^T + mean. batch: a PatchBatch or a RasterBatch (the
    JAX package's reproject_raster is this function); depth: [B, G];
    grid_uv: [G, 2] -> [B, G, 3]."""
    B, G = depth.shape
    local = torch.cat([depth[..., None], grid_uv.expand(B, G, 2)], dim=-1)
    return torch.matmul(local, batch.rotations.transpose(1, 2)) \
        + batch.means[:, None, :]
