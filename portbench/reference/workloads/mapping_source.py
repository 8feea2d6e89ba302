"""The source's map insert in plain torch: one registered scan folded into
a GP map.

Written from nilsbore/gp_compressor `src/gp_mapping.cpp:39-151` and
`:213-291` (as SURVEY.md §2 and §3.4 describe them): the scan's voxels
that are new become leaves, numbered in key order after the existing
ones; a point near a patch that exists is projected into that patch's
frame and marks its cell of the occupancy mask W (`transform_to_old`);
a leaf that is not yet a patch gathers its points, and once it has
`min_nbr` of them (`:7`, `:126`) it gets a plane fit, a frame, its depth
and colour means, and its points become its first data
(`transform_to_new`); then every patch's GPs take the points it received
(`train_processes`, `:293-343`). It imports nothing of the program under
test; the GPs' training loop and health check are the benchmark's
reference SOGP (`portbench/reference/models/sparse_gp.py`).

Departures from the source, each one the configuration states:

  * the plane fit of a new patch is the smallest eigenvector of the 4x4
    homogeneous second moments of this scan's points in the patch's
    search sphere, taken at octant resolution: an octant of a neighbour
    voxel counts whole when its centre lies within sqrt(3)/2 res of the
    leaf's centre (the source fits the points of a radius search);
  * a point is claimed by one patch, the first: among the patches that
    exist or are made by this scan, in the 27 voxels around its own, those
    whose search sphere holds it and whose frame clip |u|, |v| <= res/2
    passes, the one of least linear voxel key;
  * the map has B rows: new leaves past them are not made, and the map
    counts them as `lost` (the source's octree grows without bound); the
    comparison counts each as a patch that differs;
  * a leaf that is not yet a patch keeps at most `pending` unclaimed points
    of its own voxel, in scan order, across scans; those of them inside
    the new frame's clip join the first data and the means;
  * a patch trains on at most `bank + spill` of a scan's points, nearest
    its centre first (by u^2 + v^2; ties in scan order), in two banks, then
    on the pending points of a patch made now; a GP whose state or
    predictions turn non-finite or wild is reset (the health check);
  * free-space carving (`train_classification`, `:154-211`, which the
    source leaves unfinished) is not part of this reference, and the
    comparison does not look at its mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.config import GPConfig, PatchConfig
from portbench.reference.cuda_kernels.sogp_train import add_points_batch_plain
from portbench.reference.geometry.patches import prediction_grid
from portbench.reference.models import sparse_gp
from portbench.reference.models.sparse_gp import SOGPState
from portbench.reference.ops.kernels import RBFParams

SQRT3_2 = 0.8660254037844386
OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]
# octant o of a voxel has centre (+-0.25, +-0.25, +-0.25) res from the
# voxel's centre, bit 4 / 2 / 1 of o for x / y / z above it
_OCT = np.array([[0.25 if o & 4 else -0.25, 0.25 if o & 2 else -0.25,
                  0.25 if o & 1 else -0.25] for o in range(8)])
_IN_SPHERE = [[o for o in range(8)
               if np.linalg.norm(np.asarray(d, float) + _OCT[o]) <= SQRT3_2]
              for d in OFFSETS]


class Map(NamedTuple):
    """A map: the box (origin [3], dims [3]), the voxel -> patch table
    [n_cells] (-1 where none), the leaves' count, per patch whether it
    exists [B], its frame [B, 3, 3] (column 0 the normal), mean [B, 3],
    colour mean [B, 3], occupancy mask W [B, sz*sz], pending points and
    colours [B, Pp, 3] and their count [B], its depth and colour GPs, and
    the new leaves of the last insert that found no free row (`lost`)."""

    origin: torch.Tensor
    dims: torch.Tensor
    key_to_leaf: torch.Tensor
    n_patches: int
    created: torch.Tensor
    rotations: torch.Tensor
    means: torch.Tensor
    rgb_means: torch.Tensor
    W: torch.Tensor
    pend_pts: torch.Tensor
    pend_cols: torch.Tensor
    pend_count: torch.Tensor
    depth_gp: SOGPState
    rgb_gp: SOGPState
    lost: int = 0


class Settings(NamedTuple):
    """The insert's constants: voxel edge, patch grid, the points a leaf
    needs to become a patch, the plane fit's least support, the two bank
    widths, and the GPs' configurations."""

    res: float
    sz: int
    min_nbr: int
    min_points_for_rotation: int
    bank: int
    spill: int
    depth_gp: GPConfig
    rgb_gp: GPConfig


def frame_from_normal(n):
    """The source's frame (src/gp_compressor.cpp:38-63): the normal turned
    positive along its largest axis, u = unit(axis x n) with axis z, x, y
    for a normal mostly along x, y, z, and v = n x u."""
    a = n.abs()
    dom = torch.where((a[:, 0] > a[:, 1]) & (a[:, 0] > a[:, 2]), 0,
                      torch.where((a[:, 1] > a[:, 0]) & (a[:, 1] > a[:, 2]),
                                  1, 2))
    n = n * torch.where(n.gather(1, dom[:, None]) < 0, -1.0, 1.0)
    axis = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                        dtype=n.dtype, device=n.device)[dom]
    u = torch.linalg.cross(axis, n, dim=1)
    u = u / torch.linalg.norm(u, dim=1, keepdim=True)
    return torch.stack([n, u, torch.linalg.cross(n, u, dim=1)], dim=2)


def _k3(lin, dims):
    return torch.stack([lin // (dims[1] * dims[2]), (lin // dims[2]) % dims[1],
                        lin % dims[2]], 1)


def _lin(k3, dims):
    inside = torch.all((k3 >= 0) & (k3 < dims), dim=1)
    return (k3[:, 0] * dims[1] + k3[:, 1]) * dims[2] + k3[:, 2], inside


def plane_frames(points, valid, origin, dims, res, key_to_leaf, B,
                 min_points):
    """Per leaf, the frame of the plane through this scan's points in its
    sphere (identity below `min_points`) and their count: ([B, 3, 3]
    float64, [B])."""
    dev = points.device
    keys = torch.floor((points - origin) * (1.0 / res)).long()
    lin, inside = _lin(keys, dims)
    home = torch.where(inside & valid,
                       key_to_leaf[torch.where(inside, lin, 0)].long(), -1)
    frac = (points - origin) * (1.0 / res) - keys.to(points.dtype)
    octant = ((frac[:, 0] >= 0.5).long() * 4 + (frac[:, 1] >= 0.5).long() * 2
              + (frac[:, 2] >= 0.5).long())
    h = torch.cat([points.double(), torch.ones_like(points[:, :1]).double()],
                  1)
    outer = (h[:, :, None] * h[:, None, :]).reshape(-1, 16)
    S = torch.zeros((B * 8 + 1, 16), dtype=torch.float64, device=dev)
    S.index_add_(0, torch.where(home >= 0, home * 8 + octant, B * 8), outer)
    S = S[:B * 8].reshape(B, 8, 16)
    cell = torch.nonzero(key_to_leaf >= 0).flatten()
    leaf_k3 = torch.zeros((B, 3), dtype=torch.long, device=dev)
    leaf_k3[key_to_leaf[cell].long()] = _k3(cell, dims)
    M = torch.zeros((B, 16), dtype=torch.float64, device=dev)
    for d, octs in zip(OFFSETS, _IN_SPHERE):
        nb, ok = _lin(leaf_k3 + torch.tensor(d, device=dev), dims)
        g = torch.where(ok, key_to_leaf[torch.where(ok, nb, 0)].long(), -1)
        part = S[torch.clamp(g, min=0)][:, octs].sum(1)
        M = M + torch.where((g >= 0)[:, None], part, 0.0)
    M = M.reshape(B, 4, 4)
    count = M[:, 3, 3].round().long()
    _, V = torch.linalg.eigh(M)
    n = V[:, :3, 0]
    norm = torch.linalg.norm(n, dim=1, keepdim=True)
    R = frame_from_normal(n / torch.where(norm > 0, norm, 1.0))
    bad = (count < min_points) | (norm[:, 0] <= 0)
    eye = torch.eye(3, dtype=R.dtype, device=dev).expand(B, 3, 3)
    return torch.where(bad[:, None, None], eye, R), count


def claim(points, valid, origin, dims, res, key_to_leaf, candidate,
          rotations):
    """First claim of each point among the candidate patches: (patch [N]
    long, -1 where none; (u, v) [N, 2] in its frame about its voxel's
    centre)."""
    N, dev = points.shape[0], points.device
    keys = torch.floor((points - origin) * (1.0 / res)).long()
    home = torch.minimum(torch.clamp(keys, min=0), dims - 1)
    best_key = torch.full((N,), 2 ** 62, dtype=torch.long, device=dev)
    best = torch.full((N,), -1, dtype=torch.long, device=dev)
    uv = torch.zeros((N, 2), dtype=points.dtype, device=dev)
    for d in OFFSETS:
        nb = home + torch.tensor(d, device=dev)
        lin, inside = _lin(nb, dims)
        g = torch.where(inside, key_to_leaf[torch.where(inside, lin, 0)]
                        .long(), -1)
        gs = torch.clamp(g, min=0)
        rel = points - (origin + (nb.to(points.dtype) + 0.5) * res)
        loc = torch.einsum('nji,nj->ni', rotations[gs], rel)[:, 1:]
        better = (valid & (g >= 0) & candidate[gs]
                  & (torch.sum(rel * rel, 1) <= (SQRT3_2 * res) ** 2)
                  & (loc.abs() <= res / 2.0).all(1) & (lin < best_key))
        best_key = torch.where(better, lin, best_key)
        best = torch.where(better, g, best)
        uv = torch.where(better[:, None], loc, uv)
    return best, uv


def cell_of(uv, res, sz):
    """(u, v) -> the W cell sz * x + y, x from u, y from v."""
    c = torch.clamp((sz * (uv / res + 0.5)).long(), 0, sz - 1)
    return sz * c[..., 0] + c[..., 1]


def insert(m: Map, points, colors, valid, s: Settings, depth_kp: RBFParams,
           depth_s20, depth_eps) -> Map:
    """The map after one scan, given in the map's coordinates. The GPs
    train in their configurations' dtype."""
    dev, dt = points.device, points.dtype
    B, Pp = m.created.shape[0], m.pend_pts.shape[1]
    dims, res, sz = m.dims.long(), s.res, s.sz
    ar = torch.arange(B, device=dev)

    # ---- new leaves, in key order after the existing ones
    keys = torch.floor((points - m.origin) * (1.0 / res)).long()
    lin, inside = _lin(keys, dims)
    ok = valid & inside
    touched = torch.unique(lin[ok])
    new = touched[m.key_to_leaf[touched] < 0]
    lost = max(new.shape[0] - (B - m.n_patches), 0)
    new = new[:B - m.n_patches]
    key_to_leaf = m.key_to_leaf.clone()
    key_to_leaf[new] = (m.n_patches + torch.arange(new.shape[0], device=dev)
                        ).to(key_to_leaf.dtype)
    n_patches = m.n_patches + new.shape[0]

    # ---- leaves that become patches now: a frame from this scan's sphere
    R_new, count = plane_frames(points, valid, m.origin, dims, res,
                                key_to_leaf, B, s.min_points_for_rotation)
    R_new = R_new.to(dt)
    becomes = ~m.created & (m.pend_count + count >= s.min_nbr) \
        & (ar < n_patches)
    cell = torch.nonzero(key_to_leaf >= 0).flatten()
    centre = torch.zeros((B, 3), dtype=dt, device=dev)
    centre[key_to_leaf[cell].long()] = m.origin + (_k3(cell, dims).to(dt)
                                                   + 0.5) * res
    R = torch.where(becomes[:, None, None], R_new, m.rotations)
    origin_of = torch.where(becomes[:, None], centre, m.means)
    created = m.created | becomes

    # ---- claims; depth along the normal from the patch's mean (a new
    # patch's voxel centre until its mean is known)
    patch, uv = claim(points, valid, m.origin, dims, res, key_to_leaf,
                      created, R)
    got = patch >= 0
    g = torch.clamp(patch, min=0)
    depth = torch.sum(R[g, :, 0] * (points - origin_of[g]), 1)

    # ---- a new patch's depth and colour means: its points and its
    # pending points inside the new frame's clip
    pend_ok = (torch.arange(Pp, device=dev)[None] < m.pend_count[:, None]) \
        & becomes[:, None]
    pend_loc = torch.einsum('bji,bpj->bpi', R,
                            m.pend_pts - origin_of[:, None, :])
    pend_in = pend_ok & (pend_loc[..., 1:].abs() <= res / 2.0).all(-1)
    n_pts = torch.zeros(B, dtype=dt, device=dev).index_add_(
        0, g[got], torch.ones_like(depth[got]))
    d_sum = torch.zeros(B, dtype=dt, device=dev).index_add_(0, g[got],
                                                           depth[got])
    c_sum = torch.zeros((B, 3), dtype=dt, device=dev).index_add_(
        0, g[got], colors[got].to(dt))
    pf = pend_in.to(dt)
    tot = torch.clamp(n_pts + pf.sum(1), min=1.0)
    mn = (d_sum + (pend_loc[..., 0] * pf).sum(1)) / tot
    cmn = (c_sum + (m.pend_cols * pf[..., None]).sum(1)) / tot[:, None]
    means = torch.where(becomes[:, None], centre + mn[:, None] * R[:, :, 0],
                        m.means)
    rgb_means = torch.where(becomes[:, None], cmn, m.rgb_means)

    # ---- the occupancy mask
    W = m.W.clone()
    W[g[got], cell_of(uv[got], res, sz)] = True
    pb, pp = torch.nonzero(pend_in, as_tuple=True)
    W[pb, cell_of(pend_loc[pb, pp, 1:], res, sz)] = True

    # ---- the banks, nearest the centre first, and the training
    mn_of = torch.where(becomes, mn, 0.0)
    rank_key = torch.sum(uv * uv, 1)
    order = torch.argsort(rank_key, stable=True)
    order = order[torch.argsort(torch.where(got, patch, B)[order],
                                stable=True)]
    sp = torch.where(got, patch, B)[order]
    first = torch.ones_like(got)
    first[1:] = sp[1:] != sp[:-1]
    idx = torch.arange(sp.shape[0], device=dev)
    rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values

    def bank(lo, width):
        sel = (sp < B) & (rank >= lo) & (rank < lo + width)
        i, b, r = order[sel], sp[sel], rank[sel] - lo
        X = torch.zeros((B, width, 2), dtype=dt, device=dev)
        Y = torch.zeros((B, width, 1), dtype=dt, device=dev)
        C = torch.zeros((B, width, 3), dtype=dt, device=dev)
        M = torch.zeros((B, width), dtype=torch.bool, device=dev)
        X[b, r] = uv[i]
        Y[b, r, 0] = depth[i] - mn_of[b]
        C[b, r] = colors[i].to(dt) - rgb_means[b]
        M[b, r] = True
        return X, Y, C, M

    ckp = RBFParams(*(torch.tensor(v, dtype=s.rgb_gp.dtype, device=dev)
                      for v in (s.rgb_gp.sigmaf_sq, s.rgb_gp.l_sq)))
    gps = (m.depth_gp, m.rgb_gp)

    def train(gps, X, Y, C, M):
        return (add_points_batch_plain(depth_kp, s.depth_gp, gps[0], X, Y, M,
                                       s20=depth_s20, eps_tol=depth_eps),
                add_points_batch_plain(ckp, s.rgb_gp, gps[1], X, C, M))

    for lo, width in ((0, s.bank), (s.bank, s.spill)):
        gps = train(gps, *bank(lo, width))
    if bool(becomes.any()):
        gps = train(gps, pend_loc[..., 1:],
                    (pend_loc[..., 0] - mn[:, None])[..., None],
                    m.pend_cols - cmn[:, None, :], pend_in)
    probes = prediction_grid_of(res, sz, dt, dev)[::5]
    depth_gp, _ = sparse_gp.sanitize_batch(gps[0], depth_kp, depth_s20,
                                           max_pred=10.0 * res,
                                           probes=probes)
    rgb_gp, _ = sparse_gp.sanitize_batch(gps[1], ckp, s.rgb_gp.s20,
                                         max_pred=2.5e3, probes=probes)

    # ---- pending points: a leaf that is not a patch keeps its unclaimed
    # points, in scan order, up to Pp; a patch made now empties its buffer
    home = torch.where(ok, key_to_leaf[torch.where(ok, lin, 0)].long(), -1)
    store = ~got & (home >= 0) & ~created[torch.clamp(home, min=0)]
    pend_count = torch.where(becomes, 0, m.pend_count).long()
    pend_pts = torch.where(becomes[:, None, None], 0.0, m.pend_pts)
    pend_cols = torch.where(becomes[:, None, None], 0.0, m.pend_cols)
    i = torch.nonzero(store).flatten()
    b = home[i]
    sb = torch.argsort(b, stable=True)
    i, b = i[sb], b[sb]
    firstb = torch.ones_like(b, dtype=torch.bool)
    firstb[1:] = b[1:] != b[:-1]
    j = torch.arange(b.shape[0], device=dev)
    slot = pend_count[b] + j - torch.cummax(torch.where(firstb, j, 0),
                                            0).values
    keep = slot < Pp
    pend_pts[b[keep], slot[keep]] = points[i[keep]].to(pend_pts.dtype)
    pend_cols[b[keep], slot[keep]] = colors[i[keep]].to(pend_cols.dtype)
    pend_count = torch.clamp(pend_count + torch.bincount(b, minlength=B),
                             max=Pp)
    return Map(origin=m.origin, dims=m.dims, key_to_leaf=key_to_leaf,
               n_patches=int(n_patches), created=created, rotations=R,
               means=means, rgb_means=rgb_means, W=W, pend_pts=pend_pts,
               pend_cols=pend_cols, pend_count=pend_count.to(m.pend_count
                                                             .dtype),
               depth_gp=depth_gp, rgb_gp=rgb_gp, lost=lost)


def prediction_grid_of(res: float, sz: int, dt, dev):
    """The sz x sz (u, v) grid a patch predicts on."""
    return prediction_grid(PatchConfig(res=res, sz=sz), dt, dev)
