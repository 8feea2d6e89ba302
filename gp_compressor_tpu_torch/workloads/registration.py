"""Scan-to-map rigid registration by gradient ascent on the GP likelihood.

The port of `gp_compressor_tpu.workloads.registration`, with the mapping
stream's persistent claim tables. The map is a compressed cloud (patch
GPs). Each step claims scan points to map patches with the same
first-claim rule as compression, banks them per patch, takes the
closed-form gradient of each point's predictive density w.r.t. its local
coordinates, rotates it to world, chains it through the twist Jacobian
J = [I | -[x]_x] and averages over the scan; the pose then moves by the
small-angle step R = Rx Ry Rz, t.

The JAX `lax.while_loop` is a Python loop here. The step counter is read
once at entry, so the re-claim cadence is decided on the host; the stop
test is the one device-to-host read of a step. Scatters route what JAX
drops with `mode='drop'` (out-of-range indices) to a dump row that is
sliced off.

With `mesh=` (a (data, chain) `DeviceMesh`, see `parallel.mesh`) the map
holds this rank's patch rows. The claims against the map are whole on
every rank (tables, centers, frames), each rank banks only the points its
rows claim, and a step's sums [twist (6), points used, likelihood, colour
likelihood] are one all-reduce over the data group before the division:
every rank then takes the same iRprop step and the same stop decision.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from gp_compressor_tpu_torch.config import (CompressorConfig,
                                            RegistrationConfig)
from gp_compressor_tpu_torch.geometry import transforms, voxel
from gp_compressor_tpu_torch.geometry.patches import sort_by_claim
from gp_compressor_tpu_torch.models import sparse_gp
from gp_compressor_tpu_torch.ops.kernels import RBFParams
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib
from gp_compressor_tpu_torch.utils.profiling import count, span
from gp_compressor_tpu_torch.workloads.compressor import (CompressedCloud,
                                                         default_params)


class RegistrationState(NamedTuple):
    R_cloud: torch.Tensor     # [3, 3] accumulated rotation
    t_cloud: torch.Tensor     # [3] plain per-step sum of translations
    t_exact: torch.Tensor     # [3] exactly composed translation
                              # (t <- R_k t + t_k): (R_cloud, t_exact)
                              # applied to the original scan reproduces
                              # the iterated per-step transforms
    delta: torch.Tensor       # [6] last gradient (t, omega)
    step_nbr: torch.Tensor    # 0-dim int32
    mean_likelihood: torch.Tensor
    mean_color_likelihood: torch.Tensor


def init_state(dtype=torch.float32, device="cuda") -> RegistrationState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return RegistrationState(
        R_cloud=torch.eye(3, dtype=dtype, device=device), t_cloud=z(3),
        t_exact=z(3), delta=z(6),
        step_nbr=torch.zeros((), dtype=torch.int32, device=device),
        mean_likelihood=z(), mean_color_likelihood=z())


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """The voxel module's constant tables on `device`, copied once (a copy
    from host memory synchronises the stream)."""
    table = {"offs27": voxel.OFFSETS, "oct_cand_27": voxel.OCT_CAND_27,
             "oct_cand_offs": voxel.OCT_CAND_OFFS}[name]
    return torch.as_tensor(table, dtype=torch.int32).to(device)


def _scalar(v, dtype):
    """A hyperparameter as a tensor of `dtype`, or a Python float (which
    torch passes to a kernel without a copy)."""
    return v.to(dtype) if isinstance(v, torch.Tensor) else float(v)


class ClaimTables(NamedTuple):
    """Leaf-level candidate tables for scan -> map claiming: one row per
    (cell of the 1-dilated leaf set) x (home octant) holds the 8 reachable
    candidate leaves' claim priority, gp index and frame u/v axes."""

    cell_row: torch.Tensor   # [nc] int32 in-grid cell -> base row (-1 none)
    prio: torch.Tensor       # [Bx*8, 8] int32 candidate's linear voxel key
                             # (voxel.FILL where missing or untrained):
                             # first claim = min priority
    gid: torch.Tensor        # [Bx*8, 8] int32 candidate gp index (0 if none)
    R12: torch.Tensor        # [Bx*8, 8, 6] candidate frame cols 1, 2
    nm: torch.Tensor         # [B, 6] per-gp-index (normal, mean)


def build_claim_tables(grid, rotations, means, trained,
                       leaf_ids=None) -> ClaimTables:
    """Requires grid.table (the dense cell -> leaf map)."""
    i32 = torch.int32
    dev = rotations.device
    B_slots = grid.keys.shape[0]
    offs = _const("offs27", dev)
    leaf3 = voxel.delinearize(torch.clamp(grid.keys, max=2 ** 30), grid.dims)
    real = torch.arange(B_slots, device=dev) < grid.n_leaves
    ext3 = (leaf3[:, None, :] + offs[None]).reshape(-1, 3)       # [Bx, 3]
    Bx = B_slots * 27
    ext_lin = voxel.linearize(ext3, grid.dims)
    ext_lin = torch.where(real.repeat_interleave(27), ext_lin, voxel.FILL)
    nc = grid.table.shape[0]
    # duplicate writers describe the same cell -> identical rows; any wins
    cell_row = torch.full((nc + 1,), -1, dtype=i32, device=dev)
    cell_row[torch.where(ext_lin < nc, ext_lin, nc).long()] = torch.arange(
        Bx, dtype=i32, device=dev)
    cell_row = cell_row[:nc]

    nb_lin = voxel.linearize(ext3[:, None, :] + offs[None], grid.dims)
    nb_idx, nb_ok = voxel.lookup(grid, nb_lin)                   # [Bx, 27]
    g = torch.where(nb_ok, nb_idx, 0).long()
    g = g if leaf_ids is None else leaf_ids[g].long()
    cok = nb_ok & trained[g]
    # priority = the candidate's own linear voxel key: min-key first claim
    # is the reference's leaf-iteration order
    prio27 = torch.where(cok, nb_lin, voxel.FILL).to(i32)
    gid27 = torch.where(cok, g, 0).to(i32)
    R12_27 = torch.where(cok[..., None],
                         rotations[g][..., 1:].transpose(-1, -2)
                         .reshape(Bx, 27, 6), 0.0)
    sel = _const("oct_cand_27", dev).long()                      # [8, 8]
    return ClaimTables(
        cell_row=cell_row,
        prio=prio27[:, sel].reshape(Bx * 8, 8),
        gid=gid27[:, sel].reshape(Bx * 8, 8),
        R12=R12_27[:, sel].reshape(Bx * 8, 8, 6),
        nm=torch.cat([rotations[:, :, 0], means], dim=1))


def _claim_table_rows(cells3, ok_cell, key_to_leaf, trained, rotations,
                      dims):
    """Row content for a batch of cells [M, 3] in the dense (gp-index row
    layout) claim tables: per (cell, octant), the 8 reachable candidates'
    claim priority (linear key, voxel.FILL where missing or untrained), gp
    index and frame u/v columns. The content rule of build_claim_tables,
    with candidates looked up through a dense cell -> gp index map
    (key_to_leaf, -1 where none), so a row does not depend on slot order.
    Returns (prio [M*8, 8], gid [M*8, 8], R12 [M*8, 8, 6])."""
    i32 = torch.int32
    M = cells3.shape[0]
    offs = _const("offs27", cells3.device)
    nc = key_to_leaf.shape[0]
    lin = voxel.linearize(cells3[:, None, :] + offs[None], dims)  # [M, 27]
    g = key_to_leaf[torch.clamp(lin, 0, nc - 1).long()]
    gs = torch.clamp(g, min=0).long()
    ok = ok_cell[:, None] & (lin != voxel.FILL) & (g >= 0) & trained[gs]
    prio27 = torch.where(ok, lin, voxel.FILL).to(i32)
    gid27 = torch.where(ok, gs, 0).to(i32)
    R12_27 = torch.where(ok[..., None],
                         rotations[gid27.long()][..., 1:].transpose(-1, -2)
                         .reshape(M, 27, 6), 0.0)
    sel = _const("oct_cand_27", cells3.device).long()            # [8, 8]
    return (prio27[:, sel].reshape(M * 8, 8),
            gid27[:, sel].reshape(M * 8, 8),
            R12_27[:, sel].reshape(M * 8, 8, 6))


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx] = src, where idx == len(dst) marks a dropped row
    (JAX's `mode='drop'`): the write lands in a dump row sliced off. src:
    a tensor, or a Python scalar (filled on dst's device)."""
    n = dst.shape[0]
    out = torch.cat([dst, dst[:1]])
    if not isinstance(src, torch.Tensor):
        src = torch.full((), src, dtype=dst.dtype, device=dst.device)
    out[idx.long()] = src
    return out[:n]


def build_claim_tables_dense(key_to_leaf, key_by_gid, n_patches, trained,
                             rotations, means, dims) -> ClaimTables:
    """Full build of the mapping stream's persistent claim tables.

    Row layout: base row gid*27 + j holds the cell leaf_cell(gid) +
    OFFSETS[j]; gp-index rows stay put across scans. Row content depends
    on the cell only, so duplicate writers (adjacent leaves sharing a
    dilated cell) write identical rows and any cell_row winner is right."""
    B = key_by_gid.shape[0]
    i32 = torch.int32
    dev = key_by_gid.device
    offs = _const("offs27", dev)
    nc = key_to_leaf.shape[0]
    exists = torch.arange(B, device=dev) < n_patches
    leaf3 = voxel.delinearize(torch.clamp(key_by_gid, max=voxel.FILL - 1),
                              dims)
    cells3 = (leaf3[:, None, :] + offs[None]).reshape(B * 27, 3)
    lin = voxel.linearize(cells3, dims)
    okc = exists.repeat_interleave(27) & (lin != voxel.FILL)
    cell_row = _scatter_rows(
        torch.full((nc,), -1, dtype=i32, device=dev),
        torch.where(okc, lin, nc), torch.arange(B * 27, dtype=i32, device=dev))
    prio, gid, R12 = _claim_table_rows(cells3, okc, key_to_leaf, trained,
                                       rotations, dims)
    nm = torch.cat([rotations[:, :, 0], means], dim=1)
    return ClaimTables(cell_row=cell_row, prio=prio, gid=gid, R12=R12, nm=nm)


def empty_claim_tables_dense(n_cells: int, B: int, dtype=torch.float32,
                             device="cuda") -> ClaimTables:
    """map_init's persistent tables: no candidates anywhere."""
    i32 = torch.int32
    return ClaimTables(
        cell_row=torch.full((n_cells,), -1, dtype=i32, device=device),
        prio=torch.full((B * 27 * 8, 8), voxel.FILL, dtype=i32,
                        device=device),
        gid=torch.zeros((B * 27 * 8, 8), dtype=i32, device=device),
        R12=torch.zeros((B * 27 * 8, 8, 6), dtype=dtype, device=device),
        nm=torch.zeros((B, 6), dtype=dtype, device=device))


def update_claim_tables(tables: ClaimTables, changed_gids, changed_ok,
                        key_to_leaf, key_by_gid, trained, rotations,
                        dims) -> ClaimTables:
    """Fold K newly trained leaves into the persistent claim tables. A
    leaf's candidacy touches exactly the rows of its 27-neighbourhood
    cells, so the update allocates rows from the changed leaf's own row
    budget for the cells not covered yet, and recomputes those rows
    against the current map. changed_gids: [K] gp indices, changed_ok
    False on padding."""
    i32 = torch.int32
    dev = changed_gids.device
    K = changed_gids.shape[0]
    offs = _const("offs27", dev)
    nc = tables.cell_row.shape[0]
    g = torch.clamp(changed_gids, 0, key_by_gid.shape[0] - 1)
    leaf3 = voxel.delinearize(
        torch.clamp(key_by_gid[g.long()], max=voxel.FILL - 1), dims)
    cells3 = (leaf3[:, None, :] + offs[None]).reshape(K * 27, 3)
    lin = voxel.linearize(cells3, dims)
    okc = changed_ok.repeat_interleave(27) & (lin != voxel.FILL)
    cur = tables.cell_row[torch.clamp(lin, 0, nc - 1).long()]
    own = (g[:, None] * 27
           + torch.arange(27, dtype=i32, device=dev)[None]).reshape(K * 27)
    rowid = torch.where(cur >= 0, cur, own)
    cell_row = _scatter_rows(tables.cell_row, torch.where(okc, lin, nc), rowid)
    prio, gid, R12 = _claim_table_rows(cells3, okc, key_to_leaf, trained,
                                       rotations, dims)
    tgt = torch.where(okc[:, None], rowid[:, None] * 8
                      + torch.arange(8, dtype=i32, device=dev)[None],
                      tables.prio.shape[0]).reshape(K * 27 * 8)
    return tables._replace(
        cell_row=cell_row,
        prio=_scatter_rows(tables.prio, tgt, prio),
        gid=_scatter_rows(tables.gid, tgt, gid),
        R12=_scatter_rows(tables.R12, tgt, R12))


def claim_with_tables(tables: ClaimTables, grid, points, valid, res,
                      out_fill):
    """Claim scan points against prebuilt tables. Points are keyed by their
    grid-clamped voxel, so a point up to one cell outside the map box can
    still reach boundary leaves. Returns (gp_index claim [N] (out_fill
    where unclaimed), local (depth, u, v) [N, 3], claimed [N])."""
    N = points.shape[0]
    dt, dev = points.dtype, points.device
    res = torch.as_tensor(res, dtype=dt)
    half = res / 2.0

    keys3 = voxel.point_keys(points, grid.origin, grid.res)
    keys3c = torch.minimum(torch.clamp(keys3, min=0), grid.dims - 1)
    lin = voxel.linearize(keys3c, grid.dims)
    nc = tables.cell_row.shape[0]
    row = tables.cell_row[torch.clamp(lin, 0, nc - 1).long()]
    has = (lin < nc) & (row >= 0) & valid

    home_center = grid.origin + (keys3c.to(dt) + 0.5) * res
    relh = points - home_center                                  # [N, 3]
    oct_id = voxel.octant_of(relh)
    row8 = (torch.where(has, row, 0) * 8 + oct_id).long()

    Rk = tables.R12[row8].reshape(N, 8, 2, 3)                    # row gather
    sk = tables.prio[row8]
    gk = tables.gid[row8]
    co = _const("oct_cand_offs", dev)[oct_id.long()].to(dt) * res
    relc = relh[:, None, :] - co                                 # p - center_k
    d2 = torch.sum(relc * relc, dim=-1)
    # clip coordinates against the candidate's voxel center (equal to the
    # patch mean's up to the normal offset, orthogonal to u and v)
    loc12 = torch.sum(Rk * relc[:, :, None, :], dim=3)           # [N, 8, 2]
    pass_ = (has[:, None] & (sk != voxel.FILL)
             & (d2 <= (voxel.SQRT3_2 * res) ** 2)
             & (loc12[..., 0] <= half) & (loc12[..., 0] >= -half)
             & (loc12[..., 1] <= half) & (loc12[..., 1] >= -half))
    masked = torch.where(pass_, sk, voxel.FILL)
    # first claim = min priority; the winner is unique (keys are unique)
    best = torch.amin(masked, dim=1)
    claimed = best != voxel.FILL
    win = masked == best[:, None]
    uv = torch.sum(torch.where(win[..., None], loc12, 0.0), dim=1)
    gwin = torch.sum(torch.where(win, gk, 0), dim=1)
    # winner-only depth: one (normal, mean) gather per point
    nm = tables.nm[torch.where(claimed, gwin, 0).long()]         # [N, 6]
    depth = torch.sum(nm[:, :3] * (points - nm[:, 3:]), dim=-1)
    loc_claim = torch.where(claimed[:, None],
                            torch.cat([depth[:, None], uv], dim=-1), 0.0)
    gclaim = torch.where(claimed, gwin, out_fill).to(torch.int32)
    return gclaim, loc_claim, claimed


def claim_to_patches(grid, rotations, means, trained, points, valid, res,
                     leaf_ids=None):
    """Assign scan points to existing patches: a candidate is a neighbour
    leaf whose search sphere contains the point and whose frame clip
    passes; the claim is the first passing leaf in leaf (key) order;
    patches with an empty GP never claim. With grid.table this builds the
    claim tables; without it, 27 per-point candidate passes.
    Returns (gp_index claim [N], local coords [N, 3], claimed [N])."""
    B = rotations.shape[0]
    if grid.table is not None:
        tables = build_claim_tables(grid, rotations, means, trained,
                                    leaf_ids=leaf_ids)
        return claim_with_tables(tables, grid, points, valid, res,
                                 out_fill=B)

    N = points.shape[0]
    dt, dev = points.dtype, points.device
    half = torch.as_tensor(res, dtype=dt) / 2.0
    best = torch.full((N,), B, dtype=torch.int32, device=dev)
    loc_claim = torch.zeros((N, 3), dtype=dt, device=dev)
    for off in voxel.OFFSETS:
        idx, ok, _ = voxel.candidate_at_offset(grid, points, valid, off)
        gid = (idx if leaf_ids is None else leaf_ids[idx.long()]).long()
        ok = ok & trained[gid]
        loc = torch.einsum('nji,nj->ni', rotations[gid], points - means[gid])
        clip_ok = ((loc[:, 1] <= half) & (loc[:, 1] >= -half)
                   & (loc[:, 2] <= half) & (loc[:, 2] >= -half))
        better = ok & clip_ok & (idx < best)
        best = torch.where(better, idx, best)
        loc_claim = torch.where(better[:, None], loc, loc_claim)
    claimed = best < B
    safe = torch.clamp(best, max=B - 1)
    gclaim = safe if leaf_ids is None else leaf_ids[safe.long()]
    gclaim = torch.where(claimed, gclaim, B).to(torch.int32)
    return gclaim, loc_claim, claimed


def _map_claim_tables(comp: CompressedCloud, trained=None):
    """Candidate tables against a compressed map (None if the grid carries
    no dense table). trained: optional [B] bool override of the claim
    candidates; by default the patches whose depth GP is not empty."""
    batch = comp.patch
    if batch.grid.table is None:
        return None
    if trained is None:
        trained = sparse_gp.size(comp.depth_gp) > 0
    return build_claim_tables(batch.grid, batch.rotations, batch.means,
                              trained)


def _claim_to_map(comp: CompressedCloud, points, valid,
                  cfg: CompressorConfig, tables=None, trained=None):
    """trained: optional [B] claim candidates (default: the patches whose
    depth GP is not empty)."""
    batch = comp.patch
    if tables is not None:
        return claim_with_tables(tables, batch.grid, points, valid,
                                 cfg.patch.res,
                                 out_fill=batch.rotations.shape[0])
    if trained is None:
        trained = sparse_gp.size(comp.depth_gp) > 0
    return claim_to_patches(batch.grid, batch.rotations, batch.means,
                            trained, points, valid, cfg.patch.res)


def _bank_points(claim, loc, colors, claimed, B: int, P: int):
    """Bank claimed points into [B, P] by the claim-sorted scatter form:
    row i of segment b lands at slot (b, i - starts[b]); rows past P and
    unclaimed rows go to a dump row. Returns (loc [B, P, 3],
    colors [B, P, 3], mask [B, P])."""
    dt, dev = loc.dtype, loc.device
    N = claim.shape[0]
    (payload,), starts, segs = sort_by_claim(
        claim, claimed, (torch.cat([loc, colors.to(dt)], dim=-1),), B)
    rank = torch.arange(N, dtype=torch.int32, device=dev) \
        - starts[torch.clamp(segs, 0, B).long()]
    ok = (segs < B) & (rank < P)
    tgt = torch.where(ok, segs * P + rank, B * P)
    flat = torch.zeros((B * P + 1, 6), dtype=dt, device=dev)
    flat[tgt.long()] = torch.where(ok[:, None], payload, 0.0)
    flat = flat[:B * P]
    counts = starts[1:] - starts[:-1]
    Mb = torch.arange(P, dtype=torch.int32, device=dev)[None, :] \
        < torch.clamp(counts, max=P)[:, None]
    return flat[:, :3].reshape(B, P, 3), flat[:, 3:].reshape(B, P, 3), Mb


def _density_grads_closed(kp: RBFParams, s20, states, Xb, vals, mask,
                          zero_y: bool = False):
    """Closed-form per-point gradient and value of the predictive density,
    batched over patches. One kernel matrix serves mean, variance, density
    and every gradient contraction.

    Xb: [B, P, 3] local (depth, u, v); vals: [B, P, D] targets (the depth
    column, or demeaned colours sharing one variance across channels).
    zero_y drops the gradient's depth component (the colour field).
    Returns ([B, P, 3] gradient w.r.t. (y, u, v), [B, P] density)."""
    dt = Xb.dtype
    l2, sf, s20 = (_scalar(v, dt) for v in (kp.l_sq, kp.sigmaf_sq, s20))
    D = vals.shape[-1]
    act = states.active.to(dt)                            # [B, S]
    uv = Xb[..., 1:]                                      # [B, P, 2]
    diff = uv[:, :, None, :] - states.bv[:, None, :, :]   # [B, P, S, 2]
    d2 = torch.sum(diff * diff, dim=-1)
    K = sf * torch.exp(-0.5 * d2 / l2) * act[:, None, :]  # [B, P, S]
    mean = torch.einsum('bps,bsd->bpd', K, states.alpha)
    KC = torch.einsum('bps,bst->bpt', K, states.C)
    latent = sf + torch.sum(KC * K, dim=-1)               # k** + k^T C k
    var = s20 + torch.clamp(latent, min=0.0)              # [B, P]
    r = vals - mean                                       # [B, P, D]
    lp = torch.sum(-0.5 * torch.log(2.0 * math.pi * var)[..., None]
                   - 0.5 * r * r / var[..., None], dim=-1)
    p = torch.exp(lp)                                     # [B, P]

    # d lp/du_a = (1/var) sum_d r_d dmean_d/du_a
    #           + (sum_d r_d^2 / (2 var^2) - D / (2 var)) dvar/du_a
    # with dK_s/du_a = -K_s diff_{s,a} / l2, dvar = 2 (C k)^T dK (clamped)
    w = torch.einsum('bpd,bsd->bps', r, states.alpha)
    r2 = torch.sum(r * r, dim=-1)                         # [B, P]
    dvar_on = (latent > 0.0).to(dt)[..., None]
    coef = -(K / l2) * (w / var[..., None]
                        + (r2 / var ** 2 - D / var)[..., None] * KC * dvar_on)
    duv = torch.sum(coef[..., None] * diff, dim=2)        # [B, P, 2]
    if zero_y:
        dy = torch.zeros_like(p)
    else:
        dy = (mean[..., 0] - Xb[..., 0]) / var            # depth: D = 1
    out = p[..., None] * torch.cat([dy[..., None], duv], dim=-1)
    return (torch.where(mask[..., None], out, 0.0),
            torch.where(mask, p, 0.0))


def _blend_grads(rcfg: RegistrationConfig, dX, dCX, ll, cl):
    """Combine depth and colour density gradients: "alpha" blends
    a*dX + (1-a)*dCX; "likelihood" cross-weights each gradient by the
    other channel's likelihood, dX = l*dCX + cl*dX."""
    if rcfg.blend_mode == "likelihood":
        return ll[..., None] * dCX + cl[..., None] * dX
    a = rcfg.color_blend
    return a * dX + (1.0 - a) * dCX


def _twist_mean(rotations, dX, pw, m, ll, cl, mesh=None):
    """Rotate local gradients to world and average the twist contribution
    [g, x cross g] and the likelihoods ll, cl over the masked points. The
    sums [twist (6), n, sum ll, sum cl] are one tensor, all-reduced over
    the mesh's data group when there is one, and divided after that.
    Returns (delta [6], mean ll, mean cl, n points used)."""
    gw = torch.einsum('bij,bpj->bpi', rotations, dX)
    contrib = torch.cat([gw, torch.linalg.cross(pw, gw, dim=-1)], dim=-1)
    n = torch.sum(m)
    sums = torch.cat([torch.sum(torch.where(m[..., None], contrib, 0.0),
                                dim=(0, 1)),
                      torch.stack([n.to(contrib.dtype), torch.sum(ll),
                                   torch.sum(cl)])])
    if mesh is not None:
        sums = mesh_lib.all_reduce_sum(sums, mesh)
        n = sums[6].to(n.dtype)
    n_used = torch.clamp(sums[6], min=1)
    return sums[:6] / n_used, sums[7] / n_used, sums[8] / n_used, n


def compute_transformation(comp: CompressedCloud, points, colors, valid,
                           cfg: CompressorConfig, rcfg: RegistrationConfig,
                           depth_kp=None, rgb_kp=None, tables=None,
                           depth_s20=None):
    """One gradient evaluation from scratch (claims, banks, gradients).
    Returns (delta [6], mean likelihood, mean colour likelihood,
    n_points_used)."""
    batch = comp.patch
    dkp, ckp = default_params(cfg, points.device)
    depth_kp = depth_kp if depth_kp is not None else dkp
    rgb_kp = rgb_kp if rgb_kp is not None else ckp
    ds20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    B = batch.rotations.shape[0]
    P = cfg.patch.max_points_per_patch

    claim, loc, claimed = _claim_to_map(comp, points, valid, cfg,
                                        tables=tables)
    Xb, Cb, Mb = _bank_points(claim, loc, colors, claimed, B, P)
    # demean colours per bank row (== per-point rgb_means[claim])
    Cb = torch.where(Mb[..., None], Cb - batch.rgb_means[:, None, :], 0.0)

    dX, ll = _density_grads_closed(depth_kp, ds20, comp.depth_gp,
                                   Xb, Xb[..., :1], Mb)
    dCX, cl = _density_grads_closed(rgb_kp, cfg.rgb_gp.s20, comp.rgb_gp,
                                    Xb, Cb, Mb, zero_y=True)
    dX = _blend_grads(rcfg, dX, dCX, ll, cl)
    pw = torch.einsum('bij,bpj->bpi', batch.rotations, Xb) \
        + batch.means[:, None, :]
    return _twist_mean(batch.rotations, dX, pw, Mb, ll, cl)


def _bank_step(comp: CompressedCloud, cfg: CompressorConfig,
               rcfg: RegistrationConfig, depth_kp, rgb_kp,
               Wb, Cb, Mb, centers, depth_s20=None, mesh=None):
    """One gradient evaluation on pre-banked world points: local
    coordinates are re-derived from the banked positions (which ride the
    accumulated transform between re-claims) and the claiming patch's
    sphere and frame clip are re-applied as a mask. At a re-claim step this
    is compute_transformation. mesh: comp and the banks are this rank's
    rows; the means are global (see _twist_mean). Returns (delta [6], mean
    likelihood, mean colour likelihood, n_used)."""
    batch = comp.patch
    res = torch.tensor(cfg.patch.res, dtype=Wb.dtype)
    half = res / 2.0
    r2 = (voxel.SQRT3_2 * res) ** 2

    rel = Wb - batch.means[:, None, :]
    loc = torch.einsum('bji,bpj->bpi', batch.rotations, rel)     # R^T rel
    d2 = torch.sum((Wb - centers[:, None, :]) ** 2, dim=-1)
    m = (Mb & (d2 <= r2)
         & (loc[..., 1] <= half) & (loc[..., 1] >= -half)
         & (loc[..., 2] <= half) & (loc[..., 2] >= -half))
    Xb = torch.where(m[..., None], loc, 0.0)

    ds20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    dX, ll = _density_grads_closed(depth_kp, ds20, comp.depth_gp,
                                   Xb, Xb[..., :1], m)
    dCX, cl = _density_grads_closed(rgb_kp, cfg.rgb_gp.s20, comp.rgb_gp,
                                    Xb, Cb, m, zero_y=True)
    dX = _blend_grads(rcfg, dX, dCX, ll, cl)
    return _twist_mean(batch.rotations, dX, Wb, m, ll, cl, mesh)


def register(comp: CompressedCloud, scan_points, scan_colors, scan_valid,
             cfg: CompressorConfig,
             rcfg: RegistrationConfig = RegistrationConfig(),
             init: RegistrationState = None,
             depth_kp: RBFParams = None, depth_s20=None,
             tables: ClaimTables = None, mesh=None):
    """The registration loop: gradient steps until registration_done
    (more than min_steps, and max_steps reached or converged).

    The scan -> map claims run every rcfg.reclaim_every steps (counted from
    this call's entry); between them the banked points ride the
    accumulated transform and are re-clipped against their claiming patch
    (_bank_step). reclaim_every=1 is the reference's cadence. depth_kp /
    depth_s20: the map's (possibly calibrated) depth hyperparameters.
    init: a state to resume from; its pose is applied with t_exact.

    The loop runs on the host: the step counter is read once at entry and
    each step reads back one flag, its stop test. Each step is the span
    `reg.step`, with its claims pass `reg.claims` and its gradient
    `reg.grad` inside; the host counts `reg.steps`, `reg.reclaims` and
    `reg.reads` (the stop reads).

    mesh: comp is this rank's rows of the map, as the compressor's entry
    points return it under a mesh (`compressor.shard_cloud` cuts a whole
    one); the scan is whole. The frames and the trained flags are gathered
    once at entry for the claims, which every rank computes whole; each
    step is one all-reduce (see the module docstring). Returns (state,
    transformed scan points), the same on every rank."""
    dt, dev = scan_points.dtype, scan_points.device
    state = init if init is not None else init_state(dt, dev)
    step = int(state.step_nbr)
    # the t_exact recursion continues from state.t_exact, so the points
    # iterated are the ones (R_cloud, t_exact) produces
    pts = transforms.apply(scan_points, state.R_cloud, state.t_exact)
    batch = comp.patch
    B = batch.rotations.shape[0]           # this rank's patch rows
    # the map the claims run against: the whole one, on every rank
    claim_map, trained, first = comp, None, 0
    if mesh is not None:
        Bw = B * mesh_lib.axis_size(mesh, "data")
        first = mesh_lib.axis_index(mesh, "data") * B
        rotations, means, trained = mesh_lib.gather_leading(
            (batch.rotations, batch.means,
             sparse_gp.size(comp.depth_gp) > 0), mesh, Bw)
        claim_map = comp._replace(patch=batch._replace(rotations=rotations,
                                                       means=means))
    if tables is None:
        tables = _map_claim_tables(claim_map, trained)
    # bank_points caps the per-patch registration bank
    P = rcfg.bank_points or cfg.patch.max_points_per_patch
    centers = voxel.voxel_centers(batch.grid)[first:first + B]
    dkp, ckp = default_params(cfg, dev)
    dkp = dkp if depth_kp is None else depth_kp

    def rebank(p):
        claim, _, claimed = _claim_to_map(claim_map, p, scan_valid, cfg,
                                          tables=tables, trained=trained)
        if mesh is not None:
            # this rank's rows only, as local patch ids
            claimed = claimed & (claim >= first) & (claim < first + B)
            claim = claim - first
        Wb, Cb, Mb = _bank_points(claim, p, scan_colors, claimed, B, P)
        Cb = torch.where(Mb[..., None], Cb - batch.rgb_means[:, None, :], 0.0)
        return Wb, Cb, Mb

    if rcfg.grad_tol_step_ref is not None:
        tol = rcfg.grad_tol * rcfg.step / rcfg.grad_tol_step_ref
    else:
        tol = rcfg.grad_tol

    def stop_test(delta, eta):
        if rcfg.step_mode == "rprop":
            return torch.all(eta < rcfg.rprop_tol)
        return (torch.linalg.norm(delta[:3]) < tol) \
            & (torch.linalg.norm(delta[3:]) < tol)

    def read_stop(delta, eta):
        count("reg.reads")
        return bool(stop_test(delta, eta))

    eta = torch.full((6,), rcfg.rprop_eta0, dtype=dt, device=dev)
    Wb = Cb = Mb = None
    # the stop test also holds the entry state: a resumed state past
    # min_steps may already be done (read only then)
    conv = step > rcfg.min_steps and read_stop(state.delta, eta)
    k = 0                                  # steps since entry
    while not (step > rcfg.min_steps and (step >= rcfg.max_steps or conv)):
        with span("reg.step"):
            if k % rcfg.reclaim_every == 0:
                with span("reg.claims"):
                    Wb, Cb, Mb = rebank(pts)
                count("reg.reclaims")
            with span("reg.grad"):
                delta, ls, cls, _ = _bank_step(comp, cfg, rcfg, dkp, ckp, Wb,
                                               Cb, Mb, centers,
                                               depth_s20=depth_s20, mesh=mesh)
            if rcfg.step_mode == "rprop":
                # iRprop-: per-axis motion eta * sign(delta), grow 1.2x
                # while the sign holds, halve and skip the axis on a flip;
                # an axis with exactly zero gradient shrinks (counts as
                # converged)
                flip = delta * state.delta < 0
                eta = torch.clamp(torch.where(flip | (delta == 0.0),
                                              0.5 * eta, 1.2 * eta),
                                  rcfg.rprop_eta_min, rcfg.rprop_eta_max)
                move = torch.where(flip, 0.0, torch.sign(delta)) * eta
                tv, wv = move[:3], move[3:]
                delta = torch.where(flip, 0.0, delta)
            else:
                tv = rcfg.step * delta[:3]
                wv = rcfg.step * delta[3:]
                if rcfg.max_motion is not None:
                    cap, tiny = rcfg.max_motion, 1e-30
                    tv = tv * torch.clamp(
                        cap / (torch.linalg.norm(tv) + tiny), max=1.0)
                    wv = wv * torch.clamp(
                        cap / (torch.linalg.norm(wv) + tiny), max=1.0)
            R = transforms.euler_xyz(wv)
            state = RegistrationState(
                R_cloud=transforms.matmul3(R, state.R_cloud),
                t_cloud=state.t_cloud + tv,
                t_exact=torch.matmul(R, state.t_exact) + tv,
                delta=delta, step_nbr=state.step_nbr + 1,
                mean_likelihood=ls, mean_color_likelihood=cls)
            pts = transforms.apply(pts, R, tv)
            Wb = transforms.apply(Wb, R, tv)
            step += 1
            k += 1
            count("reg.steps")
            conv = read_stop(delta, eta)   # the step's one device read
    return state, pts


def registration_error(R_est, t_est, R_true, t_true):
    """Translation / rotation error of a registration that should recover
    the inverse of the applied perturbation."""
    dR = transforms.matmul3(R_est, R_true)
    t_err = torch.linalg.norm(torch.matmul(R_est, t_true) + t_est)
    return t_err, transforms.rotation_angle(dR)
