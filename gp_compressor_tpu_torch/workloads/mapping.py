"""Incremental GP mapping (SLAM front end).

The port of `gp_compressor_tpu.workloads.mapping`. Per scan: transform by
the accumulated pose, register against the map, then insert: trained
patches absorb the points they claim, new voxels gather evidence until
`min_points_new_patch` points are available and then become patches with
a fresh plane fit, a ray-carving pass fills the probit channel's `free`
mask, and every touched GP trains incrementally, through the fused CUDA
kernel (`cuda_kernels.sogp_train`) for CUDA tensors.

`smc_refine_pose` refines a scan's pose against the map with a particle
filter (`inference.smc`), and `_map_as_compressed` is the map's
registration view in leaf-key order.

The map is a persistent `MapState` over a fixed world box: a dense
key -> leaf table, padded patch banks, padded pending-evidence buffers and
the dense claim tables, all of static shape; growth flips entries.

Where the JAX module branches on the device (`lax.cond`, `while_loop`),
the port branches on the host, from values read once:

  * the claim-table choice (full build, incremental update or none) reads
    the number of leaves that become patches, once per insert; the
    pending-evidence training pass runs when that number is not zero;
  * the carve reads the longest camera -> hit walk once and runs exactly
    that many walk steps;
  * `add_cloud_fused` reads whether the map has patches, once per scan
    (registration and the first-scan threshold follow from it).

The rest runs unconditionally where JAX gates it and the ungated form
gives the same result: the leaf-table rebuild (with no new leaf it
reproduces the cached grid), the pending statistics (zero without a new
patch) and the spill bank's training pass (a launch on an all-false mask
leaves the states as they are). Scatters that JAX drops with
`mode='drop'` go to a dump row that is sliced off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from gp_compressor_tpu_torch.config import (CompressorConfig, MappingConfig,
                                            RegistrationConfig, SMCConfig)
from gp_compressor_tpu_torch.cuda_kernels import sogp_train
from gp_compressor_tpu_torch.geometry import patches as patches_mod
from gp_compressor_tpu_torch.geometry import rotation, transforms, voxel
from gp_compressor_tpu_torch.geometry.voxel import FILL, VoxelGrid
from gp_compressor_tpu_torch.models import sparse_gp
from gp_compressor_tpu_torch.models.sparse_gp import SOGPState
from gp_compressor_tpu_torch.ops.kernels import RBFParams
from gp_compressor_tpu_torch.ops.noise import ProbitNoise
from gp_compressor_tpu_torch.utils.profiling import count, span
from gp_compressor_tpu_torch.workloads import registration
from gp_compressor_tpu_torch.workloads.compressor import (CompressedCloud,
                                                         default_params)
from gp_compressor_tpu_torch.workloads.registration import _scatter_rows

I32 = torch.int32


class MapState(NamedTuple):
    """Persistent map over a fixed world box. B = max_patches, G = sz*sz."""

    origin: torch.Tensor       # [3]
    dims: torch.Tensor         # [3] int32
    key_to_leaf: torch.Tensor  # [n_cells] int32 gp_index or -1
    leaf_keys: torch.Tensor    # [B] sorted linear keys (FILL padding)
    leaf_ids: torch.Tensor     # [B] gp_index per sorted slot
    n_patches: torch.Tensor    # 0-dim int32

    # patch banks, indexed by gp_index
    rotations: torch.Tensor    # [B, 3, 3]
    means: torch.Tensor        # [B, 3]
    rgb_means: torch.Tensor    # [B, 3]
    W: torch.Tensor            # [B, G] bool
    free: torch.Tensor         # [B, G] bool, the probit channel's data
    created: torch.Tensor      # [B] bool: the patch exists (frame fitted)
    depth_gp: SOGPState
    rgb_gp: SOGPState

    # pending evidence of not-yet-created patches (world coordinates)
    pend_pts: torch.Tensor     # [B, Pp, 3]
    pend_cols: torch.Tensor    # [B, Pp, 3]
    pend_count: torch.Tensor   # [B] int32

    # accumulated pose
    R_cloud: torch.Tensor      # [3, 3]
    t_cloud: torch.Tensor      # [3]

    # the persistent dense claim tables (registration.ClaimTables, gp-index
    # row layout), shared by the scan's registration and the insert's
    # claims, updated incrementally as leaves become patches; `nm` is
    # refreshed from the stored frames and means
    tables: registration.ClaimTables

    def grid(self, res) -> VoxelGrid:
        """The sorted-slot grid: its dense table maps a cell to the sorted
        slot (claims need key-order priority), not to the gp_index."""
        return VoxelGrid(keys=self.leaf_keys, n_leaves=self.n_patches,
                         origin=self.origin, dims=self.dims,
                         res=_full(res, self.origin),
                         table=_slot_table(self.leaf_keys,
                                           self.key_to_leaf.shape[0]))


def _full(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A 0-dim tensor of `like`'s device (and dtype), filled there."""
    return torch.full((), v, dtype=dtype or like.dtype, device=like.device)


def _slot_table(leaf_keys: torch.Tensor, nc: int) -> torch.Tensor:
    """[nc] cell -> sorted slot (-1 where no leaf)."""
    B = leaf_keys.shape[0]
    tgt = torch.where(leaf_keys != FILL, torch.clamp(leaf_keys, max=nc - 1),
                      nc)
    return _scatter_rows(
        torch.full((nc,), -1, dtype=I32, device=leaf_keys.device), tgt,
        torch.arange(B, dtype=I32, device=leaf_keys.device))


def _by_gid(leaf_keys, leaf_ids, n_patches):
    """(slot_tgt [B]: each sorted slot's gp_index, B past the real leaves;
    key_by_gid [B]: each gp_index's linear voxel key, FILL where none)."""
    B = leaf_keys.shape[0]
    ar = torch.arange(B, device=leaf_keys.device)
    slot_tgt = torch.where(ar < n_patches, leaf_ids, B)
    key_by_gid = _scatter_rows(torch.full_like(leaf_keys, FILL), slot_tgt,
                               leaf_keys)
    return slot_tgt, key_by_gid


def map_init(cfg: CompressorConfig, mcfg: MappingConfig, world_min,
             world_max, dtype=torch.float32, pending_capacity: int = 256,
             device="cuda") -> MapState:
    """An empty map over the box [world_min, world_max] on `device`."""
    B = cfg.patch.max_patches
    G = cfg.patch.sz ** 2
    origin = torch.as_tensor(np.asarray(world_min), dtype=dtype)
    dims = torch.floor((torch.as_tensor(np.asarray(world_max), dtype=dtype)
                        - origin) / cfg.patch.res).to(I32) + 1
    n_cells = int(torch.prod(dims.long()))
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return MapState(
        origin=origin.to(device), dims=dims.to(device),
        key_to_leaf=torch.full((n_cells,), -1, dtype=I32, device=device),
        leaf_keys=torch.full((B,), FILL, dtype=I32, device=device),
        leaf_ids=torch.zeros((B,), dtype=I32, device=device),
        n_patches=torch.zeros((), dtype=I32, device=device),
        rotations=torch.eye(3, dtype=dtype, device=device).repeat(B, 1, 1),
        means=z(B, 3), rgb_means=z(B, 3),
        W=torch.zeros((B, G), dtype=torch.bool, device=device),
        free=torch.zeros((B, G), dtype=torch.bool, device=device),
        created=torch.zeros((B,), dtype=torch.bool, device=device),
        depth_gp=sparse_gp.init_batch(cfg.depth_gp, B, device=device),
        rgb_gp=sparse_gp.init_batch(cfg.rgb_gp, B, device=device),
        pend_pts=z(B, pending_capacity, 3), pend_cols=z(B, pending_capacity, 3),
        pend_count=torch.zeros((B,), dtype=I32, device=device),
        R_cloud=torch.eye(3, dtype=dtype, device=device), t_cloud=z(3),
        tables=registration.empty_claim_tables_dense(n_cells, B, dtype=dtype,
                                                     device=device))


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------

def _linkey(state: MapState, res, points):
    """(linear voxel key [N], -1 outside the box; in-box mask [N])."""
    keys3 = voxel.point_keys(points, state.origin, res)
    ok = torch.all((keys3 >= 0) & (keys3 < state.dims), dim=-1)
    d = state.dims
    lin = (keys3[..., 0] * d[1] + keys3[..., 1]) * d[2] + keys3[..., 2]
    return torch.where(ok, lin, -1), ok


def _unique_sorted(x: torch.Tensor, size: int) -> torch.Tensor:
    """`jnp.unique(x, size=size, fill_value=FILL)` for int32 x whose
    padding value is FILL: the sorted distinct values, truncated to `size`
    and FILL-padded, by a sort, a first-of-run mark and a scatter to the
    run's rank (no host read)."""
    s = torch.sort(x).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    first &= s != FILL
    rank = torch.cumsum(first.to(I32), 0, dtype=I32) - 1
    return _scatter_rows(torch.full((size,), FILL, dtype=I32, device=x.device),
                         torch.where(first & (rank < size), rank, size), s)


@span("map.insert")
def map_insert(state: MapState, points, colors, valid, cfg: CompressorConfig,
               mcfg: MappingConfig, min_nbr, depth_kp: RBFParams = None,
               depth_s20=None, depth_eps=None):
    """insert_into_map + train_processes (src/gp_mapping.cpp:37-152,293-343).

    `points` are in world (map) coordinates. min_nbr: the evidence a
    voxel needs to become a patch (1 on the first scan, the reference's
    constructor path). depth_kp / depth_s20 / depth_eps: the map's
    (calibrated) depth hyperparameters, which ride the kernel's row.
    The insert is the span `map.insert`, and each stage a span inside it
    (`map.allocate`, `map.sphere_stats`, `map.tables`, `map.claims`,
    `map.sort_banks`, `map.train`, `map.sanitize`, `map.pending`,
    `map.carve`).

    Returns (MapState, info) where info holds 0-dim int32 truncation
    counters: bank_dropped (claimed points beyond the main and spill
    banks), pend_dropped (points that found their pending buffer full),
    patch_overflow (new leaves past max_patches)."""
    B = cfg.patch.max_patches
    G = cfg.patch.sz ** 2
    Pmax = cfg.patch.max_points_per_patch
    Pp = state.pend_pts.shape[1]
    sz = cfg.patch.sz
    dt, dev = points.dtype, points.device
    res = torch.tensor(cfg.patch.res, dtype=dt)
    half = cfg.patch.res / 2.0
    N = points.shape[0]
    ar = torch.arange(B, device=dev)

    # ---- 1. voxels touched by this scan; allocate leaves (gp indices of
    # new leaves in key order)
    with span("map.allocate"):
        lin, in_box = _linkey(state, res, points)
        lin_valid = torch.where(valid & in_box, lin, FILL)
        uniq = _unique_sorted(lin_valid, B)
        is_real = uniq != FILL
        nc = state.key_to_leaf.shape[0]
        existing = torch.where(
            is_real, state.key_to_leaf[torch.clamp(uniq, max=nc - 1).long()],
            -2)
        is_new = is_real & (existing == -1)
        new_ids = state.n_patches \
            + torch.cumsum(is_new.to(I32), 0, dtype=I32) - 1
        overflow = new_ids >= B
        fresh = is_new & ~overflow
        n_patches = torch.clamp(state.n_patches + fresh.sum(), max=B).to(I32)
        fresh_ids = torch.where(fresh, new_ids, 0).to(I32)
        key_to_leaf = _scatter_rows(state.key_to_leaf,
                                    torch.where(fresh, uniq, nc), fresh_ids)
        # the sorted leaf table, old keys and new
        all_keys = torch.cat([state.leaf_keys, torch.where(fresh, uniq, FILL)])
        all_ids = torch.cat([state.leaf_ids, fresh_ids])
        order = torch.argsort(all_keys, stable=True)[:B]
        leaf_keys, leaf_ids = all_keys[order], all_ids[order]
        grid = VoxelGrid(keys=leaf_keys, n_leaves=n_patches,
                         origin=state.origin, dims=state.dims,
                         res=_full(cfg.patch.res, points),
                         table=_slot_table(leaf_keys, nc))

    # ---- 2. sphere statistics of would-be-new patches (plane fits from
    # this scan's sphere points), remapped from sorted slots to gp indices
    with span("map.sphere_stats"):
        M_slot, cnt_slot = patches_mod.sphere_moments(grid, points, valid,
                                                      cfg.patch)
        slot_tgt, key_by_gid = _by_gid(leaf_keys, leaf_ids, n_patches)
        M = _scatter_rows(
            torch.zeros((B, 4, 4), dtype=M_slot.dtype, device=dev),
            slot_tgt, M_slot)
        sphere_counts = _scatter_rows(torch.zeros((B,), dtype=I32, device=dev),
                                      slot_tgt, cnt_slot.to(I32))
        R_fresh = rotation.rotation_from_moment_batch(
            M, sphere_counts, cfg.patch.min_points_for_rotation).to(dt)
        centers_all = state.origin + (voxel.delinearize(
            torch.clamp(leaf_keys, max=FILL - 1), state.dims).to(dt)
            + 0.5) * res
        centers_by_id = _scatter_rows(
            torch.zeros((B, 3), dtype=dt, device=dev), slot_tgt,
            centers_all)
        # leaves becoming patches now: not created, pending + sphere evidence
        # >= min_nbr (src/gp_mapping.cpp:126)
        becomes = (~state.created
                   & (state.pend_count + sphere_counts >= min_nbr)
                   & (ar < n_patches))

    # ---- 3. claims against the persistent tables, with the leaves that
    # become patches folded in first: incrementally up to
    # table_update_max of them, by a full build past it
    with span("map.tables"):
        trained_or_new = state.created | becomes
        rot_eff = torch.where(becomes[:, None, None], R_fresh, state.rotations)
        mean_eff = torch.where(becomes[:, None], centers_by_id, state.means)
        K_INC = mcfg.table_update_max
        n_changed = int(becomes.sum())        # the insert's read: table choice
        if n_changed > K_INC:
            tables = registration.build_claim_tables_dense(
                key_to_leaf, key_by_gid, n_patches, trained_or_new, rot_eff,
                mean_eff, state.dims)
        elif n_changed > 0:
            changed = torch.sort(
                torch.where(becomes, ar.to(I32), B)).values[:K_INC]
            tables = registration.update_claim_tables(
                state.tables, torch.clamp(changed, max=B - 1), changed < B,
                key_to_leaf, key_by_gid, trained_or_new, rot_eff, state.dims)
        else:
            tables = state.tables
        tables = tables._replace(nm=torch.cat([rot_eff[:, :, 0], mean_eff], 1))

    with span("map.claims"):
        claim, loc_claim, claimed = registration.claim_with_tables(
            tables, grid, points, valid, cfg.patch.res, out_fill=B)

    # ---- 4. ONE shared sort serves the banks, the patch means, the
    # pending append and the counters: claimed points into segment
    # `claim` in centre-out order, unclaimed storable points into segment
    # B + home gp_index in arrival order, the rest last
    with span("map.sort_banks"):
        home_gid = torch.where(
            lin_valid != FILL,
            key_to_leaf[torch.clamp(lin_valid, 0, nc - 1).long()], -1)
        created = state.created | becomes
        store = (~claimed & valid & in_box & (home_gid >= 0)
                 & ~created[torch.clamp(home_gid, min=0).long()])
        d2c = loc_claim[:, 1] ** 2 + loc_claim[:, 2] ** 2     # 0 for unclaimed
        seg_all = torch.where(claimed, claim,
                              torch.where(store, B + home_gid, 2 * B)).to(I32)
        # payload columns: u v d | r g b | world x y z
        payload = torch.cat([loc_claim[:, 1:], loc_claim[:, :1], colors.to(dt),
                             points], 1)
        (srt,), starts2, seg_i = patches_mod.sort_by_claim(
            seg_all, seg_all < 2 * B, (payload,), 2 * B, rank=d2c)
        counts_b = starts2[1:B + 1] - starts2[:B]             # [B]
        # per-patch claimed sums from one prefix sum over the sorted payload,
        # in float64 along the contiguous dimension (as build_patches)
        Z = torch.cumsum(srt[:, 2:6].double().T.contiguous(), dim=1)
        Z = torch.cat([torch.zeros((4, 1), dtype=Z.dtype, device=dev), Z], 1)
        seg_sums = (Z[:, starts2[1:B + 1].long()]
                    - Z[:, starts2[:B].long()]).T.to(dt)        # [B, 4]
        cur_cnt = counts_b.to(dt)

        # pending evidence of the patches created now joins their plane means
        # (transform_to_new, src/gp_mapping.cpp:260-281); zero elsewhere
        pend_valid = ((torch.arange(Pp, device=dev)[None, :]
                       < state.pend_count[:, None]) & becomes[:, None])
        pend_loc = torch.matmul(state.pend_pts - mean_eff[:, None, :],
                                rot_eff)                  # R^T rel, [B,Pp,3]
        pend_clip = ((torch.abs(pend_loc[..., 1]) <= half)
                     & (torch.abs(pend_loc[..., 2]) <= half) & pend_valid)
        pf = pend_clip.to(dt)
        tot = torch.clamp(cur_cnt + pf.sum(1), min=1.0)
        mn = (seg_sums[:, 0] + torch.sum(pend_loc[..., 0] * pf, 1)) / tot
        cmn = (seg_sums[:, 1:]
               + torch.sum(state.pend_cols * pf[..., None], 1)) \
            / tot[:, None]

        # new patches: frame, centre moved along the normal, colour mean; old
        # patches keep theirs (transform_to_old does not re-demean)
        nb = becomes[:, None]
        rotations = torch.where(becomes[:, None, None], R_fresh,
                                state.rotations)
        means = torch.where(nb, centers_by_id + mn[:, None] * R_fresh[:, :, 0],
                            state.means)
        rgb_means = torch.where(nb, cmn, state.rgb_means)

        # ---- 5. W mask: OR of the claimed cells and the new patches' pending
        # cells (src/gp_mapping.cpp:242,290)
        cell = patches_mod.grid_cell(loc_claim[:, 1:], res, sz)
        pend_cell = patches_mod.grid_cell(pend_loc[..., 1:], res, sz)
        W = _scatter_rows(state.W.reshape(-1), torch.cat([
            torch.where(claimed, claim * G + cell, B * G),
            torch.where(pend_clip, ar[:, None] * G + pend_cell,
                        B * G).reshape(-1)
        ]), True).reshape(B, G)

        # ---- 6. training banks: one [N, 6] scatter from the shared sort into
        # [B, width] banks (row i of segment b lands at (b, i - starts[b] -
        # rank0)), in centre-out insertion order; new patches demean depth by
        # their mean, every patch demeans colour by its stored colour mean
        Sp = mcfg.spill_bank
        mn_eff = torch.where(becomes, mn, 0.0)
        rank_row = torch.arange(N, dtype=I32, device=dev) \
            - starts2[torch.clamp(seg_i, 0, 2 * B).long()]
        is_claim_row = seg_i < B

        def bank(rank0, width):
            okb = is_claim_row & (rank_row >= rank0) \
                & (rank_row < rank0 + width)
            flat = _scatter_rows(
                torch.zeros((B * width, 6), dtype=dt, device=dev),
                torch.where(okb, seg_i * width + (rank_row - rank0),
                            B * width),
                torch.where(okb[:, None], srt[:, :6], 0.0))
            m = (rank0 + torch.arange(width, dtype=I32, device=dev))[None, :] \
                < torch.clamp(counts_b, max=rank0 + width)[:, None]
            X = flat[:, :2].reshape(B, width, 2).contiguous()
            Y = torch.where(m[..., None], (flat[:, 2].reshape(B, width)
                                           - mn_eff[:, None])[..., None], 0.0)
            C = torch.where(m[..., None], flat[:, 3:].reshape(B, width, 3)
                            - rgb_means[:, None, :], 0.0)
            return X, Y, C, m

        banks = [bank(0, Pmax)] + ([bank(Pmax, Sp)] if Sp > 0 else [])

    with span("map.train"):
        dkp, ckp = default_params(cfg, dev)
        dkp = dkp if depth_kp is None else depth_kp
        d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20

        def train_pair(states, X, Y, C, M):
            # the kernel for CUDA tensors, its plain version for CPU tensors;
            # banks arrive in their insertion order
            d = sogp_train.add_points_batch_cuda(
                dkp, cfg.depth_gp, states[0], X, Y, M, s20=depth_s20,
                eps_tol=depth_eps)
            c = sogp_train.add_points_batch_cuda(ckp, cfg.rgb_gp, states[1],
                                                 X, C, M)
            return d, c

        # the main bank, then the spill bank (every insert: an all-false mask
        # leaves a patch's state as it was), then the pending evidence of the
        # patches created now (only when there are such patches)
        gps = (state.depth_gp, state.rgb_gp)
        for X, Y, C, m in banks:
            gps = train_pair(gps, X, Y, C, m)
        if n_changed > 0:
            gps = train_pair(gps, pend_loc[..., 1:].contiguous(),
                             (pend_loc[..., 0] - mn[:, None])[..., None],
                             state.pend_cols - cmn[:, None, :], pend_clip)
    # failure containment, as in compressor.train
    with span("map.sanitize"):
        probes = patches_mod.prediction_grid(cfg.patch, dt, dev)[::5]
        depth_gp, _ = sparse_gp.sanitize_batch(gps[0], dkp, d_s20,
                                               max_pred=10.0 * cfg.patch.res,
                                               probes=probes)
        rgb_gp, _ = sparse_gp.sanitize_batch(gps[1], ckp, cfg.rgb_gp.s20,
                                             max_pred=2.5e3, probes=probes)

    # ---- 7. pending buffers: consumed for created patches; unclaimed
    # points append to their home voxel's buffer straight from the shared
    # sort (rows of segment B + gid are contiguous and in arrival order)
    with span("map.pending"):
        pend_count0 = torch.where(becomes, 0, state.pend_count)
        is_pend_row = (seg_i >= B) & (seg_i < 2 * B)
        b_row = torch.clamp(seg_i - B, 0, B - 1)
        slot = pend_count0[b_row.long()] + rank_row
        okp = is_pend_row & (slot < Pp)
        pflat = torch.where(okp, b_row * Pp + slot, B * Pp)

        def append(buf, cols):
            buf = torch.where(becomes[:, None, None], 0.0, buf)
            return _scatter_rows(buf.reshape(B * Pp, 3), pflat,
                                 torch.where(okp[:, None], cols, 0.0)
                                 ).reshape(B, Pp, 3)

        pend_pts = append(state.pend_pts, srt[:, 6:9])
        pend_cols = append(state.pend_cols, srt[:, 3:6])
        pend_new = starts2[B + 1:2 * B + 1] - starts2[B:2 * B]
        pend_count = torch.clamp(pend_count0 + pend_new, max=Pp).to(I32)

        # ---- truncation counters
        info = {
            "bank_dropped": torch.clamp(counts_b - (Pmax + Sp), min=0).sum()
            .to(I32),
            "pend_dropped": torch.clamp(pend_count0 + pend_new - Pp,
                                        min=0).sum().to(I32),
            "patch_overflow": (is_new & overflow).sum().to(I32)}

    # ---- 8. free-space carving (every carve_stride-th ray)
    with span("map.carve"):
        cs = mcfg.carve_stride
        free = _carve_free_space(state, key_to_leaf, created, rotations,
                                 means, state.free, points[::cs],
                                 (valid & claimed)[::cs], claim[::cs], cfg,
                                 mcfg, key_by_gid=key_by_gid)

    # the stored tables carry the final frames and means
    tables = tables._replace(nm=torch.cat([rotations[:, :, 0], means], 1))
    return state._replace(
        key_to_leaf=key_to_leaf, leaf_keys=leaf_keys, leaf_ids=leaf_ids,
        n_patches=n_patches, rotations=rotations, means=means,
        rgb_means=rgb_means, W=W, free=free, created=created,
        depth_gp=depth_gp, rgb_gp=rgb_gp, pend_pts=pend_pts,
        pend_cols=pend_cols, pend_count=pend_count, tables=tables), info


def required_ray_steps(world_min, world_max, res) -> int:
    """DDA step bound for exact traversal of the map's world box (any
    segment through the grid crosses <= sum(dims) + 1 voxels)."""
    dims = np.floor((np.asarray(world_max, np.float64)
                     - np.asarray(world_min, np.float64)) / res).astype(int) + 1
    return int(dims.sum()) + 2


def _carve_free_space(state: MapState, key_to_leaf, created, rotations,
                      means, free, points, hit_valid, hit_claim,
                      cfg: CompressorConfig, mcfg: MappingConfig,
                      key_by_gid=None, chunk: int = 8):
    """Batched ray -> voxel traversal (Amanatides-Woo, voxel.ray_walk_*)
    and the marking of train_classification (src/gp_mapping.cpp:154-211).

    A ray marks only if its walk reaches its hit patch's voxel (the
    reference's reached_gp latch); every created patch whose voxel it
    crosses before gets its plane-crossing cell marked free, and the hit
    patch's cell is marked not free. Within one insert a hit beats a
    crossing. The hit voxel is known, so the step at which a ray enters it
    (s_hit, the L1 distance from the entry voxel) comes from a slab test;
    the longest s_hit is read once and the walk runs exactly that many
    steps (at most max_ray_steps). The marking runs on blocks of `chunk`
    steps, each folded into one [B*G + 1] buffer by a scatter-max
    (1 = crossed, 2 = hit), so the [steps, N, 12] temporaries are never
    whole. key_by_gid: optional [B] linear key per gp_index."""
    B = cfg.patch.max_patches
    G = cfg.patch.sz ** 2
    sz = cfg.patch.sz
    dt, dev = points.dtype, points.device
    res = torch.tensor(cfg.patch.res, dtype=dt)
    half = cfg.patch.res / 2.0
    N = points.shape[0]
    cam = state.t_cloud.to(dt)                           # camera position
    delta = points - cam                                 # ray directions
    dims = state.dims
    ncells = key_to_leaf.shape[0]

    if key_by_gid is None:
        key_by_gid = _scatter_rows(
            torch.full((B,), FILL, dtype=I32, device=dev),
            torch.where(key_to_leaf >= 0, key_to_leaf, B),
            torch.arange(ncells, dtype=I32, device=dev))

    st = voxel.ray_walk_init(state.origin, dims, res, cam, delta)

    # ---- s_hit: slab test of the hit voxel's box, L1 step index
    hc = torch.clamp(hit_claim, 0, B - 1).long()
    hk = key_by_gid[hc]                                            # [N]
    hk3 = voxel.delinearize(torch.clamp(hk, max=FILL - 1), dims)   # [N, 3]
    vlo = state.origin + hk3.to(dt) * res
    vhi = vlo + res
    big = 3.4e38
    nz = delta != 0
    dsafe = torch.where(nz, delta, 1.0)
    c = cam[None, :]
    t1 = torch.where(nz, (vlo - c) / dsafe, torch.where(c >= vlo, -big, big))
    t2 = torch.where(nz, (vhi - c) / dsafe, torch.where(c <= vhi, big, -big))
    tvlo = torch.amax(torch.minimum(t1, t2), dim=-1)
    tvhi = torch.amin(torch.maximum(t1, t2), dim=-1)
    reaches = (st.active & hit_valid & (hk != FILL) & created[hc]
               & (tvlo < tvhi) & (tvhi > st.t) & (tvlo < st.t_end))
    s_hit = torch.where(reaches, torch.sum(torch.abs(hk3 - st.X), dim=-1),
                        FILL).to(I32)
    # a ray records a voxel at steps 0..s_hit: the walk's one read
    n_steps = 0 if N == 0 else min(
        int(torch.amax(torch.where(reaches, s_hit, -1))) + 1,
        mcfg.max_ray_steps)
    st = st._replace(active=reaches)

    plane = torch.cat([torch.cat([rotations.reshape(B, 9), means], 1),
                       torch.zeros((1, 12), dtype=dt, device=dev)], 0)
    marks = torch.zeros((B * G + 1,), dtype=I32, device=dev)

    def mark(gidbuf, s0):
        # the (step, ray) plane / cell / mark math of one block of steps
        k = gidbuf.shape[0]
        g = torch.clamp(gidbuf, min=0).long()
        ok = (gidbuf >= 0) & created[g]
        pl = plane[torch.where(ok, g, B)]                  # [k, N, 12]
        R = pl[..., :9].reshape(k, N, 3, 3)
        n = R[..., :, 0]                                   # normals
        mid = pl[..., 9:]
        denom = torch.sum(n * delta[None], dim=-1)
        dplane = torch.sum(n * (mid - cam), dim=-1) / torch.where(
            torch.abs(denom) > 1e-12, denom, 1e-12)
        inter = cam + dplane[..., None] * delta[None]
        loc = torch.sum(R * (inter - mid)[..., :, None], dim=2)  # R^T rel
        okm = ok & (torch.abs(loc[..., 1]) <= half) \
            & (torch.abs(loc[..., 2]) <= half)
        idx = torch.where(okm, g * G + patches_mod.grid_cell(
            loc[..., 1:], res, sz), B * G)
        # the 2-mark lands only where the walk is at the hit voxel
        svec = s0 + torch.arange(k, dtype=I32, device=dev)[:, None]
        val = torch.where((svec == s_hit[None, :])
                          & (gidbuf == hit_claim[None, :]), 2, 1).to(I32)
        marks.scatter_reduce_(0, idx.reshape(-1), val.reshape(-1), "amax")

    block = []
    for s in range(n_steps):
        lin = voxel.linearize(st.X, dims)
        act = st.active & (lin != FILL)
        block.append(torch.where(
            act, key_to_leaf[torch.clamp(lin, 0, ncells - 1).long()], -1))
        st = voxel.ray_walk_step(st, dims)
        st = st._replace(active=st.active & (s < s_hit))
        if len(block) == chunk or s == n_steps - 1:
            mark(torch.stack(block), s + 1 - len(block))
            block = []

    m = marks[:B * G].reshape(B, G)
    return (free | (m == 1)) & ~(m == 2)


# ---------------------------------------------------------------------------
# the add_cloud loop
# ---------------------------------------------------------------------------

def _map_view_gid(state: MapState, cfg: CompressorConfig) -> CompressedCloud:
    """Registration view of the map in gp_index order, without
    permutation gathers: claims against state.tables return gp indices.
    grid.keys here are key_by_gid (not sorted, no table): valid for
    geometry and voxel centres only, so pair this view with state.tables."""
    B = state.rotations.shape[0]
    dt, dev = state.means.dtype, state.means.device
    _, key_by_gid = _by_gid(state.leaf_keys, state.leaf_ids, state.n_patches)
    grid = VoxelGrid(keys=key_by_gid, n_leaves=state.n_patches,
                     origin=state.origin, dims=state.dims,
                     res=_full(cfg.patch.res, state.origin), table=None)
    batch = patches_mod.PatchBatch(
        grid=grid, rotations=state.rotations, means=state.means,
        rgb_means=state.rgb_means, W=state.W,
        X=torch.zeros((B, 0, 2), dtype=dt, device=dev),
        y=torch.zeros((B, 0, 1), dtype=dt, device=dev),
        rgb=torch.zeros((B, 0, 3), dtype=dt, device=dev),
        mask=torch.zeros((B, 0), dtype=torch.bool, device=dev),
        counts=torch.zeros((B,), dtype=I32, device=dev),
        claims=torch.zeros((0,), dtype=I32, device=dev),
        n_leaves=state.n_patches)
    return CompressedCloud(patch=batch, depth_gp=state.depth_gp,
                           rgb_gp=state.rgb_gp)


def _map_as_compressed(state: MapState, cfg: CompressorConfig
                       ) -> CompressedCloud:
    """Registration view of the map in sorted-slot (leaf-key) order: every
    bank gathered through leaf_ids, with the sorted-slot grid, so that
    `registration.register` builds its own claim tables from it."""
    B = state.rotations.shape[0]
    dt, dev = state.means.dtype, state.means.device
    ids = state.leaf_ids.long()
    batch = patches_mod.PatchBatch(
        grid=state.grid(cfg.patch.res), rotations=state.rotations[ids],
        means=state.means[ids], rgb_means=state.rgb_means[ids],
        W=state.W[ids],
        X=torch.zeros((B, 0, 2), dtype=dt, device=dev),
        y=torch.zeros((B, 0, 1), dtype=dt, device=dev),
        rgb=torch.zeros((B, 0, 3), dtype=dt, device=dev),
        mask=torch.zeros((B, 0), dtype=torch.bool, device=dev),
        counts=torch.zeros((B,), dtype=I32, device=dev),
        claims=torch.zeros((0,), dtype=I32, device=dev),
        n_leaves=state.n_patches)
    return CompressedCloud(
        patch=batch, depth_gp=SOGPState(*[a[ids] for a in state.depth_gp]),
        rgb_gp=SOGPState(*[a[ids] for a in state.rgb_gp]))


def _zero_info(device):
    z = lambda: torch.zeros((), dtype=I32, device=device)
    return {"bank_dropped": z(), "pend_dropped": z(), "patch_overflow": z()}


def registration_view(state: MapState, cfg: CompressorConfig):
    """What a scan registers against: (the map's view in gp_index order,
    its persistent claim tables with `nm` refreshed from the stored frames
    and means), as `registration.register` takes them."""
    tables = state.tables._replace(nm=torch.cat(
        [state.rotations[:, :, 0], state.means], 1))
    return _map_view_gid(state, cfg), tables


def add_cloud_fused(state: MapState, points, colors, valid,
                    cfg: CompressorConfig, mcfg: MappingConfig,
                    rcfg: RegistrationConfig = RegistrationConfig(),
                    register_scan: bool = True, depth_kp=None,
                    depth_s20=None, depth_eps=None):
    """gp_mapping::add_cloud (src/gp_mapping.cpp:12-35): transform by the
    accumulated pose, register (on every reg_stride-th point, the pose
    then carried onto the whole scan by the exactly composed translation),
    and insert unless drop_on_reg_cap drops a scan whose registration hit
    max_steps (counted as `map.dropped`). Reads whether the map has
    patches (registration needs a map; the first scan inserts with min_nbr
    1). The transform and the registration are the span `map.register`,
    the insert `map.insert`.

    The stored pose takes the registration's rotation and, by default, the
    plain sum of its per-step translations (the reference's t_cloud,
    src/gp_registration.cpp:83-84), which leaves it off the pose the scan
    was inserted at by (R - I) t; with mcfg.exact_pose it is composed
    exactly, x -> R_reg (R x + t) + t_reg, and the scan is inserted at
    that pose, transformed once.

    Returns (state, diverged (bool), reg_steps (0-dim int32), info)."""
    dev = points.device
    with span("map.register"):
        pts = transforms.apply(points, state.R_cloud, state.t_cloud)
        diverged = False
        reg_steps = torch.zeros((), dtype=I32, device=dev)
        has_map = bool(state.n_patches > 0)        # the scan's read
        if register_scan and has_map:
            k = mcfg.reg_stride
            view, tables = registration_view(state, cfg)
            rstate, sub = registration.register(
                view, pts[::k], colors[::k], valid[::k], cfg, rcfg,
                depth_kp=depth_kp, depth_s20=depth_s20, tables=tables)
            R_cloud = transforms.matmul3(rstate.R_cloud, state.R_cloud)
            if mcfg.exact_pose:
                t_cloud = torch.matmul(rstate.R_cloud, state.t_cloud) \
                    + rstate.t_exact
                pts = transforms.apply(points, R_cloud, t_cloud)
            else:
                t_cloud = state.t_cloud + rstate.t_cloud
                pts = sub if k == 1 else transforms.apply(
                    pts, rstate.R_cloud, rstate.t_exact)
            state = state._replace(R_cloud=R_cloud, t_cloud=t_cloud)
            if mcfg.drop_on_reg_cap:
                diverged = int(rstate.step_nbr) >= rcfg.max_steps
            reg_steps = rstate.step_nbr
    if diverged:                               # drop the scan (:22-27)
        count("map.dropped")
        return state, diverged, reg_steps, _zero_info(dev)
    min_nbr = mcfg.min_points_new_patch if has_map else 1
    state, info = map_insert(state, pts, colors, valid, cfg, mcfg, min_nbr,
                             depth_kp=depth_kp, depth_s20=depth_s20,
                             depth_eps=depth_eps)
    return state, diverged, reg_steps, info


def add_clouds(state: MapState, points, colors, valid, cfg: CompressorConfig,
               mcfg: MappingConfig,
               rcfg: RegistrationConfig = RegistrationConfig(),
               depth_kp=None, depth_s20=None, depth_eps=None):
    """Fold a batch of scans into the map, one add_cloud_fused each.

    points / colors: [S, N, 3]; valid: [S, N] (or sequences of per-scan
    tensors). Returns (state, diverged [S] bool on the host, reg_steps [S]
    int32, info dict of per-scan [S] int32 counters, see map_insert)."""
    dvg, steps, infos = [], [], []
    for p, c, v in zip(points, colors, valid):
        state, d, s, info = add_cloud_fused(
            state, p, c, v, cfg, mcfg, rcfg=rcfg, depth_kp=depth_kp,
            depth_s20=depth_s20, depth_eps=depth_eps)
        dvg.append(d)
        steps.append(s)
        infos.append(info)
    info = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    return state, torch.tensor(dvg, dtype=torch.bool), torch.stack(steps), \
        info


def add_cloud(state: MapState, points, colors, valid, cfg: CompressorConfig,
              mcfg: MappingConfig,
              rcfg: RegistrationConfig = RegistrationConfig(),
              register_scan: bool = True):
    """Host-facing wrapper over add_cloud_fused: the info dict as Python
    numbers, the counters in key order (as JAX's jitted dict returns
    them, so that a printed info reads the same)."""
    state, diverged, reg_steps, counters = add_cloud_fused(
        state, points, colors, valid, cfg, mcfg, rcfg=rcfg,
        register_scan=register_scan)
    info = {"diverged": diverged, "reg_steps": int(reg_steps)}
    info.update({k: int(counters[k]) for k in sorted(counters)})
    if not diverged:
        info["n_patches"] = int(state.n_patches)
    return state, info


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------

def train_occupancy(state: MapState, cfg: CompressorConfig, perm=None,
                    generator: torch.Generator = None, occ_cfg=None):
    """Train the probit occupancy channel: per patch, every observed grid
    cell is a labelled example in the (u, v) plane, hit cells (W & ~free)
    occupied (+1), carved cells (free) empty (-1), and a probit-noise
    sparse GP per patch gives an occupancy field over the patch. Plain
    torch (the fused kernel takes Gaussian noise only).

    Each patch's G cells train in a uniformly random order: perm [B, G]
    gives it (JAX draws `permutation(split(key, B)[b], G)`), else it is
    drawn from `generator` (seed 0 when None). Returns the SOGPState
    bank."""
    B, G = state.W.shape
    dt, dev = state.means.dtype, state.means.device
    if occ_cfg is None:
        occ_cfg = dataclasses.replace(cfg.depth_gp, dout=1, sigmaf_sq=1.0,
                                      s20=1.0, eps_tol=1e-3)
    if perm is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        perm = patches_mod._bank_perm(patches_mod.draw_shuffle_bits(
            B, G, dev, generator))
    p = perm.long().to(dev)
    grid_uv = patches_mod.prediction_grid(cfg.patch, dt, dev)       # [G, 2]
    y = torch.where(state.W & ~state.free, 1.0, -1.0).to(dt)
    mask = (state.W | state.free) & state.created[:, None]
    X = grid_uv[p]                                                  # [B,G,2]
    y = torch.take_along_dim(y, p, dim=1)[..., None]
    mask = torch.take_along_dim(mask, p, dim=1)
    kp = RBFParams(sigmaf_sq=_full(occ_cfg.sigmaf_sq, state.means),
                   l_sq=_full(occ_cfg.l_sq, state.means))
    noise = ProbitNoise(s20=_full(occ_cfg.s20, state.means))
    states = sparse_gp.init_batch(occ_cfg, B, device=dev)
    states = sparse_gp.add_points_batch(kp, noise, occ_cfg, states, X, y, mask)
    states, _ = sparse_gp.sanitize_batch(states, kp, occ_cfg.s20)
    return states


def predict_occupancy(occ_states: SOGPState, cfg: CompressorConfig, Xstar,
                      sigmaf_sq=1.0, l_sq=1.0, s20=1.0):
    """Occupancy probability by the probit link on the latent mean:
    P(occupied) = Phi(mu / sqrt(1 + var)). Xstar: [B, m, 2]."""
    kp = RBFParams(sigmaf_sq=_full(sigmaf_sq, Xstar),
                   l_sq=_full(l_sq, Xstar))
    mean, var = sparse_gp.predict_batch(kp, s20, occ_states, Xstar)
    return torch.special.ndtr(mean[..., 0] / torch.sqrt(1.0 + var))


def smc_refine_pose(state: MapState, points, colors, valid,
                    cfg: CompressorConfig, smc_cfg: SMCConfig,
                    n_iters: int = 8, n_eval_points: int = 2048,
                    depth_kp=None, depth_s20=None,
                    generator: Optional[torch.Generator] = None,
                    draws=None):
    """SMC refinement of a scan pose against the map: a particle population
    over 6-DoF pose perturbations, weighted by the GP log-density of a
    subsample of the scan (n_eval_points points at evenly spaced indices)
    under each particle's pose, resampled systematically and jittered for
    n_iters steps (inference.smc). Unclaimed points score an outlier floor
    (the log density of a ~3-sigma prior outlier), so that pushing points
    out of claim range cannot raise the likelihood.

    The map's grid predictions are computed once; each particle's points
    are claimed against the map's stored tables (nm refreshed from its
    frames and means), all particles' points in one claim call, and score
    the nearest grid cell of their patch. Nothing is read back.
    draws: (init normals [P, 6], inference.smc.SMCDraws with a leading
    [n_iters] dim); else drawn from `generator` (seed 0 when None).
    Returns ((R [3, 3], t [3]) of the final weighted-mean pose, the
    particle state, the max log-weight of each step [n_iters])."""
    from gp_compressor_tpu_torch.inference import smc as smc_mod

    comp, tables = registration_view(state, cfg)
    dt, dev = points.dtype, points.device
    dkp, _ = default_params(cfg, dev)
    dkp = dkp if depth_kp is None else depth_kp
    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    P = smc_cfg.num_particles
    if draws is None:
        g = smc_mod._generator(generator, dev)
        init_normals = torch.randn((P, 6), generator=g, dtype=dt, device=dev)
        steps = smc_mod.draw_steps(n_iters, P, dt, dev, g)
    else:
        init_normals, steps = draws

    N = points.shape[0]
    n = min(n_eval_points, N)
    sel = torch.linspace(0, N - 1, n, dtype=torch.float64,
                         device=dev).to(torch.int64)
    pts_s, val_s = points[sel], valid[sel]

    B = comp.patch.rotations.shape[0]
    G = cfg.patch.sz ** 2
    grid_uv = patches_mod.prediction_grid(cfg.patch, dt, dev)
    dmean, dvar = sparse_gp.predict_batch(dkp, d_s20, comp.depth_gp,
                                          grid_uv.expand(B, G, 2))
    dmean = dmean[..., 0]                                    # [B, G]
    res = torch.as_tensor(cfg.patch.res, dtype=dt)
    floor = -0.5 * torch.log(2 * torch.pi * (dkp.sigmaf_sq + d_s20)) - 4.5

    def pose_loglik(poses):
        R, t = smc_mod.pose_matrices(poses)
        moved = torch.matmul(pts_s, R.transpose(1, 2)) + t[:, None, :]
        claim, loc, claimed = registration.claim_with_tables(
            tables, comp.patch.grid, moved.reshape(-1, 3),
            val_s.repeat(poses.shape[0]), cfg.patch.res, out_fill=B)
        gidx = torch.where(claimed, claim, 0).long()
        cell = patches_mod.grid_cell(loc[:, 1:], res, cfg.patch.sz).long()
        mu, var = dmean[gidx, cell], dvar[gidx, cell]
        ll = -0.5 * torch.log(2 * torch.pi * var) \
            - 0.5 * (loc[:, 0] - mu) ** 2 / var
        ll = torch.where(claimed & val_s.repeat(poses.shape[0]), ll, floor)
        return torch.sum(ll.reshape(poses.shape[0], -1), dim=1)

    st = smc_mod.init_particles(smc_cfg, normals=init_normals)
    trace = []
    for i in range(n_iters):
        st, mean_pose = smc_mod.smc_step(st, pose_loglik, smc_cfg, draws=
                                         smc_mod.SMCDraws(steps.normals[i],
                                                          steps.u0[i]))
        trace.append(torch.max(st.log_weights))
    if not n_iters:
        mean_pose = torch.zeros(6, dtype=dt, device=dev)
    R, t = smc_mod.pose_matrices(mean_pose[None])
    return (R[0], t[0]), st, torch.stack(trace) if trace else \
        torch.zeros((0,), dtype=dt, device=dev)


def map_cloud(state: MapState, cfg: CompressorConfig, depth_kp=None,
              depth_s20=None):
    """Predict the whole map as a cloud (load_compressed over the map's
    banks). Returns (points [B*G, 3], colours [B*G, 3], valid [B*G])."""
    B = state.rotations.shape[0]
    G = cfg.patch.sz ** 2
    dt, dev = state.means.dtype, state.means.device
    dkp, ckp = default_params(cfg, dev)
    dkp = dkp if depth_kp is None else depth_kp
    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    q = patches_mod.prediction_grid(cfg.patch, dt, dev).expand(B, G, 2)
    dmean, _ = sparse_gp.predict_batch(dkp, d_s20, state.depth_gp, q)
    cmean, _ = sparse_gp.predict_batch(ckp, cfg.rgb_gp.s20, state.rgb_gp, q)
    local = torch.cat([dmean, q], dim=-1)
    world = torch.matmul(local, state.rotations.transpose(1, 2)) \
        + state.means[:, None, :]
    cols = cmean + state.rgb_means[:, None, :]
    cols = torch.clamp(torch.where(torch.isfinite(cols), cols, 255.0),
                       0.0, 255.0)
    okp = (state.created & (sparse_gp.size(state.depth_gp) > 0))[:, None]
    return (world.reshape(-1, 3), cols.reshape(-1, 3),
            okp.expand(B, G).reshape(-1))
