"""GP compression / decompression workload: the parts the checks call.

The port of `gp_compressor_tpu.workloads.compressor` (main path): project
the cloud into per-voxel patches (`project`), check the trained GPs
(`sanitize`), and regenerate the cloud by predicting both GPs on a
regular sz x sz grid per patch and rotating back to world coordinates
(`decompress`). Training is the caller's (the per-point loop of
`cuda_kernels.sogp_train`). The calibration's subsample and log
posterior (`_calib_logpost`) feed `inference.hmc.map_estimate_multi`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference.config import CompressorConfig
from portbench.reference.geometry import patches as patches_mod
from portbench.reference.models import sparse_gp
from portbench.reference.models.sparse_gp import SOGPState
from portbench.reference.ops.kernels import RBFParams


class CompressedCloud(NamedTuple):
    """The in-memory compressed artifact: patch geometry + GP states."""

    patch: patches_mod.PatchBatch
    depth_gp: SOGPState    # batched [B, ...]
    rgb_gp: SOGPState      # batched [B, ...]


def default_params(cfg: CompressorConfig,
                   device="cuda") -> Tuple[RBFParams, RBFParams]:
    """The configs' kernel constants as 0-dim tensors of each GP's dtype
    (filled on the device: no host-to-device copy)."""
    def kp(g):
        t = lambda v: torch.full((), v, dtype=g.dtype, device=device)
        return RBFParams(sigmaf_sq=t(g.sigmaf_sq), l_sq=t(g.l_sq))

    return kp(cfg.depth_gp), kp(cfg.rgb_gp)


def project(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
            cfg: CompressorConfig) -> patches_mod.PatchBatch:
    """project_cloud equivalent (src/gp_compressor.cpp:177-249)."""
    return patches_mod.build_patches(points, colors, valid, cfg.patch)


def sanitize(batch: patches_mod.PatchBatch, cfg: CompressorConfig,
             dstates: SOGPState, cstates: SOGPState, depth_kp: RBFParams,
             rgb_kp: RBFParams, depth_s20, full_probes: bool = False):
    """Reset diverged patches of both banks; returns (dstates, cstates,
    n_bad_depth, n_bad_rgb).

    A 1/5 subsample of the prediction grid suffices as health probes when
    the length-scale covers the patch footprint (a diverged patch then
    blows up everywhere); below it (l^2 < res^2) the full grid is probed.
    Health bounds sit ~10x beyond any legitimate posterior: depth within
    +-res of the patch plane, colours within +-255 of the mean."""
    grid = patches_mod.prediction_grid(cfg.patch, batch.X.dtype,
                                       batch.X.device)
    dfull = full_probes or cfg.depth_gp.l_sq < cfg.patch.res ** 2
    dprobes = grid if dfull else grid[::5]
    cprobes = grid[::5] if cfg.rgb_gp.l_sq >= cfg.patch.res ** 2 else grid
    dstates, n_bad_d = sparse_gp.sanitize_batch(
        dstates, depth_kp, depth_s20, max_pred=10.0 * cfg.patch.res,
        probes=dprobes)
    cstates, n_bad_c = sparse_gp.sanitize_batch(
        cstates, rgb_kp, cfg.rgb_gp.s20, max_pred=2.5e3, probes=cprobes)
    return dstates, cstates, n_bad_d, n_bad_c


def decompress(comp: CompressedCloud, cfg: CompressorConfig,
               depth_kp: Optional[RBFParams] = None,
               rgb_kp: Optional[RBFParams] = None, depth_s20=None):
    """load_compressed equivalent (src/gp_compressor.cpp:267-386).

    Returns (points [B*G, 3], colors [B*G, 3] in 0..255, valid [B*G],
    centers [B, 3], normals [B, 3], patch_ok [B])."""
    batch = comp.patch
    dkp, ckp = default_params(cfg, batch.X.device)
    depth_kp = depth_kp if depth_kp is not None else dkp
    rgb_kp = rgb_kp if rgb_kp is not None else ckp
    B = batch.mask.shape[0]
    grid_uv = patches_mod.prediction_grid(cfg.patch, batch.X.dtype,
                                          batch.X.device)            # [G,2]
    G = grid_uv.shape[0]
    queries = grid_uv.expand(B, G, 2)

    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    dmean, _ = sparse_gp.predict_batch(depth_kp, d_s20, comp.depth_gp,
                                       queries)                      # [B,G,1]
    cmean, _ = sparse_gp.predict_batch(rgb_kp, cfg.rgb_gp.s20, comp.rgb_gp,
                                       queries)                      # [B,G,3]

    world = patches_mod.reproject(batch, dmean[..., 0], grid_uv)     # [B,G,3]
    colors = cmean + batch.rgb_means[:, None, :]
    # flatten_colors semantics: NaN/inf -> 255, then clamp to [0, 255]
    colors = torch.where(torch.isfinite(colors), colors, 255.0)
    colors = torch.clamp(colors, 0.0, 255.0)

    # patches with an empty GP emit nothing
    patch_ok = (sparse_gp.size(comp.depth_gp) > 0) & \
        (torch.arange(B, device=batch.X.device) < batch.n_leaves)
    valid = patch_ok[:, None].expand(B, G)
    return (world.reshape(B * G, 3), colors.reshape(B * G, 3),
            valid.reshape(B * G), batch.means, batch.rotations[:, :, 0],
            patch_ok)


def calib_subsample(batch: patches_mod.PatchBatch, n_patches: int,
                    n_points: int):
    """A dense, spatially stratified calibration subsample of the banks:
    the n_patches patches with the most valid points (ties to the lower
    index, as lax.top_k), each one's valid points compacted to the front
    and strided (idx_j = floor(j * count / n)) when it has more than n, so
    that any bank order covers the patch's span.
    Returns (X [n_patches, n, 2], y [n_patches, n], mask [n_patches, n])."""
    counts = torch.sum(batch.mask, dim=1)
    top = torch.argsort(counts, descending=True, stable=True)[:n_patches]
    return _subsample_rows(batch.X[top], batch.y[top, :, 0],
                           batch.mask[top], n_points)


def _subsample_rows(Xb, yb, mb, n_points: int):
    """calib_subsample on the chosen rows: Xb [k, P, 2], yb, mb [k, P]."""
    order = torch.argsort((~mb).to(torch.uint8), dim=1, stable=True)
    cnt = torch.sum(mb, dim=1).to(torch.int32)
    j = torch.arange(n_points, dtype=torch.int32, device=mb.device)
    # stride only when the patch has more than n points; otherwise take
    # the compacted prefix as it is
    strided = torch.minimum(
        torch.div(j[None, :] * torch.clamp(cnt, min=1)[:, None], n_points,
                  rounding_mode='floor'),
        torch.clamp(cnt - 1, min=0)[:, None])
    pos = torch.where(cnt[:, None] > n_points, strided,
                      torch.clamp(j[None, :], max=order.shape[1] - 1))
    sel = torch.take_along_dim(order, pos.long(), dim=1)
    X = torch.take_along_dim(Xb, sel[:, :, None], dim=1)
    y = torch.take_along_dim(yb, sel, dim=1)
    m = torch.take_along_dim(mb, sel, dim=1) & (j[None, :] < cnt[:, None])
    return X, y, m


def _calib_logpost(batch, cfg: CompressorConfig, calib_patches, calib_points,
                   calib_dtype):
    from portbench.reference.inference import hmc

    B = min(calib_patches, batch.X.shape[0])
    n = min(calib_points, batch.X.shape[1])
    Xc, yc, mc = calib_subsample(batch, B, n)
    logpost = hmc.make_patch_logpost(Xc.to(calib_dtype), yc.to(calib_dtype),
                                     mc.to(calib_dtype))
    g = cfg.depth_gp
    theta0 = torch.tensor([math.log(g.sigmaf_sq), math.log(g.l_sq),
                           math.log(g.s20)], dtype=calib_dtype,
                          device=batch.X.device)
    return logpost, theta0

