"""K-SVD compression workload (no GPs): the reference's second pipeline.

The port of `gp_compressor_tpu.workloads.ksvd_compressor`
(src/pointcloud_compressor.cpp, src/pointcloud_decompressor.cpp):
rasterize the patches to grid images, learn masked dictionaries for depth
and for the stacked RGB channels by K-SVD, write the artifact, and
reconstruct by summing the sparse codes and reprojecting the occupied
cells.

The random data rows of the atom replacement come from a
`torch.Generator` (seed 0 when none is given; depth draws first, then
RGB) or from explicit draws, a (depth, RGB) pair of
`dictionary.KSVDDraws`.

Spans: `ksvd.compress` holds `ksvd.front_end` (the raster) and one
`ksvd.depth` and one `ksvd.rgb` (each `dictionary.ksvd` call, whose
sweeps have spans of their own); `ksvd.decompress` is the decompression.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gp_compressor_tpu_torch.config import CompressorConfig
from gp_compressor_tpu_torch.geometry import patches as patches_mod
from gp_compressor_tpu_torch.geometry import rotation
from gp_compressor_tpu_torch.io.artifact import Artifact
from gp_compressor_tpu_torch.models import dictionary
from gp_compressor_tpu_torch.models.dictionary import KSVDResult
from gp_compressor_tpu_torch.utils.profiling import span


class KSVDCompressed(NamedTuple):
    """The in-memory form of the .pccode/.pcdict artifact (schema:
    src/dictionary_representation.h:12-41)."""

    raster: patches_mod.RasterBatch
    depth: KSVDResult            # dictionary [G, K] + codes over patches
    rgb: KSVDResult              # stacked channels: 3B patch rows
    cfg: CompressorConfig


def rgb_problem(raster: patches_mod.RasterBatch, pvalid: torch.Tensor):
    """The stacked RGB problem of compress_colors: 3B rows of length G,
    channel-major, the mask and validity replicated. Returns (S, W,
    valid)."""
    S = torch.cat([raster.RGB[:, :, 0], raster.RGB[:, :, 1],
                   raster.RGB[:, :, 2]], dim=0)
    W = torch.cat([raster.W] * 3, dim=0).to(raster.S.dtype)
    return S, W, torch.cat([pvalid] * 3, dim=0)


@span("ksvd.compress")
def compress(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
             cfg: CompressorConfig,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Tuple[dictionary.KSVDDraws,
                                   dictionary.KSVDDraws]] = None,
             verbose: bool = False) -> KSVDCompressed:
    """pointcloud_compressor::save_compressed minus the file write."""
    with span("ksvd.front_end"):
        raster = patches_mod.build_raster_patches(points, colors, valid,
                                                  cfg.patch)
    B = raster.S.shape[0]
    pvalid = torch.arange(B, device=points.device) < raster.n_leaves
    if draws is None and generator is None:
        generator = torch.Generator(device=points.device).manual_seed(0)
    dd, dc = (None, None) if draws is None else draws
    with span("ksvd.depth"):
        depth = dictionary.ksvd(raster.S, raster.W.to(raster.S.dtype),
                                pvalid, cfg.ksvd, generator=generator,
                                draws=dd, verbose=verbose)
    with span("ksvd.rgb"):
        rgb = dictionary.ksvd(*rgb_problem(raster, pvalid), cfg.rgb_ksvd,
                              generator=generator, draws=dc, verbose=verbose)
    return KSVDCompressed(raster=raster, depth=depth, rgb=rgb, cfg=cfg)


@span("ksvd.decompress")
def decompress(comp: KSVDCompressed):
    """pointcloud_decompressor::load_compressed minus the file read.
    Returns (points [B*G, 3], colors [B*G, 3], valid [B*G])."""
    raster = comp.raster
    B = raster.S.shape[0]
    S_rec = dictionary.reconstruct(comp.depth.D, comp.depth.code)   # [B, G]
    RGB_flat = dictionary.reconstruct(comp.rgb.D, comp.rgb.code)    # [3B, G]
    RGB_rec = torch.stack([RGB_flat[:B], RGB_flat[B:2 * B],
                           RGB_flat[2 * B:]], dim=-1)               # [B, G, 3]
    return patches_mod.raster_reproject(raster, S_rec, RGB_rec,
                                        comp.cfg.patch.sz, comp.cfg.patch.res)


def to_artifact(comp: KSVDCompressed) -> Artifact:
    """Strip the padding and convert to the host-side artifact record."""
    raster = comp.raster
    n = int(raster.n_leaves)
    B = raster.S.shape[0]
    host = lambda t, dt: t.detach().cpu().numpy().astype(dt)
    quats = rotation.matrix_to_quaternion(raster.rotations[:n])
    rgb_sel = np.concatenate([np.arange(n), B + np.arange(n),
                              2 * B + np.arange(n)])
    return Artifact(
        res=float(comp.cfg.patch.res), sz=comp.cfg.patch.sz,
        D=host(comp.depth.D, np.float32),
        RGB_D=host(comp.rgb.D, np.float32),
        words_max=comp.cfg.ksvd.words_max,
        RGB_words_max=comp.cfg.rgb_ksvd.words_max,
        means=host(raster.means[:n], np.float32),
        quats=host(quats, np.float32),
        rgb_means=host(raster.rgb_means[:n], np.float32),
        X=host(comp.depth.code.X[:n], np.float32),
        I=host(comp.depth.code.I[:n], np.int32),
        nw=host(comp.depth.code.nw[:n], np.int32),
        RGB_X=host(comp.rgb.code.X, np.float32)[rgb_sel],
        RGB_I=host(comp.rgb.code.I, np.int32)[rgb_sel],
        RGB_nw=host(comp.rgb.code.nw, np.int32)[rgb_sel],
        W=host(raster.W[:n], bool),
    )


def decompress_artifact(art: Artifact) -> Tuple[np.ndarray, np.ndarray]:
    """Reconstruct a cloud from a (possibly file-loaded) artifact: the
    standalone pointcloud_decompressor path, on the host in NumPy.
    Returns (points [m, 3], colors [m, 3])."""
    n = art.means.shape[0]
    G = art.sz * art.sz
    usek = np.arange(art.words_max)[None, :] < art.nw[:, None]
    S = np.einsum('nk,lnk->nl', art.X * usek, art.D[:, art.I])
    usek3 = np.arange(art.RGB_words_max)[None, :] < art.RGB_nw[:, None]
    RGBf = np.einsum('nk,lnk->nl', art.RGB_X * usek3, art.RGB_D[:, art.RGB_I])
    pts = []
    cols = []
    Rms = rotation.quaternion_to_matrix(torch.from_numpy(
        np.asarray(art.quats))).numpy()
    m = np.arange(G)
    x, y = m // art.sz, m % art.sz
    u = (x + 0.5) * art.res / art.sz - art.res / 2.0
    v = (y + 0.5) * art.res / art.sz - art.res / 2.0
    for i in range(n):
        occ = art.W[i]
        local = np.stack([S[i, occ], u[occ], v[occ]], axis=-1)
        pts.append(local @ Rms[i].T + art.means[i])
        c = np.stack([RGBf[i, occ], RGBf[n + i, occ], RGBf[2 * n + i, occ]],
                     axis=-1) + art.rgb_means[i]
        cols.append(np.clip(c, 0, 255))
    return np.concatenate(pts), np.concatenate(cols)


def rms_error(comp: KSVDCompressed) -> float:
    """In-sample RMS at the projected points against the reconstructed
    cell values (pointcloud_compressor::compute_rms_error)."""
    raster = comp.raster
    S_rec = dictionary.reconstruct(comp.depth.D, comp.depth.code)      # [B, G]
    claimed = raster.claims >= 0
    idx = torch.where(claimed, raster.claims, 0).long()
    rec = S_rec[idx, raster.cells.long()]
    err2 = torch.where(claimed, (rec - raster.depth_demeaned) ** 2, 0.0)
    n = torch.clamp(torch.sum(claimed), min=1)
    return float(torch.sqrt(torch.sum(err2) / n))
