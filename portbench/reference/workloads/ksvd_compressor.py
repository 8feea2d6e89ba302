"""The dictionary codec's round trip: raster, two K-SVDs, decompression.

Written from the source's description (SURVEY.md §2.2–2.3, §3.2:
`pointcloud_compressor`, `pointcloud_decompressor`):

  * raster (`project_points`): the patches' plane fits and claims of the
    GP path (`geometry.patches.claim_points`), then each claimed point
    falls into one of the sz x sz cells of its patch's plane; a cell holds
    the mean depth and colour of its points, W marks the occupied cells;
    each patch's depth and colours are demeaned by their mean over all
    sz^2 cells (an empty cell counts as 0), and the depth mean moves the
    patch's centre along its normal;
  * `compress_depths`: K-SVD on the depth rows; `compress_colors`: K-SVD
    on the three colour channels stacked as rows (channel-major), the
    mask replicated;
  * decompression (`decompress_depths`, `reproject_cloud`): each row is
    the sum of its words, each occupied cell of a real patch one world
    point at its cell centre; colours get the patch's mean back, a
    non-finite colour becomes 255 and all are clamped to [0, 255];
  * `compute_rms_error`: the RMS over the claimed points of the depth
    reconstructed in their cell against their own demeaned depth; the
    same over the colour channels for colour.

Departures: the cell sums accumulate in float64 (the source keeps a
float32 running mean); the random rows of the atom replacement are given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.config import PatchConfig
from portbench.reference.geometry import patches
from portbench.reference.models import dictionary
from portbench.reference.models.dictionary import KSVDConfig, KSVDResult


@dataclasses.dataclass(frozen=True)
class KSVDCompressorConfig:
    patch: PatchConfig
    ksvd: KSVDConfig
    rgb_ksvd: KSVDConfig


class Raster(NamedTuple):
    """B = max_patches rows of G = sz^2 cells."""

    rotations: torch.Tensor      # [B, 3, 3] plane frames (col 0 = normal)
    means: torch.Tensor          # [B, 3] centres moved by the depth mean
    rgb_means: torch.Tensor      # [B, 3]
    S: torch.Tensor              # [B, G] demeaned depth
    RGB: torch.Tensor            # [B, G, 3] demeaned colour
    W: torch.Tensor              # [B, G] bool occupancy
    n_leaves: torch.Tensor       # 0-dim: rows that are patches
    claims: torch.Tensor         # [N] claiming patch, -1 for none
    cells: torch.Tensor          # [N] cell of each point in its patch
    depth_demeaned: torch.Tensor  # [N] depth minus the patch's mean


class KSVDCompressed(NamedTuple):
    raster: Raster
    depth: KSVDResult
    rgb: KSVDResult


def raster(points, colors, valid, cfg: PatchConfig,
           dtype: torch.dtype = None) -> Raster:
    """project_points over every patch (dtype: the raster's, default the
    points')."""
    dt = dtype or points.dtype
    B, sz = cfg.max_patches, cfg.sz
    G = sz * sz
    grid, R, centers, claim, loc, claimed = patches.claim_points(
        points, valid, cfg)
    cell = patches.grid_cell(loc[:, 1:], grid.res, sz)
    row = torch.where(claimed, claim, 0).long()
    flat = row * G + cell.long()
    one = claimed.double()
    payload = torch.cat([one[:, None], (loc[:, 0].double() * one)[:, None],
                         colors.double() * one[:, None]], dim=1)
    sums = torch.zeros((B * G, 5), dtype=torch.float64,
                       device=points.device).index_add_(0, flat, payload)
    cnt = sums[:, 0]
    mean = sums[:, 1:] / torch.clamp(cnt, min=1.0)[:, None]
    S = mean[:, 0].reshape(B, G)
    RGB = mean[:, 1:].reshape(B, G, 3)
    mn = S.mean(dim=1)
    cmn = RGB.mean(dim=1)
    return Raster(
        rotations=R.to(dt),
        means=(centers.double() + mn[:, None] * R[:, :, 0].double()).to(dt),
        rgb_means=cmn.to(dt), S=(S - mn[:, None]).to(dt),
        RGB=(RGB - cmn[:, None, :]).to(dt), W=(cnt > 0).reshape(B, G),
        n_leaves=grid.n_leaves,
        claims=torch.where(claimed, claim, -1).long(), cells=cell.long(),
        depth_demeaned=(loc[:, 0].double() - mn[row]).to(dt))


def rgb_rows(R: Raster):
    """The stacked colour problem: (S [3B, G], W [3B, G])."""
    return (torch.cat([R.RGB[..., c] for c in range(3)], dim=0),
            torch.cat([R.W] * 3, dim=0))


def patch_rows(R: Raster) -> torch.Tensor:
    """[B] bool: the rows that are patches."""
    return torch.arange(R.S.shape[0], device=R.S.device) < int(R.n_leaves)


def compress(points, colors, valid, cfg: KSVDCompressorConfig, draws,
             dtype: torch.dtype = None) -> KSVDCompressed:
    """pointcloud_compressor::save_compressed minus the file write. draws:
    ((init, sweeps) of the depth K-SVD, (init, sweeps) of the colour
    one). dtype: the raster's and the K-SVDs' (default the points')."""
    R = raster(points, colors, valid, cfg.patch, dtype)
    ok = patch_rows(R)
    depth = dictionary.ksvd(R.S, R.W, ok, cfg.ksvd, *draws[0])
    S3, W3 = rgb_rows(R)
    rgb = dictionary.ksvd(S3, W3, torch.cat([ok] * 3), cfg.rgb_ksvd,
                          *draws[1])
    return KSVDCompressed(raster=R, depth=depth, rgb=rgb)


def reconstruct_rows(comp):
    """(depth [B, G], colour [B, G, 3]) summed from the codes."""
    S = dictionary.reconstruct(comp.depth.D, comp.depth.code)
    C = dictionary.reconstruct(comp.rgb.D, comp.rgb.code)
    B = S.shape[0]
    return S, torch.stack([C[:B], C[B:2 * B], C[2 * B:]], dim=-1)


def decompress(comp, sz: int, res: float):
    """pointcloud_decompressor::load_compressed minus the file read:
    (points [B*G, 3], colours [B*G, 3], valid [B*G]): one point per cell
    (cell = sz * x + y, x along u), valid at the occupied cells of the
    patches."""
    R = comp.raster
    S, C = reconstruct_rows(comp)
    B, G = S.shape
    dt, dev = S.dtype, S.device
    m = torch.arange(G, device=dev)
    u = ((m // sz).to(dt) + 0.5) * res / sz - res / 2
    v = ((m % sz).to(dt) + 0.5) * res / sz - res / 2
    local = torch.stack([S, u.expand(B, G), v.expand(B, G)], dim=-1)
    world = local @ R.rotations.transpose(1, 2) + R.means[:, None, :]
    col = C + R.rgb_means[:, None, :]
    col = torch.clamp(torch.where(torch.isfinite(col), col, 255.0), 0, 255)
    ok = R.W & patch_rows(R)[:, None]
    return world.reshape(B * G, 3), col.reshape(B * G, 3), ok.reshape(B * G)


def rms_errors(comp, colors) -> tuple:
    """compute_rms_error: (depth RMS in m, colour RMS in 0-255 units) over
    the claimed points (colors: the cloud's [N, 3])."""
    R = comp.raster
    S, C = reconstruct_rows(comp)
    got = R.claims >= 0
    row, cell = R.claims[got].long(), R.cells[got].long()
    d = S[row, cell].double() - R.depth_demeaned[got].double()
    c = (C[row, cell].double() + R.rgb_means[row].double()
         - colors[got].double())
    return (float(torch.sqrt(torch.mean(d * d))),
            float(torch.sqrt(torch.mean(c * c))))
