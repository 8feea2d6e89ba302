"""GP compression / decompression workload.

The port of `gp_compressor_tpu.workloads.compressor` (main path): project
the cloud into per-voxel patches, train a depth sparse GP and an RGB field
GP per patch, then regenerate the cloud by predicting both GPs on a
regular sz x sz grid per patch and rotating back to world coordinates.

Training goes through the fused CUDA kernel (`cuda_kernels.sogp_train`)
when the banks are CUDA tensors, and through its plain PyTorch version
when they are CPU tensors. The banks carry their insertion order: a
deterministic `PatchConfig.bank_order`, or the `shuffle` order drawn at
bank time from an explicit `torch.Generator` (seed 0 when none is given).

The calibrated round trip (`compress_decompress_calibrated`) fits the
depth GP's (sigma_f^2, l^2, s20) by multi-start MAP on a subsample of the
banks and trains with the result; the calibrated values stay device
tensors from the ascent to the kernel's hyperparameter row, so a new
calibration reads nothing back to the host.

With `mesh=` (a (data, chain) `DeviceMesh`, see `parallel.mesh`) the
entry points run as one rank of an SPMD program on this rank's block of
the cloud (`shard_points` cuts one; JAX's P('data') on the points). The
front end runs on the block and calls collectives only for what is global
(the grid's bounds and leaf keys, the sphere moments), then routes each
claimed point to the owner of its patch row (`patches.build_patches`), so
no rank holds the whole point axis or the whole banks. Each rank trains
its [B / n_data, P] rows with the kernel (no collective inside, the
hyperparameter row whole), sanitizes and decompresses locally. The
returned cloud holds this rank's rows of the patch-banked leaves and of
both `SOGPState`s and its block's claims; the grid and `n_leaves` are
whole. `gather_cloud` gives back the whole cloud, `shard_cloud` cuts one.
The global sums are one all-reduce over the data group, and the MAP
starts are cut over `chain`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gp_compressor_tpu_torch.config import CompressorConfig, GPConfig
from gp_compressor_tpu_torch.cuda_kernels import sogp_train
from gp_compressor_tpu_torch.geometry import patches as patches_mod
from gp_compressor_tpu_torch.models import sparse_gp
from gp_compressor_tpu_torch.models.sparse_gp import SOGPState
from gp_compressor_tpu_torch.ops.kernels import RBFParams
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib
from gp_compressor_tpu_torch.utils.profiling import span

# the patch-banked leaves of a PatchBatch, the ones a mesh cuts (JAX's
# compressor._constrain_batch); grid, claims and n_leaves stay whole
BANK_LEAVES = ("rotations", "means", "rgb_means", "W", "X", "y", "rgb",
               "mask", "counts")


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


@span("front_end")
def project(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
            cfg: CompressorConfig, generator: torch.Generator = None,
            shuffle_bits: torch.Tensor = None,
            mesh=None) -> patches_mod.PatchBatch:
    """project_cloud equivalent (src/gp_compressor.cpp:177-249).
    generator / shuffle_bits: the `shuffle` bank order's random source
    (see patches.build_patches); without one the banks keep native order.
    mesh: points, colors and valid are this rank's block (shard_points),
    and the batch holds this rank's patch rows (see the module
    docstring)."""
    return patches_mod.build_patches(points, colors, valid, cfg.patch,
                                     generator=generator,
                                     shuffle_bits=shuffle_bits, mesh=mesh)


def shard_points(points, colors, valid, mesh):
    """This rank's block of a whole cloud, as the entry points take it
    under a mesh: rows point_rows(N, mesh) of each, the padding rows past
    N invalid (and zero)."""
    return (mesh_lib.point_block(points, mesh),
            mesh_lib.point_block(colors, mesh),
            mesh_lib.point_block(valid, mesh, fill=False))


def shard_batch(batch: patches_mod.PatchBatch,
                mesh) -> patches_mod.PatchBatch:
    """This rank's rows of the patch-banked leaves of a whole batch, and
    its block of the claims."""
    B = batch.mask.shape[0]
    return batch._replace(
        claims=mesh_lib.point_block(batch.claims, mesh, fill=-1),
        **{k: mesh_lib.shard_leading(getattr(batch, k), mesh, B)
           for k in BANK_LEAVES})


def shard_cloud(comp: CompressedCloud, mesh) -> CompressedCloud:
    """This rank's rows of a whole compressed cloud (its banks, both GP
    states and its block of the claims), as the entry points return it
    under a mesh."""
    B = comp.patch.mask.shape[0]
    return CompressedCloud(shard_batch(comp.patch, mesh),
                           mesh_lib.shard_leading(comp.depth_gp, mesh, B),
                           mesh_lib.shard_leading(comp.rgb_gp, mesh, B))


def gather_batch(batch: patches_mod.PatchBatch, mesh,
                 n_points: Optional[int] = None) -> patches_mod.PatchBatch:
    """The whole batch from every rank's rows and blocks (all-gathers over
    the data group; every rank gets it). n_points: the cloud's size, to
    drop the claims of the padding rows (kept when None)."""
    B = batch.mask.shape[0] * mesh_lib.axis_size(mesh, "data")
    claims = mesh_lib.all_gather_rows(batch.claims, mesh)[:n_points]
    return batch._replace(claims=claims, **{
        k: mesh_lib.gather_leading(getattr(batch, k), mesh, B)
        for k in BANK_LEAVES})


def gather_cloud(comp: CompressedCloud, mesh,
                 n_points: Optional[int] = None) -> CompressedCloud:
    """The whole compressed cloud from every rank's rows and blocks (see
    gather_batch), for tests, checkpoints and the command line."""
    B = comp.patch.mask.shape[0] * mesh_lib.axis_size(mesh, "data")
    g = lambda t: mesh_lib.gather_leading(t, mesh, B)
    return CompressedCloud(gather_batch(comp.patch, mesh, n_points),
                           g(comp.depth_gp), g(comp.rgb_gp))


def _shuffle_source(points, cfg: CompressorConfig, generator, shuffle_bits):
    """The generator the compress entry points draw the `shuffle` order
    from: the caller's, or one seeded 0 (None where no draw happens)."""
    if cfg.patch.bank_order != "shuffle" or shuffle_bits is not None \
            or generator is not None:
        return generator
    return torch.Generator(device=points.device).manual_seed(0)


def bank_permutations(B: int, P: int, device="cuda",
                      generator: torch.Generator = None):
    """(depth, rgb) per-patch uniform permutations [B, P] of the banks'
    rows, for training banks that were not shuffled at bank time."""
    return tuple(patches_mod._bank_perm(patches_mod.draw_shuffle_bits(
        B, P, device, generator)) for _ in range(2))


def train_gp(batch: patches_mod.PatchBatch, gpcfg: GPConfig, kp: RBFParams,
             Y: torch.Tensor, use_kernel: Optional[bool] = None, s20=None,
             eps_tol=None, geom=None) -> SOGPState:
    """Train one bank of patch GPs (depth or RGB) on the batch's banks.

    use_kernel: None = the kernel's wrapper, which launches the kernel for
    CUDA banks and takes its plain version for CPU banks; False = the
    plain version; True = the kernel (raises for CPU banks)."""
    states = sparse_gp.init_batch(gpcfg, batch.mask.shape[0],
                                  device=batch.X.device)
    if use_kernel and not batch.X.is_cuda:
        raise ValueError("use_kernel=True needs CUDA banks")
    train = (sogp_train.add_points_batch_plain if use_kernel is False
             else sogp_train.add_points_batch_cuda)
    return train(kp, gpcfg, states, batch.X, Y, batch.mask, s20=s20,
                 eps_tol=eps_tol, geom=geom)


@span("sanitize")
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


def train(batch: patches_mod.PatchBatch, cfg: CompressorConfig,
          depth_kp: Optional[RBFParams] = None,
          rgb_kp: Optional[RBFParams] = None,
          use_kernel: Optional[bool] = None,
          depth_s20=None, depth_eps=None, full_probes: bool = False,
          geom=None, perm=None, mesh=None) -> CompressedCloud:
    """train_processes equivalent (src/gp_compressor.cpp:121-175): feed each
    patch's banked points into its depth GP and RGB field GP, then sanitize.

    depth_s20 / depth_eps: overrides of the depth GP's noise floor and
    novelty threshold (data, not constants: they ride the kernel's
    hyperparameter row). geom: (dmin, max_bv, gamma_min_rel) override of
    the geometric novelty mode. use_kernel: see train_gp. perm: optional
    (depth, rgb) per-patch permutations [B, P] of the bank rows, the
    insertion order of banks that were not shuffled at bank time (see
    bank_permutations); the returned cloud keeps the unpermuted banks.
    mesh: optional (data, chain) mesh; the batch and perm are this rank's
    rows (as project(mesh=) returns them; shard_batch cuts a whole one),
    trained as they are: training is per patch."""
    if mesh is not None:
        rows = cfg.patch.max_patches // mesh_lib.axis_size(mesh, "data")
        if batch.mask.shape[0] != rows:
            raise ValueError(f"train(mesh=) takes this rank's {rows} patch "
                             f"rows, got {batch.mask.shape[0]}")
    dkp, ckp = default_params(cfg, batch.X.device)
    depth_kp = depth_kp if depth_kp is not None else dkp
    rgb_kp = rgb_kp if rgb_kp is not None else ckp
    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    dbatch = cbatch = batch
    if perm is not None:
        def take(a, p):
            p = p.long()
            return torch.take_along_dim(
                a, p.reshape(p.shape + (1,) * (a.ndim - 2)), dim=1)

        pd, pc = perm
        dbatch = batch._replace(X=take(batch.X, pd), y=take(batch.y, pd),
                                mask=take(batch.mask, pd))
        cbatch = batch._replace(X=take(batch.X, pc), rgb=take(batch.rgb, pc),
                                mask=take(batch.mask, pc))
    with span("train.depth"):
        dstates = train_gp(dbatch, cfg.depth_gp, depth_kp, dbatch.y,
                           use_kernel, s20=depth_s20, eps_tol=depth_eps,
                           geom=geom)
    with span("train.rgb"):
        cstates = train_gp(cbatch, cfg.rgb_gp, rgb_kp, cbatch.rgb,
                           use_kernel, geom=geom)
    dstates, cstates, _, _ = sanitize(batch, cfg, dstates, cstates, depth_kp,
                                      rgb_kp, d_s20, full_probes)
    return CompressedCloud(patch=batch, depth_gp=dstates, rgb_gp=cstates)


@span("decompress")
def decompress(comp: CompressedCloud, cfg: CompressorConfig,
               depth_kp: Optional[RBFParams] = None,
               rgb_kp: Optional[RBFParams] = None, depth_s20=None,
               mesh=None):
    """load_compressed equivalent (src/gp_compressor.cpp:267-386).

    Returns (points [B*G, 3], colors [B*G, 3] in 0..255, valid [B*G],
    centers [B, 3], normals [B, 3], patch_ok [B]). mesh: comp holds this
    rank's rows (see the module docstring), and so do the outputs."""
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

    # patches with an empty GP emit nothing; ids are global under a mesh
    first = 0 if mesh is None else mesh_lib.axis_index(mesh, "data") * B
    patch_ok = (sparse_gp.size(comp.depth_gp) > 0) & \
        (torch.arange(first, first + B, device=batch.X.device)
         < batch.n_leaves)
    valid = patch_ok[:, None].expand(B, G)
    return (world.reshape(B * G, 3), colors.reshape(B * G, 3),
            valid.reshape(B * G), batch.means, batch.rotations[:, :, 0],
            patch_ok)


def reconstruction_rmse(comp: CompressedCloud, cfg: CompressorConfig,
                        depth_kp: Optional[RBFParams] = None,
                        depth_s20=None, mesh=None) -> torch.Tensor:
    """In-sample depth RMS over the actual projected points (0-dim).
    mesh: comp holds this rank's rows; [sum err^2, sum mask] is
    all-reduced over the data group as one tensor before the root, so
    every rank returns the global value."""
    batch = comp.patch
    dkp, _ = default_params(cfg, batch.X.device)
    depth_kp = depth_kp if depth_kp is not None else dkp
    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    mean, _ = sparse_gp.predict_batch(depth_kp, d_s20, comp.depth_gp,
                                      batch.X)                       # [B,P,1]
    err2 = torch.sum(torch.where(batch.mask,
                                 (mean[..., 0] - batch.y[..., 0]) ** 2, 0.0))
    n = torch.sum(batch.mask)
    if mesh is not None:
        err2, n = mesh_lib.all_reduce_sum(
            torch.stack([err2, n.to(err2.dtype)]), mesh).unbind()
    return torch.sqrt(err2 / torch.clamp(n, min=1))


def compress(points, colors, valid, cfg: CompressorConfig,
             use_kernel: Optional[bool] = None, geom=None,
             generator: torch.Generator = None,
             shuffle_bits: torch.Tensor = None,
             mesh=None) -> CompressedCloud:
    """Full save_compressed pipeline: project, then train. The `shuffle`
    bank order draws from `generator` (seed 0 when None) unless
    shuffle_bits gives the draw; under a mesh every rank draws the whole
    [B, P] from its own generator, so the generators must agree. mesh:
    points, colors and valid are this rank's block (see the module
    docstring)."""
    generator = _shuffle_source(points, cfg, generator, shuffle_bits)
    batch = project(points, colors, valid, cfg, generator=generator,
                    shuffle_bits=shuffle_bits, mesh=mesh)
    return train(batch, cfg, use_kernel=use_kernel, geom=geom, mesh=mesh)


@span("round_trip")
def compress_decompress(points, colors, valid, cfg: CompressorConfig,
                        use_kernel: Optional[bool] = None, geom=None,
                        generator: torch.Generator = None,
                        shuffle_bits: torch.Tensor = None, mesh=None):
    """save_compressed + load_compressed: the production round trip.
    Returns (CompressedCloud, decompress outputs); under a mesh (points,
    colors and valid this rank's block), this rank's rows of both."""
    comp = compress(points, colors, valid, cfg, use_kernel=use_kernel,
                    geom=geom, generator=generator,
                    shuffle_bits=shuffle_bits, mesh=mesh)
    return comp, decompress(comp, cfg, mesh=mesh)


def calib_subsample(batch: patches_mod.PatchBatch, n_patches: int,
                    n_points: int, mesh=None):
    """A dense, spatially stratified calibration subsample of the banks:
    the n_patches patches with the most valid points (ties to the lower
    index, as lax.top_k), each one's valid points compacted to the front
    and strided (idx_j = floor(j * count / n)) when it has more than n, so
    that any bank order covers the patch's span.
    Returns (X [n_patches, n, 2], y [n_patches, n], mask [n_patches, n]).

    mesh: the batch holds this rank's patch rows; the per-patch counts are
    all-gathered (the top-k is global), each rank takes the subsample of
    the chosen rows it owns, and those [n_patches, n] rows are gathered
    from their owners, so every rank returns the whole subsample."""
    counts = torch.sum(batch.mask, dim=1)
    if mesh is not None:
        return _calib_subsample_owned(batch, counts, n_patches, n_points,
                                      mesh)
    top = torch.argsort(counts, descending=True, stable=True)[:n_patches]
    return _subsample_rows(batch.X[top], batch.y[top, :, 0],
                           batch.mask[top], n_points)


def _calib_subsample_owned(batch, counts, n_patches, n_points, mesh):
    per = counts.shape[0]
    whole = mesh_lib.all_gather_rows(counts, mesh)
    top = torch.argsort(whole, descending=True, stable=True)[:n_patches]
    owner = torch.div(top, per, rounding_mode="floor")
    local = torch.where(owner == mesh_lib.axis_index(mesh, "data"),
                        top - owner * per, 0)
    X, y, m = _subsample_rows(batch.X[local], batch.y[local, :, 0],
                              batch.mask[local], n_points)
    # [ranks, n_patches, n, 4]: the chosen row i comes from rank owner[i]
    parts = mesh_lib.all_gather_rows(
        torch.cat([X, y[..., None], m[..., None].to(X.dtype)], -1)[None],
        mesh)
    got = parts[owner, torch.arange(top.shape[0], device=top.device)]
    return got[..., :2], got[..., 2], got[..., 3] > 0


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
                   calib_dtype, mesh=None):
    from gp_compressor_tpu_torch.inference import hmc

    rows = batch.X.shape[0] * (1 if mesh is None
                               else mesh_lib.axis_size(mesh, "data"))
    B = min(calib_patches, rows)
    n = min(calib_points, batch.X.shape[1])
    Xc, yc, mc = calib_subsample(batch, B, n, mesh=mesh)
    logpost = hmc.make_patch_logpost(Xc.to(calib_dtype), yc.to(calib_dtype),
                                     mc.to(calib_dtype))
    g = cfg.depth_gp
    theta0 = torch.tensor([math.log(g.sigmaf_sq), math.log(g.l_sq),
                           math.log(g.s20)], dtype=calib_dtype,
                          device=batch.X.device)
    return logpost, theta0


@span("round_trip")
def compress_decompress_calibrated(points, colors, valid,
                                   cfg: CompressorConfig,
                                   use_kernel: Optional[bool] = None,
                                   calib_patches: int = 32,
                                   calib_points: int = 64,
                                   calib_steps: int = 150,
                                   calib_lr: float = 0.1,
                                   calib_starts: int = 4,
                                   theta_init=None,
                                   calib_dtype: torch.dtype = torch.float32,
                                   generator: torch.Generator = None,
                                   shuffle_bits: torch.Tensor = None,
                                   mesh=None):
    """The calibrated round trip: project -> multi-start MAP of the exact-GP
    marginal posterior over (sigma_f^2, l^2, s20) on a bank subsample ->
    sparse-GP training with the calibrated values -> grid decompression.

    The calibrated values stay device tensors: they reach the training
    kernel through its hyperparameter row, and sanitize and decompress as
    tensors, so nothing is read back between stages. theta_init: optional
    warm start (the previous cloud's log theta) — pair with calib_steps ~40
    and calib_starts=1. calib_dtype: the dtype of the ascent (float32 on
    the card; the tests pass float64). mesh: points, colors and valid are
    this rank's block; the subsample's rows are gathered from their
    owners (calib_subsample), the MAP starts are cut over `chain` and
    every rank gets the same theta; then as compress_decompress.

    Returns (CompressedCloud, depth RBFParams, s20 0-dim tensor,
    decompress outputs)."""
    from gp_compressor_tpu_torch.inference import hmc

    generator = _shuffle_source(points, cfg, generator, shuffle_bits)
    batch = project(points, colors, valid, cfg, generator=generator,
                    shuffle_bits=shuffle_bits, mesh=mesh)
    with span("calibration"):
        logpost, theta0 = _calib_logpost(batch, cfg, calib_patches,
                                         calib_points, calib_dtype,
                                         mesh=mesh)
        theta, _ = hmc.map_estimate_multi(
            logpost, theta0, steps=calib_steps, lr=calib_lr,
            n_starts=calib_starts, theta_init=theta_init, mesh=mesh)
    sf, l2, s20 = torch.exp(theta).to(batch.X.dtype).unbind()
    depth_kp = RBFParams(sigmaf_sq=sf, l_sq=l2)
    # keep the relative novelty floor: eps_tol's natural scale is sigmaf_sq
    eps_cal = cfg.depth_gp.eps_tol * sf / cfg.depth_gp.sigmaf_sq
    comp = train(batch, cfg, depth_kp=depth_kp, use_kernel=use_kernel,
                 depth_s20=s20, depth_eps=eps_cal, full_probes=True,
                 mesh=mesh)
    out = decompress(comp, cfg, depth_kp=depth_kp, depth_s20=s20, mesh=mesh)
    return comp, depth_kp, s20, out


def compress_calibrated(points, colors, valid, cfg: CompressorConfig,
                        use_kernel: Optional[bool] = None, method: str = "map",
                        calib_patches: int = 32, calib_points: int = 64,
                        calib_steps: int = 400, calib_lr: float = 0.1,
                        calib_dtype: torch.dtype = torch.float64,
                        generator: torch.Generator = None, perm=None,
                        hmc_draws=None):
    """The staged calibrated compress: a calibration over the exact-GP
    marginal of a bank subsample, then training with a config built from
    the calibrated values (read to the host here, by design). method "map"
    (the default, deterministic, and any name but "hmc"): Adam ascent from
    the reference constants. method "hmc": 2-chain HMC (num_warmup = num_samples = calib_steps, 16
    leapfrogs) from the reference constants and from them + 0.3, theta
    the mean of both chains' samples; its draws are `hmc_draws`
    (inference.hmc.HMCDraws) or come from `generator`. The banks are built
    in native order and each bank is permuted before training, by `perm`
    ((depth, rgb) [B, P], see train) or by permutations drawn from
    `generator` (seed 0 when None) after the HMC's draws.

    The calibration runs in float64 by default (the JAX package's choice
    where x64 is on; the card runs it at the same speed, its cost being
    launches): far from its mode the exact-GP posterior of the subsample
    is so ill-conditioned that float32 log posteriors err by thousands of
    nats, and on the card a float32 HMC chain started at the reference
    constants reached a local mode (sigma_f^2 ~5, s20 at the noise floor)
    in every run measured. Returns (CompressedCloud, depth RBFParams,
    calibrated s20, calibrated config)."""
    from gp_compressor_tpu_torch.config import HMCConfig
    from gp_compressor_tpu_torch.inference import hmc

    batch = project(points, colors, valid, cfg)
    if generator is None:
        generator = torch.Generator(device=points.device).manual_seed(0)
    with span("calibration"):
        logpost, theta0 = _calib_logpost(batch, cfg, calib_patches,
                                         calib_points, calib_dtype)
        if method == "hmc":
            hcfg = HMCConfig(num_warmup=calib_steps,
                             num_samples=calib_steps, num_chains=2)
            samples, _, _ = hmc.hmc_sample_chains(
                logpost, torch.stack([theta0, theta0 + 0.3]), hcfg,
                generator=generator, draws=hmc_draws)
            theta = torch.mean(samples.reshape(-1, 3), dim=0)
        else:
            theta, _ = hmc.map_estimate(logpost, theta0, steps=calib_steps,
                                        lr=calib_lr)
    sf, l2, s20 = torch.exp(theta).unbind()
    dt = batch.X.dtype
    depth_kp = RBFParams(sigmaf_sq=sf.to(dt), l_sq=l2.to(dt))
    # the novelty threshold is an absolute gamma bound whose natural scale
    # is sigmaf_sq: rescale it to keep the same relative novelty floor
    eps_cal = cfg.depth_gp.eps_tol * float(sf) / cfg.depth_gp.sigmaf_sq
    cal_cfg = dataclasses.replace(cfg, depth_gp=dataclasses.replace(
        cfg.depth_gp, sigmaf_sq=float(sf), l_sq=float(l2), s20=float(s20),
        eps_tol=eps_cal))
    if perm is None:
        perm = bank_permutations(*batch.mask.shape, batch.X.device, generator)
    comp = train(batch, cal_cfg, depth_kp=depth_kp, use_kernel=use_kernel,
                 perm=perm)
    return comp, depth_kp, float(s20), cal_cfg
