"""Point-to-plane ICP: the independent registration comparator.

The port of `gp_compressor_tpu.workloads.icp`. Classic point-to-plane ICP
(Chen & Medioni) against the map's patch planes, by Gauss-Newton on the
linearized 6-DoF twist: each scan point is first-claim assigned to a map
patch with the claim tables registration uses, its residual is the signed
distance to that patch's plane, and each iteration solves the damped 6x6
normal equations

    sum_i J_i^T J_i  dx = -sum_i J_i^T r_i,   J_i = [n_i^T, (p_i x n_i)^T].

A geometric least-squares method with no GP state, so that its error
curve and gp-accuracy's anchor each other. JAX's `lax.while_loop` is a
host loop here: each iteration ends in one device-to-host read of its
stop test (counted as `icp.reads`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gp_compressor_tpu_torch.config import CompressorConfig
from gp_compressor_tpu_torch.geometry import transforms
from gp_compressor_tpu_torch.workloads import registration
from gp_compressor_tpu_torch.utils.profiling import count
from gp_compressor_tpu_torch.workloads.compressor import CompressedCloud


class ICPResult(NamedTuple):
    R: torch.Tensor             # [3, 3] estimated rotation
    t: torch.Tensor             # [3] estimated translation
    iters: int
    rms_residual: torch.Tensor  # plane-distance RMS over matched points
    n_matched: torch.Tensor     # int32 matched points at the last iteration


def icp_register(comp: CompressedCloud, scan_points, scan_valid,
                 cfg: CompressorConfig, max_iters: int = 30,
                 tol: float = 1e-5, damping: float = 1e-6) -> ICPResult:
    """Align `scan_points` to the compressed map by point-to-plane ICP.
    Apply the result as p_aligned = p @ R.T + t (registration.register's
    convention). Stops when the twist increment's norm is not above `tol`
    (a non-finite one included) or after `max_iters`."""
    dt, dev = scan_points.dtype, scan_points.device
    normals = comp.patch.rotations[:, :, 0]
    tables = registration._map_claim_tables(comp)
    eye6 = damping * torch.eye(6, dtype=dt, device=dev)
    R = torch.eye(3, dtype=dt, device=dev)
    t = torch.zeros(3, dtype=dt, device=dev)
    rms = torch.full((), math.inf, dtype=dt, device=dev)
    nm = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters:
        pts = transforms.apply(scan_points, R, t)
        claim, loc, claimed = registration._claim_to_map(
            comp, pts, scan_valid, cfg, tables=tables)
        nrm = normals[torch.where(claimed, claim, 0).long()]    # [N, 3]
        r = loc[:, 0]                                   # depth in patch frame
        w = claimed.to(dt)
        J = torch.cat([nrm, torch.linalg.cross(pts, nrm, dim=-1)], 1) \
            * w[:, None]                                        # [N, 6]
        H = J.T @ J
        b = -J.T @ (r * w)
        rms = torch.sqrt(torch.sum(w * r * r) / torch.clamp(torch.sum(w),
                                                            min=1.0))
        nm = torch.sum(claimed).to(torch.int32)
        dx = torch.linalg.solve_ex(H + eye6, b, check_errors=False)[0]
        dR = transforms.euler_xyz(dx[3:])
        R = transforms.matmul3(dR, R)
        t = dR @ t + dx[:3]
        it += 1
        count("icp.reads")
        if not bool(torch.linalg.vector_norm(dx) > tol):
            break
    return ICPResult(R=R, t=t, iters=it, rms_residual=rms, n_matched=nm)
