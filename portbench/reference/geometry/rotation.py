"""Patch plane rotations.

The port of `gp_compressor_tpu.geometry.rotation` (main-path part): the
per-patch plane fit is the smallest eigenvector of the 4x4 homogeneous
second-moment matrix, found by batched cyclic Jacobi rotations, and the
frame follows the reference's sign and axis conventions
(src/gp_compressor.cpp:38-63) exactly — no downstream check can agree
otherwise.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _basis(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The cross-product axis per dominant axis, on `device` once (a copy
    from host memory synchronises the stream)."""
    return torch.tensor([[0.0, 0.0, 1.0],    # dom=x -> cross with z
                         [1.0, 0.0, 0.0],    # dom=y -> cross with x
                         [0.0, 1.0, 0.0]],   # dom=z -> cross with y
                        dtype=dtype, device=device)


def frame_from_normal(normal: torch.Tensor) -> torch.Tensor:
    """Rotation matrices from plane normals. [..., 3] -> [..., 3, 3].

    Columns: R[:,0] = normal (flipped positive along its dominant axis),
    R[:,1] = unit(axis x normal) where axis is z/x/y for dominant x/y/z,
    R[:,2] = normal x R[:,1]."""
    a = torch.abs(normal)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    # dominant axis 0, 1 or 2; ties go to z like the C++ else-chain
    dom = torch.where((a0 > a1) & (a0 > a2), 0,
                      torch.where((a1 > a0) & (a1 > a2), 1, 2))
    nd = torch.gather(normal, -1, dom[..., None])
    sign = torch.where(nd < 0, -1.0, 1.0).to(normal.dtype)
    n = normal * sign
    axis = _basis(normal.dtype, normal.device)[dom]
    c1 = torch.linalg.cross(axis, n, dim=-1)
    c1 = c1 / torch.linalg.norm(c1, dim=-1, keepdim=True)
    c2 = torch.linalg.cross(n, c1, dim=-1)
    return torch.stack([n, c1, c2], dim=-1)


def jacobi_eigh_batch(M: torch.Tensor, sweeps: int = 5):
    """Batched symmetric eigendecomposition of tiny [B, n, n] matrices by
    cyclic Jacobi rotations. Returns (w [B, n] ascending, V [B, n, n] with
    columns as eigenvectors)."""
    Bb, n, _ = M.shape
    dt = M.dtype
    # normalize scale so the a_pq ~ 0 guard has an absolute threshold
    scale = torch.clamp(torch.amax(torch.abs(M), dim=(1, 2), keepdim=True),
                        min=1e-30)
    A = M / scale
    V = torch.eye(n, dtype=dt, device=M.device).expand(Bb, n, n).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = A[:, p, q]
                app = A[:, p, p]
                aqq = A[:, q, q]
                small = torch.abs(apq) <= 1e-12
                theta = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
                t = torch.sign(theta) / (torch.abs(theta)
                                         + torch.sqrt(1.0 + theta * theta))
                t = torch.where(theta == 0, 1.0, t)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = torch.where(small, 0.0, t * c)
                c = torch.where(small, 1.0, c)
                # G = I with G[p,p]=G[q,q]=c, G[p,q]=s, G[q,p]=-s annihilates
                # A'[p,q] in A' = G^T A G: column mixes, then row mixes
                cc, sc = c[:, None], s[:, None]
                Acp, Acq = A[:, :, p].clone(), A[:, :, q].clone()
                A[:, :, p] = cc * Acp - sc * Acq
                A[:, :, q] = sc * Acp + cc * Acq
                Arp, Arq = A[:, p, :].clone(), A[:, q, :].clone()
                A[:, p, :] = cc * Arp - sc * Arq
                A[:, q, :] = sc * Arp + cc * Arq
                Vcp, Vcq = V[:, :, p].clone(), V[:, :, q].clone()
                V[:, :, p] = cc * Vcp - sc * Vcq
                V[:, :, q] = sc * Vcp + cc * Vcq
    w = torch.diagonal(A, dim1=1, dim2=2) * scale[:, :, 0]
    order = torch.argsort(w, dim=1, stable=True)
    w = torch.gather(w, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(-1, n, -1))
    return w, V


def rotation_from_moment_batch(M: torch.Tensor, npoints: torch.Tensor,
                               min_points: int = 4) -> torch.Tensor:
    """[B, 4, 4] moments -> [B, 3, 3] frames. Below `min_points` support
    points, or for a degenerate normal, the frame is the identity."""
    _, V = jacobi_eigh_batch(M)
    normal = V[:, :3, 0]
    norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(norm > 0, norm, 1.0)
    R = frame_from_normal(normal)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    bad = (npoints < min_points) | (norm[:, 0] <= 0)
    return torch.where(bad[:, None, None], eye, R)

