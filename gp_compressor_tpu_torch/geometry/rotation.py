"""Patch plane rotations.

The port of `gp_compressor_tpu.geometry.rotation` (main-path part): the
per-patch plane fit is the smallest eigenvector of the 4x4 homogeneous
second-moment matrix, found by batched cyclic Jacobi rotations, and the
frame follows the reference's sign and axis conventions
(src/gp_compressor.cpp:38-63) exactly — no downstream check can agree
otherwise. The quaternion pair of the artifact format works on batches
(the JAX package vmaps its single-matrix forms).
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


def rotation_from_moment(M: torch.Tensor, npoints,
                         min_points: int = 4) -> torch.Tensor:
    """One patch's frame from its [4, 4] homogeneous second-moment matrix
    (the sum over its sphere points of [x,y,z,1][x,y,z,1]^T) and its point
    count: the plane is the eigenvector of the smallest eigenvalue
    (`torch.linalg.eigh`, as the JAX form takes `jnp.linalg.eigh`). Below
    `min_points`, or for a degenerate normal, the identity
    (src/gp_compressor.cpp:31-34)."""
    _, V = torch.linalg.eigh(M)
    normal = V[:3, 0]                        # eigenvalues ascending
    norm = torch.linalg.norm(normal)
    normal = normal / torch.where(norm > 0, norm, 1.0)
    R = frame_from_normal(normal)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    bad = (torch.as_tensor(npoints, device=M.device) < min_points) \
        | (norm <= 0)
    return torch.where(bad, eye, R)


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


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> quaternions [..., 4] in (x, y, z, w)
    order, Eigen's coeffs() as the artifact format stores them. All four
    Shepperd constructions are built and the one with the largest pivot
    is taken (the first on ties); the sign follows that case, not w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    case = torch.argmax(qw, dim=-1, keepdim=True)
    s = torch.sqrt(torch.clamp(torch.gather(qw, -1, case), min=1e-12)) * 2.0
    q = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, qw[..., 0]], -1),
        torch.stack([qw[..., 1], m01 + m10, m02 + m20, m21 - m12], -1),
        torch.stack([m01 + m10, qw[..., 2], m12 + m21, m02 - m20], -1),
        torch.stack([m02 + m20, m12 + m21, qw[..., 3], m10 - m01], -1),
    ], -2) / s[..., None]                                      # [..., 4, 4]
    q = torch.take_along_dim(q, case[..., None], dim=-2)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions [..., 4] in (x, y, z, w) order -> rotation matrices
    [..., 3, 3] (a zero quaternion gives the identity)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / n, 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)
