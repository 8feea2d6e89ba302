"""Rigid-body transform helpers for registration.

The port of `gp_compressor_tpu.geometry.transforms`: the small-angle
gradient step R = Rx(w0) Ry(w1) Rz(w2), and the 6-DoF twist Jacobian
J = [I | -[x]_x].

Every product here runs at full float32 precision (`torch.matmul` with
TF32 off, as the package sets it): a reduced-precision `points @ R.T`
quantises metre-scale coordinates to millimetres, which puts a noise floor
under registration (the JAX package measured 9 mm at bfloat16).
"""

from __future__ import annotations

import torch


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows])


def rot_x(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rot_z(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def euler_xyz(angles: torch.Tensor) -> torch.Tensor:
    """R = Rx(a0) Ry(a1) Rz(a2), the reference's composition order."""
    return matmul3(matmul3(rot_x(angles[0]), rot_y(angles[1])),
                   rot_z(angles[2]))


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """3x3 (or batched) rotation composition at full precision."""
    return torch.matmul(A, B)


def transform_jacobian(x: torch.Tensor) -> torch.Tensor:
    """J(x) = [I_3 | -[x]_x] as a [3, 6]: d(R x + t)/d(t, omega) at the
    identity."""
    one, zero = torch.ones_like(x[0]), torch.zeros_like(x[0])
    return _mat([[one, zero, zero, zero, x[2], -x[1]],
                 [zero, one, zero, -x[2], zero, x[0]],
                 [zero, zero, one, x[1], -x[0], zero]])


def apply(points: torch.Tensor, R: torch.Tensor,
          t: torch.Tensor) -> torch.Tensor:
    """p -> R p + t for [N, 3] points."""
    return torch.matmul(points, R.T) + t


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic angle of a rotation matrix."""
    c = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(c)
