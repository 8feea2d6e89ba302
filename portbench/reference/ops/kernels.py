"""Batched RBF (squared-exponential) kernel primitives.

k(xi, xj) = sigmaf_sq * exp(-||xi - xj||^2 / (2 l_sq)), as in
`gp_compressor_tpu.ops.kernels`. Every function broadcasts over leading
batch dimensions and follows its inputs' dtype and device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RBFParams(NamedTuple):
    """Kernel hyperparameters: 0-dim tensors on the data's device."""

    sigmaf_sq: torch.Tensor  # signal variance p0
    l_sq: torch.Tensor       # squared lengthscale p1


def sqdist(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances. X: [..., n, d], Z: [..., m, d] -> [..., n, m].

    The difference form: exact for the d = 2 patch inputs, and free of the
    |x|^2 + |z|^2 - 2 x.z cancellation that would feed the novelty gamma."""
    diff = X[..., :, None, :] - Z[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def gram(params: RBFParams, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Cross-Gram matrix K[..., i, j] = k(X[..., i], Z[..., j])."""
    return params.sigmaf_sq * torch.exp(-0.5 / params.l_sq * sqdist(X, Z))


def kdiag(params: RBFParams, X: torch.Tensor) -> torch.Tensor:
    """k(x, x) for each row — constant sigmaf_sq for the RBF kernel."""
    return params.sigmaf_sq.to(X.dtype).expand(X.shape[:-1])

