"""Exact (dense Cholesky) Gaussian process, batched over leading dims.

The port of `gp_compressor_tpu.models.exact_gp`: the full RBF Gram plus
s20 I, factored; alpha = K^-1 y; predictive mean K*^T alpha and latent
variance k** - v^T v with v = L^-1 K*. Rows with mask 0 are decoupled by a
unit diagonal and a zero target, so one static shape serves patches of any
true size. Every function takes the patch axis (or none) as leading dims.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gp_compressor_tpu_torch.ops import kernels, linalg_f32
from gp_compressor_tpu_torch.ops.kernels import RBFParams


class ExactGPState(NamedTuple):
    X: torch.Tensor      # [..., n, d] training inputs (padded)
    mask: torch.Tensor   # [..., n] 1.0 for real rows
    chol: torch.Tensor   # [..., n, n] lower Cholesky of masked (K + s20 I)
    alpha: torch.Tensor  # [..., n, dout] = (K + s20 I)^-1 y


def fit(params: RBFParams, s20, X: torch.Tensor, y: torch.Tensor,
        mask: torch.Tensor) -> ExactGPState:
    """Factor the masked Gram and solve for alpha. y: [..., n, dout]."""
    m2 = mask[..., :, None] * mask[..., None, :]
    K = kernels.gram(params, X, X) * m2
    # decouple masked-out rows with a unit diagonal; real rows get + s20
    K = K + torch.diag_embed(torch.where(mask > 0, s20, 1.0).to(K.dtype))
    L = linalg_f32.cholesky(K)
    alpha = linalg_f32.cho_solve(L, y * mask[..., None])
    return ExactGPState(X=X, mask=mask, chol=L, alpha=alpha)


def predict(params: RBFParams, state: ExactGPState,
            Xstar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean [..., m, dout] and latent variance [..., m]."""
    Ks = kernels.gram(params, state.X, Xstar) * state.mask[..., :, None]
    mean = torch.einsum('...nm,...nd->...md', Ks, state.alpha)
    v = linalg_f32.solve_lower(state.chol, Ks)                 # [..., n, m]
    var = kernels.kdiag(params, Xstar) - torch.sum(v * v, dim=-2)
    return mean, var


# the patch axis is a leading dim already
fit_batch = fit
predict_batch = predict
