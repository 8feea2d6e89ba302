"""Observation (noise) models: the first and second derivative of
ln P(y | f) at the predictive marginal N(f; m, s2), the (q, r) scalars of
the Csató–Opper update.

The port of `gp_compressor_tpu.ops.noise`. The batched trainer calls
`dx_ln(y, m, s2[:, None])` with y, m [B, dout] and `dx2_ln(y, m, s2)` with
s2 [B], so `dx_ln` is elementwise and `dx2_ln` reduces over the output
axis where the model needs it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GaussianNoise(NamedTuple):
    """Gaussian observation model. Elementwise, so `s2` broadcasts against
    `y - m` exactly as the caller shapes it."""

    s20: torch.Tensor  # noise variance

    def dx_ln(self, y: torch.Tensor, m: torch.Tensor,
              s2: torch.Tensor) -> torch.Tensor:
        return (y - m) / (self.s20 + s2)

    def dx2_ln(self, y: torch.Tensor, m: torch.Tensor,
               s2: torch.Tensor) -> torch.Tensor:
        return -1.0 / (self.s20 + s2)


class ProbitNoise(NamedTuple):
    """Probit classification model for binary y in {-1, +1}: the
    Csató–Opper classification moments with sigma = sqrt(s20 + s2),
    z = y m / sigma,
      dx_ln  = y phi(z) / (sigma Phi(z))
      dx2_ln = -(phi/Phi) (z + phi/Phi) / sigma^2
    (the JAX module explains why the reference's erf form is not used)."""

    s20: torch.Tensor

    def _ratio(self, z: torch.Tensor) -> torch.Tensor:
        """phi(z) / Phi(z), with the asymptote -z below z = -8."""
        phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        Phi = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
        safe = phi / torch.clamp(Phi, min=1e-30)
        return torch.where(z < -8.0, -z, safe)

    def dx_ln(self, y: torch.Tensor, m: torch.Tensor,
              s2: torch.Tensor) -> torch.Tensor:
        sigma = torch.sqrt(self.s20 + s2)
        z = y * m / sigma
        return y / sigma * self._ratio(z)

    def dx2_ln(self, y: torch.Tensor, m: torch.Tensor,
               s2: torch.Tensor) -> torch.Tensor:
        sigma2 = self.s20 + s2
        sigma = torch.sqrt(sigma2)
        # dout == 1 for probit: the sum collapses the output axis
        z = torch.sum(y * m, dim=-1) / sigma
        ratio = self._ratio(z)
        return -ratio * (z + ratio) / sigma2


def gaussian_log_pdf(y, mu, var):
    """ln N(y; mu, var) elementwise — the likelihood paths' density and
    the autodiff ground truth for the closed forms above."""
    return -0.5 * math.log(2.0 * math.pi) - 0.5 * torch.log(var) \
        - 0.5 * (y - mu) ** 2 / var
