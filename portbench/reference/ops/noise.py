"""Observation (noise) models: the first and second derivative of
ln P(y | f) at the predictive marginal N(f; m, s2), the (q, r) scalars of
the Csató–Opper update.

The port of `gp_compressor_tpu.ops.noise`. The batched trainer calls
`dx_ln(y, m, s2[:, None])` with y, m [B, dout] and `dx2_ln(y, m, s2)` with
s2 [B], so `dx_ln` is elementwise and `dx2_ln` reduces over the output
axis where the model needs it.
"""

from __future__ import annotations

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

