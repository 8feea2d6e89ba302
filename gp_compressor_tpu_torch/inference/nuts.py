"""Sampler helpers of `gp_compressor_tpu.inference.nuts`.

Only `_safe_vag` is ported so far: the MAP ascent of `inference.hmc` uses
it. The NUTS and HMC samplers arrive with the Bayesian slice.
"""

from __future__ import annotations

from typing import Callable

import torch


def _safe_vag(logpost: Callable) -> Callable:
    """theta [..., 3] -> (value [...], grad [..., 3]) of logpost, with each
    batch element sanitized on its own: where the value or the gradient is
    non-finite, the value is -inf and the gradient 0."""

    def vag(theta):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            v = logpost(th)
            g, = torch.autograd.grad(v.sum(), th)
        v = v.detach()
        bad = ~(torch.isfinite(v) & torch.all(torch.isfinite(g), dim=-1))
        return (torch.where(bad, torch.full_like(v, -torch.inf), v),
                torch.where(bad[..., None], torch.zeros_like(g), g))

    return vag
