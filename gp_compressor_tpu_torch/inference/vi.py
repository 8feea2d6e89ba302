"""ADVI (mean-field variational inference) over GP hyperparameters.

The port of `gp_compressor_tpu.inference.vi`: the same log posterior as
`inference.hmc`, a diagonal-Gaussian variational family in the
unconstrained theta space, reparameterized ELBO gradients, and the
optax-order Adam of `inference.hmc`. The optimisation is a Python loop
that never reads the device. Its normals are a `torch.Generator` draw
(seed 0 when None) of [steps, n_mc, dim] in one call, or passed in.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gp_compressor_tpu_torch.inference.hmc import adam_init, adam_update
from gp_compressor_tpu_torch.inference.nuts import _generator


class VIResult(NamedTuple):
    mean: torch.Tensor         # [dim] variational mean
    log_std: torch.Tensor      # [dim]
    elbo_trace: torch.Tensor   # [steps]


def fit_advi(logpost: Callable, theta0: torch.Tensor, steps: int = 500,
             lr: float = 5e-2, n_mc: int = 8,
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> VIResult:
    """Adam on the negative Monte-Carlo ELBO from mean theta0 [dim] and
    log_std -2. Step i evaluates logpost at mean + eps[i] * std, eps
    [steps, n_mc, dim] standard normals, and differentiates the raw ELBO
    (no sanitization)."""
    dim = theta0.shape[0]
    dt, dev = theta0.dtype, theta0.device
    if eps is None:
        eps = torch.randn((steps, n_mc, dim), generator=_generator(
            generator, dev), dtype=dt, device=dev)
    # (mean, log_std) as one [2, dim] tensor: Adam is elementwise
    params = torch.stack([theta0, torch.full_like(theta0, -2.0)])
    state = adam_init(params)
    half_log = 0.5 * dim * (1.0 + math.log(2.0 * math.pi))
    elbos = []
    for i in range(steps):
        with torch.enable_grad():
            pr = params.detach().requires_grad_(True)
            thetas = pr[0] + eps[i] * torch.exp(pr[1])
            entropy = torch.sum(pr[1]) + half_log
            loss = -(torch.mean(logpost(thetas)) + entropy)
            g, = torch.autograd.grad(loss, pr)
        upd, state = adam_update(g, state, lr)
        params = params.detach() + upd
        elbos.append(-loss.detach())
    return VIResult(mean=params[0], log_std=params[1],
                    elbo_trace=torch.stack(elbos))


def sample_posterior(res: VIResult, n: int,
                     generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n draws [n, dim] of the fitted Gaussian (eps: [n, dim] normals)."""
    if eps is None:
        eps = torch.randn((n, res.mean.shape[0]), generator=_generator(
            generator, res.mean.device), dtype=res.mean.dtype,
            device=res.mean.device)
    return res.mean + eps * torch.exp(res.log_std)


def elbo_plateaued(elbo_trace: torch.Tensor, window: int = 30,
                   tol: float = 2.0) -> torch.Tensor:
    """True (0-dim bool) when the mean ELBO of the last `window` steps
    moved by less than `tol` nats from the preceding window's: the gate
    for reporting a fitted mode. The MC-ELBO noise at n_mc 8 on the bench
    posterior is ~1 nat, while a run still in transit along the posterior
    ridge drifts by hundreds per window."""
    a = torch.mean(elbo_trace[-window:])
    b = torch.mean(elbo_trace[-2 * window:-window])
    return torch.abs(a - b) < tol
