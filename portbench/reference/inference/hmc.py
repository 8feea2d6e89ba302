"""Calibration of the GP kernel hyperparameters by MAP.

The port of `gp_compressor_tpu.inference.hmc` (its MAP part): the
exact-GP marginal log posterior over a bank of patches and its
multi-start gradient ascent.

theta parameterization: unconstrained logs, theta = (ln sigmaf_sq, ln l_sq,
ln s20), with any leading batch dims (the starts of the multi-start ascent
are one batch dim). The ascent is a Python loop over steps that never
reads the device: each step is queued on the stream.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from portbench.reference.ops import linalg_f32
from portbench.reference.ops.kernels import sqdist


def _safe_vag(logpost: Callable) -> Callable:
    """theta [..., 3] -> (value [...], grad [..., 3]) of logpost, with each
    batch element sanitized on its own: where the value or the gradient is
    non-finite, the value is -inf and the gradient 0."""

    def vag(theta):
        v, g = _vag(logpost, theta)
        return _sanitize(v, g)

    return vag


def _vag(logpost: Callable, theta: torch.Tensor):
    """The raw value and gradient of logpost at theta [..., dim]."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        v = logpost(th)
        g, = torch.autograd.grad(v.sum(), th)
    return v.detach(), g


def _sanitize(v: torch.Tensor, g: torch.Tensor):
    bad = ~(torch.isfinite(v) & torch.all(torch.isfinite(g), dim=-1))
    return (torch.where(bad, torch.full_like(v, -torch.inf), v),
            torch.where(bad[..., None], torch.zeros_like(g), g))


def gp_marginal_loglik(theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                       mask: torch.Tensor,
                       noise_floor_rel: float = 0.0) -> torch.Tensor:
    """Exact GP marginal log-likelihood ln N(y; 0, K + s20 I) of patches.

    X: [..., n, d], y: [..., n], mask: [..., n]; theta: [..., 3]
    broadcast against the patch dims. Masked rows are decoupled by a unit
    diagonal. noise_floor_rel adds a noise floor relative to the signal
    variance (s20_eff = s20 + floor * sigmaf_sq).

    A theta whose Gram cannot factor is refused before the factorization,
    by the a-priori condition bound cond <= 1 + n sigmaf^2 / s20_eff
    (cond_cap 2e6 in float32, 1e12 in float64): it yields -inf, as does
    any non-finite result."""
    sf = torch.exp(theta[..., 0])
    l2 = torch.exp(theta[..., 1])
    s20 = torch.exp(theta[..., 2]) + noise_floor_rel * sf
    n = X.shape[-2]
    m2 = mask[..., :, None] * mask[..., None, :]
    K = sf[..., None, None] * torch.exp((-0.5 / l2)[..., None, None]
                                        * sqdist(X, X)) * m2
    K = K + torch.diag_embed(torch.where(mask > 0, s20[..., None], 1.0))
    neff = torch.sum(mask, dim=-1)
    cond_cap = 2e6 if K.dtype == torch.float32 else 1e12
    bad = sf * neff / s20 > cond_cap
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L = linalg_f32.cholesky(torch.where(bad[..., None, None], eye, K))
    ym = (y * mask).expand(L.shape[:-1])
    alpha = linalg_f32.cho_solve(L, ym)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
                             * mask, dim=-1)
    quad = torch.sum(ym * alpha, dim=-1)
    ll = -0.5 * (quad + logdet + neff * math.log(2.0 * math.pi))
    return torch.where(bad | ~torch.isfinite(ll),
                       torch.full_like(ll, -torch.inf), ll)


def make_patch_logpost(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                       prior_mean=(4.6, 0.0, -2.3), prior_std=3.0,
                       noise_floor_rel: Optional[float] = None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Posterior over shared hyperparameters given a bank of patches
    X: [B, n, d], y: [B, n], mask: [B, n]. The returned function maps
    theta [..., 3] to [...]. The prior centers on the reference constants
    (sigmaf^2 100, l^2 1, s20 0.1). noise_floor_rel: None picks 1e-4 for
    float32 inputs (the float32 conditioning floor) and 0 for float64."""
    pm = torch.tensor(prior_mean, dtype=X.dtype, device=X.device)
    if noise_floor_rel is None:
        noise_floor_rel = 1e-4 if X.dtype == torch.float32 else 0.0

    def logpost(theta):
        ll = torch.sum(gp_marginal_loglik(theta[..., None, :], X, y, mask,
                                          noise_floor_rel), dim=-1)
        lp = torch.sum(-0.5 * ((theta - pm) / prior_std) ** 2, dim=-1)
        out = ll + lp
        # a factorization that fails where the gate did not foresee it
        # makes the point rejected instead of poisoning the ascent
        return torch.where(torch.isfinite(out), out,
                           torch.full_like(out, -torch.inf))

    return logpost


class AdamState(NamedTuple):
    count: int              # steps taken (host int: known without a read)
    mu: torch.Tensor
    nu: torch.Tensor


def adam_init(theta: torch.Tensor) -> AdamState:
    return AdamState(0, torch.zeros_like(theta), torch.zeros_like(theta))


def adam_update(g: torch.Tensor, state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple:
    """One step of optax.adam(lr) (eps_root 0) in its arithmetic order:
    moments (1 - b) g^k + b m, bias-corrected m_hat / (sqrt(v_hat) + eps),
    scaled by -lr. g is the gradient of the loss to minimise. Returns
    (updates, new state)."""
    mu = (1 - b1) * g + b1 * state.mu
    nu = (1 - b2) * g ** 2 + b2 * state.nu
    count = state.count + 1
    mu_hat = mu / (1 - b1 ** count)
    nu_hat = nu / (1 - b2 ** count)
    return -lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), \
        AdamState(count, mu, nu)


def _ascend(vag: Callable, theta: torch.Tensor, steps: int, lr: float):
    """Adam ascent of the value vag returns; (theta, trace [steps, ...])."""
    state = adam_init(theta)
    trace = []
    for _ in range(steps):
        lp, g = vag(theta)
        upd, state = adam_update(-g, state, lr)
        theta = theta + upd
        trace.append(lp)
    return theta, torch.stack(trace)


# log-space start offsets for the multi-start ascent: reference-scale,
# cm-scale, mm-scale and amplified starts
MAP_START_OFFSETS = ((0.0, 0.0, 0.0), (-3.0, -3.0, -2.0),
                     (-6.0, -5.0, -4.0), (2.0, 1.0, 1.0))


def map_estimate_multi(logpost: Callable, theta0: torch.Tensor,
                       steps: int = 150, lr: float = 0.1,
                       n_starts: int = 4, theta_init=None):
    """Multi-start MAP: the Adam ascent from `n_starts` log-space offsets
    of theta0, run as one batch dimension, keeping the best final log
    posterior (ties to the lower start). theta_init: optional warm start
    replacing the first offset. Returns (best theta [3], final logposts
    [n_starts])."""
    offs = torch.tensor(MAP_START_OFFSETS[:n_starts], dtype=theta0.dtype)
    starts = theta0[None, :] + offs.to(theta0.device)
    if theta_init is not None:
        starts = torch.cat([torch.as_tensor(theta_init).to(starts)[None],
                            starts[1:]])
    thetas, _ = _ascend(_safe_vag(logpost), starts, steps, lr)
    with torch.no_grad():
        lps = logpost(thetas)
    best = torch.argmax(torch.where(torch.isfinite(lps), lps,
                                    torch.full_like(lps, -torch.inf)))
    # a 1-element index keeps the choice on the device
    return thetas[best.reshape(1)][0], lps

