"""Calibration of the GP kernel hyperparameters: MAP and HMC.

The port of `gp_compressor_tpu.inference.hmc`: the exact-GP marginal log
posterior over a bank of patches, its gradient ascent (single and
multi-start), fixed-length HMC with dual-averaging step-size warmup
(chains as a batch dim), and the chain diagnostics split-R-hat and ESS.

theta parameterization: unconstrained logs, theta = (ln sigmaf_sq, ln l_sq,
ln s20), with any leading batch dims (the starts of the multi-start ascent
and the chains of the sampler are one batch dim). The ascents and the
sampler are Python loops over steps that never read the device: each step
is queued on the stream. On the card the MAP ascent of a `PatchLogpost`
is replayed as one CUDA graph from its second call of a shape on (see
`_ascend`); it counts `calibration.eager_ascents`,
`calibration.graph_captures` and `calibration.graph_replays`. The
sampler's randomness is a `torch.Generator` (seed 0 when None) or the
draws themselves (`HMCDraws`).

With `mesh=` (a (data, chain) `DeviceMesh`, see `parallel.mesh`) the
multi-start ascent and the chains are cut over `chain`: each rank runs its
own starts or chains and the results are all-gathered in chain order. The
draws are made whole on every rank and then cut, so a sharded run draws
what a single run draws.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Callable, NamedTuple, Optional

import torch

from gp_compressor_tpu_torch.config import HMCConfig
from gp_compressor_tpu_torch.inference.nuts import (_generator, _safe_vag,
                                                    _sanitize, _vag,
                                                    dual_average)
from gp_compressor_tpu_torch.ops import linalg_f32
from gp_compressor_tpu_torch.ops.kernels import sqdist
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib
from gp_compressor_tpu_torch.utils.profiling import count, span


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


class PatchLogpost:
    """The posterior over shared hyperparameters given a bank of patches
    X: [B, n, d], y: [B, n], mask: [B, n]: called on theta [..., 3], it
    returns [...]. It carries its bank and its constants (prior_mean,
    prior_std, noise_floor_rel), which is what lets the MAP ascent replay
    a CUDA graph over a new bank of the same shapes."""

    def __init__(self, X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 prior_mean, prior_std, noise_floor_rel: float):
        self.X, self.y, self.mask = X, y, mask
        self.prior_mean, self.prior_std = prior_mean, prior_std
        self.noise_floor_rel = noise_floor_rel
        self.pm = torch.tensor(prior_mean, dtype=X.dtype, device=X.device)

    def constants(self) -> tuple:
        return (tuple(float(v) for v in self.prior_mean),
                float(self.prior_std), float(self.noise_floor_rel))

    def on_bank(self, X, y, mask) -> "PatchLogpost":
        """The same posterior over another bank."""
        return PatchLogpost(X, y, mask, self.prior_mean, self.prior_std,
                            self.noise_floor_rel)

    def __call__(self, theta: torch.Tensor) -> torch.Tensor:
        ll = torch.sum(gp_marginal_loglik(theta[..., None, :], self.X,
                                          self.y, self.mask,
                                          self.noise_floor_rel), dim=-1)
        lp = torch.sum(-0.5 * ((theta - self.pm) / self.prior_std) ** 2,
                       dim=-1)
        out = ll + lp
        # a factorization that fails where the gate did not foresee it
        # makes the point rejected instead of poisoning the ascent
        return torch.where(torch.isfinite(out), out,
                           torch.full_like(out, -torch.inf))


def make_patch_logpost(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                       prior_mean=(4.6, 0.0, -2.3), prior_std=3.0,
                       noise_floor_rel: Optional[float] = None
                       ) -> PatchLogpost:
    """Posterior over shared hyperparameters given a bank of patches
    X: [B, n, d], y: [B, n], mask: [B, n]. The returned callable maps
    theta [..., 3] to [...]. The prior centers on the reference constants
    (sigmaf^2 100, l^2 1, s20 0.1). noise_floor_rel: None picks 1e-4 for
    float32 inputs (the float32 conditioning floor) and 0 for float64."""
    if noise_floor_rel is None:
        noise_floor_rel = 1e-4 if X.dtype == torch.float32 else 0.0
    return PatchLogpost(X, y, mask, prior_mean, prior_std, noise_floor_rel)


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


def _steps(vag: Callable, theta: torch.Tensor, steps: int, lr: float,
           mark):
    """Adam ascent of the value vag returns; (theta, trace [steps, ...]).
    Each step (value, gradient, update) runs inside the context `mark`."""
    state = adam_init(theta)
    trace = []
    for _ in range(steps):
        with mark:
            lp, g = vag(theta)
            upd, state = adam_update(-g, state, lr)
            theta = theta + upd
        trace.append(lp)
    return theta, torch.stack(trace)


# Ascents of a PatchLogpost on the card replay a CUDA graph: the first call
# of a key runs eager (and warms cuBLAS and cuSOLVER up), the second
# captures the unrolled ascent and replays it, later calls replay. The
# cache is the process's, since every calibration builds a new posterior
# over a new bank of the same shapes. It holds GRAPH_KEYS keys, the least
# recently used dropped first; a key seen once maps to None.
GRAPH_KEYS = 4
_graphs = collections.OrderedDict()


def ascent_key(logpost: PatchLogpost, theta: torch.Tensor, steps: int,
               lr: float) -> tuple:
    """What an ascent's graph depends on: the bank's shapes, dtypes and
    device, the starts' shape and dtype, steps, lr and the posterior's
    constants."""
    bank = (logpost.X, logpost.y, logpost.mask)
    return (tuple(tuple(t.shape) for t in bank),
            tuple(t.dtype for t in bank), logpost.X.device,
            tuple(theta.shape), theta.dtype, int(steps), float(lr),
            logpost.constants())


class _AscentGraph:
    """One ascent captured as a CUDA graph over static copies of the bank
    and of the starts, in its own memory pool."""

    def __init__(self, logpost: PatchLogpost, theta: torch.Tensor,
                 steps: int, lr: float):
        self.bank = tuple(torch.empty_like(t) for t in
                          (logpost.X, logpost.y, logpost.mask))
        self.theta0 = torch.empty_like(theta)
        # kept: the graph reads its prior mean
        self.logpost = logpost.on_bank(*self.bank)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _steps(_safe_vag(self.logpost), self.theta0, steps,
                              lr, contextlib.nullcontext())
        count("calibration.graph_captures")

    def __call__(self, logpost: PatchLogpost, theta: torch.Tensor):
        with torch.no_grad():
            for dst, src in zip(self.bank + (self.theta0,),
                                (logpost.X, logpost.y, logpost.mask, theta)):
                dst.copy_(src)
            self.graph.replay()
            count("calibration.graph_replays")
            # the next replay overwrites the graph's outputs
            return tuple(t.clone() for t in self.out)


def _ascend(logpost: Callable, theta: torch.Tensor, steps: int, lr: float):
    """Adam ascent of logpost (sanitized, see _safe_vag) from theta;
    (theta, trace [steps, ...]). A PatchLogpost on the card, outside any
    capture, takes the graph of its key (see _graphs); every other
    ascent runs eager, each step a `calibration.step` span."""
    if (isinstance(logpost, PatchLogpost) and logpost.X.is_cuda
            and theta.is_cuda and not torch.cuda.is_current_stream_capturing()):
        key = ascent_key(logpost, theta, steps, lr)
        if key in _graphs:
            _graphs.move_to_end(key)
            if _graphs[key] is None:
                _graphs[key] = _AscentGraph(logpost, theta, steps, lr)
            return _graphs[key](logpost, theta)
        _graphs[key] = None
        if len(_graphs) > GRAPH_KEYS:
            _graphs.popitem(last=False)
    count("calibration.eager_ascents")
    return _steps(_safe_vag(logpost), theta, steps, lr,
                  span("calibration.step"))


def map_estimate(logpost: Callable, theta0: torch.Tensor, steps: int = 200,
                 lr: float = 5e-2):
    """Type-II MAP hyperparameter fit by Adam ascent on the patch-bank log
    posterior. Returns (theta, logpost trace [steps])."""
    return _ascend(logpost, theta0, steps, lr)


# log-space start offsets for the multi-start ascent: reference-scale,
# cm-scale, mm-scale and amplified starts
MAP_START_OFFSETS = ((0.0, 0.0, 0.0), (-3.0, -3.0, -2.0),
                     (-6.0, -5.0, -4.0), (2.0, 1.0, 1.0))


def map_estimate_multi(logpost: Callable, theta0: torch.Tensor,
                       steps: int = 150, lr: float = 0.1,
                       n_starts: int = 4, theta_init=None, mesh=None):
    """Multi-start MAP: the Adam ascent from `n_starts` log-space offsets
    of theta0, run as one batch dimension, keeping the best final log
    posterior (ties to the lower start). theta_init: optional warm start
    replacing the first offset. mesh: the starts are cut over `chain`, the
    final thetas and log posteriors all-gathered, so every rank picks the
    same theta. Returns (best theta [3], final logposts [n_starts])."""
    offs = torch.tensor(MAP_START_OFFSETS[:n_starts], dtype=theta0.dtype)
    starts = theta0[None, :] + offs.to(theta0.device)
    if theta_init is not None:
        starts = torch.cat([torch.as_tensor(theta_init).to(starts)[None],
                            starts[1:]])
    if mesh is not None:
        starts = mesh_lib.shard_leading(starts, mesh, n_starts, "chain")
    thetas, _ = _ascend(logpost, starts, steps, lr)
    with torch.no_grad():
        lps = logpost(thetas)
    if mesh is not None:
        thetas, lps = mesh_lib.gather_leading((thetas, lps), mesh, n_starts,
                                              "chain")
    best = torch.argmax(torch.where(torch.isfinite(lps), lps,
                                    torch.full_like(lps, -torch.inf)))
    # a 1-element index keeps the choice on the device
    return thetas[best.reshape(1)][0], lps


# ---------------------------------------------------------------------------
# HMC with dual-averaging warmup
# ---------------------------------------------------------------------------

class HMCChainState(NamedTuple):
    """Per-chain sampler state, each field with a leading chain dim."""

    theta: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    step_size: torch.Tensor
    # dual averaging statistics (Hoffman & Gelman 2014, eq. 6)
    h_bar: torch.Tensor
    log_eps_bar: torch.Tensor
    mu: torch.Tensor
    inv_mass: torch.Tensor
    accept_prob: torch.Tensor


class HMCDraws(NamedTuple):
    """The draws of a whole run of C chains over T = num_warmup +
    num_samples steps: step m of chain c uses z[c, m] and u[c, m]."""

    z: torch.Tensor            # [C, T, dim] momentum normals (unit metric)
    u: torch.Tensor            # [C, T] uniforms of the accept test


def draw_hmc(C: int, T: int, dim: int, dtype, device,
             generator: Optional[torch.Generator] = None) -> HMCDraws:
    """The draws of C chains over T steps from `generator` (seed 0 when
    None)."""
    g = _generator(generator, device)
    return HMCDraws(
        torch.randn((C, T, dim), generator=g, dtype=dtype, device=device),
        torch.rand((C, T), generator=g, dtype=dtype, device=device))


def _leapfrog(logpost, theta, p, grad, eps, inv_mass, n_steps):
    """n_steps leapfrogs of step eps [C]. Returns (theta, p, sanitized
    grad, the raw logpost value at the last point)."""
    lp = None
    for _ in range(n_steps):
        p = p + (0.5 * eps)[:, None] * grad
        theta = theta + eps[:, None] * inv_mass * p
        lp, g = _vag(logpost, theta)
        grad = _sanitize(lp, g)[1]
        p = p + (0.5 * eps)[:, None] * grad
    if lp is None:
        with torch.no_grad():
            lp = logpost(theta)
    return theta, p, grad, lp


def hmc_warmup_and_sample(logpost: Callable, theta0: torch.Tensor,
                          cfg: HMCConfig, n_leapfrog: int = 16,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[HMCDraws] = None):
    """HMC for chains theta0 [C, dim]: num_warmup dual-averaging steps, then
    num_samples steps at exp(log_eps_bar) (the averages keep updating at
    m = num_warmup, and each step runs at the previous average, as in the
    JAX package). The accept test takes logpost at the proposal, not its
    sanitized value. Returns (samples [C, num_samples, dim], mean accept
    probability [C], final step size [C])."""
    C, dim = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    T = cfg.num_warmup + cfg.num_samples
    if draws is None:
        draws = draw_hmc(C, T, dim, dt, dev, generator)
    lp0, g0 = _safe_vag(logpost)(theta0)
    eps0 = torch.full((C,), cfg.init_step_size, dtype=dt, device=dev)
    zero = torch.zeros((C,), dtype=dt, device=dev)
    st = HMCChainState(
        theta=theta0, logp=lp0, grad=g0, step_size=eps0, h_bar=zero,
        log_eps_bar=zero, mu=torch.log(10.0 * eps0),
        inv_mass=torch.ones((C, dim), dtype=dt, device=dev), accept_prob=zero)

    def step(st: HMCChainState, t: int, adapt: bool, m: int):
        p0 = draws.z[:, t] / torch.sqrt(st.inv_mass)
        th, p, g, lp_new = _leapfrog(logpost, st.theta, p0, st.grad,
                                     st.step_size, st.inv_mass, n_leapfrog)
        h0 = st.logp - 0.5 * torch.sum(st.inv_mass * p0 * p0, -1)
        h1 = lp_new - 0.5 * torch.sum(st.inv_mass * p * p, -1)
        log_acc = torch.clamp(h1 - h0, max=0.0)
        acc_p = torch.where(torch.isfinite(log_acc), torch.exp(log_acc), 0.0)
        accept = draws.u[:, t] < acc_p
        h_bar, log_eps, log_eps_bar = dual_average(
            m, acc_p, cfg.target_accept, st.mu, st.h_bar, st.log_eps_bar,
            weak_carry=adapt)
        return st._replace(
            theta=torch.where(accept[:, None], th, st.theta),
            logp=torch.where(accept, lp_new, st.logp),
            grad=torch.where(accept[:, None], g, st.grad),
            step_size=torch.exp(log_eps if adapt else st.log_eps_bar),
            h_bar=h_bar, log_eps_bar=log_eps_bar, accept_prob=acc_p)

    for m in range(cfg.num_warmup):
        st = step(st, m, True, m)
    st = st._replace(step_size=torch.exp(st.log_eps_bar))
    samples, accs = [], []
    for i in range(cfg.num_samples):
        st = step(st, cfg.num_warmup + i, False, cfg.num_warmup)
        samples.append(st.theta)
        accs.append(st.accept_prob)
    return torch.stack(samples, 1), torch.mean(torch.stack(accs, 1), 1), \
        st.step_size


def hmc_sample_chains(logpost: Callable, theta0: torch.Tensor,
                      cfg: HMCConfig, n_leapfrog: int = 16,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[HMCDraws] = None, mesh=None):
    """theta0 [C, dim] -> (samples [C, num_samples, dim], mean accept [C],
    step size [C]); the chains are one batch dim of every step. mesh: the
    chains (and their whole draws) are cut over `chain` and the results
    all-gathered in chain order."""
    if mesh is None:
        return hmc_warmup_and_sample(logpost, theta0, cfg, n_leapfrog,
                                     generator=generator, draws=draws)
    C, dim = theta0.shape
    if draws is None:
        draws = draw_hmc(C, cfg.num_warmup + cfg.num_samples, dim,
                         theta0.dtype, theta0.device, generator)
    theta0, draws = mesh_lib.shard_leading((theta0, draws), mesh, C, "chain")
    out = hmc_warmup_and_sample(logpost, theta0, cfg, n_leapfrog,
                                draws=draws)
    return mesh_lib.gather_leading(out, mesh, C, "chain")


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split-R-hat per dimension. samples: [C, T, dim]."""
    C, T, dim = samples.shape
    half = T // 2
    x = torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)
    cm = torch.mean(x, dim=1)                        # [2C, dim]
    gv = torch.var(cm, dim=0, unbiased=True)         # between
    wv = torch.mean(torch.var(x, dim=1, unbiased=True), dim=0)
    var_est = (half - 1) / half * wv + gv
    return torch.sqrt(var_est / wv)


def effective_sample_size(samples: torch.Tensor,
                          max_lag: int = 100) -> torch.Tensor:
    """Bulk ESS per dimension via the initial positive sequence: the
    autocorrelation is cut at its first value below -0.05. [C, T, dim]."""
    C, T, dim = samples.shape
    x = samples - torch.mean(samples, dim=1, keepdim=True)
    max_lag = min(max_lag, T - 1)
    ac = torch.stack([
        torch.mean(torch.sum(x[:, :T - lag] * x[:, lag:], dim=1), dim=0) / T
        for lag in range(max_lag)])                  # [max_lag, dim]
    rho = ac / ac[0]
    positive = torch.cumprod((rho > -0.05).to(rho.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(rho * positive, dim=0)
    return C * T / torch.clamp(tau, min=1.0)
