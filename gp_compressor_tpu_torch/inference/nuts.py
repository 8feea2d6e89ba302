"""No-U-Turn Sampler over GP hyperparameters.

The port of `gp_compressor_tpu.inference.nuts`: dynamic-trajectory HMC
(Hoffman & Gelman 2014) with multinomial progressive sampling and biased
trajectory selection (Betancourt 2017), and the dual-averaging step-size
warmup shared with `inference.hmc`. The trajectory of a transition keeps
every leapfrog state of its current subtree in a [2^(max_depth-1), dim]
buffer and runs the sub-tree U-turn checks by indexing it.

Chains are a batch dimension: theta [C, dim]. The JAX package `vmap`s a
`lax.while_loop`, which runs the loop body for every chain while any chain
is still building its tree and keeps each stopped chain's carry; here one
Python loop runs the body for all chains in lockstep, and a stopped chain
keeps its outputs (its sample, accept statistic and leapfrog count), its
integration point, its subtree depth and its leaf slot. The loop reads
the all-stopped flag once per BLOCK leapfrogs, never once per leapfrog;
it cannot need more than 2^max_depth - 1 leapfrogs, and stops there
without a read.

Randomness is explicit. Every sampler takes either a `torch.Generator`
(seed 0 when None, on the chains' device) or the draws themselves: the
momentum normals of `find_reasonable_step_size` as a [C, dim] tensor and
one `NUTSDraws` per transition, each drawn in one call per distribution,
so the drawn and the fed paths run the same code. The dual-averaging
constants are float32, as JAX computes them even under x64.

The work is counted (`profiling.count`) under `nuts.transitions`
(chains x transitions), `nuts.iterations` (iterations of the lockstep
loop, each one batched leapfrog), `nuts.reads` (host reads of stop
flags), `nuts.leapfrogs` (of all chains: a 0-dim device tensor, since
reading it would synchronise), and, of find_reasonable_step_size,
`nuts.find_iterations` and `nuts.find_reads`.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from gp_compressor_tpu_torch.config import HMCConfig
from gp_compressor_tpu_torch.ops import linalg_f32
from gp_compressor_tpu_torch.utils.profiling import count

BLOCK = 8                          # leapfrogs between reads of stop flags
GAMMA, T0, KAPPA = 0.05, 10.0, 0.75


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


def _generator(generator, device) -> torch.Generator:
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _da_consts(m: int):
    """(1 - eta, eta, sqrt(mf) / gamma, w, 1 - w) of the dual-averaging
    update at step m (Hoffman & Gelman 2014, eq. 6) as the JAX package's
    compiled loops compute them: mf = float32(m) + 1 and every constant in
    float32, whatever the chains' dtype; XLA turns the division by the
    constant gamma into a product with its float32 reciprocal (20). w =
    mf^-kappa is the float64 power rounded to float32 (XLA's float32 power
    differs from it in the last bit at a few m, the first at m = 323)."""
    f = np.float32
    mf = f(m) + f(1.0)
    eta = f(1.0) / (mf + f(T0))
    w = f(np.float64(mf) ** -KAPPA)
    return (float(f(1.0) - eta), float(eta),
            float(np.sqrt(mf) * (f(1.0) / f(GAMMA))), float(w),
            float(f(1.0) - w))


def _f32_product(c: float, x: torch.Tensor) -> torch.Tensor:
    """c * x rounded as a float32 product, in x's dtype."""
    return (c * x.to(torch.float32)).to(x.dtype)


def dual_average(m: int, acc, target: float, mu, h_bar, log_eps_bar,
                 weak_carry: bool = True):
    """One dual-averaging update at step m: (h_bar, log_eps, log_eps_bar).

    weak_carry: the JAX package's loops start h_bar and log_eps_bar from
    weakly typed Python zeros, and inside a loop the carries stay weakly
    typed, so (1 - eta) h_bar and (1 - w) log_eps_bar are float32 products
    even under x64 (a loop's outputs are not weakly typed: HMC's sampling
    loop, which continues from its warmup loop's outputs, multiplies in
    float64). The port rounds them the same way; for float32 chains both
    are the same."""
    ome, eta, s, w, omw = _da_consts(m)
    prod = _f32_product if weak_carry else (lambda c, x: c * x)
    h_bar = prod(ome, h_bar) + eta * (target - acc)
    log_eps = mu - s * h_bar
    return h_bar, log_eps, w * log_eps + prod(omw, log_eps_bar)


def _mv(inv_mass: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """inv_mass @ p per chain: inv_mass is a diagonal [..., dim] or a dense
    [..., dim, dim] inverse metric (a posterior covariance estimate)."""
    if inv_mass.ndim > p.ndim:
        return torch.matmul(inv_mass, p[..., None])[..., 0]
    return inv_mass * p


def _sample_momentum(z: torch.Tensor, inv_mass: torch.Tensor):
    """p ~ N(0, inv_mass^-1) from standard normals z [C, dim]."""
    if inv_mass.ndim > z.ndim:
        L = linalg_f32.cholesky(inv_mass)        # inv_mass = L L^T
        return linalg_f32.solve_lower_t(L, z)    # cov(p) = (L L^T)^-1
    return z / torch.sqrt(inv_mass)


class _Z(NamedTuple):
    theta: torch.Tensor        # [C, dim]
    p: torch.Tensor            # [C, dim]
    logp: torch.Tensor         # [C]
    grad: torch.Tensor         # [C, dim]

    def energy(self, inv_mass):
        return self.logp - 0.5 * torch.sum(self.p * _mv(inv_mass, self.p), -1)


def _zwhere(pred: torch.Tensor, a: _Z, b: _Z) -> _Z:
    """Per chain: a where pred [C], else b."""
    return _Z(*[torch.where(pred.reshape(pred.shape + (1,) * (x.ndim - 1)),
                            x, y) for x, y in zip(a, b)])


def _leapfrog(lg, z: _Z, eps: torch.Tensor, inv_mass) -> _Z:
    """One leapfrog of step eps [C] (signed) from z."""
    p = z.p + (0.5 * eps)[:, None] * z.grad
    theta = z.theta + eps[:, None] * _mv(inv_mass, p)
    logp, grad = lg(theta)
    p = p + (0.5 * eps)[:, None] * grad
    return _Z(theta, p, logp, grad)


def _uturn(theta_m, p_m, theta_p, p_p, inv_mass):
    d = theta_p - theta_m
    return (torch.sum(d * _mv(inv_mass, p_m), -1) < 0.0) | \
        (torch.sum(d * _mv(inv_mass, p_p), -1) < 0.0)


class NUTSDraws(NamedTuple):
    """The random draws of one NUTS transition of C chains. Leapfrog slot
    l < 2^max_depth - 1 of a chain uses column l (JAX folds the chain's
    leapfrog count into its key)."""

    z: torch.Tensor            # [C, dim] standard normals of the momentum
    go_right: torch.Tensor     # [C] bool, the first direction
    take: torch.Tensor         # [C, L] uniforms of the in-subtree sampling
    accept: torch.Tensor       # [C, L] uniforms of the subtree acceptance
    direction: torch.Tensor    # [C, L] bool, the next subtree's direction


def draw_transition(C: int, dim: int, max_depth: int, dtype, device,
                    generator: torch.Generator) -> NUTSDraws:
    """NUTSDraws of one transition: one normal and one uniform draw."""
    L = (1 << max_depth) - 1
    z = torch.randn((C, dim), generator=generator, dtype=dtype, device=device)
    u = torch.rand((C, 3 * L + 1), generator=generator, dtype=dtype,
                   device=device)
    return NUTSDraws(z, u[:, 0] < 0.5, u[:, 1:L + 1], u[:, L + 1:2 * L + 1],
                     u[:, 2 * L + 1:] < 0.5)


def _count_transition(n_lf: torch.Tensor, iterations: int, reads: int):
    count("nuts.transitions", n_lf.shape[0])
    count("nuts.iterations", iterations)
    count("nuts.reads", reads)
    count("nuts.leapfrogs", n_lf.sum())


def nuts_step(logpost: Callable, theta0: torch.Tensor, eps, inv_mass,
              max_depth: int = 8, draws: Optional[NUTSDraws] = None,
              generator: Optional[torch.Generator] = None):
    """One NUTS transition of every chain. theta0 [C, dim]; eps [C]; inv_mass
    [C, dim] (diagonal) or [C, dim, dim] (dense). Returns (theta [C, dim],
    accept statistic [C], leapfrog count [C] int32).

    The flat iterative form of the JAX package: one loop iteration is one
    leapfrog plus O(max_depth) predicated bookkeeping. Subtree j has 2^j
    leaves; the doubling-boundary work (biased trajectory acceptance,
    endpoint update, whole-trajectory U-turn test, the next direction)
    applies where the subtree completed. Sub-U-turn checks compare a leaf
    that closes a block of 2^k leaves with the block's first leaf, in time
    order (the sign flips for a backward subtree). A subtree that turns or
    diverges mid-build ends the transition unmerged."""
    lg = _safe_vag(logpost)
    C, dim = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    Smax = 1 << max(max_depth - 1, 0)
    L = (1 << max_depth) - 1
    if draws is None:
        draws = draw_transition(C, dim, max_depth, dt, dev,
                                _generator(generator, dev))
    eps = torch.as_tensor(eps, dtype=dt, device=dev).expand(C)
    log_take, log_acc = torch.log(draws.take), torch.log(draws.accept)

    logp0, grad0 = lg(theta0)
    z0 = _Z(theta0, _sample_momentum(draws.z, inv_mass), logp0, grad0)
    H0 = z0.energy(inv_mass)
    zero_i = torch.zeros((C,), dtype=torch.int32, device=dev)
    false = torch.zeros((C,), dtype=torch.bool, device=dev)
    z_minus = z_plus = z_cur = z0
    z_sample = z_prop = theta0
    log_w_total = torch.zeros((C,), dtype=dt, device=dev)
    log_w_sub = torch.full((C,), -torch.inf, dtype=dt, device=dev)
    sum_acc = torch.zeros((C,), dtype=dt, device=dev)
    stop, go_right = false, draws.go_right
    n_lf = depth = i_sub = zero_i
    thetas = torch.zeros((C, Smax, dim), dtype=dt, device=dev)
    ps = torch.zeros_like(thetas)
    ks = torch.arange(1, max_depth, device=dev)
    blk = (1 << ks).to(torch.int32)                               # [K]

    it, reads = 0, 0
    while True:
        active = ~stop
        step_eps = torch.where(go_right, eps, -eps)
        dirsign = torch.where(go_right, 1.0, -1.0).to(dt)

        z = _leapfrog(lg, z_cur, step_eps, inv_mass)
        dh = z.energy(inv_mass) - H0
        div = dh < -1000.0
        lw = torch.where(torch.isfinite(dh), dh, -torch.inf)
        # progressive multinomial sampling within the subtree
        log_w_sub = torch.logaddexp(log_w_sub, lw)
        take = log_take[:, it] < (lw - log_w_sub)
        z_prop = torch.where(take[:, None], z.theta, z_prop)
        sum_acc = sum_acc + torch.where(
            active, torch.minimum(torch.ones_like(dh), torch.exp(dh)), 0.0)
        slot = i_sub.long()[:, None, None].expand(C, 1, dim)
        thetas = thetas.scatter(1, slot, z.theta[:, None, :])
        ps = ps.scatter(1, slot, z.p[:, None, :])

        # sub-U-turn checks: leaf i closes the blocks of 2^k leaves with
        # (i + 1) % 2^k == 0; compare with each block's first leaf
        i1 = (i_sub + 1)[:, None]                                 # [C, 1]
        closes = (i1 % blk) == 0                                  # [C, K]
        first = torch.clamp(i1 - blk, min=0).long()[..., None].expand(
            C, ks.numel(), dim)
        d = (z.theta[:, None, :] - torch.gather(thetas, 1, first)) \
            * dirsign[:, None, None]
        ut = (torch.sum(d * _mv(inv_mass[:, None], torch.gather(ps, 1, first)),
                        -1) < 0.0) \
            | (torch.sum(d * _mv(inv_mass, z.p)[:, None, :], -1) < 0.0)
        sub_turn = torch.any(closes & ut, dim=1)

        done_leaves = (i_sub + 1) >= (1 << depth)
        bad = sub_turn | div
        sub_done = done_leaves | bad

        # doubling-boundary work, predicated on subtree completion
        ok = done_leaves & ~bad
        accept_sub = log_acc[:, it] < (log_w_sub - log_w_total)
        z_sample = torch.where((active & ok & accept_sub)[:, None], z_prop,
                               z_sample)
        log_w_total = torch.where(ok, torch.logaddexp(log_w_total, log_w_sub),
                                  log_w_total)
        z_minus = _zwhere(go_right | ~ok, z_minus, z)
        z_plus = _zwhere(go_right & ok, z, z_plus)
        whole_turn = _uturn(z_minus.theta, z_minus.p, z_plus.theta, z_plus.p,
                            inv_mass)
        new_depth = depth + sub_done.to(torch.int32)
        stop = stop | (sub_done & (bad | whole_turn | (new_depth >= max_depth)))

        # the next iteration: next leaf or next subtree. A stopped chain
        # keeps its integration point, subtree depth and leaf slot, so its
        # repeated leapfrogs never index past the subtree buffer
        go_next = draws.direction[:, it]
        go_right = torch.where(sub_done, go_next, go_right)
        z_start = _zwhere(go_next, z_plus, z_minus)
        z_cur = _zwhere(active, _zwhere(sub_done, z_start, z), z_cur)
        depth = torch.where(active, new_depth, depth)
        i_sub = torch.where(active & ~sub_done, i_sub + 1,
                            torch.where(active, 0, i_sub)).to(torch.int32)
        log_w_sub = torch.where(sub_done, -torch.inf, log_w_sub)
        z_prop = torch.where(sub_done[:, None], z_cur.theta, z_prop)
        n_lf = n_lf + active.to(torch.int32)

        it += 1
        if it >= L:
            break
        if it % BLOCK == 0:
            reads += 1
            if bool(stop.all()):
                break

    _count_transition(n_lf, it, reads)
    acc_stat = sum_acc / torch.clamp(n_lf, min=1)
    return z_sample, acc_stat, n_lf


def find_reasonable_step_size(logpost: Callable, theta0: torch.Tensor,
                              inv_mass, eps0, max_doublings: int = 30,
                              z: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """Hoffman & Gelman (2014) Algorithm 4, per chain: double or halve eps
    until the one-leapfrog acceptance ratio crosses 1/2. theta0 [C, dim];
    z: the momentum's standard normals [C, dim]. A chain whose logpost at
    theta0 is not finite keeps eps0. Returns eps [C]."""
    lg = _safe_vag(logpost)
    C, dim = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    if z is None:
        z = torch.randn((C, dim), generator=_generator(generator, dev),
                        dtype=dt, device=dev)
    logp0, grad0 = lg(theta0)
    z0 = _Z(theta0, _sample_momentum(z, inv_mass), logp0, grad0)
    H0 = z0.energy(inv_mass)

    def logr_at(eps):
        logr = _leapfrog(lg, z0, eps, inv_mass).energy(inv_mass) - H0
        return torch.where(torch.isfinite(logr), logr, -torch.inf)

    eps0 = torch.as_tensor(eps0, dtype=dt, device=dev).expand(C)
    eps, logr = eps0, logr_at(eps0)
    a = torch.where(logr > math.log(0.5), 1.0, -1.0).to(dt)
    n_it = torch.zeros((C,), dtype=torch.int32, device=dev)
    reads = 0
    for it in range(max_doublings):
        if it and it % BLOCK == 0:
            reads += 1
            if not bool(go.any()):
                break
        go = (a * logr > -a * math.log(2.0)) & (n_it < max_doublings)
        eps = torch.where(go, eps * torch.exp2(a), eps)
        logr = torch.where(go, logr_at(eps), logr)
        n_it = n_it + go.to(torch.int32)
        count("nuts.find_iterations")
    count("nuts.find_reads", reads)
    return torch.where(torch.isfinite(logp0), eps, eps0)


def _next(draws: Optional[Iterator], make: Callable):
    return make() if draws is None else next(draws)


def nuts_warmup_and_sample(logpost: Callable, theta0: torch.Tensor,
                           cfg: HMCConfig, adapt_mass: bool = False,
                           dense_mass: bool = False,
                           generator: Optional[torch.Generator] = None,
                           draws=None):
    """Warmup then sampling for chains theta0 [C, dim]. Returns (samples
    [C, num_samples, dim], mean accept statistic [C], step size [C]).

    Default: one fused run (find_reasonable_step_size, then num_warmup
    dual-averaged transitions, after which eps freezes at exp(log_eps_bar),
    then num_samples transitions) under a unit metric. dense_mass: a first
    unit-metric run of max(num_warmup // 2, 10) transitions whose settled
    half estimates each chain's posterior covariance (shrunk toward a small
    identity), which is the inverse metric of a second fused run.
    adapt_mass with num_warmup >= 100: two dual-averaging phases, the
    first's settled half giving a diagonal metric (shrunk, floored at 1% of
    its largest entry); with fewer warmup steps, one phase. draws: an
    iterable of the draws in the order they are used: at each run or
    phase start the momentum normals [C, dim] of
    find_reasonable_step_size, then one NUTSDraws per transition."""
    C, dim = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    if draws is None:
        generator = _generator(generator, dev)
    else:
        draws = iter(draws)
    depth_max = cfg.max_tree_depth
    find_z = lambda: _next(draws, lambda: torch.randn(
        (C, dim), generator=generator, dtype=dt, device=dev))
    step_draws = lambda: _next(draws, lambda: draw_transition(
        C, dim, depth_max, dt, dev, generator))

    def step(theta, eps, inv_mass):
        return nuts_step(logpost, theta, eps, inv_mass, depth_max,
                         draws=step_draws())

    def start(theta, inv_mass):
        eps0 = find_reasonable_step_size(logpost, theta, inv_mass,
                                         cfg.init_step_size, z=find_z())
        zero = torch.zeros((C,), dtype=dt, device=dev)
        return eps0, torch.log(10.0 * eps0), zero, zero

    def fused_run(theta, inv_mass, n_warm, n_samp):
        """find_reasonable eps + warmup + sampling; dual averaging applies
        for m < n_warm, then eps is exp(log_eps_bar). Returns (theta, eps,
        thetas [C, n_warm + n_samp, dim], accept statistics [C, ...])."""
        eps, mu, h_bar, log_eps_bar = start(theta, inv_mass)
        thetas, accs = [], []
        for m in range(n_warm + n_samp):
            theta, acc, _ = step(theta, eps, inv_mass)
            if m < n_warm:
                h_bar, log_eps, log_eps_bar = dual_average(
                    m, acc, cfg.target_accept, mu, h_bar, log_eps_bar)
            # the step after the last warmup transition, and every later
            # one, runs at the averaged step size
            eps = torch.exp(log_eps if m + 1 < n_warm else log_eps_bar)
            thetas.append(theta)
            accs.append(acc)
        return theta, eps, torch.stack(thetas, 1), torch.stack(accs, 1)

    def da_phase(theta, inv_mass, n):
        """n dual-averaging warmup transitions. Returns (theta, adapted
        eps, draws [C, n, dim])."""
        eps, mu, h_bar, log_eps_bar = start(theta, inv_mass)
        thetas = []
        for m in range(n):
            theta, acc, _ = step(theta, eps, inv_mass)
            h_bar, log_eps, log_eps_bar = dual_average(
                m, acc, cfg.target_accept, mu, h_bar, log_eps_bar)
            eps = torch.exp(log_eps)
            thetas.append(theta)
        return theta, torch.exp(log_eps_bar), torch.stack(thetas, 1)

    inv_mass = torch.ones((C, dim), dtype=dt, device=dev)
    if dense_mass:
        n1 = max(cfg.num_warmup // 2, 10)
        theta, _, drawn, _ = fused_run(theta0, inv_mass, n1, 0)
        tail = drawn[:, n1 // 2:]
        m = tail.shape[1]
        xc = tail - torch.mean(tail, dim=1, keepdim=True)
        Sigma = torch.matmul(xc.transpose(1, 2), xc) / max(m - 1, 1)
        # shrinkage toward a small identity: guards the few-draw estimate
        # and keeps the metric positive definite
        Sigma = (m / (m + 5.0)) * Sigma + 1e-3 * (5.0 / (m + 5.0)) * \
            torch.eye(dim, dtype=dt, device=dev)
        n2 = cfg.num_warmup - n1
        theta, eps, thetas, accs = fused_run(theta, Sigma, n2,
                                             cfg.num_samples)
        return thetas[:, n2:], torch.mean(accs[:, n2:], 1), eps

    if not adapt_mass:
        n_warm = cfg.num_warmup
        theta, eps, thetas, accs = fused_run(theta0, inv_mass, n_warm,
                                             cfg.num_samples)
        return thetas[:, n_warm:], torch.mean(accs[:, n_warm:], 1), eps

    if cfg.num_warmup >= 100:
        # a short first window can estimate a near-zero variance on an
        # axis where a chain barely moved: adapt only with a real budget,
        # and floor every axis at 1% of the largest
        n1 = cfg.num_warmup // 2
        theta, eps, drawn = da_phase(theta0, inv_mass, n1)
        tail = drawn[:, n1 // 2:]
        m = tail.shape[1]
        var = torch.var(tail, dim=1, unbiased=False)
        inv_mass = (m / (m + 5.0)) * var + 1e-3 * (5.0 / (m + 5.0))
        inv_mass = torch.maximum(inv_mass, 1e-2 * torch.amax(
            inv_mass, 1, keepdim=True)).clamp(max=1e6)
        theta, eps, _ = da_phase(theta, inv_mass, cfg.num_warmup - n1)
    else:
        theta, eps, _ = da_phase(theta0, inv_mass, cfg.num_warmup)

    samples, accs = [], []
    for _ in range(cfg.num_samples):
        theta, acc, _ = step(theta, eps, inv_mass)
        samples.append(theta)
        accs.append(acc)
    return torch.stack(samples, 1), torch.mean(torch.stack(accs, 1), 1), eps


def nuts_sample_chains(logpost: Callable, theta0: torch.Tensor,
                       cfg: HMCConfig, dense_mass: bool = False,
                       generator: Optional[torch.Generator] = None,
                       draws=None):
    """theta0 [C, dim] -> (samples [C, num_samples, dim], mean accept [C],
    step size [C]); dense_mass: per-chain two-phase dense metric (see
    nuts_warmup_and_sample)."""
    return nuts_warmup_and_sample(logpost, theta0, cfg,
                                  dense_mass=dense_mass, generator=generator,
                                  draws=draws)
