"""The port's Bayesian samplers against the JAX package, float64 on the CPU.

Exact parity: the chain diagnostics on fixed samples; one NUTS transition
at a normal step, at a step that diverges and under a dense metric;
find_reasonable_step_size with a chain whose log posterior is not finite;
the NUTS sampler in its three branches (fused, dense metric, adapted
diagonal metric); HMC chains; ADVI. The JAX functions draw from their key
trees, and the port is fed the same draws, built here from those keys
along JAX's own split / fold_in tree. Tolerance 1e-9 on states (float64
rounding through tens of leapfrogs of a 3-parameter posterior); leapfrog
counts equal.

Statistical tests with the port's own generator mirror
tests/test_inference.py (a correlated Gaussian's moments and R-hat; ADVI
on a Gaussian), and read counts show that HMC and ADVI read nothing back
and that NUTS reads at most once per block of leapfrogs.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu.config import HMCConfig as JHMCConfig
from gp_compressor_tpu.inference import hmc as jhmc
from gp_compressor_tpu.inference import nuts as jnuts
from gp_compressor_tpu.inference import vi as jvi
from gp_compressor_tpu_torch.config import HMCConfig
from gp_compressor_tpu_torch.inference import hmc as thmc
from gp_compressor_tpu_torch.inference import nuts as tnuts
from gp_compressor_tpu_torch.inference import vi as tvi
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.utils import profiling

torch.set_num_threads(1)

T = torch.from_numpy
ATOL = 1e-9
PRIOR = dict(prior_mean=(0.0, -1.0, -4.0), prior_std=4.0)
THETA0 = np.array([[0.5, -0.5, -4.0], [1.0, -2.0, -5.0]])
DENSE = np.array([[0.3, 0.05, 0.0], [0.05, 0.2, 0.02], [0.0, 0.02, 0.5]])
COV = np.array([[1.0, 0.7], [0.7, 2.0]])


def _bank(B=4, n=12, seed=0):
    """A tiny patch bank drawn from a GP (sigma_f^2 2, l^2 0.25, s20 0.01),
    three rows of one patch masked."""
    r = np.random.default_rng(seed)
    X = r.uniform(-1.0, 1.0, (B, n, 2))
    d2 = np.sum((X[:, :, None] - X[:, None]) ** 2, -1)
    K = 2.0 * np.exp(-0.5 * d2 / 0.25) + 0.01 * np.eye(n)
    y = np.stack([r.multivariate_normal(np.zeros(n), K[b]) for b in range(B)])
    mask = np.ones((B, n))
    mask[1, -3:] = 0.0
    return X, y, mask


@functools.lru_cache(maxsize=None)
def _logposts():
    X, y, m = _bank()
    return (jhmc.make_patch_logpost(jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(m), **PRIOR),
            thmc.make_patch_logpost(T(X), T(y), T(m), **PRIOR))


def _gauss():
    jp, tp = jnp.asarray(np.linalg.inv(COV)), T(np.linalg.inv(COV))
    return (lambda th: -0.5 * th @ jp @ th,
            lambda th: -0.5 * torch.einsum("...i,ij,...j->...", th, tp, th))


# ---- the JAX draws, along JAX's key trees -------------------------------

def nuts_step_draws(key, dim, max_depth, dtype=jnp.float64):
    """(z, go_right, take, accept, direction) of jax nuts_step(key)."""
    kp, kd0, key = jax.random.split(key, 3)

    def slot(n_lf):
        k_take, k_acc, k_dir = jax.random.split(jax.random.fold_in(key, n_lf),
                                                3)
        return (jax.random.uniform(k_take), jax.random.uniform(k_acc),
                jax.random.bernoulli(k_dir))

    take, acc, d = jax.vmap(slot)(jnp.arange((1 << max_depth) - 1,
                                             dtype=jnp.int32))
    return (jax.random.normal(kp, (dim,), dtype), jax.random.bernoulli(kd0),
            take, acc, d)


def _stack_draws(per_chain):
    """Per-chain (z, d0, take, acc, dir) -> one NUTSDraws."""
    return tnuts.NUTSDraws(*[T(np.stack([np.asarray(c[i]) for c in per_chain]))
                             for i in range(5)])


def _find_z(key, dim):
    return jax.random.normal(key, (dim,), jnp.float64)


def _fused_items(key, n, dim, depth):
    """The draws of jax nuts fused_run(key) with n transitions."""
    key, kf = jax.random.split(key)
    return [("z", _find_z(kf, dim))] + [
        ("t", nuts_step_draws(k, dim, depth)) for k in jax.random.split(key, n)]


def _da_items(key, n, dim, depth):
    """The draws of jax nuts da_phase(key) with n transitions."""
    key, kf = jax.random.split(key)
    items = [("z", _find_z(kf, dim))]
    for _ in range(n):
        key, sub = jax.random.split(key)
        items.append(("t", nuts_step_draws(sub, dim, depth)))
    return items


def nuts_run_draws(key, C, dim, cfg, branch):
    """The port's draw sequence for jax nuts_warmup_and_sample over C
    chains (chain c keyed by split(key, C)[c])."""
    depth, W, S = cfg.max_tree_depth, cfg.num_warmup, cfg.num_samples
    chains = []
    for kc in jax.random.split(key, C):
        kc, k1 = jax.random.split(kc)
        if branch == "dense":
            n1 = max(W // 2, 10)
            kc, k2 = jax.random.split(kc)
            items = _fused_items(k1, n1, dim, depth) + \
                _fused_items(k2, W - n1 + S, dim, depth)
        elif branch == "fused":
            items = _fused_items(k1, W + S, dim, depth)
        else:                                     # adapt_mass, W >= 100
            n1 = W // 2
            items = _da_items(k1, n1, dim, depth)
            kc, k2 = jax.random.split(kc)
            items += _da_items(k2, W - n1, dim, depth)
            items += [("t", nuts_step_draws(k, dim, depth))
                      for k in jax.random.split(kc, S)]
        chains.append(items)
    out = []
    for i, (kind, _) in enumerate(chains[0]):
        col = [c[i][1] for c in chains]
        out.append(T(np.stack([np.asarray(z) for z in col])) if kind == "z"
                   else _stack_draws(col))
    return out


def hmc_run_draws(key, C, dim, cfg):
    """HMCDraws of jax hmc_sample_chains(key) over C chains."""
    zs, us = [], []
    for kc in jax.random.split(key, C):
        kc, kw = jax.random.split(kc)
        subs = []
        for _ in range(cfg.num_warmup):
            kw, sub = jax.random.split(kw)
            subs.append(sub)
        subs += list(jax.random.split(kc, cfg.num_samples))
        pairs = [jax.random.split(s) for s in subs]
        zs.append(np.stack([np.asarray(jax.random.normal(k1, (dim,)))
                            for k1, _ in pairs]))
        us.append(np.stack([np.asarray(jax.random.uniform(k2))
                            for _, k2 in pairs]))
    return thmc.HMCDraws(T(np.stack(zs)), T(np.stack(us)))


# ---- exact parity ------------------------------------------------------

def test_diagnostics_match_jax():
    """split_rhat and ESS on fixed autocorrelated samples [4, 60, 3]."""
    r = np.random.default_rng(3)
    x = np.zeros((4, 60, 3))
    for t in range(1, 60):
        x[:, t] = 0.6 * x[:, t - 1] + r.standard_normal((4, 3))
    x += np.array([0.0, 0.3, -0.2])[None, None] * np.arange(4)[:, None, None]
    for f, kw in (("split_rhat", {}), ("effective_sample_size", {}),
                  ("effective_sample_size", {"max_lag": 20})):
        # jitted: eager JAX compiles each lag's slice on its own
        j = np.asarray(jax.jit(functools.partial(getattr(jhmc, f), **kw))(
            jnp.asarray(x)))
        t = getattr(thmc, f)(T(x), **kw).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-12)


@pytest.mark.parametrize("case", ["normal", "divergent", "dense"])
def test_nuts_step_matches_jax(case):
    """One transition of 2 chains on the tiny patch-bank posterior
    (max_depth 5): theta, accept statistic and leapfrog count."""
    jlp, tlp = _logposts()
    eps = {"normal": 0.25, "divergent": 40.0, "dense": 0.4}[case]
    inv = DENSE if case == "dense" else np.ones(3)
    keys = jax.random.split(jax.random.key(11), 2)
    f = jax.jit(jax.vmap(lambda th, k: jnuts.nuts_step(
        jlp, th, k, eps, jnp.asarray(inv), max_depth=5)))
    jt, ja, jn = f(jnp.asarray(THETA0), keys)
    draws = _stack_draws([nuts_step_draws(k, 3, 5) for k in keys])
    profiling.reset_counters()
    tt, ta, tn = tnuts.nuts_step(
        tlp, T(THETA0), eps, T(inv).expand((2,) + inv.shape), max_depth=5,
        draws=draws)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    if case == "divergent":
        assert int(tn.max()) <= 2
    else:
        assert int(tn.min()) >= 3
    c = profiling.counters()
    assert c["nuts.transitions"] == 2
    assert int(c["nuts.leapfrogs"]) == int(tn.sum())


def test_lockstep_chains_match_single_chains():
    """Chains in lockstep give what each chain gives alone from the same
    draws: chain 0 stops within a few leapfrogs beside a -inf wall while
    chain 1 (a tiny step) runs all 2^8 - 1, so the stopped chain keeps
    taking the loop's leapfrogs (toward the wall they diverge) and must
    stay inside its subtree buffer."""
    def lp(th):
        v = -0.5 * torch.sum(th * th, -1)
        return torch.where(th[..., 0] < 1.0, v, torch.full_like(v, -torch.inf))

    th = torch.tensor([[0.9, 0.0, 0.0], [0.0, 0.0, 0.0]], dtype=torch.float64)
    eps = torch.tensor([0.5, 1e-3], dtype=torch.float64)
    inv = torch.ones(2, 3, dtype=torch.float64)
    for seed in range(4):            # the overflow showed at seed 3
        d = tnuts.draw_transition(2, 3, 8, torch.float64, "cpu",
                                  torch.Generator().manual_seed(seed))
        both = tnuts.nuts_step(lp, th, eps, inv, 8, draws=d)
        assert both[2].tolist()[1] == 255
        for c in range(2):
            one = tnuts.nuts_step(lp, th[c:c + 1], eps[c:c + 1],
                                  inv[c:c + 1], 8,
                                  draws=tnuts.NUTSDraws(*[a[c:c + 1]
                                                          for a in d]))
            for a, b in zip(both, one):
                assert torch.equal(a[c:c + 1], b)


def test_find_reasonable_step_size_matches_jax():
    """Three chains, one of which starts where the log posterior is -inf
    (the condition gate refuses its Gram) and keeps eps0."""
    jlp, tlp = _logposts()
    th = np.array([[0.5, -0.5, -4.0], [1.0, -2.0, -5.0], [30.0, 0.0, -30.0]])
    keys = jax.random.split(jax.random.key(5), 3)
    j = jax.jit(jax.vmap(lambda t, k: jnuts.find_reasonable_step_size(
        jlp, t, k, jnp.ones(3), 0.1)))(jnp.asarray(th), keys)
    z = T(np.stack([np.asarray(_find_z(k, 3)) for k in keys]))
    t = tnuts.find_reasonable_step_size(tlp, T(th), torch.ones(
        3, 3, dtype=torch.float64), 0.1,
                                        z=z)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    assert float(t[2]) == 0.1 and float(t[0]) != 0.1


@pytest.mark.parametrize("branch", ["fused", "dense", "adapt_mass"])
def test_nuts_sampler_matches_jax(branch):
    """A few transitions of each branch: the default fused run and the
    dense metric on the patch-bank posterior, the adapted diagonal metric
    (num_warmup 100) on a 2-D Gaussian."""
    if branch == "adapt_mass":
        jlp, tlp = _gauss()
        cfg = dict(num_warmup=100, num_samples=3, max_tree_depth=4)
        th0 = np.array([[0.3, -0.4], [-1.0, 0.8]])
    else:
        jlp, tlp = _logposts()
        cfg = dict(num_warmup=20 if branch == "dense" else 4, num_samples=3,
                   max_tree_depth=5)
        th0 = THETA0
    C, dim = th0.shape
    key = jax.random.key(21)
    jc = JHMCConfig(num_chains=C, **cfg)
    if branch == "adapt_mass":
        keys = jax.random.split(key, C)
        js, ja, je = jax.jit(jax.vmap(lambda t, k: jnuts.nuts_warmup_and_sample(
            jlp, t, k, jc, adapt_mass=True)))(jnp.asarray(th0), keys)
    else:
        js, ja, je = jax.jit(lambda t, k: jnuts.nuts_sample_chains(
            jlp, t, k, jc, dense_mass=branch == "dense"))(jnp.asarray(th0),
                                                          key)
    draws = nuts_run_draws(key, C, dim, jc, branch)
    tc = HMCConfig(num_chains=C, **cfg)
    if branch == "adapt_mass":
        ts, ta, te = tnuts.nuts_warmup_and_sample(tlp, T(th0), tc,
                                                  adapt_mass=True, draws=draws)
    else:
        ts, ta, te = tnuts.nuts_sample_chains(
            tlp, T(th0), tc, dense_mass=branch == "dense", draws=draws)
    assert ts.shape == (C, cfg["num_samples"], dim)
    for t, j in ((ts, js), (ta, ja), (te, je)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=ATOL)


def test_hmc_sample_chains_matches_jax():
    """Warmup and sampling on a correlated 3-D Gaussian (the patch-bank
    posterior's HMC graph takes JAX ~10 s to compile; the samplers share
    it with the NUTS tests above): samples, accept rates, step sizes."""
    cov = np.array([[1.0, 0.6, 0.1], [0.6, 2.0, -0.3], [0.1, -0.3, 0.5]])
    jp, tp = jnp.asarray(np.linalg.inv(cov)), T(np.linalg.inv(cov))
    cfg = dict(num_warmup=5, num_samples=4, num_chains=2)
    key = jax.random.key(31)
    js, ja, je = jax.jit(lambda t, k: jhmc.hmc_sample_chains(
        lambda th: -0.5 * th @ jp @ th, t, k, JHMCConfig(**cfg)))(
            jnp.asarray(THETA0), key)
    draws = hmc_run_draws(key, 2, 3, JHMCConfig(**cfg))
    ts, ta, te = thmc.hmc_sample_chains(
        lambda th: -0.5 * torch.einsum("...i,ij,...j->...", th, tp, th),
        T(THETA0), HMCConfig(**cfg), draws=draws)
    for t, j in ((ts, js), (ta, ja), (te, je)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=ATOL)


def test_fit_advi_matches_jax():
    jlp, tlp = _logposts()
    key = jax.random.key(41)
    steps, n_mc = 25, 8
    j = jvi.fit_advi(jlp, jnp.asarray(THETA0[0]), key, steps=steps, lr=0.05,
                     n_mc=n_mc)
    eps = T(np.stack([np.asarray(jax.random.normal(k, (n_mc, 3)))
                      for k in jax.random.split(key, steps)]))
    t = tvi.fit_advi(tlp, T(THETA0[0]), steps=steps, lr=0.05, n_mc=n_mc,
                     eps=eps)
    ref = convert.vi_result_from_numpy(
        {k: np.asarray(v) for k, v in j._asdict().items()}, device="cpu")
    for a, b in zip(t, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                   rtol=ATOL)
    assert bool(tvi.elbo_plateaued(t.elbo_trace, window=10)) == \
        bool(jvi.elbo_plateaued(j.elbo_trace, window=10))
    z = np.random.default_rng(0).standard_normal((5, 3))
    np.testing.assert_allclose(
        tvi.sample_posterior(t, 5, eps=T(z)).numpy(),
        np.asarray(j.mean) + z * np.exp(np.asarray(j.log_std)), atol=ATOL)


# ---- statistics with the port's own generator --------------------------

def _moments(samples, acc):
    s = samples.reshape(-1, 2).numpy()
    assert float(acc.mean()) > 0.5, acc
    assert np.abs(s.mean(0)).max() < 0.2, s.mean(0)
    assert np.abs(np.cov(s.T) - COV).max() < 0.4, np.cov(s.T)
    assert float(thmc.split_rhat(samples).max()) < 1.1


def test_nuts_samples_gaussian():
    _, tlp = _gauss()
    g = torch.Generator().manual_seed(3)
    th0 = torch.randn((4, 2), generator=g, dtype=torch.float64)
    samples, acc, _ = tnuts.nuts_sample_chains(
        tlp, th0, HMCConfig(num_warmup=150, num_samples=400,
                            max_tree_depth=6), generator=g)
    _moments(samples, acc)


def test_hmc_samples_gaussian():
    _, tlp = _gauss()
    g = torch.Generator().manual_seed(1)
    th0 = torch.randn((4, 2), generator=g, dtype=torch.float64)
    samples, acc, _ = thmc.hmc_sample_chains(
        tlp, th0, HMCConfig(num_warmup=200, num_samples=500, num_chains=4),
        generator=g)
    _moments(samples, acc)


def test_advi_fits_gaussian():
    prec = T(np.linalg.inv(np.diag([0.5, 2.0])))
    mu = torch.tensor([1.0, -2.0], dtype=torch.float64)

    def logpost(th):
        d = th - mu
        return -0.5 * torch.einsum("...i,ij,...j->...", d, prec, d)

    res = tvi.fit_advi(logpost, torch.zeros(2, dtype=torch.float64),
                       steps=400, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(res.mean.numpy(), mu.numpy(), atol=0.3)
    np.testing.assert_allclose(np.exp(2 * res.log_std.numpy()), [0.5, 2.0],
                               rtol=0.4)
    tr = res.elbo_trace.numpy()
    assert tr[-50:].mean() > tr[:50].mean()


# ---- host reads ----------------------------------------------------------

def _count_reads(monkeypatch):
    return importlib.import_module("test_torch_calibration")._count_reads(
        monkeypatch)


def test_hmc_and_advi_read_nothing(monkeypatch):
    _, tlp = _logposts()
    reads = _count_reads(monkeypatch)
    thmc.hmc_sample_chains(tlp, T(THETA0), HMCConfig(num_warmup=3,
                                                     num_samples=3))
    tvi.fit_advi(tlp, T(THETA0[0]), steps=5)
    assert reads == []


def test_nuts_reads_once_per_block(monkeypatch):
    """Each transition reads at most once per block of leapfrogs (the
    last block ends without a read at 2^max_depth - 1), and the step-size
    search at most once per block of its doublings."""
    _, tlp = _logposts()
    profiling.reset_counters()
    reads = _count_reads(monkeypatch)
    cfg = HMCConfig(num_warmup=3, num_samples=3, max_tree_depth=5)
    tnuts.nuts_sample_chains(tlp, T(THETA0), cfg)
    c = {k[len("nuts."):]: v for k, v in profiling.counters().items()
         if k.startswith("nuts.")}
    n_trans = cfg.num_warmup + cfg.num_samples
    assert len(reads) == c["reads"] + c["find_reads"] > 0
    assert c["transitions"] == 2 * n_trans
    assert c["reads"] <= c["iterations"] // tnuts.BLOCK
    assert c["iterations"] <= n_trans * ((1 << 5) - 1)
    assert c["find_reads"] <= 30 // tnuts.BLOCK
