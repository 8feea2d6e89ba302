"""The port's calibration layer against the JAX package, float64 on the
CPU unless a case says otherwise: the kernel's hyperparameter derivative,
the small-matrix linear algebra, the exact GP, the marginal posterior, the
Adam update, the MAP ascents, the calibration subsample, and the
calibrated round trip (staged and in one call) on a small room cloud.
Besides: the posterior's callable object against the closure it
replaced, the ascents' eager path on the CPU, and the key of the card's
ascent graphs."""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.inference import hmc as jhmc
from gp_compressor_tpu.models import exact_gp as jexact
from gp_compressor_tpu.ops import kernels as jkern
from gp_compressor_tpu.ops import linalg_f32 as jla
from gp_compressor_tpu.ops.kernels import RBFParams as JRBF
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.inference import hmc as thmc
from gp_compressor_tpu_torch.inference import nuts
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.models import exact_gp as texact
from gp_compressor_tpu_torch.ops import kernels as tkern
from gp_compressor_tpu_torch.ops import linalg_f32 as tla
from gp_compressor_tpu_torch.ops.kernels import RBFParams as TRBF
from gp_compressor_tpu_torch.testing import sogp_regimes
from gp_compressor_tpu_torch.utils import profiling
from gp_compressor_tpu_torch.workloads import compressor as tcomp

torch.set_num_threads(1)

T = torch.from_numpy


def _spd(r, n, batch=()):
    A = r.standard_normal(batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_gram_dtheta_and_dx_match_jax():
    r = np.random.default_rng(0)
    X, Z = r.uniform(-0.1, 0.1, (7, 2)), r.uniform(-0.1, 0.1, (5, 2))
    for sf, l2 in ((100.0, 1.0), (1.04e-3, 1.36e-3)):
        jp, tp = JRBF(jnp.asarray(sf), jnp.asarray(l2)), \
            TRBF(torch.tensor(sf, dtype=torch.float64),
                 torch.tensor(l2, dtype=torch.float64))
        for f in ("gram_dtheta", "gram_dx"):
            j = np.asarray(getattr(jkern, f)(jp, jnp.asarray(X), jnp.asarray(Z)))
            t = getattr(tkern, f)(tp, T(X), T(Z)).numpy()
            np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12 * abs(j).max())


@pytest.mark.parametrize("vec", [True, False], ids=["b[n]", "b[n,k]"])
def test_linalg_matches_jax_and_numpy(vec):
    r = np.random.default_rng(1)
    n = 9
    K = _spd(r, n)
    b = r.standard_normal((n,) if vec else (n, 3))
    L = np.linalg.cholesky(K)
    tL = tla.cholesky(T(K))
    np.testing.assert_allclose(tL.numpy(), L, atol=1e-10)
    np.testing.assert_allclose(tL.numpy(), np.asarray(jla.cholesky(jnp.asarray(K))),
                               atol=1e-10)
    ref = {"solve_lower": np.linalg.solve(L, b),
           "solve_lower_t": np.linalg.solve(L.T, b),
           "cho_solve": np.linalg.solve(K, b)}
    for f, want in ref.items():
        t = getattr(tla, f)(T(L), T(b)).numpy()
        j = np.asarray(getattr(jla, f)(jnp.asarray(L), jnp.asarray(b)))
        np.testing.assert_allclose(t, want, atol=1e-10)
        np.testing.assert_allclose(t, j, atol=1e-10)

    # gradients: torch autograd against JAX's closed-form VJPs
    W = r.standard_normal((n, n))
    _, vjp = jax.vjp(jla.cholesky, jnp.asarray(K))
    Kt = T(K).requires_grad_(True)
    g, = torch.autograd.grad(tla.cholesky(Kt), Kt, T(W))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(W))[0]),
                               atol=1e-9)
    xbar = r.standard_normal(b.shape)
    for f in ("solve_lower", "solve_lower_t"):
        _, vjp = jax.vjp(getattr(jla, f), jnp.asarray(L), jnp.asarray(b))
        jl, jb = vjp(jnp.asarray(xbar))
        Lt, bt = T(L).requires_grad_(True), T(b).requires_grad_(True)
        gl, gb = torch.autograd.grad(getattr(tla, f)(Lt, bt), (Lt, bt),
                                     T(xbar))
        np.testing.assert_allclose(gl.numpy(), np.asarray(jl), atol=1e-9)
        np.testing.assert_allclose(gb.numpy(), np.asarray(jb), atol=1e-9)


def test_cholesky_of_indefinite_is_all_nan():
    r = np.random.default_rng(2)
    K = _spd(r, 6, (3,))
    K[1, 4, 4] = -50.0                     # one indefinite matrix
    L = tla.cholesky(T(K))
    assert torch.isnan(L[1]).all()
    assert torch.isfinite(L[[0, 2]]).all()
    assert np.isnan(np.asarray(jla.cholesky(jnp.asarray(K[1])))).any()


def test_exact_gp_matches_jax():
    r = np.random.default_rng(3)
    B, n, m = 4, 12, 6
    X = r.uniform(-0.1, 0.1, (B, n, 2))
    y = r.standard_normal((B, n, 1)) * 0.01
    mask = (r.uniform(size=(B, n)) > 0.3).astype(np.float64)
    Xs = r.uniform(-0.1, 0.1, (B, m, 2))
    jp = JRBF(jnp.asarray(1e-3), jnp.asarray(2e-3))
    tp = TRBF(torch.tensor(1e-3, dtype=torch.float64),
              torch.tensor(2e-3, dtype=torch.float64))
    js = jexact.fit_batch(jp, 4e-4, jnp.asarray(X), jnp.asarray(y),
                          jnp.asarray(mask))
    ts = texact.fit_batch(tp, 4e-4, T(X), T(y), T(mask))
    for f in ("chol", "alpha"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-10)
    jm, jv = jexact.predict_batch(jp, js, jnp.asarray(Xs))
    tm, tv = texact.predict_batch(tp, ts, T(Xs))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-10)


def _bank(seed=4, B=8, n=24, dtype=np.float64):
    """A small calibration bank: smooth surfaces plus noise, one patch
    fully masked and one half masked."""
    r = np.random.default_rng(seed)
    X = r.uniform(-0.075, 0.075, (B, n, 2))
    y = 0.02 * np.sin(9 * X[..., 0]) + 0.01 * np.cos(13 * X[..., 1]) \
        + 0.003 * r.standard_normal((B, n))
    mask = np.ones((B, n))
    mask[2] = 0.0
    mask[5, n // 2:] = 0.0
    return X.astype(dtype), y.astype(dtype), mask.astype(dtype)


THETAS = [
    [np.log(100.0), 0.0, np.log(0.1)],                  # reference constants
    [np.log(1.04e-3), np.log(1.36e-3), np.log(4.4e-4)],  # calibrated scale
    [np.log(1e-2), np.log(5e-3), np.log(1e-3)],
    [np.log(1e4), 0.0, np.log(1e-12)],                  # past the gate: -inf
]


def _vag_t(f, theta, dtype):
    th = torch.tensor(theta, dtype=dtype, requires_grad=True)
    v = f(th)
    g, = torch.autograd.grad(v, th)
    return v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("f64", [True, False], ids=["float64", "float32"])
def test_marginal_loglik_and_logpost_match_jax(f64):
    npdt = np.float64 if f64 else np.float32
    tdt = torch.float64 if f64 else torch.float32
    rtol = 1e-9 if f64 else 1e-4
    X, y, mask = _bank(dtype=npdt)
    jX, jy, jm = (jnp.asarray(a) for a in (X, y, mask))
    tX, ty, tm = T(X), T(y), T(mask)
    jll = jax.jit(jax.value_and_grad(jhmc.gp_marginal_loglik))
    jlp = jax.jit(jax.value_and_grad(jhmc.make_patch_logpost(jX, jy, jm)))
    tlp = thmc.make_patch_logpost(tX, ty, tm)
    # float32 gradients carry the Gram's conditioning (~1e4 at the
    # reference constants) times eps: compared relative to their largest
    # component
    for theta in THETAS:
        th = np.asarray(theta, npdt)
        for p in (2, 5, 0):                # masked, half masked, full
            jv, jg = jll(jnp.asarray(th), jX[p], jy[p], jm[p])
            tv, tg = _vag_t(lambda t: thmc.gp_marginal_loglik(
                t, tX[p], ty[p], tm[p]), th, tdt)
            if np.isinf(jv):
                assert np.isinf(tv) and tv < 0
            else:
                np.testing.assert_allclose(tv, np.asarray(jv), rtol=rtol)
            np.testing.assert_allclose(tg, np.asarray(jg), rtol=rtol,
                                       atol=rtol * np.abs(jg).max())
        jv, jg = jlp(jnp.asarray(th))
        tv, tg = _vag_t(tlp, th, tdt)
        if np.isinf(jv):
            assert np.isinf(tv) and tv < 0
        else:
            np.testing.assert_allclose(tv, np.asarray(jv), rtol=rtol)
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=rtol,
                                   atol=rtol * np.abs(jg).max())
    # theta with a batch dim: the starts of the multi-start ascent
    th = torch.tensor(THETAS, dtype=tdt)
    batched = tlp(th)
    for i, theta in enumerate(THETAS):
        np.testing.assert_allclose(batched[i].numpy(),
                                   tlp(th[i]).numpy(), rtol=1e-12)


def test_adam_matches_optax():
    r = np.random.default_rng(5)
    grads = r.standard_normal((50, 3)) * np.logspace(-3, 2, 50)[:, None]
    opt = optax.adam(0.05)
    jth = jnp.asarray([0.3, -1.0, 2.0])
    st = opt.init(jth)
    tth = torch.tensor([0.3, -1.0, 2.0], dtype=torch.float64)
    tst = thmc.adam_init(tth)
    for g in grads:
        u, st = opt.update(jnp.asarray(g), st)
        jth = jth + u
        tu, tst = thmc.adam_update(T(g), tst, 0.05)
        tth = tth + tu
        np.testing.assert_allclose(tu.numpy(), np.asarray(u), rtol=1e-13)
    np.testing.assert_allclose(tth.numpy(), np.asarray(jth), rtol=1e-13)


def _logposts():
    X, y, mask = _bank()
    return (jhmc.make_patch_logpost(*(jnp.asarray(a) for a in (X, y, mask))),
            thmc.make_patch_logpost(T(X), T(y), T(mask)))


THETA0 = [np.log(100.0), 0.0, np.log(0.1)]


def test_map_estimate_matches_jax():
    jlp, tlp = _logposts()
    jth, jtr = jhmc.map_estimate(jlp, jnp.asarray(THETA0), steps=40, lr=0.1)
    tth, ttr = thmc.map_estimate(tlp, torch.tensor(THETA0, dtype=torch.float64),
                                 steps=40, lr=0.1)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-7)
    np.testing.assert_allclose(tth.numpy(), np.asarray(jth), atol=1e-6)


@pytest.mark.parametrize("case", ["starts", "one_start_gated", "float32"])
def test_map_estimate_multi_matches_jax(case):
    """Four starts as one batch, float64; with `one_start_gated` the first
    start is put past the condition gate (-inf, zero gradient), and the
    other three must come out exactly as without it. In float32 (the
    card's calibration dtype, with its relative noise floor) the ascent
    lands on JAX's theta to float32 rounding."""
    gated, f32 = case == "one_start_gated", case == "float32"
    if f32:
        X, y, mask = _bank(dtype=np.float32)
        jlp = jhmc.make_patch_logpost(*(jnp.asarray(a) for a in (X, y, mask)))
        tlp = thmc.make_patch_logpost(T(X), T(y), T(mask))
    else:
        jlp, tlp = _logposts()
    npdt, tdt = (np.float32, torch.float32) if f32 else (np.float64,
                                                         torch.float64)
    init = [np.log(1e6), 0.0, np.log(1e-10)] if gated else None
    kw = dict(steps=30, lr=0.1, n_starts=4)
    jth, jlps = jhmc.map_estimate_multi(
        jlp, jnp.asarray(THETA0, npdt), theta_init=None if init is None
        else jnp.asarray(init), **kw)
    tth, tlps = thmc.map_estimate_multi(
        tlp, torch.tensor(THETA0, dtype=tdt),
        theta_init=None if init is None
        else torch.tensor(init, dtype=tdt), **kw)
    jl, tl = np.asarray(jlps), tlps.numpy()
    assert np.array_equal(np.isfinite(tl), np.isfinite(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], rtol=1e-4 if f32 else 1e-7)
    assert np.argmax(np.where(fin, tl, -np.inf)) == np.argmax(
        np.where(fin, jl, -np.inf))
    np.testing.assert_allclose(tth.numpy(), np.asarray(jth),
                               atol=1e-4 if f32 else 1e-6)
    if gated:
        assert tl[0] == -np.inf and fin[1:].all()
        _, free = thmc.map_estimate_multi(
            tlp, torch.tensor(THETA0, dtype=torch.float64), **kw)
        np.testing.assert_allclose(tl[1:], free.numpy()[1:], rtol=1e-12)


def _closure_logpost(X, y, mask, prior_mean=(4.6, 0.0, -2.3), prior_std=3.0,
                     noise_floor_rel=None):
    """make_patch_logpost as a closure, as the port had it before the
    callable object."""
    pm = torch.tensor(prior_mean, dtype=X.dtype, device=X.device)
    if noise_floor_rel is None:
        noise_floor_rel = 1e-4 if X.dtype == torch.float32 else 0.0

    def logpost(theta):
        ll = torch.sum(thmc.gp_marginal_loglik(theta[..., None, :], X, y,
                                               mask, noise_floor_rel), dim=-1)
        lp = torch.sum(-0.5 * ((theta - pm) / prior_std) ** 2, dim=-1)
        out = ll + lp
        return torch.where(torch.isfinite(out), out,
                           torch.full_like(out, -torch.inf))

    return logpost


@pytest.mark.parametrize("prior", [{}, dict(prior_mean=(0.0, -1.0, -4.0),
                                            prior_std=4.0)],
                         ids=["default", "own_prior"])
@pytest.mark.parametrize("f64", [True, False], ids=["float64", "float32"])
def test_patch_logpost_object_matches_closure_bitwise(f64, prior):
    """The callable object gives the closure's values and gradients bit
    for bit, at each theta of THETAS (the last one gated) and batched."""
    npdt = np.float64 if f64 else np.float32
    tdt = torch.float64 if f64 else torch.float32
    bank = tuple(T(a) for a in _bank(dtype=npdt))
    obj = thmc.make_patch_logpost(*bank, **prior)
    assert isinstance(obj, thmc.PatchLogpost)
    assert obj.X is bank[0] and obj.y is bank[1] and obj.mask is bank[2]
    clo = _closure_logpost(*bank, **prior)
    for theta in THETAS + [THETAS]:
        th = torch.tensor(theta, dtype=tdt)
        (vo, go), (vc, gc) = (nuts._vag(f, th) for f in (obj, clo))
        assert torch.equal(vo, vc) and torch.equal(go, gc)


def _eager_count():
    c = profiling.counters()
    return tuple(c.get(f"calibration.{k}", 0)
                 for k in ("eager_ascents", "graph_captures", "graph_replays"))


@pytest.mark.parametrize("fn", ["map_estimate", "map_estimate_multi"])
def test_map_ascents_on_cpu_run_eager(fn):
    """On the CPU every ascent runs eager, repeated calls included: each
    call counts one eager ascent and no graph, and the results equal the
    JAX package's as before."""
    jlp, tlp = _logposts()
    th0 = torch.tensor(THETA0, dtype=torch.float64)
    kw = dict(steps=20, lr=0.1) if fn == "map_estimate" else dict(
        steps=20, lr=0.1, n_starts=4)
    want = getattr(jhmc, fn)(jlp, jnp.asarray(THETA0), **kw)
    before = _eager_count()
    for _ in range(3):
        got = getattr(thmc, fn)(tlp, th0, **kw)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-7)
    after = _eager_count()
    assert (after[0] - before[0], after[1:]) == (3, before[1:])
    assert not thmc._graphs


KEY_CHANGES = {
    "steps": lambda b, th: (b, th, 41, 0.1),
    "lr": lambda b, th: (b, th, 40, 0.05),
    "starts": lambda b, th: (b, th.expand(4, 3), 40, 0.1),
    "bank_rows": lambda b, th: ((b[0][:-1], b[1][:-1], b[2][:-1]), th, 40,
                                0.1),
    "bank_points": lambda b, th: (tuple(t[:, :-1] for t in b), th, 40, 0.1),
    "dtype": lambda b, th: (tuple(t.float() for t in b), th.float(), 40,
                            0.1),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_ascent_key_separates_what_the_graph_depends_on(change):
    """The graph key is a pure function of the ascent's shapes and
    constants: the same for a bank of other values, another for each
    change of steps, lr, the number of starts, the bank's shape or its
    dtype, or the prior."""
    bank = tuple(T(a) for a in _bank())
    th = torch.tensor([THETA0], dtype=torch.float64)

    def key(b, t, steps, lr, **prior):
        return thmc.ascent_key(thmc.make_patch_logpost(*b, **prior), t,
                               steps, lr)

    base = key(bank, th, 40, 0.1)
    assert key(bank, th, 40, 0.1) == base
    other = tuple(t + 1.0 for t in bank)
    assert key(other, th + 1.0, 40, 0.1) == base
    assert key(bank, th, 40, 0.1, prior_std=4.0) != base
    assert key(*KEY_CHANGES[change](bank, th)) != base


FakeBatch = collections.namedtuple("FakeBatch", "X y mask")


def test_calib_subsample_matches_jax_exactly():
    """Counts with ties at the cut (the lower index wins, as lax.top_k),
    patches above and below n_points."""
    r = np.random.default_rng(6)
    B, P, n = 12, 40, 16
    counts = np.array([5, 30, 22, 30, 3, 40, 30, 0, 16, 17, 22, 9])
    mask = np.zeros((B, P), bool)
    for b, c in enumerate(counts):
        mask[b, r.permutation(P)[:c]] = True
    X = r.uniform(-0.1, 0.1, (B, P, 2)).astype(np.float32)
    y = r.standard_normal((B, P, 1)).astype(np.float32)
    for n_patches in (3, 8):
        j = jcomp.calib_subsample(FakeBatch(jnp.asarray(X), jnp.asarray(y),
                                            jnp.asarray(mask)), n_patches, n)
        t = tcomp.calib_subsample(FakeBatch(T(X), T(y), T(mask)),
                                  n_patches, n)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


N = 4000
KEY = jax.random.key(2)
CALIB = dict(calib_patches=8, calib_points=32)


def _cfg(m):
    return m.CompressorConfig(
        patch=m.PatchConfig(res=0.3, sz=10, max_patches=256,
                            max_points_per_patch=64,
                            approx_sphere_moments=True,
                            bank_order="center_out"),
        depth_gp=m.GPConfig(capacity=14, slots=16, eps_tol=2.0),
        rgb_gp=dataclasses.replace(m.rgb_gp_config(slots=16, capacity=14),
                                   eps_tol=2.0))


def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


@functools.lru_cache(maxsize=None)
def _cloud():
    pts, cols = synthetic.room_cloud(n=N, seed=1)
    return pts, cols


def _hold(jc, tc, jkp, tkp, js20, ts20):
    """Calibrated values within 1e-6 in log space; depth states by the
    realistic rule on the same banks; RMSE within 2%."""
    jt = np.log([float(jkp.sigmaf_sq), float(jkp.l_sq), float(js20)])
    tt = np.log([float(tkp.sigmaf_sq), float(tkp.l_sq), float(ts20)])
    np.testing.assert_allclose(tt, jt, atol=1e-6)
    jd = convert.state_from_numpy(_asdict(jc.depth_gp), device="cpu")
    sogp_regimes.compare("realistic", jd, tc.depth_gp, tc.patch.X,
                         tc.patch.y, tc.patch.mask, kp=tkp, s20=ts20)
    rj = float(jcomp.reconstruction_rmse(jc, _cfg(jcfg), depth_kp=jkp,
                                         depth_s20=js20))
    rt = float(tcomp.reconstruction_rmse(tc, _cfg(tcfg), depth_kp=tkp,
                                         depth_s20=ts20))
    assert abs(rt - rj) <= 0.02 * rj, (rt, rj)
    return rt


def test_compress_decompress_calibrated_matches_jax():
    pts, cols = _cloud()
    jargs = (jnp.asarray(pts), jnp.asarray(cols), jnp.ones(N, bool), _cfg(jcfg))
    targs = (T(pts), T(cols), torch.ones(N, dtype=torch.bool), _cfg(tcfg))
    jc, jkp, js20, jo = jcomp.compress_decompress_calibrated(
        *jargs, KEY, calib_steps=40, **CALIB)
    tc, tkp, ts20, to = tcomp.compress_decompress_calibrated(
        *targs, calib_steps=40, calib_dtype=torch.float64, **CALIB)
    assert isinstance(ts20, torch.Tensor) and ts20.dtype == torch.float32
    assert float(tkp.l_sq) < 0.3 ** 2      # the calibrated, sharp regime
    _hold(jc, tc, jkp, tkp, js20, ts20)
    np.testing.assert_array_equal(to[5].numpy(), np.asarray(jo[5]))
    assert torch.isfinite(to[0][to[2]]).all()
    # warm start from the cold result: one start, fewer steps
    theta = jnp.log(jnp.stack([jkp.sigmaf_sq, jkp.l_sq, js20]))
    jw = jcomp.compress_decompress_calibrated(
        *jargs, KEY, calib_steps=10, calib_lr=0.05, calib_starts=1,
        theta_init=theta, **CALIB)
    tw = tcomp.compress_decompress_calibrated(
        *targs, calib_steps=10, calib_lr=0.05, calib_starts=1,
        theta_init=torch.log(torch.stack([tkp.sigmaf_sq, tkp.l_sq, ts20])),
        calib_dtype=torch.float64, **CALIB)
    _hold(jw[0], tw[0], jw[1], tw[1], jw[2], tw[2])


def test_compress_calibrated_matches_jax():
    """The staged path: unshuffled banks, each permuted before training by
    JAX's own per-patch permutations."""
    pts, cols = _cloud()
    jc, jkp, js20, jcal = jcomp.compress_calibrated(
        jnp.asarray(pts), jnp.asarray(cols), jnp.ones(N, bool), _cfg(jcfg),
        KEY, calib_steps=40, **CALIB)
    B, P = 256, 64
    kd, kc = jax.random.split(KEY)
    perm = tuple(T(np.asarray(jax.vmap(lambda k: jax.random.permutation(
        k, P))(jax.random.split(k, B))).astype(np.int64)) for k in (kd, kc))
    tc, tkp, ts20, tcal = tcomp.compress_calibrated(
        T(pts), T(cols), torch.ones(N, dtype=torch.bool), _cfg(tcfg),
        calib_steps=40, calib_dtype=torch.float64, perm=perm, **CALIB)
    assert isinstance(ts20, float)
    _hold(jc, tc, jkp, tkp, js20, ts20)
    for f in ("sigmaf_sq", "l_sq", "s20", "eps_tol"):
        np.testing.assert_allclose(getattr(tcal.depth_gp, f),
                                   getattr(jcal.depth_gp, f), rtol=1e-6)


def _count_reads(monkeypatch):
    """Count the tensor -> Python conversions (each a device-to-host read
    on the card) made from Python code."""
    reads = []
    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return reads


def test_map_ascent_reads_nothing_back(monkeypatch):
    """The multi-start ascent queues every step without a host read."""
    _, tlp = _logposts()
    reads = _count_reads(monkeypatch)
    theta, lps = thmc.map_estimate_multi(
        tlp, torch.tensor(THETA0, dtype=torch.float64), steps=5, n_starts=4)
    assert reads == [] and theta.shape == (3,)


def test_plain_tally_counts_churn():
    """The plain trainer's tally: additions minus deletions is each patch's
    final size, and the per-row BV-count sums equal those of a row-by-row
    run; at calibrated-scale hyperparameters the realistic regime's inputs
    fill to capacity and delete."""
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp as tsg

    cfg, X, Y, M = sogp_regimes.regime("realistic")
    X, Y, M = T(X), T(Y), T(M)
    kp = TRBF(torch.tensor(1.04e-3), torch.tensor(1.36e-3))
    kw = dict(s20=4.4e-4, eps_tol=2.0 * 1.04e-3 / 100.0)
    init = tsg.init_batch(cfg, X.shape[0], device="cpu")
    tally = torch.zeros((X.shape[0], 5), dtype=torch.int64)
    st = sogp_train.add_points_batch_plain(kp, cfg, init, X, Y, M,
                                           tally=tally, **kw)
    assert torch.equal(tally[:, 0] - tally[:, 1] - tally[:, 2],
                       st.active.sum(1))
    assert int(tally[:, 1].sum()) > X.shape[0]
    row = init
    sums = torch.zeros((X.shape[0], 2), dtype=torch.int64)
    for p in range(X.shape[1]):
        n = tsg.size(row) * M[:, p]
        sums += torch.stack([n, n * n], dim=1)
        row = sogp_train.add_points_batch_plain(
            kp, cfg, row, X[:, p:p + 1], Y[:, p:p + 1], M[:, p:p + 1], **kw)
    assert torch.equal(tally[:, 3:], sums)
    assert all(torch.equal(a, b) for a, b in zip(st, row))


@functools.lru_cache(maxsize=None)
def _port_calibrated():
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp as tsg

    cfg, X, Y, M = sogp_regimes.calibrated_case(1)
    X, Y, M = T(X), T(Y), T(M)
    out = sogp_train.add_points_batch_plain(
        sogp_regimes.calibrated_params(device="cpu"), cfg,
        tsg.init_batch(cfg, X.shape[0], device="cpu"),
        X, Y, M, s20=sogp_regimes.CAL_S20, eps_tol=sogp_regimes.CAL_EPS)
    return out, X, Y, M


@pytest.mark.parametrize("fault", ["gain", "non_finite", "halved"])
def test_calibrated_rule_rejects_faults(fault):
    """The `calibrated` rule fails a state whose alpha is 30% off in every
    patch, one with three non-finite patches, and one with half of every
    patch's basis vectors dropped."""
    from gp_compressor_tpu_torch.models import sparse_gp as tsg

    out, X, Y, M = _port_calibrated()
    d = {f: getattr(out, f).clone() for f in tsg.SOGPState._fields}
    if fault == "gain":
        d["alpha"] *= 1.3
    elif fault == "non_finite":
        d["C"][[3, 9, 40], 0, 0] = torch.nan
    else:
        d["active"][:, ::2] = False
    with pytest.raises(AssertionError):
        sogp_regimes.compare("calibrated", out, tsg.SOGPState(**d), X, Y, M,
                             kp=sogp_regimes.calibrated_params(device="cpu"),
                             s20=sogp_regimes.CAL_S20)


def _jax_calibrated(dout, pallas):
    from gp_compressor_tpu.models import sparse_gp as jsg
    from gp_compressor_tpu.ops.noise import GaussianNoise as JNoise
    from gp_compressor_tpu.pallas_kernels import sogp_train as jtrain

    cfg, X, Y, mask = sogp_regimes.calibrated_case(dout)
    f32 = jnp.float32
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    jc = jcfg.GPConfig(**dict(kw, dtype=f32))
    kp = JRBF(jnp.asarray(sogp_regimes.CAL_SIGMAF_SQ, f32),
              jnp.asarray(sogp_regimes.CAL_L_SQ, f32))
    s20 = jnp.asarray(sogp_regimes.CAL_S20, f32)
    eps = jnp.asarray(sogp_regimes.CAL_EPS, f32)
    args = (jsg.init_batch(jc, X.shape[0]), jnp.asarray(X), jnp.asarray(Y),
            jnp.asarray(mask))
    if pallas:
        st = jtrain.add_points_batch_pallas(kp, jc, *args, interpret=True,
                                            s20=s20, eps_tol=eps)
    else:
        st = jsg.add_points_batch(kp, JNoise(s20=s20), jc, *args,
                                  eps_tol=eps)
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("dout", [1, 3])
def test_calibrated_regime_matches_jax(dout, pallas):
    """The training kernel's calibrated regime: at the calibrated
    hyperparameters patches fill to capacity 30 and delete on most rows.
    The port's plain version, which the card holds the kernel to, agrees
    with both JAX trainers by the `calibrated` rule."""
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp as tsg

    cfg, X, Y, M = sogp_regimes.calibrated_case(dout)
    X, Y, M = T(X), T(Y), T(M)
    tally = torch.zeros((X.shape[0], 5), dtype=torch.int64)
    out = sogp_train.add_points_batch_plain(
        sogp_regimes.calibrated_params(device="cpu"), cfg,
        tsg.init_batch(cfg, X.shape[0], device="cpu"),
        X, Y, M, s20=sogp_regimes.CAL_S20, eps_tol=sogp_regimes.CAL_EPS,
        tally=tally)
    assert float(out.active.sum(1).double().mean()) > 0.95 * cfg.capacity
    assert float(tally[:, 1].double().mean()) > 5.0
    ref = convert.state_from_numpy(_jax_calibrated(dout, pallas), device="cpu")
    sogp_regimes.compare("calibrated", ref, out, X, Y, M,
                         kp=sogp_regimes.calibrated_params(device="cpu"),
                         s20=sogp_regimes.CAL_S20)
