"""The port's dictionary codec against the JAX package on the CPU.

Exact parity in float64 (x64 on): masked OMP and plain MP on a fixed
dictionary with padding patches and partial masks, OMP with a singular
unit-diagonal Gram (an atom chosen twice once the residual is orthogonal
to every unused atom: both packages return non-finite coefficients and
stop the row), reconstruct and masked_error, the NIPALS power iteration,
the atom sweep in Gauss-Seidel order (atom_block 1) and in blocks of 16
over a dictionary that is not a multiple of 16, the unused-atom
replacement, one outer sweep and a whole K-SVD run. The random data rows
come from JAX's keys along ksvd_device's own split tree and are fed to the
port as KSVDDraws. Tolerance 1e-9 in float64 (rounding through tens of
batched matrix products and 20 power iterations); atom indices, word
counts and sweep counts equal. OMP in float32: indices equal, X within
1e-4 relative. On the CPU OMP runs eager on every call (the graph cache
is the card's), and the cache's key holds every shape and constant of an
encoding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu.config import KSVDConfig as JKSVDConfig
from gp_compressor_tpu.models import dictionary as jd
from gp_compressor_tpu_torch.config import KSVDConfig
from gp_compressor_tpu_torch.models import dictionary as td
from gp_compressor_tpu_torch.utils import profiling

torch.set_num_threads(1)

T = torch.from_numpy
ATOL = 1e-9


def _problem(l=36, K=20, n=30, n_pad=4, seed=0, words=3):
    """Signals sparse in a random unit-column dictionary plus noise,
    partial masks, the last n_pad patches padding."""
    r = np.random.default_rng(seed)
    D = r.standard_normal((l, K))
    D /= np.linalg.norm(D, axis=0)
    X = np.zeros((n, K))
    for i in range(n):
        X[i, r.choice(K, size=words, replace=False)] = r.standard_normal(words)
    S = X @ D.T + 0.05 * r.standard_normal((n, l))
    W = (r.uniform(size=(n, l)) > 0.25).astype(np.float64)
    valid = np.arange(n) < n - n_pad
    return D, S, W, valid


def _jnp(*a):
    return tuple(jnp.asarray(x) for x in a)


def _t(*a):
    return tuple(T(np.array(x)) for x in a)


def _same_code(tc, jc, atol=ATOL):
    np.testing.assert_array_equal(tc.I.numpy(), np.asarray(jc.I))
    np.testing.assert_array_equal(tc.nw.numpy(), np.asarray(jc.nw))
    np.testing.assert_allclose(tc.X.numpy(), np.asarray(jc.X), atol=atol)


@pytest.mark.parametrize("exact_diag", [False, True], ids=["unit", "exact"])
@pytest.mark.parametrize("encode", ["omp_encode", "mp_encode"])
def test_encode_matches_jax(encode, exact_diag):
    D, S, W, valid = _problem()
    cfg = dict(dict_size=20, words_max=6, proj_error=0.1,
               exact_gram_diag=exact_diag)
    jc = jax.jit(getattr(jd, encode), static_argnums=4)(
        *_jnp(D, S, W, valid), JKSVDConfig(**cfg))
    tc = getattr(td, encode)(*_t(D, S, W, valid), KSVDConfig(**cfg))
    nw = np.asarray(jc.nw)
    assert nw[~valid].max() == 0 and 1 < nw[valid].mean() < 6
    _same_code(tc, jc)


def test_omp_float32_matches_jax():
    D, S, W, valid = (a.astype(np.float32) if a.dtype == np.float64 else a
                      for a in _problem(seed=1))
    cfg = dict(dict_size=20, words_max=6, proj_error=1e-3)
    jc = jax.jit(jd.omp_encode, static_argnums=4)(
        *_jnp(D, S, W, valid), JKSVDConfig(**cfg))
    tc = td.omp_encode(*_t(D, S, W, valid), KSVDConfig(**cfg))
    assert tc.X.dtype == torch.float32
    np.testing.assert_array_equal(tc.I.numpy(), np.asarray(jc.I))
    np.testing.assert_array_equal(tc.nw.numpy(), np.asarray(jc.nw))
    jX = np.asarray(jc.X)
    np.testing.assert_allclose(tc.X.numpy(), jX,
                               atol=1e-4 * np.abs(jX).max())


def test_omp_singular_gram_matches_jax():
    """A dictionary of 6 unit axes in 12 dimensions: once a signal's
    residual lies outside their span, every unused correlation is exactly
    0, argmax takes atom 0 again, and the unit-diagonal Gram of the
    repeated atom is exactly singular. The solve gives non-finite
    coefficients (no error), the residual turns non-finite, and the row
    stops, in both packages."""
    l, K, n = 12, 6, 5
    D = np.eye(l)[:, :K]
    r = np.random.default_rng(2)
    S = r.standard_normal((n, l))
    S[3, K:] = 0.0                        # row 3 lies in the span: no repeat
    W = np.ones((n, l))
    W[1, 2] = 0.0
    valid = np.ones(n, bool)
    cfg = dict(dict_size=K, words_max=K + 2, proj_error=1e-12)
    jc = jax.jit(jd.omp_encode, static_argnums=4)(
        *_jnp(D, S, W, valid), JKSVDConfig(**cfg))
    tc = td.omp_encode(*_t(D, S, W, valid), KSVDConfig(**cfg))
    jX = np.asarray(jc.X)
    fin = np.isfinite(jX)
    assert not fin.all() and fin[3].all()
    np.testing.assert_array_equal(np.isfinite(tc.X.numpy()), fin)
    np.testing.assert_allclose(tc.X.numpy()[fin], jX[fin], atol=ATOL)
    np.testing.assert_array_equal(tc.I.numpy(), np.asarray(jc.I))
    np.testing.assert_array_equal(tc.nw.numpy(), np.asarray(jc.nw))


def _omp_counts():
    c = profiling.counters()
    return [c.get(f"ksvd.{k}", 0)
            for k in ("omp_eager", "omp_graph_captures", "omp_graph_replays")]


def test_omp_on_cpu_runs_eager():
    """CPU tensors take the eager path on every call, repeats of one key
    included: each call counts `ksvd.omp_eager` and no capture or replay,
    the graph cache is left as it was, and each call gives the eager
    body's code."""
    D, S, W, valid = _t(*_problem(seed=4))
    cfg = KSVDConfig(dict_size=20, words_max=6, proj_error=0.1)
    want = td._omp_encode_eager(D, S, W, valid, cfg)
    cached = dict(td._graphs)
    before = _omp_counts()
    codes = [td.omp_encode(D, S, W, valid, cfg) for _ in range(3)]
    assert [b - a for a, b in zip(before, _omp_counts())] == [3, 0, 0]
    assert dict(td._graphs) == cached
    for code in codes:
        assert all(torch.equal(a, b) for a, b in zip(code, want))


def _omp_key(seed=0, n=30, l=36, K=20, dtype=torch.float64, words_max=6,
             proj_error=0.1, exact_gram_diag=False):
    D, S, W, valid = _problem(l=l, K=K, n=n, seed=seed)
    D, S, W = (T(a).to(dtype) for a in (D, S, W))
    cfg = KSVDConfig(dict_size=K, words_max=words_max, proj_error=proj_error,
                     exact_gram_diag=exact_gram_diag)
    return td.omp_key(D, S, W, T(valid), cfg)


@pytest.mark.parametrize("change", [
    dict(n=31), dict(l=37), dict(K=21), dict(dtype=torch.float32),
    dict(words_max=7), dict(proj_error=0.2), dict(exact_gram_diag=True)],
    ids=["n", "l", "K", "dtype", "words_max", "proj_error", "exact_gram_diag"])
def test_omp_graph_key_changes_with(change):
    """A graph replays one encoding's shapes and constants: each of them
    makes another key."""
    assert _omp_key(**change) != _omp_key()


def test_omp_graph_key_is_the_same_for_new_data():
    """New data of the same shapes and constants goes through one graph."""
    assert _omp_key(seed=5) == _omp_key()


def test_reconstruct_error_and_power_iteration_match_jax():
    D, S, W, valid = _problem(seed=3)
    cfg = dict(dict_size=20, words_max=5, proj_error=1e-3)
    jc = jd.omp_encode(*_jnp(D, S, W, valid), JKSVDConfig(**cfg))
    tc = td.OMPCode(*_t(jc.X, jc.I, jc.nw))
    np.testing.assert_allclose(td.reconstruct(T(D), tc).numpy(),
                               np.asarray(jd.reconstruct(jnp.asarray(D), jc)),
                               atol=ATOL)
    vf = valid.astype(np.float64)
    np.testing.assert_allclose(
        float(td.masked_error(*_t(D), tc, *_t(S, W, vf))),
        float(jd.masked_error(*_jnp(D), jc, *_jnp(S, W, vf))), rtol=1e-12)
    r = np.random.default_rng(4)
    # a dominant singular pair plus noise, so that 20 iterations converge
    A = 4.0 * r.standard_normal((3, 36, 1)) * r.standard_normal((3, 1, 30)) \
        + r.standard_normal((3, 36, 30))
    for a, (u, v, s) in zip(A, zip(*td._power_iteration(T(A), 20))):
        ju, jv, js = jd._power_iteration(jnp.asarray(a), 20)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
        np.testing.assert_allclose(float(s), float(js), rtol=1e-12)
        # the top singular pair itself
        sv = np.linalg.svd(a, compute_uv=False)
        assert abs(float(s) - sv[0]) < 1e-6 * sv[0]


@pytest.mark.parametrize("block", [1, 16])
def test_atom_sweep_matches_jax(block):
    """K = 40 = 2 x 16 + 8: the blocked sweep's last block is short (JAX
    pads it with no-op atoms and drops their writes)."""
    D, S, W, valid = _problem(l=30, K=40, n=60, seed=5)
    cfg = dict(dict_size=40, words_max=4, proj_error=1e-3, atom_block=block)
    jcode = jd.omp_encode(*_jnp(D, S, W, valid), JKSVDConfig(**cfg))
    jD, jc2, jR = jax.jit(jd._atom_sweep, static_argnums=5)(
        *_jnp(D), jcode, *_jnp(S, W, valid), JKSVDConfig(**cfg))
    tD, tc2, tR = td._atom_sweep(T(D), td.OMPCode(*_t(*jcode)),
                                 *_t(S, W, valid), KSVDConfig(**cfg))
    assert np.abs(np.asarray(jD) - D).max() > 0.1       # the atoms moved
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), atol=ATOL)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=ATOL)
    _same_code(tc2, jc2)


@pytest.mark.parametrize("block", [8, 40])
def test_atom_sweep_on_cpu_takes_the_plain_path(block):
    """CPU tensors take the plain block update (no `ksvd.block_kernels`
    launch counted, `ksvd.atom_blocks` as many as the blocks) and match
    JAX's sweep: blocks of 8, and one block of all 40 atoms."""
    D, S, W, valid = _problem(l=24, K=40, n=80, seed=11)
    cfg = dict(dict_size=40, words_max=4, proj_error=1e-3, atom_block=block)
    jcode = jd.omp_encode(*_jnp(D, S, W, valid), JKSVDConfig(**cfg))
    jD, jc2, jR = jax.jit(jd._atom_sweep, static_argnums=5)(
        *_jnp(D), jcode, *_jnp(S, W, valid), JKSVDConfig(**cfg))
    before = profiling.counters()
    tD, tc2, tR = td._atom_sweep(T(D), td.OMPCode(*_t(*jcode)),
                                 *_t(S, W, valid), KSVDConfig(**cfg))
    after = profiling.counters()
    assert after.get("ksvd.block_kernels", 0) \
        == before.get("ksvd.block_kernels", 0)
    assert after["ksvd.atom_blocks"] - before.get("ksvd.atom_blocks", 0) \
        == 40 // block
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), atol=ATOL)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=ATOL)
    _same_code(tc2, jc2)


def jax_draws(key, valid, cfg, dtype=jnp.float64):
    """The rows jax ksvd_device's _replace_unused calls draw from `key`,
    as the port's KSVDDraws: key -> (key, k0) for the initial dictionary,
    then (key, ks) per sweep."""
    n, K = valid.shape[0], cfg.dict_size
    p = jnp.asarray(valid).astype(dtype)
    p = p / jnp.sum(p)
    choice = jax.jit(lambda k: jax.random.choice(k, n, shape=(K,), p=p))
    key, k0 = jax.random.split(key)
    sweeps = []
    for _ in range(cfg.max_iters):
        key, ks = jax.random.split(key)
        sweeps.append(np.asarray(choice(ks)))
    return td.KSVDDraws(init=T(np.array(choice(k0))).long(),
                        sweeps=T(np.stack(sweeps)).long())


def test_replace_unused_matches_jax():
    D, S, W, valid = _problem(seed=6)
    usage = np.array([0, 3, 0, 1] * 5)
    cfg = JKSVDConfig(dict_size=20, max_iters=1)
    key = jax.random.key(7)
    # jax's first sweep key is the second split's subkey
    ks = jax.random.split(jax.random.split(key)[0])[1]
    j = jd._replace_unused(*_jnp(D, usage, S, valid), ks, cfg)
    idx = jax_draws(key, valid, cfg).sweeps[0]
    t = td._replace_unused(*_t(D, usage, S), idx)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-15)
    assert (np.asarray(j) != D)[:, usage == 0].all()


def test_ksvd_sweep_matches_jax():
    D, S, W, valid = _problem(l=30, K=24, n=50, seed=8)
    cfg = dict(dict_size=24, words_max=4, proj_error=1e-3, atom_block=8,
               max_iters=1)
    key = jax.random.key(9)
    ks = jax.random.split(jax.random.split(key)[0])[1]
    jout = jax.jit(jd._ksvd_sweep, static_argnums=5)(
        jnp.asarray(D), ks, *_jnp(S, W, valid), JKSVDConfig(**cfg))
    draws = jax_draws(key, valid, JKSVDConfig(**cfg))
    tout = td._ksvd_sweep(T(D), draws.sweeps[0], *_t(S, W, valid),
                          KSVDConfig(**cfg))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=ATOL)
    _same_code(tout[1], jout[1])
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-10)
    # (JAX's mean of int32 words is float32 even under x64)
    np.testing.assert_allclose(float(tout[3]), float(jout[3]), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _sparse_problem():
    """test_dictionary.py's recoverable sparse problem (l 49, K 24, n 200,
    3 words, 20% of each row masked) plus 10 padding patches."""
    r = np.random.default_rng(3)
    l, K, n, k = 49, 24, 210, 3
    D_true = r.standard_normal((l, K))
    D_true /= np.linalg.norm(D_true, axis=0)
    X_true = np.zeros((n, K))
    for i in range(n):
        X_true[i, r.choice(K, size=k, replace=False)] = \
            3 * r.standard_normal(k)
    S = X_true @ D_true.T + 0.01 * r.standard_normal((n, l))
    W = (r.uniform(size=(n, l)) > 0.2).astype(float)
    valid = np.arange(n) < 200
    base = np.mean(np.sum((S * W)[valid] ** 2, axis=1))
    cfg = dict(dict_size=K, words_max=k, proj_error=1e-8, stop_diff=0.04,
               max_iters=15)
    return S, W, valid, cfg, base


@functools.lru_cache(maxsize=None)
def _ksvd_runs(block):
    """K-SVD of the sparse problem in float64 from key 0 in both
    packages."""
    S, W, valid, cfg, _ = _sparse_problem()
    cfg = dict(cfg, atom_block=block)
    key = jax.random.key(0)
    jres = jd.ksvd(*_jnp(S, W, valid), JKSVDConfig(**cfg), key)
    profiling.reset_counters()
    tres = td.ksvd(*_t(S, W, valid), KSVDConfig(**cfg),
                   draws=jax_draws(key, valid, JKSVDConfig(**cfg)))
    return jres, tres, profiling.counters()["ksvd.reads"]


@pytest.mark.parametrize("block", [1, 7])
def test_ksvd_matches_jax(block):
    """The whole decomposition with JAX's draws: the same number of sweeps
    (one host read of the stop test each), dictionary, codes and error.
    The greedy choices do not split on near-ties in these runs."""
    jres, tres, reads = _ksvd_runs(block)
    assert tres.iters == int(jres.iters) and 1 < tres.iters < 15
    assert reads == tres.iters
    assert float(jres.error) < 0.1 * _sparse_problem()[4]
    np.testing.assert_allclose(tres.D.numpy(), np.asarray(jres.D), atol=ATOL)
    _same_code(tres.code, jres.code)
    np.testing.assert_allclose(float(tres.error), float(jres.error),
                               rtol=1e-9)


def test_ksvd_generator_route_and_verbose(capsys):
    """The port's own generator: other draws than JAX's, the same error
    regime; verbose prints one line per sweep."""
    S, W, valid, cfg, base = _sparse_problem()
    jres = _ksvd_runs(1)[0]
    res = td.ksvd(*_t(S, W, valid), KSVDConfig(**cfg),
                  generator=torch.Generator().manual_seed(1), verbose=True)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == res.iters and lines[0].startswith("ksvd iter 1:")
    assert float(res.error) < 0.1 * base
    assert float(res.error) < 2.0 * float(jres.error) + 1e-6
