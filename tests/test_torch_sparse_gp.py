"""Port sparse GP (the training kernel's plain version) against the JAX
package: kernel primitives, prediction and sanitize at rtol 1e-5, and the
four training regimes of tests/test_pallas_sogp.py against both JAX paths
(the XLA scan and the Pallas kernel in interpret mode) by the regimes' own
rules (gp_compressor_tpu_torch/testing/sogp_regimes.py). Also the
invariant the CUDA kernel's active-slot loops rest on (inactive slots stay
exactly zero), the state with a NaN, and the kernel's launch geometry.
Inputs are numpy arrays from a seed, pinned to float32 on both sides."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu.config import GPConfig as JGPConfig
from gp_compressor_tpu.models import sparse_gp as jsg
from gp_compressor_tpu.ops import kernels as jk
from gp_compressor_tpu.ops.noise import GaussianNoise as JNoise
from gp_compressor_tpu.pallas_kernels import sogp_train as jtrain
from gp_compressor_tpu_torch.cuda_kernels import sogp_train
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.models import sparse_gp as tsg
from gp_compressor_tpu_torch.ops import kernels as tk
from gp_compressor_tpu_torch.ops.noise import GaussianNoise as TNoise
from gp_compressor_tpu_torch.testing import sogp_regimes
from gp_compressor_tpu_torch.utils import profiling

torch.set_num_threads(1)

F32 = jnp.float32
JKP = jk.RBFParams(sigmaf_sq=jnp.asarray(100.0, F32), l_sq=jnp.asarray(1.0, F32))
TKP = sogp_regimes.params(device="cpu")


def _jcfg(cfg):
    """The JAX GPConfig with the same fields as a port GPConfig."""
    import dataclasses
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dtype"] = F32
    return JGPConfig(**kw)


def _to_port(st):
    return convert.state_from_numpy(
        {k: np.asarray(v) for k, v in st._asdict().items()}, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_regime(name, pallas):
    """The JAX state of a regime at its default size, as numpy arrays."""
    cfg, X, Y, mask = sogp_regimes.regime(name)
    st = _jax_state(cfg, X, Y, mask, pallas)
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _jax_state(cfg, X, Y, mask, pallas):
    jc = _jcfg(cfg)
    init = jsg.init_batch(jc, X.shape[0])
    if pallas:
        return jtrain.add_points_batch_pallas(
            JKP, jc, init, jnp.asarray(X, F32), jnp.asarray(Y, F32),
            jnp.asarray(mask), interpret=True)
    return jsg.add_points_batch(JKP, JNoise(s20=jnp.asarray(0.1, F32)), jc,
                                init, jnp.asarray(X, F32),
                                jnp.asarray(Y, F32), jnp.asarray(mask))


def _port_state(cfg, X, Y, mask, **kw):
    return sogp_train.add_points_batch_cuda(
        TKP, cfg, tsg.init_batch(cfg, X.shape[0], device="cpu"),
        torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(mask),
        **kw)


def test_sqdist_and_gram_match_jax():
    r = np.random.default_rng(11)
    X = r.uniform(-0.2, 0.2, size=(37, 2)).astype(np.float32)
    Z = r.uniform(-0.2, 0.2, size=(13, 2)).astype(np.float32)
    kp = tk.RBFParams(torch.tensor(3.7), torch.tensor(0.02))
    jkp = jk.RBFParams(jnp.asarray(3.7, F32), jnp.asarray(0.02, F32))
    np.testing.assert_allclose(
        tk.sqdist(torch.from_numpy(X), torch.from_numpy(Z)).numpy(),
        np.asarray(jk.sqdist(jnp.asarray(X), jnp.asarray(Z))), rtol=1e-5)
    np.testing.assert_allclose(
        tk.gram(kp, torch.from_numpy(X), torch.from_numpy(Z)).numpy(),
        np.asarray(jk.gram(jkp, jnp.asarray(X), jnp.asarray(Z))), rtol=1e-5)
    np.testing.assert_array_equal(
        tk.kdiag(kp, torch.from_numpy(X)).numpy(),
        np.asarray(jk.kdiag(jkp, jnp.asarray(X))))


def _trained_pair(dout, seed=5):
    """A JAX-trained bank (well conditioned) and its port copy."""
    r = np.random.default_rng(seed)
    cfg = sogp_regimes.regime("strict_d1" if dout == 1 else "strict_d3")[0]
    X = r.uniform(-3, 3, size=(9, 10, 2)).astype(np.float32)
    Y = r.normal(size=(9, 10, dout)).astype(np.float32)
    mask = r.uniform(size=(9, 10)) > 0.3
    st = _jax_state(cfg, X, Y, mask, pallas=False)
    return st, _to_port(st)


@pytest.mark.parametrize("dout", [1, 3])
def test_predict_batch_matches_jax(dout):
    jst, tst = _trained_pair(dout)
    q = np.random.default_rng(2).uniform(-3, 3, size=(9, 17, 2)) \
        .astype(np.float32)
    jm, jv = jsg.predict_batch(JKP, 0.1, jst, jnp.asarray(q))
    tm, tv = tsg.predict_batch(TKP, 0.1, tst, torch.from_numpy(q))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    # var = s20 + k** + k^T C k cancels terms of scale k** = sigmaf^2, so
    # its rounding is relative to sigmaf^2, not to the result
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5 * 100.0)


def test_sanitize_batch_matches_jax():
    jst, _ = _trained_pair(1)
    d = {k: np.array(v) for k, v in jst._asdict().items()}
    d["C"][2, 0, 0] = np.nan            # non-finite state
    d["alpha"][5] *= 1e6                # finite state, garbage predictions
    jst = jsg.SOGPState(**{k: jnp.asarray(v) for k, v in d.items()})
    tst = convert.state_from_numpy(d, device="cpu")
    probes = np.random.default_rng(4).uniform(-0.1, 0.1, size=(6, 2)) \
        .astype(np.float32)
    jout, jbad = jsg.sanitize_batch(jst, JKP, 0.1, max_pred=1.5,
                                    probes=jnp.asarray(probes))
    tout, tbad = tsg.sanitize_batch(tst, TKP, 0.1, max_pred=1.5,
                                    probes=torch.from_numpy(probes))
    assert int(tbad) == int(jbad) >= 2
    for f in tsg.SOGPState._fields:
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=1e-5)
    # without kernel params only the non-finite patch is reset
    _, jbad = jsg.sanitize_batch(jst)
    _, tbad = tsg.sanitize_batch(tst)
    assert int(tbad) == int(jbad) == 1


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("name", sogp_regimes.REGIMES)
def test_training_regimes_match_jax(name, pallas):
    cfg, X, Y, mask = sogp_regimes.regime(name)
    ref = convert.state_from_numpy(_jax_regime(name, pallas), device="cpu")
    out = _port_state(cfg, X, Y, mask)
    sogp_regimes.compare(name, ref, out, torch.from_numpy(X),
                         torch.from_numpy(Y), torch.from_numpy(mask))


@pytest.mark.parametrize("trainer", ["xla", "pallas", "port"])
@pytest.mark.parametrize("name", sogp_regimes.REGIMES)
def test_inactive_slots_stay_zero(name, trainer):
    """bv, alpha and the rows and columns of C and Q of every inactive
    slot are exactly 0.0 after training, in JAX's XLA scan, its Pallas
    kernel (interpret mode) and the port's plain version: the invariant
    that lets the CUDA kernel loop over the active slots only."""
    if trainer == "port":
        cfg, X, Y, mask = sogp_regimes.regime(name)
        st = {k: v.numpy() for k, v in
              _port_state(cfg, X, Y, mask)._asdict().items()}
    else:
        st = _jax_regime(name, trainer == "pallas")
    off = ~st["active"]
    assert off.any() and st["active"].any()
    assert np.all(st["bv"][off] == 0.0)
    assert np.all(st["alpha"][off] == 0.0)
    for f in ("C", "Q"):
        M = st[f]
        assert np.all(M.transpose(0, 2, 1)[off] == 0.0), f"{f} columns"
        assert np.all(M[off] == 0.0), f"{f} rows"


@pytest.mark.parametrize("name,slots", [("strict_d1", 8), ("strict_d3", 128),
                                        ("realistic", 32),
                                        ("geometric", 32)])
def test_regimes_at_other_slot_counts_match_jax(name, slots):
    """The card checks the kernel at these state sizes; the regimes keep
    their rules there (8 slots: capacity 7, so deletions run)."""
    cfg, X, Y, mask = sogp_regimes.regime(name, slots=slots)
    assert cfg.slots == slots
    ref = _to_port(_jax_state(cfg, X, Y, mask, pallas=False))
    out = _port_state(cfg, X, Y, mask)
    sogp_regimes.compare(name, ref, out, torch.from_numpy(X),
                         torch.from_numpy(Y), torch.from_numpy(mask))


def test_nan_state_matches_jax():
    """A NaN in one patch's active C spreads over that patch's C and alpha
    alike in JAX's XLA scan and the port's plain version (the `nan` rule),
    and the other patches keep the strict rule."""
    cfg, first, second = sogp_regimes.nan_case()
    st = sogp_regimes.poison(_port_state(cfg, *first))
    jc = _jcfg(cfg)
    jst = jsg.add_points_batch(
        JKP, JNoise(s20=jnp.asarray(0.1, F32)), jc,
        jsg.SOGPState(*[jnp.asarray(a.numpy()) for a in st]),
        *[jnp.asarray(a) for a in second])
    X, Y, mask = (torch.from_numpy(a) for a in second)
    out = sogp_train.add_points_batch_cuda(TKP, cfg, st, X, Y, mask)
    res = sogp_regimes.compare("nan", _to_port(jst), out, X, Y, mask)
    assert res["nan_entries"] == cfg.slots ** 2
    with pytest.raises(AssertionError):      # the rule sees a lost NaN
        sogp_regimes.compare("nan", _to_port(jst), st, X, Y, mask)


@pytest.mark.parametrize("dout", [1, 3])
def test_launch_geometry(dout):
    """Rows per lane, patches per block and shared bytes for every state
    size the kernel takes; more than 128 slots, or none, are refused."""
    for S in range(1, sogp_train.MAX_SLOTS + 1):
        warps, rows, smem = sogp_train.launch_geometry(S, dout)
        assert rows <= 4 and 32 * (rows - 1) < S <= 32 * rows
        assert warps in (1, 2, 4)
        assert smem == warps * 2 * S * (S | 1) * 4 <= 232_448
        assert warps == 1 or smem <= 48 * 1024    # no opt-in with 2+ warps
    assert sogp_train.launch_geometry(32, dout) == (4, 1, 33_792)
    for S in (0, 129):
        with pytest.raises(ValueError):
            sogp_train.launch_geometry(S, dout)
    with pytest.raises(ValueError):
        sogp_train.launch_geometry(32, 2)


@pytest.mark.parametrize("fault", [None, "gain", "dropped_bv", "swapped"])
def test_bench_rule_holds_the_port_to_jax_and_rejects_faults(fault):
    """The `bench` rule (strict state + max prediction gap < 1e-3) passes
    the port's training against JAX's and fails a state with a 1% wrong
    update gain in one patch, one basis vector dropped, or two patches'
    states swapped."""
    cfg, X, Y, mask = sogp_regimes.regime("strict_d1")
    ref = _to_port(_jax_state(cfg, X, Y, mask, pallas=False))
    out = _port_state(cfg, X, Y, mask)
    args = (torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(mask))
    if fault is None:
        res = sogp_regimes.compare("bench", ref, out, *args)
        assert res["max_abs_err"] < 1e-4 and res["max_pred_gap"] < 1e-3
        return
    d = {f: getattr(out, f).clone() for f in tsg.SOGPState._fields}
    if fault == "gain":
        d["alpha"][17] *= 1.01
    elif fault == "dropped_bv":
        d["active"][17, int(torch.nonzero(d["active"][17])[-1])] = False
    else:
        for f in d:
            d[f][[3, 4]] = d[f][[4, 3]]
    with pytest.raises(AssertionError):
        sogp_regimes.compare("bench", ref, tsg.SOGPState(**d), *args)


def test_geometric_thresholds_from_config_match_jax():
    """sparse_gp.add_points_batch without a hyperparameter row derives the
    geometric admission thresholds from the config, as JAX's does."""
    cfg, X, Y, mask = sogp_regimes.regime("geometric")
    ref = _to_port(_jax_state(cfg, X, Y, mask, pallas=False))
    out = tsg.add_points_batch(TKP, TNoise(torch.tensor(0.1)), cfg,
                               tsg.init_batch(cfg, X.shape[0], device="cpu"),
                               torch.from_numpy(X), torch.from_numpy(Y),
                               torch.from_numpy(mask))
    sogp_regimes.compare("geometric", ref, out, torch.from_numpy(X),
                         torch.from_numpy(Y), torch.from_numpy(mask))


def test_override_row_matches_static_config():
    """The geometric (dmin, max_bv, gamma_min_rel) override reproduces the
    static config bit for bit, and the hyperparameter row equals the TPU
    kernel's row formula evaluated in JAX."""
    cfg, X, Y, mask = sogp_regimes.regime("geometric")
    X, Y, mask = X[:, :24], Y[:, :24], np.ones(mask[:, :24].shape, bool)
    geom = (torch.tensor(0.05), torch.tensor(3.0), torch.tensor(1e-2))
    st_static = _port_state(cfg, X, Y, mask)
    st_traced = _port_state(cfg, X, Y, mask, geom=geom)
    for a, b in zip(st_static, st_traced):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    row = sogp_train.hyper_row(TKP, cfg, "cpu").numpy()
    sf, l2 = JKP.sigmaf_sq, JKP.l_sq
    kappa = sf * jnp.exp(jnp.asarray(-0.5, F32) * jnp.asarray(0.05, F32) ** 2
                         / l2)
    jrow = np.asarray(jnp.stack([
        sf, l2, jnp.asarray(cfg.s20, F32), jnp.asarray(cfg.eps_tol, F32),
        kappa, jnp.asarray(3, F32), jnp.asarray(1e-2, F32) * sf]))
    np.testing.assert_array_equal(row, jrow)


def test_per_point_eps_tol_matches_jax():
    """[B, P] novelty thresholds: -inf forces a point into the basis, +inf
    forces a sparse projection."""
    cfg, X, Y, mask = sogp_regimes.regime("strict_d1")
    eps = np.where(np.random.default_rng(1).uniform(size=mask.shape) > 0.5,
                   -np.inf, np.inf).astype(np.float32)
    jc = _jcfg(cfg)
    jst = jsg.add_points_batch(JKP, JNoise(s20=jnp.asarray(0.1, F32)), jc,
                               jsg.init_batch(jc, X.shape[0]),
                               jnp.asarray(X), jnp.asarray(Y),
                               jnp.asarray(mask), eps_tol=jnp.asarray(eps))
    tst = tsg.add_points_batch(TKP, TNoise(torch.tensor(0.1)), cfg,
                               tsg.init_batch(cfg, X.shape[0], device="cpu"),
                               torch.from_numpy(X), torch.from_numpy(Y),
                               torch.from_numpy(mask),
                               eps_tol=torch.from_numpy(eps))
    sogp_regimes.compare("strict_d1", _to_port(jst), tst, torch.from_numpy(X),
                         torch.from_numpy(Y), torch.from_numpy(mask))


def test_cpu_wrapper_takes_the_plain_version_and_checks_inputs():
    cfg, X, Y, mask = sogp_regimes.regime("strict_d3")
    X, Y, mask = X[:7], Y[:7], mask[:7]
    a = _port_state(cfg, X, Y, mask)
    b = sogp_train.add_points_batch_plain(
        TKP, cfg, tsg.init_batch(cfg, 7, device="cpu"), torch.from_numpy(X),
        torch.from_numpy(Y), torch.from_numpy(mask))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    # no kernel ran on the CPU
    assert profiling.counters().get("sogp_train.launches", 0) == 0
    with pytest.raises(ValueError):          # the kernel needs CUDA tensors
        sogp_train.launch(cfg, tsg.init_batch(cfg, 7, device="cpu"),
                          tsg.init_batch(cfg, 7, device="cpu"),
                          torch.from_numpy(X), torch.from_numpy(Y),
                          torch.from_numpy(mask),
                          sogp_train.hyper_row(TKP, cfg, "cpu"))
    # keys: the [B, n] permutations JAX's per-patch keys draw, the order
    # each patch's rows train in
    keys = jax.random.split(jax.random.key(0), 7)
    perm = np.stack([np.asarray(jax.random.permutation(k, X.shape[1]))
                     for k in keys])
    take = lambda a: torch.from_numpy(np.take_along_axis(
        a, perm.reshape(perm.shape + (1,) * (a.ndim - 2)), axis=1))
    noise = TNoise(torch.tensor(0.1))
    c = tsg.add_points_batch(TKP, noise, cfg,
                             tsg.init_batch(cfg, 7, device="cpu"),
                             torch.from_numpy(X), torch.from_numpy(Y),
                             torch.from_numpy(mask),
                             keys=torch.from_numpy(perm))
    d = tsg.add_points_batch(TKP, noise, cfg,
                             tsg.init_batch(cfg, 7, device="cpu"),
                             take(X), take(Y), take(mask))
    for u, v in zip(c, d):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


def test_arbitrated_rule_passes_plain_and_rejects_astray_patches():
    """The `arbitrated` rule at the reference GP constants over 4 m
    patches, where float32 training leaves a part of the patches astray
    of float64: the float32 plain version passes against itself, and a
    trainer whose every patch is poisoned fails."""
    cfg, X, Y, M = sogp_regimes.regime("strict_d1", points=40)
    X = torch.from_numpy(X) * 0.1
    Y, M = torch.from_numpy(Y) * 0.05, torch.from_numpy(M)
    cfg = dataclasses.replace(cfg, capacity=30, slots=32, eps_tol=1e-6)
    kp = sogp_regimes.params(device="cpu")
    s20 = torch.tensor(cfg.s20)
    init = tsg.init_batch(cfg, X.shape[0], device="cpu")
    ref = sogp_train.add_points_batch_plain(kp, cfg, init, X, Y, M)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    kp64 = type(kp)(*[v.double() for v in kp])
    ref64 = sogp_train.add_points_batch_plain(
        kp64, cfg64, tsg.init_batch(cfg64, X.shape[0], device="cpu"),
        X.double(), Y.double(), M)
    res = sogp_regimes.arbitrate(ref64, ref, ref, X, Y, M, kp, s20)
    assert res["f64"]["astray"] == 0
    assert 0 < res["plain"]["astray"] == res["out"]["astray"] < 130
    bad = ref._replace(alpha=torch.full_like(ref.alpha, float("nan")))
    with pytest.raises(AssertionError):
        sogp_regimes.arbitrate(ref64, ref, bad, X, Y, M, kp, s20)
