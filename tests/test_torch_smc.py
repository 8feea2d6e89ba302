"""The port's SMC pose refinement, the map's registration view and the
HMC-calibrated compress against the JAX package, float64 on the CPU.

SMC: init_particles, systematic_resample and four smc_step iterations on
a peaked synthetic likelihood (so the population resamples);
smc_refine_pose on the small mapping case's map (scan 0 inserted by
JAX's map_insert and carried across with map_state_from_numpy), refining
the moved scan 1. `_map_as_compressed`: every field of the view, and
register against it. compress_calibrated(method="hmc"): JAX's HMC draws and
bank permutations fed. The draws are built from JAX's keys along its own
split / fold_in tree. Tolerance 1e-9 on poses and weights; the view's
fields exact; the calibrated compress as its test says.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.inference import smc as jsmc
from gp_compressor_tpu.ops.kernels import RBFParams as JRBF
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu.workloads import mapping as jmap
from gp_compressor_tpu.workloads import registration as jreg
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.inference import smc as tsmc
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.ops.kernels import RBFParams as TRBF
from gp_compressor_tpu_torch.testing import mapping_case as case
from gp_compressor_tpu_torch.workloads import compressor as tcomp
from gp_compressor_tpu_torch.workloads import mapping as tmap
from gp_compressor_tpu_torch.workloads import registration as treg

torch.set_num_threads(1)

T = torch.from_numpy
ATOL = 1e-9
SCFG = dict(num_particles=64, pose_proposal_std_t=0.005,
            pose_proposal_std_r=0.002)
JCFG = case.compressor_config(jcfg, jnp.float64)
TCFG = case.compressor_config(tcfg, torch.float64)


def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


def F64(v):
    return torch.tensor(v, dtype=torch.float64)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


# ---- the JAX draws, along JAX's key trees -------------------------------

def init_normals(key, P, dtype=jnp.float64):
    kt, kr = jax.random.split(key)
    return T(np.concatenate([np.asarray(jax.random.normal(kt, (P, 3), dtype)),
                             np.asarray(jax.random.normal(kr, (P, 3), dtype))],
                            -1))


def step_draws(key, P, dtype=jnp.float64) -> tsmc.SMCDraws:
    """SMCDraws of jax smc_step(key)."""
    kj, kr = jax.random.split(key)
    n = np.concatenate([np.asarray(jax.random.normal(kj, (P, 3), dtype)),
                        np.asarray(jax.random.normal(
                            jax.random.fold_in(kj, 1), (P, 3), dtype))], -1)
    u0 = jax.random.uniform(kr, (), minval=0.0, maxval=1.0 / P)
    return tsmc.SMCDraws(T(n), torch.tensor(float(u0), dtype=torch.float64))


def refine_draws(key, P, n_iters):
    """(init normals, SMCDraws [n_iters]) of jax smc_refine_pose(key)."""
    steps = [step_draws(k, P) for k in
             jax.random.split(jax.random.fold_in(key, 1), n_iters)]
    return init_normals(key, P), tsmc.SMCDraws(
        torch.stack([s.normals for s in steps]),
        torch.stack([s.u0 for s in steps]))


# ---- SMC ---------------------------------------------------------------

def test_smc_steps_match_jax():
    target = np.array([0.02, -0.01, 0.015, 0.004, -0.003, 0.002])

    def jll(poses):
        return -0.5 * jnp.sum(((poses - target) / 0.01) ** 2, axis=-1)

    def tll(poses):
        return -0.5 * torch.sum(((poses - T(target)) / 0.01) ** 2, dim=-1)

    P = SCFG["num_particles"]
    jc, tc = jcfg.SMCConfig(**SCFG), tcfg.SMCConfig(**SCFG)
    key = jax.random.key(3)
    js = jsmc.init_particles(jc, key, dtype=jnp.float64)
    ts = tsmc.init_particles(tc, normals=init_normals(key, P))
    _close(ts.poses, js.poses)
    assert float(ts.poses[0].abs().sum()) == 0.0
    resampled = 0
    for k in jax.random.split(jax.random.key(4), 4):
        js, jm = jsmc.smc_step(js, jll, jc, k)
        ts, tm = tsmc.smc_step(ts, tll, tc, draws=step_draws(k, P))
        for a, b in ((ts.poses, js.poses), (ts.log_weights, js.log_weights),
                     (tm, jm)):
            _close(a, b)
        resampled += int(bool((ts.log_weights == 0).all()))
    assert resampled >= 1
    # systematic resampling alone, at JAX's offset
    st = jsmc.ParticleState(js.poses, jnp.asarray(
        np.random.default_rng(0).standard_normal(P) * 3.0))
    k = jax.random.key(9)
    jr = jsmc.systematic_resample(st, k)
    u0 = jax.random.uniform(k, (), minval=0.0, maxval=1.0 / P)
    tr = tsmc.systematic_resample(
        convert.particle_state_from_numpy(_asdict(st), device="cpu"),
        torch.tensor(float(u0), dtype=torch.float64))
    np.testing.assert_array_equal(tr.poses.numpy(), np.asarray(jr.poses))
    assert float(tsmc.ess(T(np.array(st.log_weights)))) == pytest.approx(
        float(jsmc.ess(st.log_weights)), rel=1e-12)


# ---- the map: registration view and pose refinement --------------------

@functools.lru_cache(maxsize=None)
def _jax_map():
    """JAX's map after inserting scan 0 (float64)."""
    st = jmap.map_init(JCFG, case.mapping_config(jcfg), *case.BOX,
                       dtype=jnp.float64, pending_capacity=case.PENDING)
    st, _ = jmap.map_insert(st, *(jnp.asarray(a) for a in case.scans()[0]),
                            JCFG, case.mapping_config(jcfg),
                            jax.random.key(0), jnp.asarray(1, jnp.int32))
    return st


def _calib(RBF, asarray):
    sf, l2, s20 = case.CAL
    return dict(depth_kp=RBF(asarray(sf), asarray(l2)), depth_s20=asarray(s20))


def test_map_as_compressed_matches_jax():
    """Every field of the sorted-slot view, and a register call on it."""
    js = _jax_map()
    ts = convert.map_state_from_numpy(_asdict(js), device="cpu")
    jv = jmap._map_as_compressed(js, JCFG)
    tv = tmap._map_as_compressed(ts, TCFG)
    jd, td = _asdict(jv), _asdict(tv)
    for f in ("rotations", "means", "rgb_means", "W", "n_leaves"):
        np.testing.assert_array_equal(td["patch"][f], jd["patch"][f])
    for f in ("keys", "n_leaves", "origin", "dims", "table"):
        np.testing.assert_array_equal(td["patch"]["grid"][f],
                                      jd["patch"]["grid"][f])
    for g in ("depth_gp", "rgb_gp"):
        for f in jd[g]:
            np.testing.assert_array_equal(td[g][f], jd[g][f])
    moved = case.moved_scans()[1]
    rcfg = case.registration_config(jcfg)
    jst, jout = jreg.register(jv, *(jnp.asarray(a) for a in moved), JCFG,
                              rcfg, **_calib(JRBF, jnp.asarray))
    tst, tout = treg.register(tv, *(T(a) for a in moved), TCFG,
                              case.registration_config(tcfg),
                              **_calib(TRBF, F64))
    assert int(tst.step_nbr) == int(jst.step_nbr)
    _close(tout, jout)


def test_smc_refine_pose_matches_jax():
    """Three steps of 32 particles scoring 256 points of the moved scan 1
    against the map of scan 0: the refined pose, the particles and the
    trace."""
    js = _jax_map()
    ts = convert.map_state_from_numpy(_asdict(js), device="cpu")
    moved = case.moved_scans()[1]
    cfg = dict(num_particles=32, pose_proposal_std_t=0.01,
               pose_proposal_std_r=0.004)
    key = jax.random.key(7)
    kw = dict(n_iters=3, n_eval_points=256)
    (jR, jt), jst, jtr = jmap.smc_refine_pose(
        js, *(jnp.asarray(a) for a in moved), JCFG, jcfg.SMCConfig(**cfg),
        key, **kw, **_calib(JRBF, jnp.asarray))
    (tR, tt), tst, ttr = tmap.smc_refine_pose(
        ts, *(T(a) for a in moved), TCFG, tcfg.SMCConfig(**cfg), **kw,
        draws=refine_draws(key, cfg["num_particles"], kw["n_iters"]),
        **_calib(TRBF, F64))
    for a, b in ((tR, jR), (tt, jt), (tst.poses, jst.poses),
                 (tst.log_weights, jst.log_weights), (ttr, jtr)):
        _close(a, b)
    assert np.isfinite(ttr.numpy()).all()


def test_smc_refine_pose_reads_nothing(monkeypatch):
    ts = convert.map_state_from_numpy(_asdict(_jax_map()), device="cpu")
    pts, cols, valid = (T(a) for a in case.moved_scans()[1])
    reads = importlib.import_module("test_torch_calibration")._count_reads(
        monkeypatch)
    (R, t), st, trace = tmap.smc_refine_pose(
        ts, pts, cols, valid, TCFG, tcfg.SMCConfig(num_particles=16),
        n_iters=2, n_eval_points=128, **_calib(TRBF, F64))
    assert reads == []
    assert R.shape == (3, 3) and trace.shape == (2,)


# ---- HMC-calibrated compress --------------------------------------------

def test_compress_calibrated_hmc_matches_jax():
    """method="hmc" at 6 warmup + 6 sampling steps, JAX's HMC draws and
    bank permutations fed: calibrated values (within 1e-6 in log space:
    both packages build float32 banks, so the calibration subsample, and
    the log posterior with it, differ at float32 rounding), states and
    RMSE as the MAP path's test holds them, and the calibrated config."""
    cal = importlib.import_module("test_torch_calibration")
    bayes = importlib.import_module("test_torch_bayes")
    pts, cols = cal._cloud()
    N, steps = cal.N, 6
    calib = cal.CALIB
    jc, jkp, js20, jcal = jcomp.compress_calibrated(
        jnp.asarray(pts), jnp.asarray(cols), jnp.ones(N, bool),
        cal._cfg(jcfg), cal.KEY, method="hmc", calib_steps=steps, **calib)
    kcal, key = jax.random.split(cal.KEY)
    draws = bayes.hmc_run_draws(kcal, 2, 3, jcfg.HMCConfig(
        num_warmup=steps, num_samples=steps, num_chains=2))
    B, P = 256, 64
    kd, kc = jax.random.split(key)
    perm = tuple(T(np.asarray(jax.vmap(lambda k: jax.random.permutation(
        k, P))(jax.random.split(k, B))).astype(np.int64)) for k in (kd, kc))
    tc, tkp, ts20, tcal = tcomp.compress_calibrated(
        T(pts), T(cols), torch.ones(N, dtype=torch.bool), cal._cfg(tcfg),
        method="hmc", calib_steps=steps, calib_dtype=torch.float64,
        perm=perm, hmc_draws=draws, **calib)
    cal._hold(jc, tc, jkp, tkp, js20, ts20)
    for f in ("sigmaf_sq", "l_sq", "s20", "eps_tol"):
        np.testing.assert_allclose(getattr(tcal.depth_gp, f),
                                   getattr(jcal.depth_gp, f), rtol=1e-5)
    assert dataclasses.replace(tcal, depth_gp=cal._cfg(tcfg).depth_gp) == \
        cal._cfg(tcfg)
