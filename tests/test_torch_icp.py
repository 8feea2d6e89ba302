"""The port's point-to-plane ICP and the gp-accuracy protocol against the
JAX package on the CPU, float64 (x64 on).

`icp_register` on tests/test_registration.py's small map (a 9k-point room
cloud, half as the map, the other half moved by a known small motion):
the JAX-built map is carried across (io/convert), and R, t, the iteration
count, the plane-residual RMS and the matched count agree (R, t and RMS
within 1e-9; one host read of the stop test per iteration).

Then the 20-pair accuracy check of `gp_compressor_tpu.cli` gp-accuracy
(`cmd_gp_accuracy` at seeds 0-19, its reference GP constants, step 0.005
/ 150 steps and motion magnitudes 0.02 m / 0.005 rad) at a small size:
4k-point clouds, 384 patches of 32 points, capacity 14. JAX compresses
the first half (the port's compress has its own parity tests; its GP
states at the reference constants follow chaotic capacity deletions),
the map is carried across, and both packages' GP `register` and
`icp_register` align the moved second half. Per pair the steps and
iterations are equal and the final mean point errors within 1e-6 m; the
medians over the 20 pairs agree within 10% or 0.5 mm, the guard
chip_smoke.py holds the card's own protocol to.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.geometry import transforms as jtf
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu.workloads import icp as jicp
from gp_compressor_tpu.workloads import registration as jreg
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.geometry import transforms as ttf
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.utils import profiling
from gp_compressor_tpu_torch.utils import synthetic as tsyn
from gp_compressor_tpu_torch.workloads import compressor as tcomp
from gp_compressor_tpu_torch.workloads import icp as ticp
from gp_compressor_tpu_torch.workloads import registration as treg

torch.set_num_threads(1)

T = torch.from_numpy


def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


@functools.lru_cache(maxsize=None)
def _icp_case():
    """tests/test_registration.py's map and scan (CFG, _map_and_scan) and
    the motion of test_icp_baseline_recovers_transform."""
    cfg = jcfg.CompressorConfig(
        patch=jcfg.PatchConfig(res=0.3, sz=10, max_patches=512,
                               max_points_per_patch=256),
        depth_gp=jcfg.GPConfig(capacity=60, slots=64, dtype=jnp.float64),
        rgb_gp=jcfg.rgb_gp_config(slots=64, capacity=60, dtype=jnp.float64))
    pts, cols = synthetic.room_cloud(n=9000, seed=4)
    half = 4500
    jc = jcomp.compress(jnp.asarray(pts[:half], jnp.float64),
                        jnp.asarray(cols[:half], jnp.float64),
                        jnp.ones(half, bool), cfg, jax.random.key(0))
    scan, _ = synthetic.rigid_transform(pts[half:].astype(np.float64),
                                        [0.0, 0.008, -0.006],
                                        [0.02, -0.015, 0.01])
    return cfg, jc, scan, pts[half:].astype(np.float64)


def _reads():
    return profiling.counters().get("icp.reads", 0)


def test_icp_register_matches_jax():
    cfg, jc, scan, truth = _icp_case()
    valid = np.ones(scan.shape[0], bool)
    jres = jicp.icp_register(jc, jnp.asarray(scan), jnp.asarray(valid), cfg)
    tc = convert.compressed_from_numpy(_asdict(jc), device="cpu")
    profiling.reset_counters()
    tres = ticp.icp_register(tc, T(scan), T(valid),
                             convert.compressor_config_from_dict(
                                 dataclasses.asdict(cfg)))
    assert tres.iters == int(jres.iters) == _reads()
    assert int(tres.n_matched) == int(jres.n_matched) > 1000
    for a, b in ((tres.R, jres.R), (tres.t, jres.t),
                 (tres.rms_residual, jres.rms_residual)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)
    aligned = ttf.apply(T(scan), tres.R, tres.t).numpy()
    err0 = np.linalg.norm(scan - truth, axis=1).mean()
    err1 = np.linalg.norm(aligned - truth, axis=1).mean()
    assert err1 < 0.5 * err0


def test_icp_stops_at_max_iters_and_on_tolerance():
    """max_iters bounds the loop (one read per iteration); a tolerance
    above the first increment stops after one iteration."""
    cfg, jc, scan, _ = _icp_case()
    tc = convert.compressed_from_numpy(_asdict(jc), device="cpu")
    tcf = convert.compressor_config_from_dict(dataclasses.asdict(cfg))
    valid = torch.ones(scan.shape[0], dtype=torch.bool)
    for kw, iters in ((dict(max_iters=2), 2), (dict(tol=1.0), 1),
                      (dict(max_iters=0), 0)):
        profiling.reset_counters()
        res = ticp.icp_register(tc, T(scan), valid, tcf, **kw)
        j = jicp.icp_register(jc, jnp.asarray(scan),
                              jnp.asarray(valid.numpy()), cfg, **kw)
        assert res.iters == int(j.iters) == iters == _reads()
        np.testing.assert_allclose(res.t.numpy(), np.asarray(j.t), atol=1e-9)


# ---- the gp-accuracy protocol over 20 pairs, small -------------------------

N_PAIRS, N_CLOUD = 20, 4000


def _acc_cfg(m, dt):
    """gp-accuracy's configuration (cli.py _gp_config at res 0.3, sz 10:
    the reference GP constants, eps_tol 1e-6) with small patch bounds
    (the ~330 leaves of a 2k-point half fit) and capacity."""
    return m.CompressorConfig(
        patch=m.PatchConfig(res=0.3, sz=10, max_patches=384,
                            max_points_per_patch=32),
        depth_gp=m.GPConfig(capacity=14, slots=16, eps_tol=1e-6, dtype=dt),
        rgb_gp=m.rgb_gp_config(slots=16, capacity=14, dtype=dt))


def _pair(seed):
    """cmd_gp_accuracy's pair at `seed`: the map half, the moved scan
    half and its ground truth."""
    pts, cols = tsyn.room_cloud(n=N_CLOUD, seed=seed)
    half = N_CLOUD // 2
    rng = np.random.default_rng(seed)
    rotvec = 0.005 * rng.standard_normal(3)
    t_true = 0.02 * rng.standard_normal(3)
    p64 = pts.astype(np.float64)
    scan, _ = tsyn.rigid_transform(p64[half:], rotvec, t_true)
    return (p64[:half], cols[:half].astype(np.float64), scan,
            cols[half:].astype(np.float64), p64[half:])


@functools.lru_cache(maxsize=None)
def _accuracy():
    """Final mean point errors [pair, (jax gp, port gp, jax icp, port icp)],
    the initial errors, and the steps / iterations of each. Both packages
    register against the map JAX compressed (carried across)."""
    jc_cfg, tc_cfg = _acc_cfg(jcfg, jnp.float64), _acc_cfg(tcfg, torch.float64)
    jr_cfg = jcfg.RegistrationConfig(step=0.005, max_steps=150)
    tr_cfg = tcfg.RegistrationConfig(step=0.005, max_steps=150)
    compress = jax.jit(jcomp.compress, static_argnames=("cfg",))
    icp = jax.jit(jicp.icp_register, static_argnames=("cfg",))
    errs, err0, counts = [], [], []
    for seed in range(N_PAIRS):
        mp, mc, scan, scols, truth = _pair(seed)
        valid = np.ones(scan.shape[0], bool)
        jc = compress(jnp.asarray(mp), jnp.asarray(mc),
                      jnp.ones(mp.shape[0], bool), jc_cfg,
                      jax.random.key(seed))
        tc = convert.compressed_from_numpy(_asdict(jc), device="cpu")
        jst, jal = jreg.register(jc, jnp.asarray(scan), jnp.asarray(scols),
                                 jnp.asarray(valid), jc_cfg, jr_cfg)
        tst, tal = treg.register(tc, T(scan), T(scols), T(valid), tc_cfg,
                                 tr_cfg)
        ji = icp(jc, jnp.asarray(scan), jnp.asarray(valid), jc_cfg)
        ti = ticp.icp_register(tc, T(scan), T(valid), tc_cfg)
        jia = np.asarray(jtf.apply(jnp.asarray(scan), ji.R, ji.t))
        tia = ttf.apply(T(scan), ti.R, ti.t).numpy()
        e = lambda a: np.linalg.norm(np.asarray(a) - truth, axis=1).mean()
        errs.append([e(jal), e(tal.numpy()), e(jia), e(tia)])
        err0.append(e(scan))
        counts.append([int(jst.step_nbr), int(tst.step_nbr), int(ji.iters),
                       ti.iters])
    return np.array(errs), np.array(err0), np.array(counts)


def test_accuracy_pairs_match_jax():
    errs, err0, counts = _accuracy()
    np.testing.assert_array_equal(counts[:, 1], counts[:, 0])
    np.testing.assert_array_equal(counts[:, 3], counts[:, 2])
    np.testing.assert_allclose(errs[:, 1], errs[:, 0], atol=1e-6)
    np.testing.assert_allclose(errs[:, 3], errs[:, 2], atol=1e-6)
    med = np.median(errs, axis=0)
    for j, t in ((0, 1), (2, 3)):
        assert abs(med[t] - med[j]) <= max(0.1 * med[j], 5e-4), med
    # both methods reduce the injected error (the GP ascent at the
    # reference constants often stops after its 10 minimum steps)
    assert (med < np.median(err0)).all(), (med, np.median(err0))
