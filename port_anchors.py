"""The JAX package's CPU anchors that `chip_smoke.py` holds the port to.

Runs the JAX package (the reference) on the CPU in float32, x64 off, on
the exact input and configuration `chip_smoke.py` drives the port with:
the 300k-point `room_cloud(seed=0)` at the bench configuration
(`bench.py:168-195`). It prints one JSON object with

  * the headline round trip: n_leaves, banked points, in-sample RMSE;
  * the calibrated round trip (`bench.py:325-357`), cold (150 steps, lr
    0.1, 4 starts) and warm (theta from the cold run, 40 steps, lr 0.05,
    1 start): sigma_f^2, l^2, s20, in-sample RMSE, BV-count histogram;
  * registration (`bench.py:488-572`): rprop with 80 steps on the
    calibrated map, and the reference-constants row (fixed step 0.005,
    grad_tol_step_ref 0.1, 40 steps) on the headline map: steps, initial
    and final mean point error, translation and rotation error;
  * mapping (`bench.py:575-688`): sigma_f^2, l^2, s20 calibrated on scan 0
    of the two 150k-point scans, then the stream at those values (the seed
    scan, then one `add_clouds` of 4 scans alternating scan 1 and scan 0):
    n_patches, the one-sided chamfer RMSE from `map_cloud` to both scans,
    non-finite map points, the summed drop counters, per-scan reg_steps;
  * bayes (`bench.py:373-456,691-777` and `compressor.compress_calibrated`):
    4- and 16-chain NUTS on the headline banks' 16 x 48 calibration
    subsample (posterior mean, standard deviation and minimum ESS of theta,
    accept, max split-R-hat), ADVI from the multi-start MAP mode (plateau,
    mode), `compress_calibrated(method="hmc")` at 400 steps (sigma_f^2,
    l^2, s20, in-sample RMSE), and the SMC row's three mean point errors;
  * nuts_seeds: the 16-chain NUTS row at NUTS_SEEDS further seeds (keys
    100 + i for the starts, 200 + i for the sampler): max split-R-hat and
    the per-axis standard deviation of each run, the spread that one
    anchor run cannot show;
  * ksvd: the K-SVD row (`bench.py:779-822`: `ksvd_compressor.compress`
    with atom_block 16 for depth and RGB) at keys 1-4: in-sample RMS,
    depth and RGB masked MSE, sweep counts and mean words per valid
    patch, and the range of each over the keys;
  * icp: `icp.icp_register` on the headline map, the full cloud moved by
    registration's perturbation (ANG, T_TRUE): iterations, translation and
    rotation error, initial and final mean point error, plane-residual
    RMS, matched points;
  * accuracy: `cli.py` gp-accuracy (`cmd_gp_accuracy`) at its defaults
    (100k points, res 0.3, sz 10, 4096 patches of 256 points, capacity
    100, step 0.005, 150 steps, motion magnitudes 0.02 m / 0.005 rad) at
    seeds 0 to ACC_PAIRS - 1, GP `register` and `icp_register` on each
    pair: steps, translation and rotation error, initial and final mean
    point error; the median and worst final error of each method;
  * accuracy_noise: the first registration gradient of gp-accuracy's pairs
    at seeds 0-2, in float32 and on the same float32 states cast to
    float64 (x64 switched on after the map is built): how much of the
    gradient at the reference GP constants is rounding;
  * accuracy_resets: gp-accuracy's GP constants at a small size (12k
    points, 384 patches of 64 points), trained in float32 and in float64
    (x64 on): the depth and RGB patches holding points that sanitize
    leaves empty, per seed 0-2.
  * cli: the command line (`cli.main`) at the arguments of chip_smoke.py's
    phase 12, see `cli_anchors`: printed counts, errors and calibrated
    values, at four keys where the command draws from one.

    JAX_PLATFORMS=cpu python3 port_anchors.py [section ...]

with sections among headline, calibrated, registration, mapping, bayes,
nuts_seeds, ksvd, icp, accuracy, cli, accuracy_noise, accuracy_resets
(all but cli and the last two, which switch x64 on and so each run
alone, when none is named; cli ~40 min;
registration needs calibrated and headline, icp needs headline). It needs the JAX
package and a few GiB of host memory, and takes some minutes on the CPU
(accuracy ~20); the port's machine does not run it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", False)

from gp_compressor_tpu import config as c  # noqa: E402
from gp_compressor_tpu.config import RegistrationConfig  # noqa: E402
from gp_compressor_tpu.geometry import transforms  # noqa: E402
from gp_compressor_tpu.models import sparse_gp  # noqa: E402
from gp_compressor_tpu.utils import synthetic  # noqa: E402
from gp_compressor_tpu.workloads import compressor, registration  # noqa: E402

N_POINTS = 300_000
ANG = [0.004, -0.003, 0.005]
T_TRUE = [0.012, -0.009, 0.006]
SMC_ANG = [0.012, -0.008, 0.010]          # bench.py:731-732
SMC_T = [0.05, -0.04, 0.03]


def bench_config():
    return c.CompressorConfig(
        patch=c.PatchConfig(res=0.15, sz=20, max_patches=2048,
                            max_points_per_patch=256,
                            approx_sphere_moments=True,
                            bank_order="center_out"),
        depth_gp=c.GPConfig(capacity=30, slots=32, eps_tol=2.0),
        rgb_gp=dataclasses.replace(c.rgb_gp_config(slots=32, capacity=30),
                                   eps_tol=2.0),
        ksvd=c.KSVDConfig(atom_block=16),
        rgb_ksvd=dataclasses.replace(c.rgb_ksvd_config(), atom_block=16))


KSVD_KEYS = (1, 2, 3, 4)


def ksvd_anchors(pts, cols, valid, cfg):
    """The K-SVD row of bench.py:779-822 on the CPU (float32) at
    KSVD_KEYS."""
    from gp_compressor_tpu.workloads import ksvd_compressor

    runs = []
    for k in KSVD_KEYS:
        t0 = time.time()
        comp = ksvd_compressor.compress(pts, cols, valid, cfg,
                                        jax.random.key(k))
        n = int(comp.raster.n_leaves)
        B = comp.raster.S.shape[0]
        nw_rgb = np.asarray(comp.rgb.code.nw).reshape(3, B)[:, :n]
        runs.append({
            "key": k, "rms": ksvd_compressor.rms_error(comp),
            "depth_mse": float(comp.depth.error),
            "rgb_mse": float(comp.rgb.error),
            "depth_iters": int(comp.depth.iters),
            "rgb_iters": int(comp.rgb.iters),
            "depth_mean_words": float(np.mean(
                np.asarray(comp.depth.code.nw)[:n])),
            "rgb_mean_words": float(np.mean(nw_rgb)),
            "n_leaves": n, "cpu_wall_s": time.time() - t0})
        print(json.dumps({"ksvd_key": runs[-1]}), flush=True)
    return {"runs": runs, "range": {
        f: [min(r[f] for r in runs), max(r[f] for r in runs)]
        for f in runs[0] if f not in ("key", "cpu_wall_s")}}


def icp_anchors(pts, valid, cfg, comp):
    """icp_register on the headline map, the whole cloud moved by the
    registration rows' perturbation."""
    from gp_compressor_tpu.workloads import icp

    R_true = transforms.euler_xyz(jnp.asarray(ANG, jnp.float32))
    t_true = jnp.asarray(T_TRUE, jnp.float32)
    moved = transforms.apply(pts, R_true, t_true)
    res = icp.icp_register(comp, moved, valid, cfg)
    terr, rerr = registration.registration_error(res.R, res.t, R_true,
                                                 t_true)
    out = transforms.apply(moved, res.R, res.t)
    return {"iters": int(res.iters), "trans_err": float(terr),
            "rot_err": float(rerr),
            "initial_mean_err": float(jnp.mean(jnp.linalg.norm(
                moved - pts, axis=1))),
            "final_mean_err": float(jnp.mean(jnp.linalg.norm(
                out - pts, axis=1))),
            "rms_residual": float(res.rms_residual),
            "n_matched": int(res.n_matched)}


ACC_PAIRS, ACC_POINTS = 20, 100_000


def accuracy_config():
    """cli.py _gp_config at gp-accuracy's defaults (cli.py:380-416)."""
    return c.CompressorConfig(
        patch=c.PatchConfig(res=0.3, sz=10, max_patches=4096,
                            max_points_per_patch=256),
        depth_gp=c.GPConfig(capacity=100, slots=101, eps_tol=1e-6),
        rgb_gp=c.rgb_gp_config(slots=101, capacity=100))


def accuracy_anchors():
    """cmd_gp_accuracy (cli.py:193-253) with --baseline icp at seeds 0 to
    ACC_PAIRS - 1."""
    from gp_compressor_tpu.workloads import icp

    cfg = accuracy_config()
    rcfg = RegistrationConfig(step=0.005, max_steps=150)
    half = ACC_POINTS // 2
    icp_fn = jax.jit(icp.icp_register, static_argnames=("cfg",))
    pairs = []
    for seed in range(ACC_PAIRS):
        pts, cols = synthetic.room_cloud(n=ACC_POINTS, seed=seed)
        comp = compressor.compress(jnp.asarray(pts[:half]),
                                   jnp.asarray(cols[:half]),
                                   jnp.ones(half, bool), cfg,
                                   jax.random.key(seed))
        rng = np.random.default_rng(seed)
        rotvec = 0.005 * rng.standard_normal(3)
        t_true = 0.02 * rng.standard_normal(3)
        scan, R_true = synthetic.rigid_transform(pts[half:], rotvec, t_true)
        ones = jnp.ones(len(scan), bool)
        st, aligned = registration.register(
            comp, jnp.asarray(scan), jnp.asarray(cols[half:]), ones, cfg,
            rcfg)
        res = icp_fn(comp, jnp.asarray(scan), ones, cfg)
        err = lambda p: float(np.linalg.norm(np.asarray(p) - pts[half:],
                                             axis=1).mean())
        Rt = jnp.asarray(R_true, jnp.float32)
        tt = jnp.asarray(t_true, jnp.float32)
        gte, gre = registration.registration_error(st.R_cloud, st.t_exact,
                                                   Rt, tt)
        ite, ire = registration.registration_error(res.R, res.t, Rt, tt)
        pairs.append({
            "seed": seed, "initial_mean_err": err(scan),
            "gp": {"steps": int(st.step_nbr), "final_mean_err": err(aligned),
                   "trans_err": float(gte), "rot_err": float(gre)},
            "icp": {"iters": int(res.iters),
                    "final_mean_err": err(transforms.apply(
                        jnp.asarray(scan), res.R, res.t)),
                    "trans_err": float(ite), "rot_err": float(ire)}})
        print(json.dumps({"accuracy_pair": pairs[-1]}), flush=True)
    summary = {m: {"median_final_mean_err": float(np.median(
        [p[m]["final_mean_err"] for p in pairs])),
        "worst_final_mean_err": float(np.max(
            [p[m]["final_mean_err"] for p in pairs]))}
        for m in ("gp", "icp")}
    return {"pairs": pairs, "summary": summary}


def hist(state):
    return np.bincount(np.asarray(sparse_gp.size(state)),
                       minlength=33).tolist()


def mapping_anchors(pts, cols, valid, cfg):
    """The mapping row of bench.py:575-688 on the CPU (float32)."""
    from scipy.spatial import cKDTree

    from gp_compressor_tpu.config import MappingConfig
    from gp_compressor_tpu.workloads import mapping

    lo = np.asarray(jnp.min(pts, 0)) - 0.3
    hi = np.asarray(jnp.max(pts, 0)) + 0.3
    p99 = float(np.percentile(np.linalg.norm(np.asarray(pts), axis=1), 99))
    steps = min(mapping.required_ray_steps(lo, hi, cfg.patch.res),
                int(1.2 * p99 / cfg.patch.res) + 2)
    mcfg = MappingConfig(min_points_new_patch=50, max_ray_steps=steps,
                         carve_stride=8, drop_on_reg_cap=False, reg_stride=4)
    rcfg = RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                              bank_points=64)
    n_scans, Ns = 4, 150_000
    scans = [(pts[i::2][:Ns], cols[i::2][:Ns], valid[i::2][:Ns])
             for i in (0, 1)]
    _, kpc, s20c, _ = compressor.compress_decompress_calibrated(
        *scans[0], cfg, jax.random.key(5), calib_patches=32,
        calib_points=64, calib_steps=150, calib_lr=0.1, calib_starts=4)
    eps_c = cfg.depth_gp.eps_tol * kpc.sigmaf_sq / cfg.depth_gp.sigmaf_sq
    calib = dict(depth_kp=kpc, depth_s20=s20c, depth_eps=eps_c)
    state = mapping.map_init(cfg, mcfg, lo, hi, dtype=pts.dtype)
    state, _, _, info0 = mapping.add_cloud_fused(
        state, *scans[0], cfg, mcfg, jax.random.key(0), rcfg=rcfg, **calib)
    n_seed = int(state.n_patches)
    SP, SC, SV = (jnp.stack([scans[(1 + s) % 2][j] for s in range(n_scans)])
                  for j in range(3))
    state, diverged, reg_steps, info = mapping.add_clouds(
        state, SP, SC, SV, cfg, mcfg, jax.random.key(1), rcfg=rcfg, **calib)
    mpts, _, mok = mapping.map_cloud(state, cfg, depth_kp=kpc,
                                     depth_s20=s20c)
    mp = np.asarray(mpts)[np.asarray(mok)]
    finite = np.isfinite(mp).all(axis=1)
    ref = np.concatenate([np.asarray(s[0]) for s in scans])
    d, _ = cKDTree(ref).query(mp[finite], k=1)
    return {
        "sigmaf_sq": float(kpc.sigmaf_sq), "l_sq": float(kpc.l_sq),
        "s20": float(s20c), "eps_c": float(eps_c), "ray_steps": steps,
        "n_patches_seed": n_seed, "n_patches": int(state.n_patches),
        "map_rmse_m": float(np.sqrt(np.mean(d ** 2))),
        "map_points": int(mp.shape[0]),
        "map_points_nonfinite": int((~finite).sum()),
        "reg_steps": np.asarray(reg_steps).tolist(),
        "diverged": np.asarray(diverged).tolist(),
        **{k: int(np.sum(np.asarray(v)) + int(info0[k]))
           for k, v in info.items()}}


def _chains(samples, acc):
    """Posterior summary of NUTS draws [C, T, 3]."""
    from gp_compressor_tpu.inference import hmc

    s = np.asarray(samples, np.float64)
    return {"mean": s.reshape(-1, 3).mean(0).tolist(),
            "std": s.reshape(-1, 3).std(0).tolist(),
            "accept": float(jnp.mean(acc)),
            "max_rhat": float(jnp.max(hmc.split_rhat(samples))),
            "ess": np.asarray(hmc.effective_sample_size(samples)).tolist()}


NUTS_SEEDS = 8


def nuts_seed_anchors(comp):
    """The 16-chain NUTS row (bench.py:414-433) at NUTS_SEEDS seeds."""
    from gp_compressor_tpu.config import HMCConfig
    from gp_compressor_tpu.inference import hmc, nuts

    Xc, yc, mc = compressor.calib_subsample(comp.patch, 16, 48)
    logpost = hmc.make_patch_logpost(Xc, yc, mc.astype(jnp.float32))
    theta0 = jnp.asarray([np.log(100.0), 0.0, np.log(0.1)], jnp.float32)
    run = jax.jit(lambda th, k: nuts.nuts_sample_chains(
        logpost, th, k, HMCConfig(num_warmup=50, num_samples=100,
                                  num_chains=16)))
    out = []
    for i in range(NUTS_SEEDS):
        th0 = theta0[None, :] + 0.2 * jax.random.normal(
            jax.random.key(100 + i), (16, 3), jnp.float32)
        samples, _, _ = run(th0, jax.random.key(200 + i))
        s = np.asarray(samples, np.float64)
        out.append({"max_rhat": float(jnp.max(hmc.split_rhat(samples))),
                    "std": s.reshape(-1, 3).std(0).tolist()})
        print(json.dumps({"nuts_seed": i, **out[-1]}), flush=True)
    return out


def bayes_anchors(pts, cols, valid, cfg, comp):
    """The Bayesian rows (float32): NUTS and ADVI on the headline banks'
    subsample (bench.py:373-456), the HMC-calibrated compress, and the SMC
    row (bench.py:691-777)."""
    from gp_compressor_tpu.config import (HMCConfig, MappingConfig,
                                          SMCConfig)
    from gp_compressor_tpu.inference import hmc, nuts, vi
    from gp_compressor_tpu.workloads import mapping

    out = {}
    Xc, yc, mc = compressor.calib_subsample(comp.patch, 16, 48)
    logpost = hmc.make_patch_logpost(Xc, yc, mc.astype(jnp.float32))
    theta0 = jnp.asarray([np.log(100.0), 0.0, np.log(0.1)], jnp.float32)
    for C, kth, ks in ((4, 7, 2), (16, 8, 12)):
        hcfg = HMCConfig(num_warmup=50, num_samples=100, num_chains=C)
        th0 = theta0[None, :] + 0.2 * jax.random.normal(
            jax.random.key(kth), (C, 3), jnp.float32)
        samples, acc, _ = nuts.nuts_sample_chains(logpost, th0,
                                                  jax.random.key(ks), hcfg)
        out[f"nuts{C}"] = _chains(samples, acc)
        print(json.dumps({f"nuts{C}": out[f"nuts{C}"]}), flush=True)
    theta_map, _ = hmc.map_estimate_multi(logpost, theta0, steps=150,
                                          lr=0.1, n_starts=4)
    res = vi.fit_advi(logpost, theta_map, jax.random.key(4), steps=300)
    out["advi"] = {"plateaued": bool(vi.elbo_plateaued(res.elbo_trace)),
                   "mean": np.asarray(res.mean).tolist(),
                   "log_std": np.asarray(res.log_std).tolist(),
                   "final_elbo": float(jnp.mean(res.elbo_trace[-20:])),
                   "map_theta": np.asarray(theta_map).tolist()}
    print(json.dumps({"advi": out["advi"]}), flush=True)

    comp_h, kph, s20h, cal = compressor.compress_calibrated(
        pts, cols, valid, cfg, jax.random.key(0), method="hmc",
        calib_steps=400)
    out["hmc_calibrated"] = {
        "calib_steps": 400, "sigmaf_sq": float(kph.sigmaf_sq),
        "l_sq": float(kph.l_sq), "s20": float(s20h),
        "rmse": float(compressor.reconstruction_rmse(
            comp_h, cal, depth_kp=kph, depth_s20=s20h))}
    print(json.dumps({"hmc_calibrated": out["hmc_calibrated"]}), flush=True)

    # the SMC row
    lo = np.asarray(jnp.min(pts, 0)) - 0.3
    hi = np.asarray(jnp.max(pts, 0)) + 0.3
    p99 = float(np.percentile(np.linalg.norm(np.asarray(pts), axis=1), 99))
    steps = min(mapping.required_ray_steps(lo, hi, cfg.patch.res),
                int(1.2 * p99 / cfg.patch.res) + 2)
    mcfg = MappingConfig(min_points_new_patch=50, max_ray_steps=steps,
                         carve_stride=8, drop_on_reg_cap=False, reg_stride=4)
    rcfg = RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                              bank_points=64)
    Ns = 150_000
    scan0 = (pts[0::2][:Ns], cols[0::2][:Ns], valid[0::2][:Ns])
    scan1 = (pts[1::2][:Ns], cols[1::2][:Ns], valid[1::2][:Ns])
    _, kpc, s20c, _ = compressor.compress_decompress_calibrated(
        *scan0, cfg, jax.random.key(5), calib_patches=32, calib_points=64,
        calib_steps=150, calib_lr=0.1, calib_starts=4)
    eps_c = cfg.depth_gp.eps_tol * kpc.sigmaf_sq / cfg.depth_gp.sigmaf_sq
    state = mapping.map_init(cfg, mcfg, lo, hi, dtype=pts.dtype)
    state, _, _, _ = mapping.add_cloud_fused(
        state, *scan0, cfg, mcfg, jax.random.key(0), rcfg=rcfg,
        depth_kp=kpc, depth_s20=s20c, depth_eps=eps_c)
    R_true = transforms.euler_xyz(jnp.asarray(SMC_ANG, jnp.float32))
    moved = transforms.apply(scan1[0], R_true,
                             jnp.asarray(SMC_T, jnp.float32))
    err = lambda p: float(jnp.mean(jnp.linalg.norm(p - scan1[0], axis=1)))
    st, out_reg = registration.register(
        mapping._map_as_compressed(state, cfg), moved, scan1[1], scan1[2],
        cfg, rcfg, depth_kp=kpc, depth_s20=s20c)
    scfg = SMCConfig(num_particles=256, pose_proposal_std_t=0.012,
                     pose_proposal_std_r=0.004)
    smc_err = []
    for k in (4, 5, 6):
        (R2, t2), _, _ = mapping.smc_refine_pose(
            state, out_reg, scan1[1], scan1[2], cfg, scfg,
            jax.random.key(k), n_iters=16, depth_kp=kpc, depth_s20=s20c)
        smc_err.append(err(transforms.apply(out_reg, R2, t2)))
    out["smc"] = {"injected_err_m": err(moved),
                  "after_reg_budget_err_m": err(out_reg),
                  "reg_steps": int(st.step_nbr),
                  "after_smc_err_m": smc_err,
                  "n_patches_seed": int(state.n_patches)}
    print(json.dumps({"smc": out["smc"]}), flush=True)
    return out


def accuracy_noise_anchors(seeds=(0, 1, 2)):
    """compute_transformation on gp-accuracy's first pairs (the map at
    x64 off, as accuracy_anchors builds it), in float32 and on the same
    states cast to float64. Switches x64 on."""
    half = ACC_POINTS // 2
    cfg = accuracy_config()
    rcfg = RegistrationConfig(step=0.005, max_steps=150)
    maps = []
    for seed in seeds:
        pts, cols = synthetic.room_cloud(n=ACC_POINTS, seed=seed)
        comp = compressor.compress(jnp.asarray(pts[:half]),
                                   jnp.asarray(cols[:half]),
                                   jnp.ones(half, bool), cfg,
                                   jax.random.key(seed))
        rng = np.random.default_rng(seed)
        scan, _ = synthetic.rigid_transform(
            pts[half:], 0.005 * rng.standard_normal(3),
            0.02 * rng.standard_normal(3))
        maps.append((comp, scan, cols[half:]))
    jax.config.update("jax_enable_x64", True)
    f64 = lambda x: (x.astype(jnp.float64) if getattr(x, "dtype", None)
                     == jnp.float32 else x)
    gp64 = {k: dataclasses.replace(getattr(cfg, k), dtype=jnp.float64)
            for k in ("depth_gp", "rgb_gp")}
    cfg64 = dataclasses.replace(cfg, **gp64)
    out = []
    for seed, (comp, scan, cols) in zip(seeds, maps):
        ones = jnp.ones(half, bool)
        d32 = registration.compute_transformation(
            comp, jnp.asarray(scan, jnp.float32),
            jnp.asarray(cols, jnp.float32), ones, cfg, rcfg)[0]
        d64 = registration.compute_transformation(
            jax.tree.map(f64, comp), jnp.asarray(scan, jnp.float64),
            jnp.asarray(cols, jnp.float64), ones, cfg64, rcfg)[0]
        d32, d64 = np.asarray(d32, np.float64), np.asarray(d64)
        out.append({"seed": seed, "delta_f32": d32.tolist(),
                    "delta_f64": d64.tolist(),
                    "max_rel_gap": float(np.max(np.abs(d32 - d64))
                                         / np.max(np.abs(d64)))})
        print(json.dumps({"accuracy_noise": out[-1]}), flush=True)
    return out


def accuracy_resets_anchors(seeds=(0, 1, 2)):
    """gp-accuracy's GP constants (sigma_f^2 100, l^2 1, s20 0.1, eps_tol
    1e-6) at a small size (12k-point clouds, the first half compressed:
    res 0.3, sz 10, 384 patches of 64 points, 32 slots, capacity 30),
    trained in float32 and then, x64 switched on, in float64: per seed
    the patches holding points, the depth and RGB patches that sanitize
    leaves empty, and the mean depth BV count over patches with points.
    Switches x64 on."""
    def cfg(dt):
        return c.CompressorConfig(
            patch=c.PatchConfig(res=0.3, sz=10, max_patches=384,
                                max_points_per_patch=64),
            depth_gp=c.GPConfig(capacity=30, slots=32, eps_tol=1e-6,
                                dtype=dt),
            rgb_gp=c.rgb_gp_config(slots=32, capacity=30, dtype=dt))

    out = []
    for name, dt in (("f32", jnp.float32), ("f64", None)):
        if dt is None:
            jax.config.update("jax_enable_x64", True)
            dt = jnp.float64
        for seed in seeds:
            pts, cols = synthetic.room_cloud(n=12_000, seed=seed)
            comp = compressor.compress(
                jnp.asarray(pts[:6000], dt), jnp.asarray(cols[:6000], dt),
                jnp.ones(6000, bool), cfg(dt), jax.random.key(seed))
            used = np.asarray(comp.patch.mask).any(1)
            dsz = np.asarray(comp.depth_gp.active).sum(1)
            csz = np.asarray(comp.rgb_gp.active).sum(1)
            out.append({"dtype": name, "seed": seed,
                        "patches_with_points": int(used.sum()),
                        "depth_emptied": int(((dsz == 0) & used).sum()),
                        "rgb_emptied": int(((csz == 0) & used).sum()),
                        "mean_depth_bvs": float(dsz[used].mean())})
            print(json.dumps({"accuracy_resets": out[-1]}), flush=True)
    return out

CLI_KEYS = (0, 1, 2, 3)
# calibrate's float32 HMC lands in more than one mode across keys (the
# posterior mean of 2 chains at s20 -> 0, or between modes): more keys
CLI_HMC_KEYS = tuple(range(12))
CLI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "port_anchors_cli")


def _cli_lines(argv, key_offset=0):
    """The printed lines of the JAX command line's main(argv), with
    jax.random.key(s) drawing key s + key_offset (the CLI's only random
    source; --seed also picks the synthetic cloud, so the offset varies
    the draws alone)."""
    import contextlib
    import io

    from gp_compressor_tpu import cli

    orig = jax.random.key
    jax.random.key = lambda s: orig(s + key_offset)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        jax.random.key = orig
    return buf.getvalue().splitlines()


def _field(lines, prefix):
    line = next(ln for ln in lines if ln.startswith(prefix))
    return float(line.split(":")[1].strip().rstrip("s"))


def cli_anchors():
    """The JAX command line at the arguments chip_smoke.py's phase 12
    gives the port's, float32: gp-compress at its defaults on the
    300k-point room_cloud(seed=0) as a binary PCD, and compress, at keys
    CLI_KEYS; gp-accuracy's synthetic pair (seed 0, --baseline icp); the
    TUM-format fixture (make_fixture, 4 frames) through gp-accuracy
    (stride 1, 3 pairs) at CLI_KEYS; calibrate --map (the
    MAP of cmd_calibrate computed here: JAX's command line hands
    json.dumps numpy float32 values there and raises TypeError) and
    calibrate (HMC, 150 + 150 steps, 2 chains) at CLI_HMC_KEYS;
    gp-mapping over 5 synthetic scans (its insert draws nothing from the
    key) and over the fixture of each seed in CLI_FIXTURE_SEEDS."""
    from gp_compressor_tpu.io import pcd, tum

    os.makedirs(CLI_DIR, exist_ok=True)
    out = {}
    cloud = os.path.join(CLI_DIR, "room300k.pcd")
    pcd.write(cloud, *synthetic.room_cloud(n=N_POINTS, seed=0))
    runs = []
    for k in CLI_KEYS:
        lines = _cli_lines(["gp-compress", "--cloud", cloud], k)
        runs.append({f: _field(lines, p) for f, p in (
            ("n_points", "Size of original"), ("n_patches", "Number of"),
            ("mean_added", "Mean added"), ("max_added", "Max added"),
            ("rms", "RMS error"),
            ("n_out", "Size of transformed"))})
        print(json.dumps({"gp_compress": runs[-1]}), flush=True)
    out["gp_compress"] = runs

    runs = []
    for k in CLI_KEYS:
        name = os.path.join(CLI_DIR, f"ksvd{k}")
        lines = _cli_lines(["compress", "--name", name], k)
        iters = [int(ln.split()[2].rstrip(":")) for ln in lines
                 if ln.startswith("ksvd iter")]
        # each ksvd call counts its sweeps from 1: depth, then RGB
        split = iters.index(1, 1)
        dec = _cli_lines(["decompress", "--name", name])
        runs.append({"rms": _field(lines, "RMS error"),
                     "depth_iters": iters[split - 1],
                     "rgb_iters": iters[-1],
                     "n_out": int(_field(dec, "Size of transformed"))})
        print(json.dumps({"compress": runs[-1]}), flush=True)
    out["compress"] = runs

    out["gp_accuracy"] = json.loads(_cli_lines(
        ["gp-accuracy", "--baseline", "icp"])[-1])
    print(json.dumps({"gp_accuracy": out["gp_accuracy"]}), flush=True)

    fixture, _ = tum.make_fixture(os.path.join(CLI_DIR, "tum"), n_frames=4)
    out["tum_accuracy"] = [
        [json.loads(ln) for ln in _cli_lines(
            ["gp-accuracy", "--dataset", fixture, "--frame-stride", "1",
             "--n-pairs", "3"], k)] for k in CLI_KEYS]
    print(json.dumps({"tum_accuracy": out["tum_accuracy"]}), flush=True)
    out.update(cli_tum_mapping_anchors())
    out.update(cli_calibrate_mapping_anchors())
    return out


CLI_FIXTURE_SEEDS = (0, 1, 2, 3)


def cli_tum_mapping_anchors():
    """gp-mapping --dataset at its defaults on the TUM-format fixture of
    each seed in CLI_FIXTURE_SEEDS (make_fixture, 4 frames): the printed
    line of each scan. Registration against a float32 map at the
    reference constants varies from scan to scan, so phase 12 holds the
    port's steps to these as a sample."""
    from gp_compressor_tpu.io import tum

    out = {}
    for seed in CLI_FIXTURE_SEEDS:
        fixture, _ = tum.make_fixture(
            os.path.join(CLI_DIR, f"tum_seed{seed}"), n_frames=4, seed=seed)
        out[seed] = _cli_lines(["gp-mapping", "--dataset", fixture])
        print(json.dumps({"tum_mapping_seed": seed, "lines": out[seed]}),
              flush=True)
    return {"tum_mapping_seeds": out}


def cli_calibrate_mapping_anchors():
    """cli_anchors' calibrate (MAP, then HMC at CLI_HMC_KEYS) and
    synthetic gp-mapping rows."""
    from gp_compressor_tpu.inference import hmc

    out = {}
    # calibrate --map: cmd_calibrate's computation at its defaults
    ccfg = c.CompressorConfig(
        patch=c.PatchConfig(res=0.3, sz=10, max_patches=4096,
                            max_points_per_patch=256),
        depth_gp=c.GPConfig(capacity=100, slots=101, eps_tol=1e-6),
        rgb_gp=c.rgb_gp_config(slots=101, capacity=100))
    p, cl = synthetic.room_cloud(n=100_000, seed=0)
    batch = compressor.project(jnp.asarray(p), jnp.asarray(cl),
                               jnp.ones(len(p), bool), ccfg)
    X, y, mask = compressor.calib_subsample(
        batch, min(32, int(batch.n_leaves)), 64)
    logpost = hmc.make_patch_logpost(X, y, mask.astype(X.dtype))
    theta, trace = hmc.map_estimate(
        logpost, jnp.asarray([np.log(100.0), 0.0, np.log(0.1)]), steps=150)
    est = np.exp(np.asarray(theta, np.float64))
    out["calibrate_map"] = {"sigmaf_sq": float(est[0]), "l_sq": float(est[1]),
                            "s20": float(est[2]),
                            "logpost": float(trace[-1])}
    print(json.dumps({"calibrate_map": out["calibrate_map"]}), flush=True)
    out["calibrate_hmc"] = [json.loads(_cli_lines(["calibrate"], k)[-1])
                            for k in CLI_HMC_KEYS]
    print(json.dumps({"calibrate_hmc": out["calibrate_hmc"]}), flush=True)

    out["gp_mapping"] = _cli_lines(["gp-mapping", "--out", os.path.join(
        CLI_DIR, "map.pcd")])
    print(json.dumps({"gp_mapping": out["gp_mapping"]}), flush=True)
    return out


def main(sections):
    t_start = time.time()
    cfg = bench_config()
    pts_np, cols_np = synthetic.room_cloud(n=N_POINTS, seed=0)
    pts = jnp.asarray(pts_np, jnp.float32)
    cols = jnp.asarray(cols_np, jnp.float32)
    valid = jnp.ones(N_POINTS, bool)
    out = {}

    if "mapping" in sections:
        out["mapping"] = mapping_anchors(pts, cols, valid, cfg)
        print(json.dumps({"mapping": out["mapping"]}), flush=True)
    if "ksvd" in sections:
        out["ksvd"] = ksvd_anchors(pts, cols, valid, cfg)
        print(json.dumps({"ksvd": out["ksvd"]}), flush=True)
    if "accuracy" in sections:
        out["accuracy"] = accuracy_anchors()
        print(json.dumps({"accuracy": out["accuracy"]}), flush=True)
    if "cli" in sections:
        out["cli"] = cli_anchors()
    if sections == {"accuracy_noise"}:
        out["accuracy_noise"] = accuracy_noise_anchors()
    if sections == {"accuracy_resets"}:
        out["accuracy_resets"] = accuracy_resets_anchors()
    if not sections & {"headline", "calibrated", "registration", "bayes",
                       "nuts_seeds", "icp"}:
        out["seconds"] = time.time() - t_start
        out["jax"] = jax.__version__
        print(json.dumps(out), flush=True)
        return

    comp, _ = compressor.compress_decompress(pts, cols, valid, cfg,
                                             jax.random.key(0))
    out["headline"] = {
        "n_leaves": int(comp.patch.n_leaves),
        "banked": int(jnp.sum(comp.patch.mask)),
        "rmse": float(compressor.reconstruction_rmse(comp, cfg)),
        "depth_bv_hist": hist(comp.depth_gp)}
    print(json.dumps(out["headline"]), flush=True)
    if "icp" in sections:
        out["icp"] = icp_anchors(pts, valid, cfg, comp)
        print(json.dumps({"icp": out["icp"]}), flush=True)
    if "bayes" in sections:
        out["bayes"] = bayes_anchors(pts, cols, valid, cfg, comp)
    if "nuts_seeds" in sections:
        out["nuts_seeds"] = nuts_seed_anchors(comp)
    if not sections & {"calibrated", "registration"}:
        out["seconds"] = time.time() - t_start
        out["jax"] = jax.__version__
        print(json.dumps(out), flush=True)
        return

    comp_c, kpc, s20c, _ = compressor.compress_decompress_calibrated(
        pts, cols, valid, cfg, jax.random.key(0), calib_patches=32,
        calib_points=64, calib_steps=150, calib_lr=0.1, calib_starts=4)
    out["cold"] = {
        "sigmaf_sq": float(kpc.sigmaf_sq), "l_sq": float(kpc.l_sq),
        "s20": float(s20c),
        "rmse": float(compressor.reconstruction_rmse(
            comp_c, cfg, depth_kp=kpc, depth_s20=s20c)),
        "depth_bv_hist": hist(comp_c.depth_gp),
        "rgb_bv_hist": hist(comp_c.rgb_gp)}
    print(json.dumps(out["cold"]), flush=True)
    theta = jnp.log(jnp.stack([kpc.sigmaf_sq, kpc.l_sq, s20c]))
    comp_w, kpw, s20w, _ = compressor.compress_decompress_calibrated(
        pts, cols, valid, cfg, jax.random.key(9), calib_patches=32,
        calib_points=64, calib_steps=40, calib_lr=0.05, calib_starts=1,
        theta_init=theta)
    out["warm"] = {
        "sigmaf_sq": float(kpw.sigmaf_sq), "l_sq": float(kpw.l_sq),
        "s20": float(s20w),
        "rmse": float(compressor.reconstruction_rmse(
            comp_w, cfg, depth_kp=kpw, depth_s20=s20w)),
        "depth_bv_hist": hist(comp_w.depth_gp)}
    print(json.dumps(out["warm"]), flush=True)

    ang = jnp.asarray(ANG, jnp.float32)
    t_true = jnp.asarray(T_TRUE, jnp.float32)
    R_true = transforms.euler_xyz(ang)
    moved = transforms.apply(pts, R_true, t_true)
    err0 = float(jnp.mean(jnp.linalg.norm(moved - pts, axis=1)))
    for name, m, rcfg, kw in (
            ("rprop", comp_c, RegistrationConfig(max_steps=80,
                                                 step_mode="rprop"),
             dict(depth_kp=kpc, depth_s20=s20c)),
            ("ref_constants", comp, RegistrationConfig(
                max_steps=40, step=0.005, grad_tol_step_ref=0.1), {})):
        st, reg = registration.register(m, moved, cols, valid, cfg, rcfg,
                                        **kw)
        terr, rerr = registration.registration_error(
            st.R_cloud, st.t_cloud, R_true, t_true)
        out[name] = {
            "steps": int(st.step_nbr), "initial_mean_err": err0,
            "final_mean_err": float(jnp.mean(jnp.linalg.norm(reg - pts,
                                                             axis=1))),
            "trans_err": float(terr), "rot_err": float(rerr)}
        print(json.dumps({name: out[name]}), flush=True)
    out["seconds"] = time.time() - t_start
    out["jax"] = jax.__version__
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(set(sys.argv[1:]) or {"headline", "calibrated", "registration",
                               "mapping", "bayes", "nuts_seeds", "ksvd",
                               "icp", "accuracy"})
