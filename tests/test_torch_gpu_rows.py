"""Card-only tests: the port at the JAX package's bench rows (`bench.py`),
held to the JAX package's CPU anchors (float32, jax 0.9.0), each written
here beside the tests that read it and named by the section of
`port_anchors.py` that produced it.

  * the headline round trip on the bench cloud (`headline`);
  * the calibrated round trip, cold and warm (`calibrated`), and its MAP
    ascent's synchronising calls;
  * registration of the moved cloud: rprop on the calibrated map and the
    reference-constants row on the headline map (`registration`);
  * the mapping stream, and the occupancy channel on its map (`mapping`);
    the benchmark cell map.stream's trajectory at the source's motion, held
    to the cell's limits;
  * NUTS with 4 and 16 chains, ADVI, the HMC-calibrated compress and SMC
    pose refinement against the mapping stream's seed map (`bayes`,
    `nuts_seeds`);
  * the K-SVD row and its artifact (`ksvd`), one sweep over 512 patches
    of its raster on the card against the CPU in float64, and every atom
    block of a bench compress against the dense plain version;
  * ICP on the headline map (`icp`), gp-accuracy's 20 pairs on kernel
    maps and on plain-version maps, two in float64 (`accuracy`), the
    kernel at pair 0's 101-slot banks by the float64 referee, and the MAP
    calibration in float32 against float64 over four clouds.

The anchors' inputs are the bench cloud, room_cloud(n=300,000, seed=0),
at bench.py's configuration (`bench_case.bench_config`). Imports no JAX;
on a machine with a CUDA card (~7 min):

    python -m pytest tests/test_torch_gpu_rows.py -m gpu --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from gp_compressor_tpu_torch.testing.bench_case import (BENCH_ANG,
                                                         BENCH_POINTS,
                                                         BENCH_T,
                                                         bench_config)
from torch_gpu_case import (bench, bench_cloud, count, count_syncs, dev,  # noqa: F401
                            hold_by_float64_referee, launches, rank_sum_p,
                            same_block)

pytestmark = pytest.mark.gpu

# port_anchors.py headline: the round trip on the bench cloud
EXPECT_LEAVES = 1675
EXPECT_BANKED = 271_377
RMSE_MAX = 0.025
RMSE_JAX = 0.0208         # in-sample depth RMSE, m


@pytest.fixture(scope="module")
def headline(dev, bench_cloud):
    """One round trip of the bench cloud: (CompressedCloud, decompress
    outputs, the kernel's launches)."""
    from gp_compressor_tpu_torch.workloads import compressor

    n0 = launches()
    comp, out = compressor.compress_decompress(*bench_cloud, bench_config())
    torch.cuda.synchronize()
    return comp, out, launches() - n0


def test_headline_round_trip_matches_jax(headline):
    from gp_compressor_tpu_torch.workloads import compressor

    comp, (world, colors, pvalid, *_), n = headline
    ccfg = bench_config()
    assert n == 2
    assert int(comp.patch.n_leaves) == EXPECT_LEAVES
    banked = int(comp.patch.mask.sum())
    assert abs(banked - EXPECT_BANKED) <= 1e-3 * EXPECT_BANKED, banked
    rmse = float(compressor.reconstruction_rmse(comp, ccfg))
    assert math.isfinite(rmse) and rmse <= RMSE_MAX, rmse
    assert abs(rmse - RMSE_JAX) <= 0.02 * RMSE_JAX, rmse
    G = ccfg.patch.sz ** 2
    assert world.shape == (2048 * G, 3) and colors.shape == (2048 * G, 3)
    assert bool(torch.isfinite(world[pvalid]).all())
    assert bool(torch.isfinite(colors).all())


# port_anchors.py calibrated: (sigma_f^2, l^2, s20, in-sample RMSE m) of
# the cold (150 Adam steps, lr 0.1, 4 starts) and warm (40 steps, lr 0.05,
# 1 start, from the cold theta) runs
CAL_ANCHORS = {
    "cold": (1.0375130223110318e-3, 1.3576451456174254e-3,
             4.3595468741841614e-4, 0.015567295253276825),
    "warm": (1.0670083574950695e-3, 1.4202079037204385e-3,
             4.385730717331171e-4, 0.013576843775808811)}
# The calibrated RMSE guard of both runs: the warm anchor's. Cold and warm
# reach the same mode, and at the calibrated values one patch whose
# float32 training goes astray but stays inside sanitize's bounds moves a
# single run's in-sample RMSE by more than 10%: the port, trained at the
# cold anchor's own hyperparameters, gives ~0.0136 m, not that run's
# 0.0156 m.
CAL_RMSE_JAX = CAL_ANCHORS["warm"][3]
CAL_RUNS = {"cold": dict(calib_steps=150, calib_lr=0.1, calib_starts=4),
            "warm": dict(calib_steps=40, calib_lr=0.05, calib_starts=1)}


@pytest.fixture(scope="module")
def calibrated(dev, bench_cloud):
    """Each of CAL_RUNS twice (the second replays the ascent's graph), the
    warm runs from the cold theta: {run: (CompressedCloud, depth
    RBFParams, s20, decompress outputs of the second call, launches of
    both)}."""
    from gp_compressor_tpu_torch.workloads import compressor

    res, theta = {}, None
    for name, kw in CAL_RUNS.items():
        if name == "warm":
            kw = dict(kw, theta_init=theta)
        n0 = launches()
        for _ in range(2):
            comp, kp, s20, out = compressor.compress_decompress_calibrated(
                *bench_cloud, bench_config(), calib_patches=32,
                calib_points=64, **kw)
        torch.cuda.synchronize()
        res[name] = (comp, kp, s20, out, launches() - n0)
        if name == "cold":
            theta = torch.log(torch.stack([kp.sigmaf_sq, kp.l_sq, s20]))
    return res


@pytest.mark.parametrize("run", list(CAL_RUNS))
def test_calibrated_round_trip_matches_jax(calibrated, run):
    from gp_compressor_tpu_torch.workloads import compressor

    comp, kp, s20, (world, colors, pvalid, *_), n = calibrated[run]
    ccfg = bench_config()
    assert n == 4, "expected 2 launches per round trip"
    G = ccfg.patch.sz ** 2
    assert world.shape == (ccfg.patch.max_patches * G, 3)
    assert bool(torch.isfinite(world[pvalid]).all())
    assert bool(torch.isfinite(colors).all())
    hp = [float(kp.sigmaf_sq), float(kp.l_sq), float(s20)]
    for v, a in zip(hp, CAL_ANCHORS[run]):
        assert math.isfinite(v) and abs(math.log(v / a)) <= 0.1, (hp, a)
    rmse = float(compressor.reconstruction_rmse(comp, ccfg, depth_kp=kp,
                                                depth_s20=s20))
    assert abs(rmse - CAL_RMSE_JAX) <= 0.05 * CAL_RMSE_JAX, rmse


def test_map_ascent_synchronises_only_at_set_up(bench, calibrated):
    """The cold MAP ascent (150 steps, 4 starts, a graph replay after the
    round trips above) makes at most 2 synchronising calls, none per
    step."""
    from gp_compressor_tpu_torch.inference import hmc
    from gp_compressor_tpu_torch.workloads import compressor

    ccfg, batch, _ = bench
    logpost, theta0 = compressor._calib_logpost(batch, ccfg, 32, 64,
                                                torch.float32)
    kw = CAL_RUNS["cold"]
    _, n_sync = count_syncs(lambda: hmc.map_estimate_multi(
        logpost, theta0, steps=kw["calib_steps"], lr=kw["calib_lr"],
        n_starts=kw["calib_starts"]))
    assert n_sync <= 2, n_sync


# port_anchors.py registration: the final mean point error (m) of rprop
# on the calibrated map (48 steps of at most 80) and of the
# reference-constants row on the headline map (40 steps, its max_steps)
REG_RPROP_FINAL_JAX = 1.937328343046829e-4
REG_REF_FINAL_JAX = 0.014729603193700314


def _bench_motion(dev):
    from gp_compressor_tpu_torch.geometry import transforms

    return (transforms.euler_xyz(torch.tensor(BENCH_ANG, device=dev)),
            torch.tensor(BENCH_T, device=dev))


@pytest.mark.parametrize("row", ["rprop", "reference"])
def test_registration_rows_match_jax(dev, bench_cloud, headline, calibrated,
                                     row):
    """The bench cloud moved by bench.py's motion, registered back: rprop
    on the cold calibrated map, and the reference constants (step 0.005,
    grad_tol_step_ref 0.1) on the headline map."""
    from gp_compressor_tpu_torch.config import RegistrationConfig
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.workloads import registration

    pts, cols, valid = bench_cloud
    moved = transforms.apply(pts, *_bench_motion(dev))
    err0 = float(torch.linalg.norm(moved - pts, dim=1).mean())
    if row == "rprop":
        comp, kp, s20 = calibrated["cold"][:3]
        rcfg = RegistrationConfig(max_steps=80, step_mode="rprop")
        st, out = registration.register(comp, moved, cols, valid,
                                        bench_config(), rcfg, depth_kp=kp,
                                        depth_s20=s20)
    else:
        rcfg = RegistrationConfig(max_steps=40, step=0.005,
                                  grad_tol_step_ref=0.1)
        st, out = registration.register(headline[0], moved, cols, valid,
                                        bench_config(), rcfg)
    err1 = float(torch.linalg.norm(out - pts, dim=1).mean())
    if row == "rprop":
        assert int(st.step_nbr) < rcfg.max_steps
        assert err1 <= min(2 * REG_RPROP_FINAL_JAX, 1e-3), err1
        assert 1.0 - err1 / err0 >= 0.95, (err0, err1)
    else:
        assert abs(err1 - REG_REF_FINAL_JAX) <= 0.1 * REG_REF_FINAL_JAX, err1


# port_anchors.py mapping: sigma_f^2, l^2, s20 calibrated on scan 0 of the
# bench cloud's two 150k-point halves, then the stream at those values
# (the seed scan, then one add_clouds of 4 scans alternating scan 1 and
# scan 0): the carve's walk bound, n_patches, the one-sided chamfer RMSE
# (m) from map_cloud to both scans
MAP_CAL_JAX = (3.253220347687602e-4, 5.610331520438194e-2,
               4.368717782199383e-4)
MAP_STEPS_JAX = 32
MAP_PATCHES_JAX = 1681
MAP_RMSE_JAX = 0.02251934293019489
MAP_RMSE_MAX = 0.025
MAP_SCANS, MAP_SCAN_POINTS = 4, 150_000


@pytest.fixture(scope="module")
def stream(dev, bench_cloud):
    """The mapping row of bench.py:575-688 on the card."""
    from scipy.spatial import cKDTree

    from gp_compressor_tpu_torch.config import (MappingConfig,
                                                RegistrationConfig)
    from gp_compressor_tpu_torch.ops.kernels import RBFParams
    from gp_compressor_tpu_torch.workloads import compressor, mapping

    pts, cols, valid = bench_cloud
    ccfg = bench_config()
    res = ccfg.patch.res
    lo = (pts.amin(0) - 0.3).cpu().numpy()
    hi = (pts.amax(0) + 0.3).cpu().numpy()
    p99 = float(np.percentile(np.linalg.norm(pts.cpu().numpy(), axis=1), 99))
    steps = min(mapping.required_ray_steps(lo, hi, res),
                int(1.2 * p99 / res) + 2)
    mcfg = MappingConfig(min_points_new_patch=50, max_ray_steps=steps,
                         carve_stride=8, drop_on_reg_cap=False, reg_stride=4)
    rcfg = RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                              bank_points=64)
    Ns = MAP_SCAN_POINTS
    scans = [(pts[i::2][:Ns], cols[i::2][:Ns], valid[i::2][:Ns])
             for i in (0, 1)]
    _, kpc, s20c, _ = compressor.compress_decompress_calibrated(
        *scans[0], ccfg, calib_patches=32, calib_points=64, calib_steps=150,
        calib_lr=0.1, calib_starts=4)
    cal = [float(kpc.sigmaf_sq), float(kpc.l_sq), float(s20c)]

    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    kp = RBFParams(sigmaf_sq=t(MAP_CAL_JAX[0]), l_sq=t(MAP_CAL_JAX[1]))
    calib = dict(depth_kp=kp, depth_s20=t(MAP_CAL_JAX[2]),
                 depth_eps=ccfg.depth_gp.eps_tol * kp.sigmaf_sq
                 / ccfg.depth_gp.sigmaf_sq)
    state0 = mapping.map_init(ccfg, mcfg, lo, hi, device=dev)
    seed, _, _, info_seed = mapping.add_cloud_fused(
        state0, *scans[0], ccfg, mcfg, rcfg=rcfg, **calib)
    order = [scans[(1 + s) % 2] for s in range(MAP_SCANS)]
    n0 = launches()
    st, dvg, _, info = mapping.add_clouds(
        seed, *([s[j] for s in order] for j in range(3)), ccfg, mcfg,
        rcfg=rcfg, **calib)
    torch.cuda.synchronize()
    n = launches() - n0
    mpts, _, mok = mapping.map_cloud(st, ccfg, depth_kp=kp,
                                     depth_s20=calib["depth_s20"])
    mp = mpts[mok].cpu().numpy()
    finite = np.isfinite(mp).all(axis=1)
    ref = np.concatenate([s[0].cpu().numpy() for s in scans])
    d, _ = cKDTree(ref).query(mp[finite], k=1)
    return {"ray_steps": steps, "cal": cal, "launches": n,
            "n_patches": int(st.n_patches),
            "map_rmse_m": float(np.sqrt(np.mean(d ** 2))),
            "map_points_nonfinite": int((~finite).sum()),
            "drops": {k: int(v.sum()) + int(info_seed[k])
                      for k, v in info.items()},
            "diverged": dvg.tolist(), "state": st, "seed": seed, "kp": kp,
            "s20": calib["depth_s20"], "scans": scans, "rcfg": rcfg}


def test_mapping_stream_matches_jax(stream):
    assert stream["ray_steps"] == MAP_STEPS_JAX
    for v, a in zip(stream["cal"], MAP_CAL_JAX):
        assert math.isfinite(v) and abs(math.log(v / a)) <= 0.1, \
            (stream["cal"], a)
    assert stream["launches"] > 0
    n = stream["n_patches"]
    assert abs(n - MAP_PATCHES_JAX) <= 0.01 * MAP_PATCHES_JAX, n
    rmse = stream["map_rmse_m"]
    assert rmse <= MAP_RMSE_MAX, rmse
    assert abs(rmse - MAP_RMSE_JAX) <= 0.05 * MAP_RMSE_JAX, rmse
    assert stream["map_points_nonfinite"] == 0
    assert all(v == 0 for v in stream["drops"].values()), stream["drops"]
    assert not any(stream["diverged"])


# the benchmark cell map.stream (portbench/configs/gp_mapping.room.json):
# its entry's trajectory, 11 mm and 1.0 deg a frame, at the configuration's
# widths under the source's stop rule, held to the cell's limits
MAP_STREAM_FRAMES = 40


def test_map_stream_holds_the_source_motion(dev):
    """40 frames of the cell through `mapping.add_cloud_fused`: the largest
    pose error, the share of frames dropped and the leaves the map could
    not hold within the cell's limits."""
    from portbench.entries import map_stream
    from portbench.harness import spec

    p = spec.cell(spec.benchmark(), "map.stream")
    e = map_stream.Entry(p["config"], p["traffic"], 2 ** 31 + 11, dev)
    e.setup()
    e.sample = set()                       # the poses only
    for i in range(MAP_STREAM_FRAMES):
        e.request(i)
    nums = e.check()
    assert len(e.dropped) == MAP_STREAM_FRAMES
    for k in ("trans_err_mm", "rot_err_deg", "drop_share", "patch_overflow"):
        assert nums[k] <= p["limits"][k], nums


def test_occupancy_tells_hit_cells_from_carved(dev, stream):
    """The occupancy channel trained on the stream's final map: mean
    P(occupied) on hit cells above that on carved cells by 0.1."""
    from gp_compressor_tpu_torch.geometry import patches
    from gp_compressor_tpu_torch.workloads import mapping

    st, ccfg = stream["state"], bench_config()
    occ = mapping.train_occupancy(st, ccfg)
    B, G = st.W.shape
    grid = patches.prediction_grid(ccfg.patch, torch.float32, dev)
    p = mapping.predict_occupancy(occ, ccfg, grid.expand(B, G, 2))
    created = st.created[:, None]
    hit = st.W & ~st.free & created
    carved = st.free & ~st.W & created
    p_hit, p_carved = float(p[hit].mean()), float(p[carved].mean())
    assert p_hit > p_carved + 0.1, (p_hit, p_carved)


# port_anchors.py bayes: NUTS on the headline banks' 16 x 48 calibration
# subsample, 50 warmup + 100 samples, from the reference constants plus
# 0.2 normals: the posterior mean and standard deviation of theta =
# (ln sigma_f^2, ln l^2, ln s20), its ESS, the mean accept statistic and
# the max split-R-hat
NUTS_JAX = {
    4: dict(mean=(-5.776528425216675, -5.701640204191208, -8.166670837402343),
            std=(0.2618568381169793, 0.18187006193447028,
                 0.0659269047631543),
            ess=(65.4940414428711, 74.58336639404297, 133.3333282470703),
            accept=0.9314074516296387, max_rhat=1.030873417854309),
    16: dict(mean=(-5.806445277035237, -5.69391652263701, -8.162288460731506),
             std=(0.36003117089733283, 0.30222239631387027,
                  0.09760737937190248),
             ess=(164.0274658203125, 216.0821075439453, 250.63792419433594),
             accept=0.9270662665367126, max_rhat=1.072005271911621)}
# port_anchors.py nuts_seeds: the 16-chain row's max split-R-hat at 8 more
# seeds: 50 warmup transitions leave a chain in transit now and then
NUTS16_RHAT_JAX = (1.0285327434539795, 1.0604816675186157, 1.0622564554214478,
                   1.0513066053390503, 1.0400068759918213, 1.231974482536316,
                   1.2655634880065918, 1.035811185836792)
NUTS_WARMUP, NUTS_SAMPLES = 50, 100
NUTS_SEEDS = {4: 7, 16: 8}
# port_anchors.py bayes: ADVI's plateau and mean from the multi-start MAP
# mode
ADVI_JAX = dict(plateaued=True, mean=(-5.804538726806641, -5.698229789733887,
                                      -8.183993339538574))
ADVI_STEPS = 300
# port_anchors.py bayes: compress_calibrated(method="hmc") at 400 steps:
# sigma_f^2, l^2, s20, in-sample RMSE (m)
HMC_CAL_STEPS = 400
HMC_CAL_JAX = (1.082348171621561e-3, 1.4159923885017633e-3,
               4.3668327271007e-4, 0.013525919988751411)
# port_anchors.py bayes: the SMC row (bench.py:691-777): mean point error
# (m) injected into scan 1, after an 8-step registration budget on the
# mapping stream's seed map, and after smc_refine_pose (256 particles, 16
# steps) at 3 keys
SMC_ANG = (0.012, -0.008, 0.010)
SMC_T = (0.05, -0.04, 0.03)
SMC_JAX = dict(injected=0.07539442926645279, after_reg=0.022825060412287712,
               after_smc=(0.01023662555962801, 0.009596461430191994,
                          0.005447890609502792))
SMC_PARTICLES, SMC_ITERS, SMC_RUNS = 256, 16, 3


@pytest.fixture(scope="module")
def headline_logpost(headline):
    """The exact-GP log posterior of the headline banks' 16 x 48
    calibration subsample."""
    from gp_compressor_tpu_torch.inference import hmc
    from gp_compressor_tpu_torch.workloads import compressor

    Xc, yc, mc = compressor.calib_subsample(headline[0].patch, 16, 48)
    return hmc.make_patch_logpost(Xc, yc, mc.to(Xc.dtype))


def _theta_ref(dev):
    return torch.tensor([math.log(100.0), 0.0, math.log(0.1)], device=dev)


def _nuts_counts():
    return {k: count("nuts." + k) for k in ("iterations", "reads")}


@pytest.fixture(scope="module")
def nuts_runs(dev, headline_logpost):
    """The 4- and 16-chain NUTS rows (bench.py:373-433): {chains:
    (samples [C, 100, 3], accept, step sizes, reads, lockstep
    iterations)}."""
    from gp_compressor_tpu_torch.config import HMCConfig
    from gp_compressor_tpu_torch.inference import nuts

    out = {}
    for C, seed in NUTS_SEEDS.items():
        cfg = HMCConfig(num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES,
                        num_chains=C)
        g = torch.Generator(device=dev).manual_seed(seed)
        th0 = _theta_ref(dev) + 0.2 * torch.randn((C, 3), generator=g,
                                                  device=dev)
        c0 = _nuts_counts()
        samples, acc, eps = nuts.nuts_sample_chains(headline_logpost, th0,
                                                    cfg, generator=g)
        c1 = _nuts_counts()
        out[C] = (samples, acc, eps, c1["reads"] - c0["reads"],
                  c1["iterations"] - c0["iterations"])
    return out


@pytest.mark.parametrize("chains", list(NUTS_SEEDS))
def test_nuts_rows_match_jax(nuts_runs, chains):
    from gp_compressor_tpu_torch.inference import hmc, nuts

    samples, acc, _, reads, iters = nuts_runs[chains]
    assert reads <= math.ceil(iters / nuts.BLOCK), (reads, iters)
    a = NUTS_JAX[chains]
    s = samples.double().reshape(-1, 3)
    mean, std = s.mean(0).tolist(), s.std(0).tolist()
    ess = hmc.effective_sample_size(samples).tolist()
    # the posterior means agree within 5 combined Monte Carlo standard
    # errors (std / sqrt(ESS) of each run): a chance failure is < 1e-6
    # per dimension
    for d in range(3):
        tol = 5.0 * math.sqrt(a["std"][d] ** 2 / a["ess"][d]
                              + std[d] ** 2 / ess[d])
        assert abs(mean[d] - a["mean"][d]) <= tol, (d, mean, tol)
    # dual averaging aims at 0.8; 50 warmup steps leave it above (the
    # anchor: 0.93)
    assert 0.6 <= float(acc.mean()) <= 0.99, float(acc.mean())
    # 50 warmup transitions from the reference constants leave a chain in
    # transit now and then (the JAX package's 16-chain runs: two of nine
    # above 1.1, at 1.23 and 1.27): the R-hat against 1.1 or the worst of
    # the JAX package's runs
    worst = max((a["max_rhat"],) + (NUTS16_RHAT_JAX if chains == 16 else ()))
    rhat = float(hmc.split_rhat(samples).max())
    assert rhat <= max(1.1, worst), rhat


def test_nuts_transition_reads_are_its_only_syncs(dev, headline_logpost,
                                                  nuts_runs):
    """One NUTS transition of the 4 chains from their last draws: its
    synchronising calls are its stop-flag reads."""
    from gp_compressor_tpu_torch.inference import nuts

    samples, _, eps, _, _ = nuts_runs[4]
    theta = samples[:, -1]
    g = torch.Generator(device=dev).manual_seed(NUTS_SEEDS[16])
    r0 = count("nuts.reads")
    _, n_sync = count_syncs(lambda: nuts.nuts_step(
        headline_logpost, theta, eps, torch.ones_like(theta), generator=g))
    assert n_sync == count("nuts.reads") - r0, n_sync


def test_advi_matches_jax(dev, headline_logpost):
    from gp_compressor_tpu_torch.inference import hmc, vi

    theta_map, _ = hmc.map_estimate_multi(headline_logpost, _theta_ref(dev),
                                          steps=150, lr=0.1, n_starts=4)
    res = vi.fit_advi(headline_logpost, theta_map, steps=ADVI_STEPS,
                      generator=torch.Generator(device=dev).manual_seed(3))
    assert bool(vi.elbo_plateaued(res.elbo_trace)) == ADVI_JAX["plateaued"]
    # Adam at lr 0.05 on an 8-sample ELBO gradient jitters the mean by a
    # few hundredths; 0.15 is ~2 posterior std on the tightest axis
    mean = res.mean.tolist()
    assert all(abs(m - a) <= 0.15 for m, a in zip(mean, ADVI_JAX["mean"])), \
        mean


def test_hmc_calibrated_compress_matches_jax(bench_cloud):
    """compress_calibrated(method="hmc") at 400 steps in float64 (its
    default) on the bench cloud."""
    from gp_compressor_tpu_torch.workloads import compressor

    n0 = launches()
    comp, kp, s20, cal = compressor.compress_calibrated(
        *bench_cloud, bench_config(), method="hmc",
        calib_steps=HMC_CAL_STEPS)
    assert launches() - n0 == 2
    hp = [float(kp.sigmaf_sq), float(kp.l_sq), s20]
    assert hp[0] < 10.0 and hp[2] < 0.1, hp
    # the port calibrates in float64, the anchor is JAX's float32 run: both
    # at the cm-scale mode, where the posterior mean of 2 chains x 400
    # draws has a Monte Carlo error of a few hundredths in log space; 0.3
    # leaves room for a slow chain
    for v, a in zip(hp, HMC_CAL_JAX):
        assert math.isfinite(v) and abs(math.log(v / a)) <= 0.3, (hp, a)
    rmse = float(compressor.reconstruction_rmse(comp, cal, depth_kp=kp,
                                                depth_s20=s20))
    assert rmse <= RMSE_MAX, rmse


def test_smc_refines_the_registration_budget(dev, stream):
    """Scan 1 moved by bench.py's SMC motion, registered with the stream's
    8-step budget against its seed map, then refined by smc_refine_pose
    at 3 keys without a host read."""
    from gp_compressor_tpu_torch.config import SMCConfig
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.workloads import mapping, registration

    ccfg = bench_config()
    seed, kp, s20, rcfg = (stream[k] for k in ("seed", "kp", "s20", "rcfg"))
    scan = stream["scans"][1]
    R_true = transforms.euler_xyz(torch.tensor(SMC_ANG, device=dev))
    moved = transforms.apply(scan[0], R_true, torch.tensor(SMC_T, device=dev))
    err = lambda p: float(torch.linalg.norm(p - scan[0], dim=1).mean())
    _, out_reg = registration.register(
        mapping._map_as_compressed(seed, ccfg), moved, scan[1], scan[2], ccfg,
        rcfg, depth_kp=kp, depth_s20=s20)
    scfg = SMCConfig(num_particles=SMC_PARTICLES, pose_proposal_std_t=0.012,
                     pose_proposal_std_r=0.004)

    def refine(k):
        return mapping.smc_refine_pose(
            seed, out_reg, scan[1], scan[2], ccfg, scfg, n_iters=SMC_ITERS,
            depth_kp=kp, depth_s20=s20,
            generator=torch.Generator(device=dev).manual_seed(k))

    errs = []
    for k in range(SMC_RUNS):
        (R2, t2), _, _ = refine(4 + k)
        errs.append(err(transforms.apply(out_reg, R2, t2)))
    _, n_sync = count_syncs(lambda: refine(7))
    assert n_sync == 0, n_sync
    injected, after_reg = err(moved), err(out_reg)
    assert abs(injected - SMC_JAX["injected"]) <= 1e-3 * SMC_JAX["injected"]
    assert abs(after_reg - SMC_JAX["after_reg"]) \
        <= 0.1 * SMC_JAX["after_reg"], after_reg
    assert max(errs) < after_reg, (errs, after_reg)
    # the runs' means agree within 4 standard errors of the difference of
    # two 3-run means (each run's spread from its own sample), at least 2 mm
    sa = float(torch.tensor(SMC_JAX["after_smc"]).double().std())
    sp = float(torch.tensor(errs).double().std())
    tol = max(4.0 * math.sqrt((sa ** 2 + sp ** 2) / SMC_RUNS), 2e-3)
    ma = sum(SMC_JAX["after_smc"]) / SMC_RUNS
    assert abs(sum(errs) / SMC_RUNS - ma) <= tol, (errs, ma, tol)


# port_anchors.py ksvd: the K-SVD row (bench.py:779-822, atom_block 16) at
# keys 1-4: the range of each value over the keys
KSVD_JAX = {"rms": (0.013902850449085236, 0.013951080851256847),
            "depth_mse": (0.008564305491745472, 0.008667842485010624),
            "depth_iters": (16, 22), "rgb_iters": (2, 2)}
KSVD_SEEDS = (1, 2)


@pytest.fixture(scope="module")
def ksvd_rows(dev, bench_cloud):
    """ksvd_compressor.compress of the bench cloud at KSVD_SEEDS: {seed:
    (compressed, stop reads, block kernel launches, atom blocks, training
    kernel launches)}."""
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    out = {}
    for seed in KSVD_SEEDS:
        c0 = [count(k) for k in ("ksvd.reads", "ksvd.block_kernels",
                                 "ksvd.atom_blocks", "sogp_train.launches")]
        comp = kc.compress(*bench_cloud, bench_config(),
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))
        torch.cuda.synchronize()
        out[seed] = (comp, *[count(k) - c for k, c in zip(
            ("ksvd.reads", "ksvd.block_kernels", "ksvd.atom_blocks",
             "sogp_train.launches"), c0)])
    return out


@pytest.mark.parametrize("seed", KSVD_SEEDS)
def test_ksvd_row_matches_jax(ksvd_rows, seed):
    """Within 5% of the JAX keys' range in RMS and depth MSE, within 2
    sweeps of it; one stop read a sweep, one block kernel launch an atom
    block, no training kernel launch."""
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    comp, reads, blocks, atom_blocks, trains = ksvd_rows[seed]
    assert blocks == atom_blocks > 0, (blocks, atom_blocks)
    assert trains == 0
    assert reads == comp.depth.iters + comp.rgb.iters, reads
    got = {"rms": kc.rms_error(comp), "depth_mse": float(comp.depth.error),
           "depth_iters": comp.depth.iters, "rgb_iters": comp.rgb.iters}
    for f in ("rms", "depth_mse"):
        lo, hi = KSVD_JAX[f]
        assert 0.95 * lo <= got[f] <= 1.05 * hi, (f, got[f])
    for f in ("depth_iters", "rgb_iters"):
        lo, hi = KSVD_JAX[f]
        assert lo - 2 <= got[f] <= hi + 2, (f, got[f])


@pytest.mark.parametrize("problem", ["depth", "rgb"])
def test_ksvd_draws_reproduce_the_compress(dev, ksvd_rows, problem):
    """dictionary.ksvd on seed 1's raster with draw_ksvd's draws from the
    same generator, depth then RGB, gives the compress's sweeps and
    masked MSE (the raster's sums are atomic: the compress's own raster)."""
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    ccfg = bench_config()
    comp = ksvd_rows[1][0]
    raster = comp.raster
    pvalid = torch.arange(raster.S.shape[0], device=dev) < raster.n_leaves
    problems = {"depth": (raster.S, raster.W.to(raster.S.dtype), pvalid,
                          ccfg.ksvd),
                "rgb": kc.rgb_problem(raster, pvalid) + (ccfg.rgb_ksvd,)}
    g = torch.Generator(device=dev).manual_seed(1)
    for name, (S, W, v, cfg) in problems.items():
        draws = dictionary.draw_ksvd(v, cfg, g)
        if name == problem:
            res = dictionary.ksvd(S, W, v, cfg, draws=draws)
            break
    ref = getattr(comp, problem)
    assert res.iters == ref.iters
    assert abs(float(res.error) - float(ref.error)) \
        <= 1e-4 * abs(float(ref.error)), (float(res.error), float(ref.error))


def test_ksvd_artifact_round_trip(ksvd_rows, tmp_path):
    """Seed 1's compress written as the artifact files, read back and
    decompressed on the host: the in-memory decompress's points to 0.1 mm
    (both emit the occupied cells patch by patch, in cell order)."""
    from gp_compressor_tpu_torch.io import artifact
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    comp = ksvd_rows[1][0]
    base = str(tmp_path / "ksvd")
    artifact.write(base, kc.to_artifact(comp))
    pts, _ = kc.decompress_artifact(artifact.read(base))
    w, _, ok = kc.decompress(comp)
    w = w[ok].cpu().numpy()
    assert pts.shape == w.shape
    assert float(np.abs(pts - w).max()) <= 1e-4



def test_ksvd_sweep_at_the_bench_raster_on_card_matches_cpu(dev, ksvd_rows):
    """omp_encode and one outer depth sweep over the first 512 patches of
    seed 1's raster at the bench K-SVD configuration, card against CPU in
    float64 with the same draws."""
    from gp_compressor_tpu_torch.testing import ksvd_case

    raster = ksvd_rows[1][0].raster
    pvalid = torch.arange(raster.S.shape[0], device=dev) < raster.n_leaves
    res = ksvd_case.sweep_parity(raster.S[:512], raster.W[:512],
                                 pvalid[:512], bench_config().ksvd, dev)
    assert res["indices_equal"], res
    for k in ("omp_X", "sweep_D", "sweep_X", "sweep_err"):
        assert res[k] <= 1e-9, res


def test_block_kernel_matches_dense_in_a_bench_compress(dev, bench_cloud,
                                                        monkeypatch):
    """Every atom block of one bench compress (seed 3, float32; depth
    n 2,048 and colour n 6,144 at the users of real sweeps) held to the
    dense plain version on the same inputs by `same_block`'s rule; one
    block kernel launch an atom block, depth and colour blocks both run."""
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    ccfg = bench_config()
    real = dictionary._block_update
    blocks = {"depth": 0, "rgb": 0}

    def both(*a):
        got = real(*a)
        same_block(got, dictionary._block_update_plain(*a), torch.float32)
        blocks["depth" if a[0].shape[0] == ccfg.patch.max_patches
               else "rgb"] += 1
        return got

    monkeypatch.setattr(dictionary, "_block_update", both)
    k0, b0 = count("ksvd.block_kernels"), count("ksvd.atom_blocks")
    kc.compress(*bench_cloud, ccfg,
                generator=torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    assert count("ksvd.block_kernels") - k0 == count("ksvd.atom_blocks") \
        - b0 == sum(blocks.values()) > 0
    assert blocks["depth"] > 0 and blocks["rgb"] > 0, blocks

# port_anchors.py icp: icp_register on the headline map, the bench cloud
# moved by bench.py's motion: iterations and final mean point error (m)
ICP_JAX = {"iters": 7, "final_mean_err": 3.1501669582212344e-05}


def test_icp_on_the_headline_map_matches_jax(dev, bench_cloud, headline):
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.workloads import icp

    pts, _, valid = bench_cloud
    moved = transforms.apply(pts, *_bench_motion(dev))
    r0 = count("icp.reads")
    res = icp.icp_register(headline[0], moved, valid, bench_config())
    assert count("icp.reads") - r0 == res.iters
    assert abs(res.iters - ICP_JAX["iters"]) <= 2, res.iters
    final = float(torch.linalg.norm(transforms.apply(moved, res.R, res.t)
                                    - pts, dim=1).mean())
    assert final <= max(2 * ICP_JAX["final_mean_err"], 1e-4), final


# port_anchors.py accuracy: the final mean point error (m) of GP register
# and of ICP at gp-accuracy's pairs of seeds 0-19 (cli.py cmd_gp_accuracy
# at its defaults)
ACC_JAX = {
    "gp": (0.8045054078102112, 0.6334191560745239, 1.1390420198440552,
           1.8362358808517456, 0.8329454660415649, 0.9177649021148682,
           0.050605591386556625, 0.08373649418354034, 1.798810601234436,
           0.01587745174765587, 0.48897606134414673, 0.8824785351753235,
           0.8276397585868835, 0.46685925126075745, 0.09986316412687302,
           0.4695148468017578, 1.8128358125686646, 0.5105294585227966,
           0.40021514892578125, 1.2248785495758057),
    "icp": (0.05605810880661011, 0.04359973594546318, 0.041498150676488876,
            0.05086246505379677, 0.054495565593242645, 3.491596221923828,
            0.021410172805190086, 0.02004675753414631, 0.0391077995300293,
            0.03792557492852211, 0.033929381519556046, 0.05827831104397774,
            0.2735496163368225, 0.024318186566233635, 0.09023834764957428,
            0.04484973102807999, 0.27870017290115356, 0.02899034693837166,
            0.04768932983279228, 0.08713871240615845)}
ACC_PAIRS, ACC_POINTS = 20, 100_000
ACC_F64_PAIRS = 2
ROUTES = ("kernel", "plain")


def accuracy_config(dtype=torch.float32):
    """gp-accuracy's configuration at its defaults (cli.py:380-416,
    _gp_config): res 0.3, sz 10, 4096 patches of 256 points, the reference
    GP constants at capacity 100 (101 slots), eps_tol 1e-6; the GPs'
    states in dtype."""
    from gp_compressor_tpu_torch import config as c

    return c.CompressorConfig(
        patch=c.PatchConfig(res=0.3, sz=10, max_patches=4096,
                            max_points_per_patch=256),
        depth_gp=c.GPConfig(capacity=100, slots=101, eps_tol=1e-6,
                            dtype=dtype),
        rgb_gp=c.rgb_gp_config(slots=101, capacity=100, dtype=dtype))


def _accuracy_pair(seed, dt, dev):
    """gp-accuracy's pair `seed` on the card in dt: (map points, map
    colours, the scan's true points, the moved scan, its colours, the true
    R, the true t)."""
    from gp_compressor_tpu_torch.utils import synthetic

    half = ACC_POINTS // 2
    p_np, c_np = synthetic.room_cloud(n=ACC_POINTS, seed=seed)
    rng = np.random.default_rng(seed)
    rotvec = 0.005 * rng.standard_normal(3)
    t_np = 0.02 * rng.standard_normal(3)
    scan_np, R_np = synthetic.rigid_transform(p_np[half:], rotvec, t_np)
    arrays = (p_np[:half], c_np[:half], p_np[half:], scan_np, c_np[half:],
              R_np, t_np)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dt)
            for a in arrays]


def _mean_err(p, q) -> float:
    return float(torch.linalg.norm(p.double() - q.double(), dim=1).mean())


def _align(comp, cfg, scan, scols, truth) -> dict:
    """The final mean point error of GP register and of ICP of one pair's
    scan against its map."""
    from gp_compressor_tpu_torch.config import RegistrationConfig
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.workloads import icp, registration

    ones = torch.ones(scan.shape[0], dtype=torch.bool, device=scan.device)
    _, aligned = registration.register(
        comp, scan, scols, ones, cfg,
        RegistrationConfig(step=0.005, max_steps=150))
    ires = icp.icp_register(comp, scan, ones, cfg)
    return {"gp": _mean_err(aligned, truth),
            "icp": _mean_err(transforms.apply(scan, ires.R, ires.t), truth)}


@pytest.fixture(scope="module")
def accuracy(dev):
    """The gp-accuracy protocol (cli.py cmd_gp_accuracy) over ACC_PAIRS
    pairs: each pair's map trained by the kernel, as the command line
    does, and by its plain version as a witness, both aligned by GP
    register and ICP; then ACC_F64_PAIRS pairs with map (the plain
    version) and registration in float64. Returns the final errors per
    route and method, the kernel's launches, pair 0's banks, and the
    float64 pairs' initial and final errors."""
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.workloads import compressor

    ones = torch.ones(ACC_POINTS // 2, dtype=torch.bool, device=dev)
    errs = {r: {"gp": [], "icp": []} for r in ROUTES}
    n = 0
    f64 = []
    for seed in range(ACC_PAIRS + ACC_F64_PAIRS):
        dt = torch.float32 if seed < ACC_PAIRS else torch.float64
        k = seed if seed < ACC_PAIRS else seed - ACC_PAIRS
        cfg = accuracy_config(dt)
        mp, mc, truth, scan, scols, *_ = _accuracy_pair(k, dt, dev)
        # compress = project + train: both routes train the same banks
        batch = compressor.project(
            mp, mc, ones, cfg,
            generator=torch.Generator(device=dev).manual_seed(k))
        if seed == 0:
            batch0 = batch
        for route in ROUTES if dt == torch.float32 else ("plain",):
            with pytest.MonkeyPatch.context() as mpatch:
                if route == "plain":
                    mpatch.setattr(sogp_train, "add_points_batch_cuda",
                                   sogp_train.add_points_batch_plain)
                n0 = launches()
                comp = compressor.train(batch, cfg)
                n += launches() - n0
            got = _align(comp, cfg, scan, scols, truth)
            if dt == torch.float32:
                for m in ("gp", "icp"):
                    errs[route][m].append(got[m])
            else:
                f64.append((k, _mean_err(scan, truth), got))
    return {"errs": errs, "launches": n, "batch0": batch0, "f64": f64}


def test_accuracy_pairs_launch_the_kernel_twice_each(accuracy):
    assert accuracy["launches"] == 2 * ACC_PAIRS


@pytest.mark.parametrize("method", ["gp", "icp"])
def test_accuracy_kernel_maps_match_plain_maps(accuracy, method):
    """The witness: the plain version's maps, aligned by the same code, are
    not told apart from the kernel's as a sample of final errors."""
    e = accuracy["errs"]
    p_val = rank_sum_p(e["kernel"][method], e["plain"][method])
    assert p_val >= 0.01, p_val


@pytest.mark.parametrize("method", ["gp", "icp"])
@pytest.mark.parametrize("route", ROUTES)
def test_accuracy_pairs_match_jax(accuracy, route, method):
    """In float32 at the reference GP constants most depth patches end
    non-finite or far off and sanitize empties them, in both trainers and
    in JAX (port_anchors.py accuracy_resets): the GP ascent then walks
    away and ICP keeps few planes, so a pair's path is rounding and not
    reproducible across packages or routes. Each route's 20 final errors
    are held to JAX's as a sample: a method passes when its median is
    within 10% or 0.5 mm of JAX's, or a rank-sum test does not tell the
    two samples apart at the 1% level."""
    mine = accuracy["errs"][route][method]
    med, ref = float(np.median(mine)), float(np.median(ACC_JAX[method]))
    p_val = rank_sum_p(mine, ACC_JAX[method])
    assert abs(med - ref) <= max(0.1 * ref, 5e-4) or p_val >= 0.01, \
        (med, ref, p_val)


def test_accuracy_float64_pairs_register(accuracy):
    """In float64 the map keeps its patches: neither method walks away
    from the injected error (or 2 cm)."""
    for k, initial, got in accuracy["f64"]:
        for m in ("gp", "icp"):
            assert got[m] <= max(initial, 0.02), (k, m, got[m], initial)


@pytest.mark.parametrize("dout", [1, 3])
def test_kernel_at_accuracy_banks_by_float64_referee(dev, accuracy, dout):
    """The kernel at pair 0's banks (B 4,096, P 256, 101 slots, the
    reference constants) against its plain version, the plain version in
    float64 as referee."""
    from gp_compressor_tpu_torch.workloads import compressor

    cfg, b = accuracy_config(), accuracy["batch0"]
    dkp, ckp = compressor.default_params(cfg, dev)
    gcfg, kp, Y = ((cfg.depth_gp, dkp, b.y) if dout == 1
                   else (cfg.rgb_gp, ckp, b.rgb))
    hold_by_float64_referee(kp, gcfg, b.X, Y, b.mask)


def _patch_sq_err(comp, kp, s20) -> torch.Tensor:
    """[B] float64: each patch's summed squared in-sample depth error (the
    terms of compressor.reconstruction_rmse)."""
    from gp_compressor_tpu_torch.models import sparse_gp

    b = comp.patch
    mean, _ = sparse_gp.predict_batch(kp, s20, comp.depth_gp, b.X)
    return torch.where(b.mask, (mean[..., 0] - b.y[..., 0]).double() ** 2,
                       0.0).sum(1)


@pytest.mark.parametrize("seed", range(4))
def test_map_calibration_float32_matches_float64(dev, seed):
    """The calibrated round trip of room_cloud(seed) with its MAP ascent
    in float32 and in float64: the same mode (each value within 0.1 in
    log space); in-sample RMSEs within 1% once the three patches whose
    squared error differs most are left out; and the float32 run's depth
    bank trained by the kernel held to its plain version by the float64
    referee (`arbitrated`)."""
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    ccfg = bench_config()
    p, c = (torch.from_numpy(a).to(dev)
            for a in synthetic.room_cloud(n=BENCH_POINTS, seed=seed))
    v = torch.ones(BENCH_POINTS, dtype=torch.bool, device=dev)
    runs = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        comp, kp, s20, _ = compressor.compress_decompress_calibrated(
            p, c, v, ccfg, calib_patches=32, calib_points=64,
            calib_steps=150, calib_lr=0.1, calib_starts=4, calib_dtype=dt)
        runs[name] = (comp, kp, s20, _patch_sq_err(comp, kp, s20))
    hp = {k: [float(r[1].sigmaf_sq), float(r[1].l_sq), float(r[2])]
          for k, r in runs.items()}
    assert all(abs(math.log(a / b)) <= 0.1
               for a, b in zip(hp["f32"], hp["f64"])), hp
    # the bench bank order draws nothing: both runs hold the same banks
    batch = runs["f32"][0].patch
    n = batch.mask.sum(1)
    e32, e64 = runs["f32"][3], runs["f64"][3]
    keep = torch.ones_like(n, dtype=torch.bool)
    keep[torch.topk((e32 - e64).abs(), 3).indices] = False
    a, b = (math.sqrt(float(e[keep].sum() / n[keep].sum()))
            for e in (e32, e64))
    assert abs(a - b) <= 0.01 * b, (a, b)

    # the whole depth bank at the float32 run's values, before sanitize
    _, kp, s20, _ = runs["f32"]
    g = ccfg.depth_gp
    hold_by_float64_referee(kp, g, batch.X, batch.y, batch.mask, s20=s20,
                            eps_tol=g.eps_tol * kp.sigmaf_sq / g.sigmaf_sq)
