"""On-card smoke run of the PyTorch/CUDA port (`gp_compressor_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  0. device  — the card's name and power limit;
  1. build   — the fused SOGP training kernel from csrc/sogp_train.cu,
               with ptxas's registers and spills per instantiation (the
               32-slot ones must not spill);
  2. check   — the kernel against its plain PyTorch version on the card:
               its inline division against IEEE division, the four
               training regimes, the strict ones at 8 to 128 slots, the realistic one at 32 slots, a state with a NaN,
               the override row, and the bench banks the port's own front
               end makes (depth D=1 and RGB D=3); every launch must leave
               its input state unchanged;
  3. main    — compress_decompress at the bench configuration on a
               300k-point room cloud: 1 warm-up and 3 timed round trips,
               checked against the JAX package's CPU anchors, then a
               per-stage split;
  4. timing  — at the bench shapes, the kernel launch alone (state,
               outputs and hyperparameter row made beforehand) against
               the plain version (CUDA events, plain / kernel / kernel /
               plain), beside its bound; then train_gp with its set-up;
  5. profile — host wall of the front end's steps, then one round trip
               under torch.profiler (device busy time, idle share, kernel
               launches, host-side CUDA calls);
  6. calibrated — compress_decompress_calibrated at the bench
               configuration, cold (150 Adam steps, 4 starts) and warm
               (40 steps from the cold theta, 1 start): walls, the
               calibrated hyperparameters and RMSE against the JAX
               package's CPU anchors, the stage split, the synchronising
               CUDA calls of the MAP ascent; then the kernel against its
               plain version at the calibrated bench banks (D=1 and D=3,
               the calibrated row, the `calibrated` rule), its launch time,
               mean active slots and deletions per patch;
  7. registration — the full scan under a known small motion: rprop on
               the calibrated map (median of 3 walls, steps/s, errors held
               to the JAX anchors), the reference-constants row on the
               headline map, and the split of one step;
  8. mapping — the mapping stream at the JAX package's bench row
               (bench.py:575-688): calibration on scan 0 held to the JAX
               anchor, then the seed scan and 1 warm-up + 3 timed
               add_clouds of 4 scans at the anchor's hyperparameters
               (scans/s, map chamfer RMSE, patch count, drops, held to the
               JAX anchors), the kernel against its plain version on the
               first stream insert's main banks (non-empty input states,
               the `calibrated` rule), the stage split of one insert, the
               synchronising calls and kernel launches per scan, and the
               occupancy channel on the final map;
  9. bayes   — the Bayesian layer at the JAX package's bench rows: NUTS
               with 4 and 16 chains on phase 3's banks (bench.py:373-433:
               samples/s, accept, split-R-hat, ESS/s, leapfrogs and host
               reads per transition), ADVI from the multi-start MAP mode
               (bench.py:436-456), compress_calibrated(method="hmc") on
               the cloud (calibrated values, RMSE, kernel launches, the
               HMC's share), SMC pose refinement of a moved scan against
               phase 8's seed map after an 8-step registration budget
               (bench.py:691-777); each held to the JAX package's CPU
               anchors; then a NUTS transition, HMC and ADVI steps and an
               SMC step on the card against the CPU in float64 with the
               same draws;
 10. ksvd    — the K-SVD codec at the JAX package's bench row
               (bench.py:779-822, atom_block 16): 1 warm-up and 2 timed
               compress calls (points/s, sweeps, masked MSE, in-sample
               RMS, mean words, one stop read per sweep, no training
               kernel launch) held to the JAX anchors' range over four
               keys, the stage split of one ksvd call (its stage
               functions timed), one depth sweep under torch.profiler, the artifact
               written, read back and decompressed on the host, one
               sweep on the card against the CPU in float64 with the same
               draws, and one compress with every atom block's kernel
               launch (csrc/ksvd_power.cu, depth and colour blocks) held
               to the dense plain version in float32 (1e-5 of each
               output's largest value), timed against it per launch;
 11. icp     — point-to-plane ICP on phase 3's map under phase 7's
               perturbation (held to the JAX anchor), the gp-accuracy
               protocol of cli.py (cmd_gp_accuracy at its defaults) over
               20 pairs with GP registration and ICP on kernel maps (2
               launches per pair) and on plain-version maps, held to the
               JAX anchors' pairs and to each other, two pairs in float64,
               the kernel at 101 slots (strict up to 90 BVs, deletions at
               100) and at pair 0's banks against its plain version with
               a float64 referee, timed; and the MAP calibration in
               float32 and float64 over four clouds (same mode, the
               patches behind any RMSE gap, each bank by the float64
               referee).
 12. cli     — the command line (`python -m gp_compressor_tpu_torch.cli`,
               driven through `cli.main`) on the card: gp-compress at its
               defaults on the 300k-point cloud written as a binary PCD
               (the native and NumPy readers agree; --out and --checkpoint
               written, the checkpoint loads strictly and decompresses to
               the --out bytes; two kernel launches; the kernel at these
               4096 x 256 banks with 101 slots against its plain version
               by the `arbitrated` rule, timed), compress -> decompress,
               gp-accuracy's synthetic pair with ICP and a TUM-format
               fixture, calibrate --map and calibrate (HMC), gp-mapping
               over 5 synthetic scans and over the fixture; each held to
               the JAX command line's numbers (port_anchors.py cli), each
               subcommand's wall printed.
 13. sharded — the multi-device layer (`parallel/`): two ranks of a gloo
               group share cuda:0 (NCCL refuses two ranks on one card;
               `--sharded-rank` starts each), each with its block of the
               cloud's points (150,000): compress_decompress on a (2, 1)
               mesh at the bench configuration (the point-sharded front
               end, 1024 patches per rank, 2 kernel launches per rank per
               round trip), the gathered claims equal to phase 3's (0
               differ), 0 patch rows whose banks differ, both GP states
               bit-equal to phase 3's, RMSE within 1e-6 relative, every rank's grid equal by checksum, each rank's
               walls by stage; the front end of room_cloud seeds 0-3
               against the single process's (claims and bank rows that
               differ, printed, beside one process against itself); the
               kernel timed on each rank's shard with both ranks
               launching (a shared card: not a scaling number); the
               calibrated round trip (MAP in float64) on (2, 1) and
               (1, 2) meshes with the calibrated values bit-equal to the
               single run's, the float64 MAP bit-equal on (2, 1) and
               within 1e-10 relative on (1, 2), where the starts split;
               register under phase 7's motion (equal steps, pose within
               2e-6); shard_report's point rows, layout (every leaf cut)
               and peak memory by stage; with a card per rank (as
               shard_probe.py runs them), each rank's front end under
               torch.profiler (spans per step and collective, each host
               sync by the port's function and op); then one rank under NCCL (its block
               the whole cloud), its RMSE, claims, banks and states
               bit-equal to phase 3's.

The last three lines of standard output are the kernels' JSON object
(sogp_train and ksvd_power), the card's `nvidia-smi` name and power
limit, and the result object.

`shard_probe.py` runs phase 13's ranks one per card under NCCL on a
machine with two or more cards.

    python3 chip_smoke.py --probe [f64_pairs] [arbitrate] [ksvd_block]

runs, instead of the phases, the card-side probes that phase 11 runs only
in part (both when none is named; JSON lines with the card's name and
power limit; ~8 minutes), or the K-SVD atom block kernel's:

  * f64_pairs — the 20 gp-accuracy pairs, each aligned by GP register and
    ICP on a map the kernel trains in float32, as phase 11 does, and on a
    map the plain version trains in float64 with the registration in
    float64: final errors, steps, the depth patches sanitize left empty;
    medians and rank-sum tests against each other and against ACC_JAX;
  * arbitrate — the kernel and the plain version in float32 held to the
    plain version in float64 (sogp_regimes.arbitrate) at the accuracy
    banks of pairs 0-2 (depth and RGB) and at the calibrated depth banks
    of room_cloud seeds 0-3 at the float32 and float64 MAP's values;
  * ksvd_block — the atom block kernel (cuda_kernels/ksvd_power.py) at
    the benchmark's shapes: build, ptxas, clusters at once, phase 10's
    float32 check over one compress (users per atom, gaps, card ms per
    launch, bytes bound), and per block of its first depth and colour
    sweep the float64 gap and the kernel timed against the same kernel
    with no row staged in shared memory; ~1 minute.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import warnings

import torch

N_POINTS = 300_000
# anchors from the JAX package's XLA path on this exact input and config
EXPECT_LEAVES = 1675
EXPECT_BANKED = 271_377
RMSE_MAX = 0.025
RMSE_JAX = 0.0208         # the JAX package's in-sample depth RMSE
TIMED_RUNS = 3
KERNEL_REPS = 20          # kernel launches per timed window
# anchors of phases 6 and 7: the JAX package on the CPU in float32 on this
# exact input and config (port_anchors.py, jax 0.9.0)
CAL_ANCHORS = {           # (sigma_f^2, l^2, s20, in-sample RMSE m)
    "cold": (1.0375130223110318e-3, 1.3576451456174254e-3,
             4.3595468741841614e-4, 0.015567295253276825),
    "warm": (1.0670083574950695e-3, 1.4202079037204385e-3,
             4.385730717331171e-4, 0.013576843775808811)}
# The calibrated RMSE guard of both runs: the warm anchor's. Cold and warm
# reach the same mode, and at the calibrated values one patch whose
# float32 training goes astray but stays inside sanitize's bounds moves a
# single run's in-sample RMSE by more than 10%: the port, trained at the
# cold anchor's own hyperparameters, gives ~0.0136 m, not that run's
# 0.0156 m (phase 6 prints both routes there).
CAL_RMSE_JAX = CAL_ANCHORS["warm"][3]
REG_RPROP_FINAL_JAX = 1.937328343046829e-4   # m, 48 steps of at most 80
REG_REF_FINAL_JAX = 0.014729603193700314     # m, 40 steps (max_steps)
PERTURB_ANG = [0.004, -0.003, 0.005]         # bench.py:509-510
PERTURB_T = [0.012, -0.009, 0.006]
# anchors of phase 8: the JAX package's mapping row on the CPU in float32
# (port_anchors.py mapping, jax 0.9.0): the calibration on scan 0, then
# the stream at those values (seed + add_clouds of 4 scans)
MAP_CAL_JAX = (3.253220347687602e-4, 5.610331520438194e-2,
               4.368717782199383e-4)             # sigma_f^2, l^2, s20
MAP_STEPS_JAX = 32                               # the carve's walk bound
MAP_PATCHES_JAX = 1681
MAP_RMSE_JAX = 0.02251934293019489               # m, one-sided chamfer
MAP_RMSE_MAX = 0.025
MAP_SCANS, MAP_SCAN_POINTS = 4, 150_000
# anchors of phase 9: the JAX package's Bayesian rows on the CPU in float32
# (port_anchors.py bayes, jax 0.9.0). NUTS on phase 3's banks' 16 x 48
# subsample, 50 warmup + 100 samples: the posterior mean and standard
# deviation of theta = (ln sigma_f^2, ln l^2, ln s20), its ESS, the mean
# accept statistic and the max split-R-hat
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
# the 16-chain row's max split-R-hat at 8 more seeds (port_anchors.py
# nuts_seeds): 50 warmup transitions leave a chain in transit now and then
NUTS16_RHAT_JAX = (1.0285327434539795, 1.0604816675186157, 1.0622564554214478,
                   1.0513066053390503, 1.0400068759918213, 1.231974482536316,
                   1.2655634880065918, 1.035811185836792)
NUTS_WARMUP, NUTS_SAMPLES = 50, {4: 100, 16: 100}
ADVI_JAX = dict(plateaued=True, mean=(-5.804538726806641, -5.698229789733887,
                                      -8.183993339538574))
ADVI_STEPS = 300
# compress_calibrated(method="hmc") at 400 steps: sigma_f^2, l^2, s20, RMSE
HMC_CAL_STEPS = 400
HMC_CAL_JAX = (1.082348171621561e-3, 1.4159923885017633e-3,
               4.3668327271007e-4, 0.013525919988751411)
# the SMC row: mean point error injected, after the 8-step registration
# budget, and after smc_refine_pose (256 particles, 16 steps) at 3 keys
SMC_ANG = [0.012, -0.008, 0.010]                 # bench.py:731-732
SMC_T = [0.05, -0.04, 0.03]
SMC_JAX = dict(injected=0.07539442926645279, after_reg=0.022825060412287712,
               after_smc=(0.01023662555962801, 0.009596461430191994,
                          0.005447890609502792))
SMC_PARTICLES, SMC_ITERS, SMC_RUNS = 256, 16, 3
# anchors of phase 10: the JAX package's K-SVD row (bench.py:779-822, atom
# block 16) on the CPU in float32 at keys 1-4 (port_anchors.py ksvd,
# jax 0.9.0): the range of each value over the keys
KSVD_JAX = {"range": {"rms": (0.013902850449085236, 0.013951080851256847),
                      "depth_mse": (0.008564305491745472,
                                    0.008667842485010624),
                      "depth_iters": (16, 22), "rgb_iters": (2, 2)}}
# anchors of phase 11 (port_anchors.py icp and accuracy, jax 0.9.0): ICP on
# the headline map under phase 7's perturbation; the final mean point
# error (m) of GP registration and of ICP at the gp-accuracy pairs of
# seeds 0-19
ICP_JAX = {"iters": 7, "final_mean_err": 3.1501669582212344e-05,
           "trans_err": 5.96235622651875e-05}
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
# pairs run again with map and registration in float64
ACC_F64_PAIRS = 2
# anchors of phase 12: the JAX command line at the same arguments on the
# CPU in float32 (port_anchors.py cli, jax 0.9.0), at keys 0-3 where the
# command draws from its key (calibrate's HMC at keys 0-11), gp-mapping
# --dataset on the fixtures of seeds 0-3
CLI_JAX = {
    "gp_compress": [
        {"n_points": 300000, "n_patches": 1675, "mean_added": 3.91,
        "max_added": 10, "rms": 0.01949, "n_out": 9200},
        {"n_points": 300000, "n_patches": 1675, "mean_added": 3.46,
        "max_added": 7, "rms": 0.0198, "n_out": 9600},
        {"n_points": 300000, "n_patches": 1675, "mean_added": 3.59,
        "max_added": 8, "rms": 0.01937, "n_out": 8800},
        {"n_points": 300000, "n_patches": 1675, "mean_added": 3.7, "max_added":
        8, "rms": 0.021, "n_out": 9200},
    ],
    "compress": [
        {"rms": 0.01728, "depth_iters": 22, "rgb_iters": 3, "n_out": 85565},
        {"rms": 0.01723, "depth_iters": 28, "rgb_iters": 4, "n_out": 85565},
        {"rms": 0.01743, "depth_iters": 18, "rgb_iters": 3, "n_out": 85565},
        {"rms": 0.01731, "depth_iters": 26, "rgb_iters": 3, "n_out": 85565},
    ],
    "gp_accuracy":
        {"steps": 150, "initial_mean_err_m": 0.01224, "final_mean_err_m":
        0.80451, "mean_likelihood": 1.1246, "icp": {"iters": 13,
        "final_mean_err_m": 0.05606, "rms_plane_residual_m": 0.04626,
        "n_matched": 1175}},
    "tum_accuracy": [
        [{"pair": [0, 1], "steps": 18, "trans_err_m": 0.01577, "rot_err":
        0.00206, "gt_trans_m": 0.02291}, {"pair": [1, 2], "steps": 11,
        "trans_err_m": 0.0161, "rot_err": 0.00512, "gt_trans_m": 0.02291},
        {"pair": [2, 3], "steps": 14, "trans_err_m": 0.01429, "rot_err":
        0.00165, "gt_trans_m": 0.02291}, {"mean_trans_err_m": 0.01539,
        "mean_rot_err": 0.00294, "n_pairs": 3}],
        [{"pair": [0, 1], "steps": 31, "trans_err_m": 0.01156, "rot_err":
        0.00256, "gt_trans_m": 0.02291}, {"pair": [1, 2], "steps": 25,
        "trans_err_m": 0.00743, "rot_err": 0.00148, "gt_trans_m": 0.02291},
        {"pair": [2, 3], "steps": 16, "trans_err_m": 0.01322, "rot_err":
        0.00201, "gt_trans_m": 0.02291}, {"mean_trans_err_m": 0.01074,
        "mean_rot_err": 0.00202, "n_pairs": 3}],
        [{"pair": [0, 1], "steps": 12, "trans_err_m": 0.02257, "rot_err":
        0.00302, "gt_trans_m": 0.02291}, {"pair": [1, 2], "steps": 22,
        "trans_err_m": 0.01741, "rot_err": 0.00475, "gt_trans_m": 0.02291},
        {"pair": [2, 3], "steps": 18, "trans_err_m": 0.01362, "rot_err":
        0.00373, "gt_trans_m": 0.02291}, {"mean_trans_err_m": 0.01787,
        "mean_rot_err": 0.00383, "n_pairs": 3}],
        [{"pair": [0, 1], "steps": 25, "trans_err_m": 0.0093, "rot_err":
        0.00158, "gt_trans_m": 0.02291}, {"pair": [1, 2], "steps": 11,
        "trans_err_m": 0.01803, "rot_err": 0.00216, "gt_trans_m": 0.02291},
        {"pair": [2, 3], "steps": 16, "trans_err_m": 0.01307, "rot_err":
        0.0021, "gt_trans_m": 0.02291}, {"mean_trans_err_m": 0.01347,
        "mean_rot_err": 0.00195, "n_pairs": 3}],
    ],
    "calibrate_map":
        {"sigmaf_sq": 1.124949488074475, "l_sq": 83.67677182593619, "s20":
        0.004498032499976906, "logpost": 2431.725830078125},
    "calibrate_hmc": [
        {"sigmaf_sq": 16.55764389038086, "l_sq": 0.17071853578090668, "s20":
        1.0520052740048413e-07, "accept": 0.7862343192100525},
        {"sigmaf_sq": 16.643423080444336, "l_sq": 0.17057949304580688, "s20":
        8.071341426330036e-07, "accept": 0.7852756977081299},
        {"sigmaf_sq": 16.583980560302734, "l_sq": 0.17068153619766235, "s20":
        8.110537130789908e-09, "accept": 0.7876706719398499},
        {"sigmaf_sq": 8.250631332397461, "l_sq": 0.08880830556154251, "s20":
        0.0008429397130385041, "accept": 0.7829138040542603},
        {"sigmaf_sq": 0.01769631914794445, "l_sq": 0.008933565579354763, "s20":
        0.0016718169208616018, "accept": 0.7762495279312134},
        {"sigmaf_sq": 8.29494571685791, "l_sq": 0.08913359045982361, "s20":
        0.0008378508500754833, "accept": 0.7852195501327515},
        {"sigmaf_sq": 8.300442695617676, "l_sq": 0.09017415344715118, "s20":
        0.0008380897925235331, "accept": 0.8009746074676514},
        {"sigmaf_sq": 0.017836427316069603, "l_sq": 0.008889401331543922,
        "s20": 0.0016629148740321398, "accept": 0.7740033864974976},
        {"sigmaf_sq": 0.017682697623968124, "l_sq": 0.008854812011122704,
        "s20": 0.0016725283348932862, "accept": 0.7976343631744385},
        {"sigmaf_sq": 16.62087631225586, "l_sq": 0.16949938237667084, "s20":
        1.2310319164043904e-07, "accept": 0.7881980538368225},
        {"sigmaf_sq": 8.208510398864746, "l_sq": 0.0888931155204773, "s20":
        0.000844001944642514, "accept": 0.7890934944152832},
        {"sigmaf_sq": 8.351917266845703, "l_sq": 0.08923892676830292, "s20":
        0.0008421987295150757, "accept": 0.7901785969734192},
    ],
    "gp_mapping": {
        "scans": [
            {"diverged": False, "reg_steps": 0, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 965},
            {"diverged": False, "reg_steps": 11, "bank_dropped": 24,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 971},
            {"diverged": False, "reg_steps": 11, "bank_dropped": 15,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 972},
            {"diverged": False, "reg_steps": 11, "bank_dropped": 2,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 973},
            {"diverged": False, "reg_steps": 11, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 975},
        ],
        "written": [
            4725,
            4950,
        ],
    },
    "tum_mapping_seeds": {
        0: [
            {"diverged": False, "reg_steps": 0, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 766},
            {"diverged": False, "reg_steps": 18, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 776},
            {"diverged": False, "reg_steps": 23, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 785},
            {"diverged": False, "reg_steps": 19, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 813},
        ],
        1: [
            {"diverged": False, "reg_steps": 0, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 755},
            {"diverged": False, "reg_steps": 17, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 766},
            {"diverged": False, "reg_steps": 19, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 781},
            {"diverged": False, "reg_steps": 22, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 791},
        ],
        2: [
            {"diverged": False, "reg_steps": 0, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 764},
            {"diverged": False, "reg_steps": 46, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 772},
            {"diverged": False, "reg_steps": 21, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 775},
            {"diverged": False, "reg_steps": 12, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 798},
        ],
        3: [
            {"diverged": False, "reg_steps": 0, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 758},
            {"diverged": False, "reg_steps": 19, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 769},
            {"diverged": False, "reg_steps": 19, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 785},
            {"diverged": False, "reg_steps": 18, "bank_dropped": 0,
            "patch_overflow": 0, "pend_dropped": 0, "n_patches": 811},
        ],
    },
}
# the H100 SXM's peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


def bench_config():
    """The headline configuration (bench.py:41-66,168-195)."""
    from gp_compressor_tpu_torch import config as c
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


def rank_sum_p(a, b) -> float:
    """Two-sided p-value of the Wilcoxon rank-sum (Mann-Whitney) test that
    samples a and b come from one distribution (normal approximation; the
    samples are continuous, so ties are not corrected for)."""
    n, m = len(a), len(b)
    ranked = sorted([(v, 0) for v in a] + [(v, 1) for v in b])
    r = sum(i + 1 for i, (_, src) in enumerate(ranked) if src == 0)
    u = r - n * (n + 1) / 2
    z = (u - n * m / 2) / math.sqrt(n * m * (n + m + 1) / 12)
    return math.erfc(abs(z) / math.sqrt(2))


def say(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (CUDA events).
    A ~1 ms device sleep ahead of the start event lets the host queue the
    launches, so host overhead between them is not timed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(log: str) -> dict:
    """{"D=.. R=..": {registers, stack, spill_stores, spill_loads}} per
    kernel instantiation, from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = re.search(r"sogp_train_kernelILi(\d)ELi(\d)E", line)
            name = f"D={m[1]} R={m[2]}" if m else None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(stack=int(m[1]),
                                            spill_stores=int(m[2]),
                                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m[1])
    return out


def train_bound(cfg, X, mask, out, tally=None) -> dict:
    """The least time the card could take for one training launch: the
    larger of its bytes (each input read once, each output written once)
    over the HBM rate and its operations over the fp32 rate. Operations
    are counted from this run's data, per valid row that starts with a
    BVs: 8a for k, 4a^2 for C k and Q k, (4 + 5D)a for the sums and alpha,
    7(a+1)^2 for the rank-1 updates of C and Q, and ~40 for the scalars;
    per capacity deletion, (D + 2)a for the scores and 7a^2 + 2Da for the
    downdates of C, Q and alpha, at a = capacity + 1. tally: the plain
    version's [B, 5] counts (sparse_gp.add_point), which give each
    patch's capacity deletions and its rows' sums of a and a^2; without
    it (the headline banks, where no patch reaches capacity) each row is
    charged the patch's final BV count, at most one above what the row
    needs. `flops_dense` charges every row a = S, as a loop over every
    slot does."""
    B, P, _ = X.shape
    S, D = cfg.slots, cfg.dout
    state = B * S * (2 * 4 + D * 4 + 2 * S * 4 + 1)
    nbytes = B * P * (2 * 4 + D * 4 + 1) + 2 * state + 7 * 4
    rows = mask.sum(1).double()
    a_del = cfg.capacity + 1
    n_del = 0.0 if tally is None else float(tally[:, 1].double().sum())
    del_flops = n_del * ((D + 2) * a_del + 7 * a_del ** 2 + 2 * D * a_del)

    def count(s1, s2):
        # sums over rows of a and a^2 -> the rows' operations
        return float((8 * s1 + 4 * s2 + (4 + 5 * D) * s1
                      + 7 * (s2 + 2 * s1 + rows) + 40 * rows).sum()) + del_flops

    if tally is None:
        a = out.active.sum(1).double()
        flops = count(rows * a, rows * a ** 2)
    else:
        flops = count(tally[:, 3].double(), tally[:, 4].double())
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return {"bytes": nbytes, "flops": flops,
            "flops_dense": count(rows * S, rows * S ** 2),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def interval_union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted(spans):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_phase(pts, cols, valid, ccfg, best_wall, kind, card):
    """Front-end step walls, then one profiled round trip."""
    from gp_compressor_tpu_torch.geometry import patches, rotation, voxel
    from gp_compressor_tpu_torch.workloads import compressor

    pc = ccfg.patch
    steps = {}
    grid = synced(lambda: voxel.build_grid(
        pts, valid, pc.res, pc.max_patches, pc.max_cells), steps, "build_grid")
    M, cnt = synced(lambda: patches.sphere_moments(grid, pts, valid, pc),
                    steps, "sphere_moments")
    synced(lambda: rotation.rotation_from_moment_batch(
        M, cnt, pc.min_points_for_rotation), steps,
        "rotation_from_moment_batch")
    synced(lambda: compressor.project(pts, cols, valid, ccfg), steps,
           "project")
    say(f"[5] front-end steps (s, host wall) on {kind} ({card}): "
        f"{json.dumps(steps)}")

    res = profile_summary(
        lambda: compressor.compress_decompress(pts, cols, valid, ccfg),
        best_wall)
    say(f"[5] profiled round trip on {kind} ({card}): {json.dumps(res)}")


def profile_summary(fn, best_wall) -> dict:
    """fn() once under torch.profiler: wall, device busy time (the union
    of device intervals), idle shares against that wall and against
    best_wall (an unprofiled run's), device kernels and copies, host-side
    CUDA calls, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev_ev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = interval_union_us((e.time_range.start, e.time_range.end)
                                for e in dev_ev)
    kernels = [e for e in dev_ev if not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    calls = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith(("cuda", "cu")) and not e.name.startswith(
                    "cudnn"):
            calls[e.name] = calls.get(e.name, 0) + 1
    res = {
        "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share_profiled": 1.0 - busy_us / (wall * 1e6),
        "idle_share_vs_best_unprofiled": 1.0 - busy_us / (best_wall * 1e6),
        "device_kernels": len(kernels),
        "device_copies": len(dev_ev) - len(kernels),
        "host_cuda_calls": dict(sorted(calls.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:80], c, us / 1e3] for n, (c, us) in top],
    }
    check(len(kernels) > 0, "the profiler saw no device kernel")
    return res


# the front end's steps and collectives, each a span of front_end_trace
# (module, function; nested spans are inclusive)
TRACE_SPANS = (("patches", "claim_points"), ("voxel", "build_grid"),
               ("patches", "sphere_moments"),
               ("rotation", "rotation_from_moment_batch"),
               ("patches", "_owner_banks"), ("patches", "_fill_banks"),
               ("mesh", "all_reduce_min"), ("mesh", "all_reduce_max"),
               ("mesh", "all_reduce_sum"), ("mesh", "all_gather_rows"),
               ("mesh", "all_gather_varlen"), ("mesh", "all_to_all_rows"))
# CUDA calls that can hold the host: a copy from or to pageable memory
# waits for its stream to reach it
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def front_end_trace(fn) -> dict:
    """fn() (one front end) once under torch.profiler with Python stacks
    and a span around each of TRACE_SPANS (wrapped for this call only):
    the traced wall; per span its calls, inclusive host ms and kernel
    launches; each CUDA call that can hold the host (SYNC_CALLS) by the
    port's function (or else the innermost span) that made it, the op and
    the call (count, ms held), where a wait is the device's
    queue and, after a collective, the other ranks' lag; and the NCCL
    kernels' count and device ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gp_compressor_tpu_torch.geometry import patches, rotation, voxel
    from gp_compressor_tpu_torch.parallel import mesh as mesh_lib

    mods = {"patches": patches, "voxel": voxel, "rotation": rotation,
            "mesh": mesh_lib}

    def span(name, f):
        def wrapped(*a, **k):
            with record_function(f"span:{name}"):
                return f(*a, **k)
        return wrapped

    saved = [(mods[m], name, getattr(mods[m], name))
             for m, name in TRACE_SPANS]
    for mod, name, f in saved:
        setattr(mod, name, span(name, f))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    cpu_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    rng = lambda e: (e.time_range.start, e.time_range.end)
    # by time alone: the CUDA runtime's events may carry another thread id
    # than the ops that made them, and the front end runs on one thread
    inside = lambda a, b: rng(b)[0] <= rng(a)[0] and rng(a)[1] <= rng(b)[1]
    dur = lambda e: rng(e)[1] - rng(e)[0]
    launches = [e for e in cpu_ev if e.name in LAUNCH_CALLS]
    spans = {}
    for e in cpu_ev:
        if e.name.startswith("span:"):
            n, ms, k = spans.get(e.name[5:], (0, 0.0, 0))
            spans[e.name[5:]] = (n + 1, ms + dur(e) / 1e3,
                                 k + sum(inside(x, e) for x in launches))
    # a sync's site: the innermost port function around it (the profiler's
    # Python events, "file(first line): name", where this torch records
    # them), else the innermost span; and the outermost op
    python = [e for e in cpu_ev if ".py(" in e.name
              and "gp_compressor_tpu_torch/" in e.name]
    marks = [e for e in cpu_ev if e.name.startswith("span:")]
    ops = [e for e in cpu_ev if e.name.startswith("aten::")]
    syncs = {}
    for e in cpu_ev:
        if e.name not in SYNC_CALLS:
            continue
        fns = sorted((x for x in python if inside(e, x)), key=dur) or \
            sorted((x for x in marks if inside(e, x)), key=dur)
        site = fns[0].name if fns else "(outside the spans)"
        outer = [x for x in ops if inside(e, x)]
        op = max(outer, key=dur).name if outer else ""
        site = site.split("gp_compressor_tpu_torch/")[-1]
        key = f"{site.removeprefix('span:')} {op} {e.name}"
        n, ms = syncs.get(key, (0, 0.0))
        syncs[key] = (n + 1, ms + dur(e) / 1e3)
    nccl = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name.lower().startswith("nccl")]
    return {"traced_wall_ms": wall * 1e3,
            "launches": len(launches),
            "spans": {k: [n, ms, k_] for k, (n, ms, k_) in spans.items()},
            "syncs": {k: [n, ms] for k, (n, ms) in sorted(
                syncs.items(), key=lambda kv: -kv[1][1])},
            "sync_ms": sum(v[1] for v in syncs.values()),
            "nccl_kernels": [len(nccl), sum(
                (e.time_range.end - e.time_range.start) for e in nccl) / 1e3]}


def synced(fn, out: dict, name: str):
    """fn() between two synchronises; its host wall (s) goes to out[name]."""
    r, out[name] = timed(fn)
    return r


def timed(fn):
    """(fn(), host wall s), synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def counted(name: str):
    """The port's count `name` so far (utils/profiling.count)."""
    from gp_compressor_tpu_torch.utils import profiling
    return profiling.counters().get(name, 0)


def reset_counters():
    from gp_compressor_tpu_torch.utils import profiling
    profiling.reset_counters()


def nuts_counts() -> dict:
    """The nuts.* counts since the last reset_counters, without the
    prefix (leapfrogs a 0-dim device tensor once a transition ran)."""
    return {k: counted("nuts." + k) for k in (
        "transitions", "iterations", "reads", "leapfrogs",
        "find_iterations", "find_reads")}


def count_syncs(fn):
    """(fn(), number of synchronising CUDA calls it made, {"file:line":
    count} of the Python lines that made them), counted by torch's sync
    debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        # (the mode's own "prototype feature" notice is not a call)
        if "called a synchronizing CUDA operation" in str(w.message):
            key = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return r, sum(where.values()), where


def calibrated_phase(pts, cols, valid, ccfg, dev, kind, card):
    """Phase 6: the calibrated round trip, cold and warm, with its guards,
    its stage split, the host syncs of the MAP ascent, and the training
    kernel against its plain version at the calibrated bench banks.
    Returns (cold CompressedCloud, its depth RBFParams, its s20)."""
    from gp_compressor_tpu_torch.inference import hmc
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.ops.kernels import RBFParams
    from gp_compressor_tpu_torch.workloads import compressor

    runs = {"cold": dict(calib_steps=150, calib_lr=0.1, calib_starts=4),
            "warm": dict(calib_steps=40, calib_lr=0.05, calib_starts=1)}
    G = ccfg.patch.sz ** 2
    result = {}
    theta = None
    for name, kw in runs.items():
        if name == "warm":
            kw = dict(kw, theta_init=theta)

        def round_trip():
            r = compressor.compress_decompress_calibrated(
                pts, cols, valid, ccfg, calib_patches=32, calib_points=64,
                **kw)
            torch.cuda.synchronize()
            return r

        round_trip()                                       # warm-up
        l0 = counted("sogp_train.launches")
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            comp, kp, s20, out = round_trip()
            walls.append(time.perf_counter() - t0)
        launches = counted("sogp_train.launches") - l0
        check(launches == 4, f"[6] {name}: kernel launches {launches}, "
                             "expected 2 per round trip")
        hp = [float(kp.sigmaf_sq), float(kp.l_sq), float(s20)]
        rmse = float(compressor.reconstruction_rmse(comp, ccfg, depth_kp=kp,
                                                    depth_s20=s20))
        hist = torch.bincount(sparse_gp.size(comp.depth_gp),
                              minlength=ccfg.depth_gp.slots + 1).tolist()
        world, colors, pvalid = out[0], out[1], out[2]
        check(world.shape == (ccfg.patch.max_patches * G, 3)
              and bool(torch.isfinite(world[pvalid]).all())
              and bool(torch.isfinite(colors).all()),
              f"[6] {name}: decompress output shape or non-finite values")
        best = min(walls)
        say(f"[6] calibrated {name} on {kind} ({card}): wall {walls} s, best "
            f"{best:.4f} s = {N_POINTS / best:.1f} points/s; sigmaf_sq "
            f"{hp[0]:.6g} l_sq {hp[1]:.6g} s20 {hp[2]:.6g}; rmse {rmse:.6f} m;"
            f" kernel launches {launches} in 2 runs; depth BV-count "
            f"histogram (0..{ccfg.depth_gp.slots}): {hist}")
        anchor = CAL_ANCHORS[name]
        for label, v, a in zip(("sigmaf_sq", "l_sq", "s20"), hp, anchor):
            check(math.isfinite(v) and abs(math.log(v / a)) <= 0.1,
                  f"[6] {name}: {label} {v} not within 0.1 of the JAX "
                  f"anchor {a} in log space")
        check(abs(rmse - CAL_RMSE_JAX) <= 0.05 * CAL_RMSE_JAX,
              f"[6] {name}: rmse {rmse} not within 5% of the JAX anchor "
              f"{CAL_RMSE_JAX}")
        result[name] = (comp, kp, s20)
        if name == "cold":
            theta = torch.log(torch.stack([kp.sigmaf_sq, kp.l_sq, s20]))

    # stage split of the cold round trip, synchronised between stages
    cold = runs["cold"]
    st = {}
    batch = synced(lambda: compressor.project(pts, cols, valid, ccfg), st,
                   "project")
    logpost, theta0 = synced(lambda: compressor._calib_logpost(
        batch, ccfg, 32, 64, torch.float32), st, "subsample")
    ascent = lambda: hmc.map_estimate_multi(
        logpost, theta0, steps=cold["calib_steps"], lr=cold["calib_lr"],
        n_starts=cold["calib_starts"])
    theta_c, _ = synced(ascent, st, "map_ascent")
    sf, l2, s20 = torch.exp(theta_c).unbind()
    kp = RBFParams(sigmaf_sq=sf, l_sq=l2)
    eps = ccfg.depth_gp.eps_tol * sf / ccfg.depth_gp.sigmaf_sq
    _, ckp = compressor.default_params(ccfg, dev)
    dstates = synced(lambda: compressor.train_gp(
        batch, ccfg.depth_gp, kp, batch.y, s20=s20, eps_tol=eps), st,
        "depth_train")
    cstates = synced(lambda: compressor.train_gp(
        batch, ccfg.rgb_gp, ckp, batch.rgb), st, "rgb_train")
    dstates, cstates, _, _ = synced(lambda: compressor.sanitize(
        batch, ccfg, dstates, cstates, kp, ckp, s20, full_probes=True), st,
        "sanitize")
    synced(lambda: compressor.decompress(
        compressor.CompressedCloud(batch, dstates, cstates), ccfg,
        depth_kp=kp, depth_s20=s20), st, "decompress")
    say(f"[6] cold stages (s) on {kind} ({card}): {json.dumps(st)}")
    _, n_sync, where = count_syncs(ascent)
    say(f"[6] synchronising CUDA calls inside the cold MAP ascent "
        f"({cold['calib_steps']} steps, {cold['calib_starts']} starts): "
        f"{n_sync}, from {json.dumps(where)}")

    # the training and its RMSE at the JAX cold anchor's own values, by
    # the kernel and by the plain version (see CAL_RMSE_JAX)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    a_sf, a_l2, a_s20, a_rmse = CAL_ANCHORS["cold"]
    a_kp, a_s20 = RBFParams(sigmaf_sq=t(a_sf), l_sq=t(a_l2)), t(a_s20)
    at_anchor = {}
    for route, use in (("kernel", True), ("plain", False)):
        c = compressor.train(batch, ccfg, depth_kp=a_kp, use_kernel=use,
                             depth_s20=a_s20, depth_eps=ccfg.depth_gp.eps_tol
                             * a_kp.sigmaf_sq / ccfg.depth_gp.sigmaf_sq,
                             full_probes=True)
        at_anchor[route] = float(compressor.reconstruction_rmse(
            c, ccfg, depth_kp=a_kp, depth_s20=a_s20))
    say(f"[6] in-sample RMSE (m) when trained at the JAX cold anchor's "
        f"sigmaf_sq, l_sq, s20: {json.dumps(at_anchor)}; the anchor run's "
        f"own {a_rmse}")

    # the kernel against its plain version at the calibrated bench banks,
    # both fed the calibrated row (device data), depth D=1 and RGB D=3
    for gpcfg, Y in ((ccfg.depth_gp, batch.y), (ccfg.rgb_gp, batch.rgb)):
        init = sparse_gp.init_batch(gpcfg, batch.mask.shape[0], device=dev)
        res, stats = kernel_at_site(kp, gpcfg, init, batch.X, Y, batch.mask,
                                    s20, eps, dev)
        say(f"[6] calibrated bench banks D={gpcfg.dout} on {kind} ({card}): "
            f"{json.dumps(res)}; {json.dumps(stats)}")
    return result["cold"]


def registration_phase(pts, cols, valid, ccfg, comp_cal, kp_cal, s20_cal,
                       comp_ref, dev, kind, card):
    """Phase 7: registration of the perturbed full scan (bench.py:488-572):
    rprop on the calibrated map with its guards, the reference-constants
    row on the headline map, and the split of one step."""
    from gp_compressor_tpu_torch.config import RegistrationConfig
    from gp_compressor_tpu_torch.geometry import transforms, voxel
    from gp_compressor_tpu_torch.workloads import compressor, registration

    ang = torch.tensor(PERTURB_ANG, device=dev)
    t_true = torch.tensor(PERTURB_T, device=dev)
    R_true = transforms.euler_xyz(ang)
    moved = transforms.apply(pts, R_true, t_true)
    err0 = float(torch.linalg.norm(moved - pts, dim=1).mean())
    rcfg = RegistrationConfig(max_steps=80, step_mode="rprop")

    def run(comp, rc, **kw):
        st, out = registration.register(comp, moved, cols, valid, ccfg, rc,
                                        **kw)
        torch.cuda.synchronize()
        return st, out

    def summary(st, out):
        terr, rerr = registration.registration_error(st.R_cloud, st.t_cloud,
                                                     R_true, t_true)
        err1 = float(torch.linalg.norm(out - pts, dim=1).mean())
        return {"steps": int(st.step_nbr), "initial_mean_err_m": err0,
                "final_mean_err_m": err1, "removed": 1.0 - err1 / err0,
                "trans_err_m": float(terr), "rot_err_rad": float(rerr)}

    cal = dict(depth_kp=kp_cal, depth_s20=s20_cal)
    run(comp_cal, rcfg, **cal)                              # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        st, out = run(comp_cal, rcfg, **cal)
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    res = summary(st, out)
    (st2, _), n_sync, where = count_syncs(lambda: run(comp_cal, rcfg, **cal))
    say(f"[7] registration rprop, calibrated map, on {kind} ({card}): walls "
        f"{walls} s, median {wall:.4f} s, {res['steps'] / wall:.2f} steps/s;"
        f" {json.dumps(res)}; synchronising CUDA calls in one register call "
        f"of {int(st2.step_nbr)} steps: {n_sync}, from {json.dumps(where)}")
    check(res["steps"] < rcfg.max_steps,
          f"[7] rprop did not converge in {rcfg.max_steps} steps")
    check(res["final_mean_err_m"] <= min(2 * REG_RPROP_FINAL_JAX, 1e-3),
          f"[7] final mean error {res['final_mean_err_m']} above "
          f"min(2 x {REG_RPROP_FINAL_JAX}, 1 mm)")
    check(res["removed"] >= 0.95, f"[7] removed only {res['removed']:.4f} "
                                  "of the injected error")

    rcfg_ref = RegistrationConfig(max_steps=40, step=0.005,
                                  grad_tol_step_ref=0.1)
    times = {}
    st, out = synced(lambda: run(comp_ref, rcfg_ref), times, "wall")
    res_ref = summary(st, out)
    say(f"[7] registration reference constants, headline map, on {kind} "
        f"({card}): wall {times['wall']:.4f} s; {json.dumps(res_ref)}")
    check(abs(res_ref["final_mean_err_m"] - REG_REF_FINAL_JAX)
          <= 0.1 * REG_REF_FINAL_JAX,
          f"[7] reference-constants final error {res_ref['final_mean_err_m']}"
          f" not within 10% of the JAX anchor {REG_REF_FINAL_JAX}")

    # one rprop step, split: claims / bank / gradients / update
    batch = comp_cal.patch
    B = batch.rotations.shape[0]
    P = ccfg.patch.max_points_per_patch
    centers = voxel.voxel_centers(batch.grid)[:B]
    _, ckp = compressor.default_params(ccfg, dev)
    sp = {}
    tables = synced(lambda: registration._map_claim_tables(comp_cal), sp,
                    "claim_tables")
    claim, _, claimed = synced(lambda: registration._claim_to_map(
        comp_cal, moved, valid, ccfg, tables=tables), sp, "claims")

    def bank():
        Wb, Cb, Mb = registration._bank_points(claim, moved, cols, claimed,
                                               B, P)
        return Wb, torch.where(Mb[..., None],
                               Cb - batch.rgb_means[:, None, :], 0.0), Mb

    Wb, Cb, Mb = synced(bank, sp, "bank")
    delta, _, _, _ = synced(lambda: registration._bank_step(
        comp_cal, ccfg, rcfg, kp_cal, ckp, Wb, Cb, Mb, centers,
        depth_s20=s20_cal), sp, "gradients")

    def update():
        eta = torch.full((6,), rcfg.rprop_eta0, device=dev)
        move = torch.sign(delta) * eta
        R = transforms.euler_xyz(move[3:])
        return (transforms.apply(moved, R, move[:3]),
                transforms.apply(Wb, R, move[:3]), bool(torch.all(
                    eta < rcfg.rprop_tol)))

    synced(update, sp, "update")
    say(f"[7] one step (s, host wall, synchronised between parts; claim "
        f"tables are built once per register call) on {kind} ({card}): "
        f"{json.dumps(sp)}")


def zero_off_active(st) -> torch.Tensor:
    """[B] bool: the patch's C and Q are exactly zero off its active block,
    the test the kernel makes at entry (else it runs its dense loop on the
    patch, csrc/sogp_train.cu)."""
    off = ~st.active
    both = off[:, :, None] | off[:, None, :]
    return ~((st.C != 0) & both).any((1, 2)) & ~((st.Q != 0) & both).any((1, 2))


def kernel_at_site(kp, gcfg, states, X, Y, mask, s20, eps, dev,
                   rule="calibrated"):
    """The training kernel against its plain version at one call site's
    banks: the same states and hyperparameter row, held by `rule`
    (sogp_regimes; "arbitrated" also trains the plain version in float64
    as its referee), after checking that the kernel leaves its input
    state unchanged. Raises AssertionError. Returns (the rule's readings,
    the launch's statistics: per-patch additions and deletions from the
    plain version's tally, active slots at entry and exit, the kernel's
    and the plain version's ms per call and the bound)."""
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.ops.kernels import RBFParams
    from gp_compressor_tpu_torch.testing import sogp_regimes

    before = [a.clone() for a in states]
    out = sogp_train.add_points_batch_cuda(kp, gcfg, states, X, Y, mask,
                                           s20=s20, eps_tol=eps)
    torch.cuda.synchronize()
    check(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
              for a, b in zip(before, states)),
          "the kernel changed its input state")
    B = mask.shape[0]
    tally = torch.zeros((B, 5), dtype=torch.int64, device=dev)
    plain = lambda tl=None: sogp_train.add_points_batch_plain(
        kp, gcfg, states, X, Y, mask, s20=s20, eps_tol=eps, tally=tl)
    ref = plain(tally)
    torch.cuda.synchronize()
    s20v = gcfg.s20 if s20 is None else s20
    if rule == "arbitrated":
        f64 = lambda v: None if v is None else torch.as_tensor(
            v, device=dev).double()
        st64 = sparse_gp.SOGPState(*[a.double() if a.is_floating_point()
                                     else a for a in states])
        ref64 = sogp_train.add_points_batch_plain(
            RBFParams(sigmaf_sq=f64(kp.sigmaf_sq), l_sq=f64(kp.l_sq)),
            dataclasses.replace(gcfg, dtype=torch.float64), st64,
            X.double(), Y.double(), mask, s20=f64(s20), eps_tol=f64(eps))
        res = sogp_regimes.arbitrate(ref64, ref, out, X, Y, mask, kp, s20v)
    else:
        res = sogp_regimes.compare(rule, ref, out, X, Y, mask, kp=kp,
                                   s20=s20v)
    used = mask.any(1)
    row = sogp_train.hyper_row(kp, gcfg, dev, s20=s20, eps_tol=eps)
    scratch = sparse_gp.SOGPState(*[torch.empty_like(a) for a in states])
    kern = lambda: sogp_train.launch(gcfg, states, scratch, X, Y, mask, row)
    kern()
    p1, k1, k2, p2 = (event_ms(plain, 1), event_ms(kern, KERNEL_REPS),
                      event_ms(kern, KERNEL_REPS), event_ms(plain, 1))
    ms = (k1 + k2) / 2
    bound = train_bound(gcfg, X, mask, out, tally=tally)
    adds, dels, gdels = tally[used, :3].double().mean(0).tolist()
    rows_max = int(mask.sum(1).max())
    stats = {
        "B": B, "P": X.shape[1], "S": gcfg.slots, "D": gcfg.dout,
        "patches_with_points": int(used.sum()),
        "additions": adds, "capacity_deletions": dels,
        "geometric_deletions": gdels,
        "active_at_entry": float(states.active.sum(1)[used].double().mean()),
        "active_at_exit": float(out.active.sum(1)[used].double().mean()),
        "row_start_bvs": float(tally[:, 3].sum()) / float(mask.sum()),
        "zero_off_active_share": float(zero_off_active(states).double()
                                       .mean()),
        "rows": int(mask.sum()), "rows_max": rows_max,
        "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
        "bound_us": bound["bound_ms"] * 1e3, "bound_by": bound["bound_by"],
        "bytes": bound["bytes"], "flops": bound["flops"],
        "flops_dense": bound["flops_dense"],
        "share_of_bound": bound["bound_ms"] / ms,
        "us_per_row_of_longest": ms * 1e3 / rows_max}
    return res, stats


def mapping_phase(pts, cols, valid, ccfg, dev, kind, card):
    """Phase 8: the mapping stream of bench.py:575-688 with its guards, the
    kernel at the mapping call site, the stage split of one insert, syncs
    and launches per scan, and the occupancy channel."""
    import numpy as np
    from scipy.spatial import cKDTree

    from gp_compressor_tpu_torch.config import (MappingConfig,
                                                RegistrationConfig)
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.geometry import patches
    from gp_compressor_tpu_torch.ops.kernels import RBFParams
    from gp_compressor_tpu_torch.utils import profiling
    from gp_compressor_tpu_torch.workloads import compressor, mapping

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
    check(steps == MAP_STEPS_JAX, f"[8] ray steps {steps} != {MAP_STEPS_JAX}")

    # ---- calibration on scan 0, held to the JAX anchor
    t0 = time.perf_counter()
    _, kpc, s20c, _ = compressor.compress_decompress_calibrated(
        *scans[0], ccfg, calib_patches=32, calib_points=64, calib_steps=150,
        calib_lr=0.1, calib_starts=4)
    torch.cuda.synchronize()
    cal_wall = time.perf_counter() - t0
    hp = [float(kpc.sigmaf_sq), float(kpc.l_sq), float(s20c)]
    eps_c = ccfg.depth_gp.eps_tol * hp[0] / ccfg.depth_gp.sigmaf_sq
    say(f"[8] calibration on scan 0 on {kind} ({card}): sigmaf_sq {hp[0]:.6g}"
        f" l_sq {hp[1]:.6g} s20 {hp[2]:.6g} eps_c {eps_c:.6g} (JAX anchor "
        f"{MAP_CAL_JAX}); wall {cal_wall:.4f} s (first call)")
    for label, v, a in zip(("sigmaf_sq", "l_sq", "s20"), hp, MAP_CAL_JAX):
        check(math.isfinite(v) and abs(math.log(v / a)) <= 0.1,
              f"[8] {label} {v} not within 0.1 of the JAX anchor {a} in log "
              "space")

    # ---- the stream at the anchor's own hyperparameters
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    kp = RBFParams(sigmaf_sq=t(MAP_CAL_JAX[0]), l_sq=t(MAP_CAL_JAX[1]))
    calib = dict(depth_kp=kp, depth_s20=t(MAP_CAL_JAX[2]),
                 depth_eps=ccfg.depth_gp.eps_tol * kp.sigmaf_sq
                 / ccfg.depth_gp.sigmaf_sq)
    state0 = mapping.map_init(ccfg, mcfg, lo, hi, device=dev)
    seed, _, _, info_seed = mapping.add_cloud_fused(
        state0, *scans[0], ccfg, mcfg, rcfg=rcfg, **calib)
    stream = [scans[(1 + s) % 2] for s in range(MAP_SCANS)]
    SP, SC, SV = ([s[j] for s in stream] for j in range(3))

    def run():
        r = mapping.add_clouds(seed, SP, SC, SV, ccfg, mcfg, rcfg=rcfg,
                               **calib)
        torch.cuda.synchronize()
        return r

    # the warm-up captures the first stream insert's main-bank inputs
    captured = []
    launch_fn = sogp_train.add_points_batch_cuda

    def spy(kp_, gcfg, states, X, Y, mask, s20=None, eps_tol=None,
            geom=None):
        if len(captured) < 2:
            captured.append((kp_, gcfg, states, X, Y, mask, s20, eps_tol))
        return launch_fn(kp_, gcfg, states, X, Y, mask, s20=s20,
                         eps_tol=eps_tol, geom=geom)

    sogp_train.add_points_batch_cuda = spy
    try:
        run()
    finally:
        sogp_train.add_points_batch_cuda = launch_fn
    l0 = counted("sogp_train.launches")
    walls = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        st, dvg, reg_steps, info = run()
        walls.append(time.perf_counter() - t0)
    launches = counted("sogp_train.launches") - l0
    wall = sorted(walls)[len(walls) // 2]
    n_scans = TIMED_RUNS * MAP_SCANS
    check(launches > 0, "[8] the stream launched no training kernel")
    drops = {k: int(v.sum()) + int(info_seed[k]) for k, v in info.items()}
    mpts, _, mok = mapping.map_cloud(st, ccfg, depth_kp=kp,
                                     depth_s20=calib["depth_s20"])
    mp = mpts[mok].cpu().numpy()
    finite = np.isfinite(mp).all(axis=1)
    ref = np.concatenate([s[0].cpu().numpy() for s in scans])
    d, _ = cKDTree(ref).query(mp[finite], k=1)
    rmse = float(np.sqrt(np.mean(d ** 2)))
    n_patches = int(st.n_patches)
    res8 = {"scans_per_s_median": MAP_SCANS / wall, "walls_s": walls,
            "n_patches": n_patches, "n_patches_seed": int(seed.n_patches),
            "ray_steps": steps, "reg_steps": reg_steps.tolist(),
            "diverged": dvg.tolist(), "map_rmse_m": rmse,
            "map_points": int(mp.shape[0]),
            "map_points_nonfinite": int((~finite).sum()), **drops,
            "kernel_launches_per_scan": launches / n_scans}
    say(f"[8] mapping stream on {kind} ({card}): {json.dumps(res8)}")
    check(abs(n_patches - MAP_PATCHES_JAX) <= 0.01 * MAP_PATCHES_JAX,
          f"[8] n_patches {n_patches} not within 1% of {MAP_PATCHES_JAX}")
    check(rmse <= MAP_RMSE_MAX and abs(rmse - MAP_RMSE_JAX)
          <= 0.05 * MAP_RMSE_JAX, f"[8] map RMSE {rmse} above "
          f"{MAP_RMSE_MAX} or not within 5% of the JAX anchor {MAP_RMSE_JAX}")
    check(res8["map_points_nonfinite"] == 0, "[8] non-finite map points")
    check(all(v == 0 for v in drops.values()), f"[8] drops {drops}")
    check(not any(res8["diverged"]), "[8] a scan diverged")

    # ---- the kernel at its second call site: the first stream insert's
    # main banks, trained from the map's (non-empty) states
    check(len(captured) == 2, "[8] main-bank inputs not captured")
    for kp_, gcfg, states, X, Y, mask, s20, eps in captured:
        res, stats = kernel_at_site(kp_, gcfg, states, X, Y, mask, s20, eps,
                                    dev)
        say(f"[8] kernel at the mapping call site, main bank D={gcfg.dout} "
            f"on {kind} ({card}): {json.dumps(res)}; {json.dumps(stats)}")

    # ---- one insert's stage split: the host wall of each stage's span
    # (spans do not synchronise: the host's queueing and its reads)
    profiling.take()
    profiling.tracing(True)
    try:
        mapping.add_cloud_fused(seed, *stream[0], ccfg, mcfg, rcfg=rcfg,
                                **calib)
    finally:
        profiling.tracing(False)
    torch.cuda.synchronize()
    split = {r.name: r.end - r.start for r in profiling.take()
             if r.name.startswith("map.")}
    say(f"[8] stages of one stream scan (s, host wall of each span, "
        f"unsynchronised) on {kind} ({card}): {json.dumps(split)}; sum "
        f"{sum(split.values()):.4f} s")
    _, n_sync, where = count_syncs(run)
    say(f"[8] synchronising CUDA calls in one add_clouds of {MAP_SCANS} "
        f"scans: {n_sync} ({n_sync / MAP_SCANS:.2f} per scan), from "
        f"{json.dumps(where)}")
    prof = profile_summary(lambda: mapping.add_cloud_fused(
        seed, *stream[0], ccfg, mcfg, rcfg=rcfg, **calib), wall / MAP_SCANS)
    say(f"[8] one stream scan profiled on {kind} ({card}): "
        f"{json.dumps(prof)}")


    # ---- the occupancy channel on the final map
    t0 = time.perf_counter()
    occ = mapping.train_occupancy(st, ccfg)
    torch.cuda.synchronize()
    occ_wall = time.perf_counter() - t0
    B, G = st.W.shape
    grid = patches.prediction_grid(ccfg.patch, torch.float32, dev)
    t0 = time.perf_counter()
    p = mapping.predict_occupancy(occ, ccfg, grid.expand(B, G, 2))
    torch.cuda.synchronize()
    pred_wall = time.perf_counter() - t0
    created = st.created[:, None]
    hit = st.W & ~st.free & created
    carved = st.free & ~st.W & created
    p_hit, p_carved = float(p[hit].mean()), float(p[carved].mean())
    say(f"[8] occupancy on {kind} ({card}): train_occupancy {occ_wall:.4f} s, "
        f"predict_occupancy {pred_wall:.4f} s; mean P(occupied) on "
        f"{int(hit.sum())} hit cells {p_hit:.4f}, on {int(carved.sum())} "
        f"carved cells {p_carved:.4f}")
    check(p_hit > p_carved + 0.1, f"[8] occupancy hit {p_hit} not above "
                                  f"carved {p_carved} + 0.1")
    return seed, kp, calib["depth_s20"], scans, rcfg


def nuts_row(samples, acc, eps, wall, cfg, seed) -> dict:
    """One NUTS run's numbers, with the nuts.* counts of that run."""
    from gp_compressor_tpu_torch.inference import hmc, nuts

    c = nuts_counts()
    n_steps = cfg.num_warmup + cfg.num_samples
    ess = hmc.effective_sample_size(samples)
    s = samples.double().reshape(-1, 3)
    check(c["reads"] <= math.ceil(c["iterations"] / nuts.BLOCK),
          f"[9] NUTS: {c['reads']} reads in {c['iterations']} iterations")
    return {
        "chains": cfg.num_chains, "seed": seed, "warmup": cfg.num_warmup,
        "samples": cfg.num_samples, "wall_s": wall,
        "samples_per_s": cfg.num_chains * cfg.num_samples / wall,
        "accept": float(acc.mean()),
        "max_rhat": float(hmc.split_rhat(samples).max()),
        "ess": ess.tolist(), "min_ess_per_s": float(ess.min()) / wall,
        "theta_mean": s.mean(0).tolist(), "theta_std": s.std(0).tolist(),
        "chain_means": samples.double().mean(1).tolist(),
        "step_size": eps.tolist(),
        "leapfrogs_per_transition": float(c["leapfrogs"]) / c["transitions"],
        "lockstep_iterations_per_transition": c["iterations"] / n_steps,
        "reads_per_transition": c["reads"] / n_steps,
        "step_size_search_reads": c["find_reads"]}


def nuts_rows(logpost, dev, kind, card):
    """The 4- and 16-chain NUTS rows (bench.py:373-433) with their guards.
    Returns the 4-chain run's (last draws [4, 3], step sizes [4])."""
    from gp_compressor_tpu_torch.config import HMCConfig
    from gp_compressor_tpu_torch.inference import nuts

    theta0 = torch.tensor([math.log(100.0), 0.0, math.log(0.1)], device=dev)
    out = None
    for C, seed in ((4, 7), (16, 8)):
        cfg = HMCConfig(num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES[C],
                        num_chains=C)
        g = torch.Generator(device=dev).manual_seed(seed)
        th0 = theta0 + 0.2 * torch.randn((C, 3), generator=g, device=dev)
        reset_counters()
        (samples, acc, eps), wall = timed(lambda: nuts.nuts_sample_chains(
            logpost, th0, cfg, generator=g))
        r = nuts_row(samples, acc, eps, wall, cfg, seed)
        say(f"[9] NUTS {C} chains on {kind} ({card}): {json.dumps(r)}")
        if C == 4:
            out = samples[:, -1], eps
        a = NUTS_JAX[C]
        # the posterior means agree within 5 combined Monte Carlo standard
        # errors (std / sqrt(ESS) of each run): a chance failure is < 1e-6
        # per dimension
        for d in range(3):
            tol = 5.0 * math.sqrt(a["std"][d] ** 2 / a["ess"][d]
                                  + r["theta_std"][d] ** 2 / r["ess"][d])
            check(abs(r["theta_mean"][d] - a["mean"][d]) <= tol,
                  f"[9] NUTS {C}: theta[{d}] mean {r['theta_mean'][d]} not "
                  f"within {tol} of the JAX anchor's {a['mean'][d]}")
        # dual averaging aims at 0.8; 50 warmup steps leave it above (the
        # anchor: 0.93)
        check(0.6 <= r["accept"] <= 0.99, f"[9] NUTS {C}: accept "
              f"{r['accept']} outside [0.6, 0.99]")
        # 50 warmup transitions from the reference constants leave a chain
        # in transit now and then (the JAX package's 16-chain runs: two of
        # nine above 1.1, at 1.23 and 1.27): the R-hat against 1.1 or the
        # worst of the JAX package's runs
        worst = max((a["max_rhat"],) + (NUTS16_RHAT_JAX if C == 16 else ()))
        check(r["max_rhat"] <= max(1.1, worst),
              f"[9] NUTS {C}: max split-R-hat {r['max_rhat']}")
    # the reads are the only synchronising calls of a transition
    theta, eps = out
    reset_counters()
    _, n_sync, where = count_syncs(lambda: nuts.nuts_step(
        logpost, theta, eps, torch.ones_like(theta), generator=g))
    c = nuts_counts()
    say(f"[9] one NUTS transition of 4 chains: {n_sync} synchronising calls "
        f"({json.dumps(where)}), {c['reads']} stop-flag reads in "
        f"{c['iterations']} lockstep leapfrogs (block {nuts.BLOCK})")
    check(n_sync == c["reads"], "[9] a NUTS transition "
          "synchronised outside its stop-flag reads")
    step = lambda: nuts.nuts_step(logpost, theta, eps, torch.ones_like(theta),
                                  generator=g)
    reset_counters()
    _, w = timed(step)
    it = nuts_counts()["iterations"]
    reset_counters()
    prof = profile_summary(step, w)
    prof["lockstep_iterations"] = nuts_counts()["iterations"]
    prof["kernels_per_iteration"] = prof["device_kernels"] / max(
        prof["lockstep_iterations"], 1)
    say(f"[9] one NUTS transition of 4 chains profiled on {kind} ({card}), "
        f"unprofiled wall {w * 1e3:.2f} ms for {it} iterations: "
        f"{json.dumps(prof)}")
    return out


def bayes_phase(pts, cols, valid, ccfg, comp, smc_ctx, dev, kind, card):
    """Phase 9: the Bayesian rows with their guards, and the card against
    the CPU with the same draws."""
    from gp_compressor_tpu_torch.config import SMCConfig
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.inference import hmc, vi
    from gp_compressor_tpu_torch.testing import bayes_case
    from gp_compressor_tpu_torch.workloads import (compressor, mapping,
                                                   registration)

    t_phase = time.perf_counter()
    walls = {}
    Xc, yc, mc = compressor.calib_subsample(comp.patch, 16, 48)
    logpost = hmc.make_patch_logpost(Xc, yc, mc.to(Xc.dtype))
    t0 = time.perf_counter()
    theta_last, eps = nuts_rows(logpost, dev, kind, card)
    walls["nuts"] = time.perf_counter() - t0

    # ---- ADVI from the multi-start MAP mode
    theta0 = torch.tensor([math.log(100.0), 0.0, math.log(0.1)], device=dev)
    theta_map, _ = hmc.map_estimate_multi(logpost, theta0, steps=150, lr=0.1,
                                          n_starts=4)
    g = torch.Generator(device=dev).manual_seed(3)
    res, wall = timed(lambda: vi.fit_advi(logpost, theta_map,
                                          steps=ADVI_STEPS, generator=g))
    plateaued = bool(vi.elbo_plateaued(res.elbo_trace))
    mean = res.mean.tolist()
    row = {"steps": ADVI_STEPS, "wall_s": wall,
           "steps_per_s": ADVI_STEPS / wall, "plateaued": plateaued,
           "mean": mean, "log_std": res.log_std.tolist(),
           "mode_sigmaf_sq": math.exp(mean[0]), "mode_l_sq": math.exp(mean[1]),
           "final_elbo": float(res.elbo_trace[-20:].mean()),
           "map_theta": theta_map.tolist()}
    say(f"[9] ADVI on {kind} ({card}): {json.dumps(row)}")
    check(plateaued == ADVI_JAX["plateaued"], "[9] ADVI plateau differs "
          "from the JAX anchor's")
    # Adam at lr 0.05 on an 8-sample ELBO gradient jitters the mean by a
    # few hundredths; 0.15 is ~2 posterior std on the tightest axis
    check(all(abs(m - a) <= 0.15 for m, a in zip(mean, ADVI_JAX["mean"])),
          f"[9] ADVI mean {mean} not within 0.15 of {ADVI_JAX['mean']}")

    # ---- the HMC-calibrated compress, its HMC timed inside the call
    hmc_walls, sample_chains = [], hmc.hmc_sample_chains

    def timed_hmc(*a, **k):
        r, w = timed(lambda: sample_chains(*a, **k))
        hmc_walls.append(w)
        return r

    n0 = counted("sogp_train.launches")
    hmc.hmc_sample_chains = timed_hmc
    try:
        (comp_h, kph, s20h, cal), wall = timed(
            lambda: compressor.compress_calibrated(
                pts, cols, valid, ccfg, method="hmc",
                calib_steps=HMC_CAL_STEPS))
    finally:
        hmc.hmc_sample_chains = sample_chains
    launches = counted("sogp_train.launches") - n0
    hp = [float(kph.sigmaf_sq), float(kph.l_sq), s20h]
    rmse = float(compressor.reconstruction_rmse(comp_h, cal, depth_kp=kph,
                                                depth_s20=s20h))
    row = {"calib_steps": HMC_CAL_STEPS, "sigmaf_sq": hp[0], "l_sq": hp[1],
           "s20": hp[2], "rmse_m": rmse, "kernel_launches": launches,
           "wall_s": wall, "hmc_wall_s": hmc_walls[0],
           "hmc_share": hmc_walls[0] / wall,
           "chain_leapfrogs": 2 * 2 * HMC_CAL_STEPS * 16}
    walls["hmc_calibrated"] = wall
    say(f"[9] compress_calibrated(method='hmc') on {kind} ({card}): "
        f"{json.dumps(row)} (JAX anchor {HMC_CAL_JAX})")
    check(launches == 2, f"[9] {launches} kernel launches, expected 2")
    check(hp[0] < 10.0 and hp[2] < 0.1, f"[9] calibrated values {hp} at the "
          "reference scale")
    # the port calibrates in float64 (compress_calibrated's default), the
    # anchor is JAX's float32 run: both at the cm-scale mode, where the
    # posterior mean of 2 chains x 400 draws has a Monte Carlo error of a
    # few hundredths in log space; 0.3 leaves room for a slow chain
    for label, v, a in zip(("sigmaf_sq", "l_sq", "s20"), hp, HMC_CAL_JAX):
        check(math.isfinite(v) and abs(math.log(v / a)) <= 0.3,
              f"[9] {label} {v} not within 0.3 of the JAX anchor {a} in log "
              "space")
    check(rmse <= RMSE_MAX, f"[9] HMC-calibrated RMSE {rmse} above "
          f"{RMSE_MAX}")
    # one warmup and one sampling step (32 batched leapfrogs) profiled
    from gp_compressor_tpu_torch.config import HMCConfig
    lp, th0 = compressor._calib_logpost(compressor.project(
        pts, cols, valid, ccfg), ccfg, 32, 64, torch.float64)
    two = HMCConfig(num_warmup=1, num_samples=1, num_chains=2)
    run2 = lambda: hmc.hmc_sample_chains(lp, torch.stack([th0, th0 + 0.3]),
                                         two, generator=g)
    _, w = timed(run2)
    prof = profile_summary(run2, w)
    prof["kernels_per_leapfrog"] = prof["device_kernels"] / 32
    say(f"[9] two HMC steps (32 leapfrogs of 2 chains on the 32 x 64 bank) "
        f"profiled on {kind} ({card}), unprofiled wall {w * 1e3:.2f} ms: "
        f"{json.dumps(prof)}")

    # ---- SMC pose refinement against phase 8's seed map
    seed, kp, s20, scans, rcfg = smc_ctx
    scan = scans[1]
    R_true = transforms.euler_xyz(torch.tensor(SMC_ANG, device=dev))
    moved = transforms.apply(scan[0], R_true, torch.tensor(SMC_T, device=dev))
    err = lambda p: float(torch.linalg.norm(p - scan[0], dim=1).mean())
    rst, out_reg = registration.register(
        mapping._map_as_compressed(seed, ccfg), moved, scan[1], scan[2], ccfg,
        rcfg, depth_kp=kp, depth_s20=s20)
    scfg = SMCConfig(num_particles=SMC_PARTICLES, pose_proposal_std_t=0.012,
                     pose_proposal_std_r=0.004)

    def refine(g):
        return mapping.smc_refine_pose(seed, out_reg, scan[1], scan[2], ccfg,
                                       scfg, n_iters=SMC_ITERS, depth_kp=kp,
                                       depth_s20=s20, generator=g)

    smc_walls, errs = [], []
    for k in range(SMC_RUNS):
        ((R2, t2), _, trace), w = timed(lambda: refine(
            torch.Generator(device=dev).manual_seed(4 + k)))
        smc_walls.append(w)
        errs.append(err(transforms.apply(out_reg, R2, t2)))
    g = torch.Generator(device=dev).manual_seed(7)
    _, n_sync, where = count_syncs(lambda: refine(g))
    wall = sorted(smc_walls)[len(smc_walls) // 2]
    row = {"particles": SMC_PARTICLES, "iters": SMC_ITERS,
           "walls_s": smc_walls,
           "particles_per_s": SMC_PARTICLES * SMC_ITERS / wall,
           "injected_err_m": err(moved), "after_reg_budget_err_m": err(out_reg),
           "reg_steps": int(rst.step_nbr), "after_smc_err_m": errs,
           "synchronising_calls_in_smc_refine_pose": n_sync,
           "n_patches_seed": int(seed.n_patches)}
    say(f"[9] SMC on {kind} ({card}): {json.dumps(row)} (JAX anchor "
        f"{json.dumps(SMC_JAX)})")
    check(n_sync == 0, f"[9] smc_refine_pose synchronised: {where}")
    check(abs(row["injected_err_m"] - SMC_JAX["injected"])
          <= 1e-3 * SMC_JAX["injected"], "[9] injected error differs")
    check(abs(row["after_reg_budget_err_m"] - SMC_JAX["after_reg"])
          <= 0.1 * SMC_JAX["after_reg"], "[9] error after the registration "
          "budget not within 10% of the JAX anchor's")
    check(max(errs) < row["after_reg_budget_err_m"], "[9] SMC did not "
          "reduce the error left by the registration budget")
    # the runs' means agree within 4 standard errors of the difference of
    # two 3-run means (each run's spread from its own sample), at least 2 mm
    sa = float(torch.tensor(SMC_JAX["after_smc"]).double().std())
    sp = float(torch.tensor(errs).double().std())
    tol = max(4.0 * math.sqrt((sa ** 2 + sp ** 2) / SMC_RUNS), 2e-3)
    ma = sum(SMC_JAX["after_smc"]) / SMC_RUNS
    check(abs(sum(errs) / SMC_RUNS - ma) <= tol, f"[9] SMC error {errs} not "
          f"within {tol} of the JAX anchor's mean {ma}")

    # ---- the card against the CPU, float64, the same draws
    t0 = time.perf_counter()
    par = bayes_case.device_parity(Xc, yc, mc.to(Xc.dtype), theta_last, dev,
                                   eps=float(eps.mean()), advi_steps=5)
    par.update(bayes_case.smc_parity(seed, out_reg, scan[1], scan[2], ccfg,
                                     dev, depth_kp=kp, depth_s20=s20))
    say(f"[9] card against CPU, float64, same draws "
        f"({time.perf_counter() - t0:.2f} s): {json.dumps(par)}")
    check(par["nuts_leapfrogs_cpu"] == par["nuts_leapfrogs_device"],
          "[9] NUTS leapfrog counts differ between the card and the CPU")
    for k in ("nuts_theta", "nuts_accept", "hmc", "advi", "smc_pose",
              "smc_particles"):
        check(par[k] <= 1e-9, f"[9] {k}: card and CPU differ by {par[k]}")
    walls["phase"] = time.perf_counter() - t_phase
    say(f"[9] phase walls (s): {json.dumps(walls)}")


def ksvd_split(S, W, valid, cfg, draws):
    """One dictionary.ksvd call with its stages wrapped in synchronised
    timers: ({stage: host wall s summed over its calls}, iters, final
    masked MSE). "rest" is the call's wall less its stages: the usage
    counts, the stop reads and the host loop."""
    from gp_compressor_tpu_torch.models import dictionary as dc

    stages = {"omp_encode": "omp_encode", "_atom_sweep": "atom_sweep",
              "masked_error": "masked_error",
              "_replace_unused": "replace_unused"}
    st = dict.fromkeys(stages.values(), 0.0)
    orig = {f: getattr(dc, f) for f in stages}

    def wrap(f):
        def timed_stage(*a, **k):
            r, w = timed(lambda: orig[f](*a, **k))
            st[stages[f]] += w
            return r
        return timed_stage

    for f in stages:
        setattr(dc, f, wrap(f))
    try:
        res, wall = timed(lambda: dc.ksvd(S, W, valid, cfg, draws=draws))
    finally:
        for f, fn in orig.items():
            setattr(dc, f, fn)
    st["rest"] = wall - sum(st.values())
    return st, res.iters, float(res.error)


BLOCK_TOL = 1e-5       # float32 kernel vs plain, share of an output's largest


def ksvd_block_run(pts, cols, valid, ccfg, dev, seed, keep=0):
    """One K-SVD compress of the cloud in float32 (as configured) with each
    atom block's kernel launch (cuda_kernels/ksvd_power.py) held to the
    dense plain version on the same inputs. Per problem (depth, rgb):
    each launch's users, its largest gap (u and x_new, finite entries, as
    a share of the output's largest; None when the non-finite entries
    differ), card ms of the launch with its max |R| reduction and of the
    plain version (CUDA events, one call each after a device sleep), and
    its bytes bound (each user row of R and W, x_j, using and the outputs
    once, at 3.35 TB/s); the users of every atom; and, with keep > 0, the
    inputs of its first `keep` blocks. Also the block launches and atom
    blocks the compress counted."""
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    real = dictionary._block_update
    per = {k: {"users": [], "gap": [], "ms": [], "plain_ms": [],
               "bound_ms": [], "atom_users": [], "kept": []}
           for k in ("depth", "rgb")}

    def gap(got, want):
        out = 0.0
        for g, w in zip(got, want):
            fin = torch.isfinite(w)
            if not torch.equal(torch.isfinite(g), fin):
                return None
            if fin.any():
                scale = max(float(w[fin].abs().max()), 1e-30)
                out = max(out, float((g[fin] - w[fin]).abs().max()) / scale)
        return out

    def both(R, W, dj, xj, using, iters):
        p = per["depth" if R.shape[0] == ccfg.patch.max_patches else "rgb"]
        got, want = [], []
        p["ms"].append(event_ms(lambda: got.append(
            real(R, W, dj, xj, using, iters)), 1))
        p["plain_ms"].append(event_ms(lambda: want.append(
            dictionary._block_update_plain(R, W, dj, xj, using, iters)), 1))
        p["gap"].append(gap(got[0], want[0]))
        users = using.sum(1).cpu()
        p["atom_users"].append(users)
        (b, n), l = xj.shape, R.shape[1]
        cnt = int(users.sum())
        nbytes = R.element_size() * (2 * cnt * l + b * n + b * (l + n)) \
            + b * n
        p["users"].append(cnt)
        p["bound_ms"].append(nbytes / 3.35e12 * 1e3)
        if len(p["kept"]) < keep:
            p["kept"].append(tuple(t.clone() for t in (R, W, dj, xj, using)))
        return got[0]

    k0, b0 = counted("ksvd.block_kernels"), counted("ksvd.atom_blocks")
    dictionary._block_update = both
    try:
        comp = kc.compress(pts, cols, valid, ccfg, generator=torch.Generator(
            device=dev).manual_seed(seed))
        torch.cuda.synchronize()
    finally:
        dictionary._block_update = real
    per["launches"] = counted("ksvd.block_kernels") - k0
    per["atom_blocks"] = counted("ksvd.atom_blocks") - b0
    per["patch_rows"] = int(comp.raster.n_leaves)
    return per


def block_summary(p, patch_rows):
    """The printable summary of one problem of ksvd_block_run: mean and
    max of each per-launch list, users per atom in quantiles."""
    import numpy as np

    u = torch.cat(p["atom_users"]).double().numpy()
    res = {"launches": len(p["ms"]), "patch_rows": patch_rows,
           "users_per_atom": {q: float(np.quantile(u, f)) for q, f in (
               ("min", 0), ("p10", .1), ("p50", .5), ("p90", .9),
               ("p99", .99), ("max", 1))},
           "mean_user_share_of_rows": float(u.mean() / patch_rows),
           "atoms_without_users": int((u == 0).sum()),
           "gap_max": max((g for g in p["gap"] if g is not None),
                          default=0.0),
           "gaps_nonfinite_differ": sum(g is None for g in p["gap"])}
    for f in ("users", "ms", "plain_ms", "bound_ms"):
        res[f] = {"mean": sum(p[f]) / len(p[f]), "max": max(p[f])}
    res["share_of_bound"] = res["bound_ms"]["mean"] / res["ms"]["mean"]
    return res


def ksvd_phase(pts, cols, valid, ccfg, dev, kind, card):
    """Phase 10: the K-SVD row of bench.py:779-822 with its guards, the
    stage split, one profiled depth sweep, the artifact on the card, one
    sweep on the card against the CPU in float64, and one compress with
    every atom block's kernel launch held to the plain version in float32.
    Returns the block kernel's entry of the `kernels` line."""
    import numpy as np

    from gp_compressor_tpu_torch.cuda_kernels import nvcc
    from gp_compressor_tpu_torch.geometry import patches
    from gp_compressor_tpu_torch.io import artifact
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.testing import ksvd_case
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    t_phase = time.perf_counter()

    def run(seed):
        r0 = counted("ksvd.reads")
        k0, b0 = counted("ksvd.block_kernels"), counted("ksvd.atom_blocks")
        comp = kc.compress(pts, cols, valid, ccfg, generator=torch.Generator(
            device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        # one block kernel launch per block of atoms
        check(counted("ksvd.block_kernels") - k0
              == counted("ksvd.atom_blocks") - b0 > 0,
              "[10] block kernel launches differ from the atom blocks")
        return comp, counted("ksvd.reads") - r0

    run(0)                                                 # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    l0 = counted("sogp_train.launches")
    rows = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        comp, reads = run(seed)
        wall = time.perf_counter() - t0
        n, B = int(comp.raster.n_leaves), comp.raster.S.shape[0]
        rows.append({
            "seed": seed, "wall_s": wall, "points_per_s": N_POINTS / wall,
            "rms_m": kc.rms_error(comp), "depth_mse": float(comp.depth.error),
            "rgb_mse": float(comp.rgb.error),
            "depth_iters": comp.depth.iters, "rgb_iters": comp.rgb.iters,
            "depth_mean_words": float(comp.depth.code.nw[:n].double().mean()),
            "rgb_mean_words": float(comp.rgb.code.nw.reshape(3, B)[:, :n]
                                    .double().mean()),
            "stop_reads": reads})
        if seed == 1:
            comp1 = comp
    peak = torch.cuda.max_memory_allocated(dev)
    best = min(r["wall_s"] for r in rows)
    say(f"[10] K-SVD compress on {kind} ({card}): best {best:.4f} s = "
        f"{N_POINTS / best:.1f} points/s; peak memory {peak} B; runs "
        f"{json.dumps(rows)}")
    check(counted("sogp_train.launches") == l0,
          "[10] the K-SVD path launched the training kernel")
    rng = KSVD_JAX["range"]
    for r in rows:
        # each sweep's stop test is the one read: iters per ksvd call
        check(r["stop_reads"] == r["depth_iters"] + r["rgb_iters"],
              f"[10] {r['stop_reads']} stop reads for {r['depth_iters']} + "
              f"{r['rgb_iters']} sweeps")
        for f in ("rms", "depth_mse"):
            v = r["rms_m" if f == "rms" else f]
            check(0.95 * rng[f][0] <= v <= 1.05 * rng[f][1],
                  f"[10] {f} {v} outside the JAX anchors' {rng[f]} +- 5%")
        for f in ("depth_iters", "rgb_iters"):
            check(rng[f][0] - 2 <= r[f] <= rng[f][1] + 2,
                  f"[10] {f} {r[f]} outside the JAX anchors' {rng[f]} +- 2")

    # ---- the stage split of seed 1's compress: its raster (the raster's
    # sums are atomic, so a rebuilt one may differ in the last bit) and
    # the same draws
    _, t_raster = timed(lambda: patches.build_raster_patches(
        pts, cols, valid, ccfg.patch))
    raster = comp1.raster
    B = raster.S.shape[0]
    pvalid = torch.arange(B, device=dev) < raster.n_leaves
    g = torch.Generator(device=dev).manual_seed(1)
    problems = {"depth": (raster.S, raster.W.to(raster.S.dtype), pvalid,
                          ccfg.ksvd),
                "rgb": kc.rgb_problem(raster, pvalid) + (ccfg.rgb_ksvd,)}
    split = {"raster_s": t_raster}
    draws = {}
    for name, (S, W, v, cfg) in problems.items():
        draws[name] = dictionary.draw_ksvd(v, cfg, g)
        st, iters, err = ksvd_split(S, W, v, cfg, draws[name])
        ref = getattr(comp1, name)
        check(iters == ref.iters and abs(err - float(ref.error))
              <= 1e-4 * abs(float(ref.error)),
              f"[10] the {name} split ({iters} sweeps, MSE {err}) differs "
              f"from the compress ({ref.iters}, {float(ref.error)})")
        split[name] = dict(st, sweeps=iters)
    say(f"[10] stage split (host wall s of one ksvd call, synchronised "
        f"around each stage, summed over its calls) on {kind} ({card}): "
        f"{json.dumps(split)}")

    # ---- one depth sweep under torch.profiler
    S, W, v, cfg = problems["depth"]
    dd = draws["depth"]
    D0 = dictionary._replace_unused(
        torch.zeros((S.shape[1], cfg.dict_size), dtype=S.dtype, device=dev),
        torch.zeros(cfg.dict_size, dtype=torch.int64, device=dev), S,
        dd.init)
    sweep = lambda: dictionary._ksvd_sweep(D0, dd.sweeps[0], S, W, v, cfg)
    _, sweep_wall = timed(sweep)
    res = profile_summary(sweep, sweep_wall)
    say(f"[10] one depth sweep (B=2048 G=400 K=200, atom_block 16) profiled "
        f"on {kind} ({card}): unprofiled wall {sweep_wall:.4f} s; "
        f"{json.dumps(res)}")

    # ---- the artifact: write, read back, decompress on the host
    base = nvcc.BUILD_DIR.parent / "chip_smoke" / "ksvd"
    base.parent.mkdir(parents=True, exist_ok=True)
    art, t_art = timed(lambda: kc.to_artifact(comp1))
    t0 = time.perf_counter()
    artifact.write(str(base), art)
    back = artifact.read(str(base))
    pts2, _ = kc.decompress_artifact(back)
    t_file = time.perf_counter() - t0
    # both emit the occupied cells patch by patch, in cell order
    w, _, ok = kc.decompress(comp1)
    w = w[ok].cpu().numpy()
    gap = float(np.abs(pts2 - w).max()) if pts2.shape == w.shape \
        else math.inf
    sizes = {s: (base.parent / (base.name + s)).stat().st_size
             for s in (".pccode", "depth.pcdict", "rgb.pcdict")}
    say(f"[10] artifact on {kind} ({card}): to_artifact {t_art:.4f} s, write "
        f"+ read + host decompress {t_file:.4f} s, {w.shape[0]} points, "
        f"bytes {json.dumps(sizes)}, max |file - in-memory| {gap:.3g} m")
    check(gap <= 1e-4, f"[10] the artifact's points differ from the "
                       f"in-memory decompress by {gap} m")

    # ---- the card against the CPU, float64, the same draws
    t0 = time.perf_counter()
    par = ksvd_case.sweep_parity(raster.S[:512], raster.W[:512],
                                 pvalid[:512], ccfg.ksvd, dev)
    say(f"[10] one depth sweep, 512 patches, card against CPU, float64, "
        f"same draws ({time.perf_counter() - t0:.2f} s on {kind} ({card})): "
        f"{json.dumps(par)}")
    check(par["indices_equal"], "[10] atom indices differ between the card "
                                "and the CPU")
    for k in ("omp_X", "sweep_D", "sweep_X", "sweep_err"):
        check(par[k] <= 1e-9, f"[10] {k}: card and CPU differ by {par[k]}")

    # ---- the block kernel against the plain version, float32, every
    # atom block of one bench compress (depth n 2,048 and colour n 6,144)
    t0 = time.perf_counter()
    blk = ksvd_block_run(pts, cols, valid, ccfg, dev, seed=3)
    n_rows = blk["patch_rows"]
    summ = {k: block_summary(blk[k], n_rows * (3 if k == "rgb" else 1))
            for k in ("depth", "rgb")}
    say(f"[10] block kernel vs plain version, float32, every atom block of "
        f"one compress ({time.perf_counter() - t0:.2f} s on {kind} "
        f"({card})): {blk['launches']} launches for {blk['atom_blocks']} "
        f"atom blocks; {json.dumps(summ)}")
    check(blk["launches"] == blk["atom_blocks"]
          == sum(s["launches"] for s in summ.values()) > 0,
          "[10] block kernel launches differ from the atom blocks")
    for k, s in summ.items():
        check(s["launches"] > 0, f"[10] no {k} atom block ran")
        check(s["gaps_nonfinite_differ"] == 0,
              f"[10] {k}: the kernel's non-finite entries differ from the "
              f"plain version's in {s['gaps_nonfinite_differ']} blocks")
        check(s["gap_max"] <= BLOCK_TOL,
              f"[10] {k}: the kernel differs from the plain version by "
              f"{s['gap_max']} of an output's largest value")
    say(f"[10] phase wall {time.perf_counter() - t_phase:.2f} s on {kind} "
        f"({card})")
    launches = blk["launches"]
    mean = lambda f: sum(sum(blk[k][f]) for k in ("depth", "rgb")) / launches
    return {
        "name": "ksvd_power",
        "route": "cuda",
        "source": "gp_compressor_tpu_torch/csrc/ksvd_power.cu",
        # no TPU kernel: the JAX package runs the atom sweep as XLA ops
        "replaces": "gp_compressor_tpu/models/dictionary.py::_atom_sweep",
        "launches": launches,
        "max_rel_err": max(s["gap_max"] for s in summ.values()),
        # per launch, means over the compress's depth and colour blocks
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes",
        # no library call runs a masked power iteration over a row subset;
        # plain_ms is the dense stack through PyTorch's batched GEMVs
        "library_ms": None,
        "depth": {f: summ["depth"][f] for f in (
            "launches", "ms", "plain_ms", "bound_ms", "share_of_bound")},
        "rgb": {f: summ["rgb"][f] for f in (
            "launches", "ms", "plain_ms", "bound_ms", "share_of_bound")},
    }


def icp_accuracy_phase(pts, valid, ccfg, comp_ref, dev, kind, card):
    """Phase 11: ICP on the headline map under phase 7's perturbation, the
    gp-accuracy protocol over ACC_PAIRS pairs (GP register and ICP), held
    to the JAX anchors, then the float32 / float64 MAP calibration over
    four clouds."""
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.workloads import icp, registration

    t_phase = time.perf_counter()
    R_true = transforms.euler_xyz(torch.tensor(PERTURB_ANG, device=dev))
    t_true = torch.tensor(PERTURB_T, device=dev)
    moved = transforms.apply(pts, R_true, t_true)

    def run():
        r = icp.icp_register(comp_ref, moved, valid, ccfg)
        torch.cuda.synchronize()
        return r

    run()                                                   # warm-up
    walls = []
    for _ in range(3):
        r0 = counted("icp.reads")
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    terr, rerr = registration.registration_error(res.R, res.t, R_true,
                                                 t_true)
    final = float(torch.linalg.norm(transforms.apply(moved, res.R, res.t)
                                    - pts, dim=1).mean())
    row = {"iters": res.iters,
           "stop_reads": counted("icp.reads") - r0,
           "trans_err_m": float(terr), "rot_err_rad": float(rerr),
           "initial_mean_err_m": float(torch.linalg.norm(
               moved - pts, dim=1).mean()), "final_mean_err_m": final,
           "rms_residual_m": float(res.rms_residual),
           "n_matched": int(res.n_matched)}
    wall = sorted(walls)[1]
    say(f"[11] ICP on the headline map on {kind} ({card}): walls {walls} s, "
        f"median {wall:.4f} s, {res.iters / wall:.1f} iterations/s; "
        f"{json.dumps(row)}")
    check(row["stop_reads"] == res.iters, "[11] ICP reads more than its "
                                          "stop test per iteration")
    check(abs(res.iters - ICP_JAX["iters"]) <= 2,
          f"[11] ICP iterations {res.iters} not within 2 of JAX's "
          f"{ICP_JAX['iters']}")
    check(final <= max(2 * ICP_JAX["final_mean_err"], 1e-4),
          f"[11] ICP final error {final} above max(2 x JAX's "
          f"{ICP_JAX['final_mean_err']}, 0.1 mm)")

    accuracy_pairs(dev, kind, card)
    map_dtype_check(ccfg, dev, kind, card)
    say(f"[11] phase wall {time.perf_counter() - t_phase:.2f} s on {kind} "
        f"({card})")


def accuracy_pair(seed, dt, dev):
    """gp-accuracy's pair `seed` (cli.py cmd_gp_accuracy) on the card in
    dt: (map points, map colours, the scan's true points, the moved scan,
    its colours, the true R, the true t)."""
    import numpy as np

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


def mean_err(p, q) -> float:
    return float(torch.linalg.norm(p.double() - q.double(), dim=1).mean())


def align_pair(comp, cfg, rcfg, scan, scols, truth, Rt, tt) -> dict:
    """GP register and ICP of one accuracy pair's scan against its map:
    steps, final mean point error, translation and rotation error and
    wall of each, and the map's depth patches holding points that
    sanitize left empty."""
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.workloads import icp, registration

    ones = torch.ones(scan.shape[0], dtype=torch.bool, device=scan.device)
    (st, aligned), t_g = timed(lambda: registration.register(
        comp, scan, scols, ones, cfg, rcfg))
    ires, t_i = timed(lambda: icp.icp_register(comp, scan, ones, cfg))
    gte, gre = registration.registration_error(st.R_cloud, st.t_exact, Rt,
                                               tt)
    ite, ire = registration.registration_error(ires.R, ires.t, Rt, tt)
    used = comp.patch.mask.any(1)
    return {"depth_emptied": int(((sparse_gp.size(comp.depth_gp) == 0)
                                  & used).sum()),
            "gp": {"steps": int(st.step_nbr),
                   "final_mean_err_m": mean_err(aligned, truth),
                   "trans_err_m": float(gte), "rot_err_rad": float(gre),
                   "wall_s": t_g},
            "icp": {"iters": ires.iters, "final_mean_err_m": mean_err(
                transforms.apply(scan, ires.R, ires.t), truth),
                "trans_err_m": float(ite), "rot_err_rad": float(ire),
                "wall_s": t_i}}


def accuracy_pairs(dev, kind, card):
    """The gp-accuracy protocol (cli.py cmd_gp_accuracy) over ACC_PAIRS
    pairs: each pair's map trained by the kernel, as the CLI does, and by
    its plain version as a witness, both aligned by GP register and ICP;
    then ACC_F64_PAIRS pairs with map and registration in float64. Then
    the kernel at 101 slots: strict regimes up to 90 BVs, capacity
    deletions at 100 BVs, and pair 0's banks against its plain version
    with the plain version in float64 as referee, timed."""
    import numpy as np

    from gp_compressor_tpu_torch.config import RegistrationConfig
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.testing import sogp_regimes
    from gp_compressor_tpu_torch.workloads import compressor

    acfg = accuracy_config()
    a64 = accuracy_config(torch.float64)
    rcfg = RegistrationConfig(step=0.005, max_steps=150)
    ones = torch.ones(ACC_POINTS // 2, dtype=torch.bool, device=dev)

    pairs = []
    launches = 0
    t_pairs = time.perf_counter()
    for seed in range(ACC_PAIRS):
        mp, mc, truth, scan, scols, Rt, tt = accuracy_pair(
            seed, torch.float32, dev)
        # compress = project + train: both routes train the same banks
        batch, t_p = timed(lambda: compressor.project(
            mp, mc, ones, acfg,
            generator=torch.Generator(device=dev).manual_seed(seed)))
        if seed == 0:
            batch0 = batch
        pair = {"seed": seed, "initial_mean_err_m": mean_err(scan, truth),
                "project_s": t_p,
                "patches_with_points": int(batch.mask.any(1).sum())}
        for route, use in (("kernel", True), ("plain", False)):
            l0 = counted("sogp_train.launches")
            comp, t_t = timed(lambda: compressor.train(batch, acfg,
                                                       use_kernel=use))
            launches += counted("sogp_train.launches") - l0
            pair[route] = dict(align_pair(comp, acfg, rcfg, scan, scols,
                                          truth, Rt, tt), train_s=t_t)
        pairs.append(pair)
        say(f"[11] accuracy pair on {kind} ({card}): {json.dumps(pair)}")
    t_pairs = time.perf_counter() - t_pairs

    summary = {}
    for route in ("kernel", "plain"):
        for m in ("gp", "icp"):
            rows = [p[route][m] for p in pairs]
            e = [r["final_mean_err_m"] for r in rows]
            summary[f"{route}/{m}"] = {
                "median_final_mean_err_m": float(np.median(e)),
                "worst_final_mean_err_m": float(np.max(e)),
                "median_trans_err_m": float(np.median(
                    [r["trans_err_m"] for r in rows])),
                "median_rot_err_rad": float(np.median(
                    [r["rot_err_rad"] for r in rows]))}
        summary[f"{route}/gp"]["pairs_at_step_cap"] = sum(
            p[route]["gp"]["steps"] == rcfg.max_steps for p in pairs)
        summary[f"{route}/depth_emptied_share"] = sum(
            p[route]["depth_emptied"] for p in pairs) / sum(
            p["patches_with_points"] for p in pairs)
    for m in ("gp", "icp"):
        k, p_ = ([p[r][m]["final_mean_err_m"] for p in pairs]
                 for r in ("kernel", "plain"))
        summary[f"kernel_vs_plain/{m}"] = {
            "pairs_within_10pct": sum(abs(a - b) <= 0.1 * max(a, b)
                                      for a, b in zip(k, p_)),
            "median_abs_gap_m": float(np.median(np.abs(np.subtract(k, p_)))),
            "rank_sum_p": rank_sum_p(k, p_)}
    say(f"[11] accuracy over {ACC_PAIRS} pairs on {kind} ({card}): "
        f"{t_pairs:.2f} s, kernel launches {launches}; "
        f"{json.dumps(summary)}")

    # ---- the float64 witness: map (plain version) and registration in
    # float64 on the first pairs
    f64 = []
    for seed in range(ACC_F64_PAIRS):
        mp, mc, truth, scan, scols, Rt, tt = accuracy_pair(
            seed, torch.float64, dev)
        batch = compressor.project(
            mp, mc, ones, a64,
            generator=torch.Generator(device=dev).manual_seed(seed))
        comp, t_t = timed(lambda: compressor.train(batch, a64,
                                                   use_kernel=False))
        f64.append(dict(align_pair(comp, a64, rcfg, scan, scols, truth, Rt,
                                   tt), seed=seed, train_s=t_t,
                        initial_mean_err_m=mean_err(scan, truth)))
        say(f"[11] float64 accuracy pair on {kind} ({card}): "
            f"{json.dumps(f64[-1])}")

    # ---- the kernel at 101 slots: strict regimes with up to 90 BVs (a
    # lane's slots 1-3 hold BVs), capacity deletions at 100 BVs
    kp_ref = sogp_regimes.params(dev)
    for rows, rule in ((40, "strict"), (96, "strict"), (160, "calibrated")):
        for name in ("strict_d1", "strict_d3"):
            cfg, X, Y, M = (torch.from_numpy(a).to(dev) if i else a
                            for i, a in enumerate(sogp_regimes.regime(
                                name, slots=101, capacity=100,
                                points=rows)))
            init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
            out = sogp_train.add_points_batch_cuda(kp_ref, cfg, init, X, Y,
                                                   M)
            ref = sogp_train.add_points_batch_plain(kp_ref, cfg, init, X, Y,
                                                    M)
            res = sogp_regimes.compare(rule, ref, out, X, Y, M)
            size = sparse_gp.size(ref).double()
            say(f"[11] {name} at 101 slots, capacity 100, {rows} rows "
                f"({rule} rule) on {kind} ({card}): {json.dumps(res)}; BVs "
                f"mean {float(size.mean()):.2f} max {int(size.max())}")

    # ---- the kernel at pair 0's banks against its plain version, the
    # plain version in float64 as referee (sogp_regimes, `arbitrated`)
    dkp, ckp = compressor.default_params(acfg, dev)
    for gcfg, kp, Y in ((acfg.depth_gp, dkp, batch0.y),
                        (acfg.rgb_gp, ckp, batch0.rgb)):
        init = sparse_gp.init_batch(gcfg, batch0.mask.shape[0], device=dev)
        res, stats = kernel_at_site(kp, gcfg, init, batch0.X, Y, batch0.mask,
                                    None, None, dev, rule="arbitrated")
        say(f"[11] kernel at the accuracy banks D={gcfg.dout} (pair 0) on "
            f"{kind} ({card}): {json.dumps(res)}; {json.dumps(stats)}")

    check(launches == 2 * ACC_PAIRS, f"[11] kernel launches {launches}, "
                                     f"expected 2 per pair's kernel map")
    # The witness: the plain version's maps, aligned by the same code, are
    # not told apart from the kernel's as a sample of final errors.
    for m in ("gp", "icp"):
        p_val = summary[f"kernel_vs_plain/{m}"]["rank_sum_p"]
        check(p_val >= 0.01, f"[11] {m}: the kernel's maps and the plain "
                             f"version's give different final errors "
                             f"(rank-sum p {p_val})")
    # In float32 at the reference GP constants most depth patches end
    # non-finite or far off and sanitize empties them, in both trainers
    # and in JAX (port_anchors.py accuracy_resets): the GP ascent then
    # walks away and ICP keeps few planes, so a pair's path is rounding
    # and not reproducible across packages or routes. Each route's 20
    # final errors are held to JAX's as a sample: a method passes when
    # its median is within 10% or 0.5 mm of JAX's, or a rank-sum test
    # does not tell the two samples apart at the 1% level. In float64 the
    # map keeps its patches and both methods register.
    for route in ("kernel", "plain"):
        for m in ("gp", "icp"):
            mine = [p[route][m]["final_mean_err_m"] for p in pairs]
            ref = float(np.median(ACC_JAX[m]))
            med = summary[f"{route}/{m}"]["median_final_mean_err_m"]
            p_val = rank_sum_p(mine, ACC_JAX[m])
            say(f"[11] {route}/{m}: median {med} against JAX's {ref}; "
                f"rank-sum p {p_val:.4f}")
            check(abs(med - ref) <= max(0.1 * ref, 5e-4) or p_val >= 0.01,
                  f"[11] {route}/{m} final errors (median {med}) differ "
                  f"from JAX's (median {ref}): rank-sum p {p_val}")
    for r in f64:
        for m in ("gp", "icp"):
            check(r[m]["final_mean_err_m"]
                  <= max(r["initial_mean_err_m"], 0.02),
                  f"[11] float64 pair {r['seed']}: {m} walks away to "
                  f"{r[m]['final_mean_err_m']} m from "
                  f"{r['initial_mean_err_m']} m")
    return pairs


def patch_sq_err(comp, kp, s20) -> torch.Tensor:
    """[B] float64: each patch's summed squared in-sample depth error (the
    terms of compressor.reconstruction_rmse)."""
    from gp_compressor_tpu_torch.models import sparse_gp

    b = comp.patch
    mean, _ = sparse_gp.predict_batch(kp, s20, comp.depth_gp, b.X)
    return torch.where(b.mask, (mean[..., 0] - b.y[..., 0]).double() ** 2,
                       0.0).sum(1)


def map_dtype_check(ccfg, dev, kind, card):
    """The MAP calibration in float32 and float64 over four clouds: the
    hyperparameters must agree (the same mode). Where the in-sample RMSEs
    differ, the patches behind the gap: the three whose squared error
    differs most, the RMSE without them, and those patches retrained at
    both runs' values by the kernel, the plain version in float32 and in
    float64. Then the float32 run's depth bank trained by the kernel and
    by the plain version in float32, held to the plain version in float64
    by the `arbitrated` rule."""
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.ops.kernels import RBFParams
    from gp_compressor_tpu_torch.testing import sogp_regimes
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    def train(batch, idx, kp, s20, route):
        # the depth bank's patches idx trained by `route`, before sanitize
        dt = torch.float64 if route == "plain_f64" else torch.float32
        g = dataclasses.replace(ccfg.depth_gp, dtype=dt)
        X, Y, M = batch.X[idx].to(dt), batch.y[idx].to(dt), batch.mask[idx]
        k = RBFParams(sigmaf_sq=kp.sigmaf_sq.to(dt), l_sq=kp.l_sq.to(dt))
        fn = (sogp_train.add_points_batch_cuda if route == "kernel"
              else sogp_train.add_points_batch_plain)
        return fn(k, g, sparse_gp.init_batch(g, len(idx), device=dev), X, Y,
                  M, s20=s20.to(dt), eps_tol=g.eps_tol * k.sigmaf_sq
                  / g.sigmaf_sq)

    t0 = time.perf_counter()
    rows = []
    for seed in range(4):
        p_np, c_np = synthetic.room_cloud(n=N_POINTS, seed=seed)
        p, c = (torch.from_numpy(a).to(dev) for a in (p_np, c_np))
        v = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
        row, runs = {"seed": seed}, {}
        for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
            comp, kp, s20, _ = compressor.compress_decompress_calibrated(
                p, c, v, ccfg, calib_patches=32, calib_points=64,
                calib_steps=150, calib_lr=0.1, calib_starts=4,
                calib_dtype=dt)
            runs[name] = (comp, kp, s20, patch_sq_err(comp, kp, s20))
            row[name] = [float(kp.sigmaf_sq), float(kp.l_sq), float(s20),
                         float(compressor.reconstruction_rmse(
                             comp, ccfg, depth_kp=kp, depth_s20=s20))]
        row["same_mode"] = all(abs(math.log(a / b)) <= 0.1 for a, b in
                               zip(row["f32"][:3], row["f64"][:3]))
        # the bench bank order draws nothing: both runs hold the same banks
        batch = runs["f32"][0].patch
        n = batch.mask.sum(1)
        e32, e64 = runs["f32"][3], runs["f64"][3]
        top = torch.topk((e32 - e64).abs(), 3).indices
        keep = torch.ones_like(n, dtype=torch.bool)
        keep[top] = False
        row["rmse_without_top3"] = [
            math.sqrt(float(e[keep].sum() / n[keep].sum()))
            for e in (e32, e64)]
        row["top3"] = [{"patch": int(b), "points": int(n[b]),
                        "rmse_f32": math.sqrt(float(e32[b] / n[b])),
                        "rmse_f64": math.sqrt(float(e64[b] / n[b])),
                        "bvs": [int(sparse_gp.size(runs[r][0].depth_gp)[b])
                                for r in ("f32", "f64")]}
                       for b in top.tolist()]
        row["retrained_top3"] = {}
        for name in ("f32", "f64"):
            _, kp, s20, _ = runs[name]
            for route in ("kernel", "plain_f32", "plain_f64"):
                st = train(batch, top, kp, s20, route)
                row["retrained_top3"][f"{route}@{name}"] = \
                    sogp_regimes.patch_rmse(
                        RBFParams(sigmaf_sq=kp.sigmaf_sq.to(st.C.dtype),
                                  l_sq=kp.l_sq.to(st.C.dtype)),
                        s20.to(st.C.dtype), st, batch.X[top].to(st.C.dtype),
                        batch.y[top], batch.mask[top]).tolist()
        # the whole depth bank at the float32 run's values
        _, kp, s20, _ = runs["f32"]
        every = torch.arange(batch.mask.shape[0], device=dev)
        out, ref, ref64 = (train(batch, every, kp, s20, r)
                           for r in ("kernel", "plain_f32", "plain_f64"))
        try:
            row["arbitrated"] = sogp_regimes.arbitrate(
                ref64, ref, out, batch.X, batch.y, batch.mask, kp, s20)
        except AssertionError as e:
            row["arbitrated"] = {"fails": str(e)}
        rows.append(row)
        say(f"[11] MAP calibration float32 vs float64, cloud {seed} "
            f"(sigma_f^2, l^2, s20, rmse m) on {kind} ({card}): "
            f"{json.dumps(row)}")
    say(f"[11] MAP calibration over 4 clouds: "
        f"{time.perf_counter() - t0:.2f} s on {kind} ({card})")
    for r in rows:
        check(r["same_mode"], f"[11] cloud {r['seed']}: the float32 MAP "
                              f"{r['f32'][:3]} is not in float64's mode "
                              f"{r['f64'][:3]}")
        a, b = r["rmse_without_top3"]
        check(abs(a - b) <= 0.01 * b, f"[11] cloud {r['seed']}: float32 "
              f"and float64 runs differ beyond three patches ({a}, {b})")
        check("fails" not in r["arbitrated"], f"[11] cloud {r['seed']}: "
              f"{r['arbitrated']}")


def cli_config(res, sz):
    """The command line's configuration at its defaults and res / sz
    (cli._gp_config)."""
    import argparse

    from gp_compressor_tpu_torch import cli
    return cli._gp_config(argparse.Namespace(
        res=res, sz=sz, max_patches=4096, max_ppp=256, capacity=100,
        eps_tol=1e-6, dict_size=200, words_max=10, rgb_dict_size=600,
        rgb_words_max=20))


def near_jax(v, vals, floor=0.0, rel=0.0) -> bool:
    """v within JAX's range over its keys (vals), widened on each side by
    the larger of the range's own width, `floor` and `rel` of that end:
    where a value varies with the draws, a run of the port is one more
    draw, and JAX's spread over its keys says how far one may land."""
    lo, hi = min(vals), max(vals)
    w = hi - lo
    return (lo - max(w, floor, rel * abs(lo)) <= v
            <= hi + max(w, floor, rel * abs(hi)))


def cli_phase(dev, kind, card):
    """Phase 12: the six subcommands of the command line on the card,
    through cli.main as `python -m gp_compressor_tpu_torch.cli` runs them,
    held to the JAX command line's numbers (CLI_JAX). Returns the
    kernel's launch statistics at gp-compress's banks, per D."""
    import ast
    import contextlib
    import io
    import os
    import shutil

    import numpy as np

    from gp_compressor_tpu_torch import cli
    from gp_compressor_tpu_torch.io import artifact, checkpoint, native, pcd
    from gp_compressor_tpu_torch.io import tum
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = lambda name: os.path.join(work, name)
    walls = {}

    def run(tag, argv, show=True):
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for ln in lines if show else lines[-2:]:
            say(f"[12] {tag}: {ln}")
        say(f"[12] {tag}: wall {walls[tag]:.3f} s on {kind} ({card})")
        return lines

    def field(lines, prefix):
        line = next(ln for ln in lines if ln.startswith(prefix))
        return float(line.split(":")[1].strip().rstrip("s"))

    # ---- gp-compress at the defaults on the cloud as a binary PCD
    pts_np, cols_np = synthetic.room_cloud(n=N_POINTS, seed=0)
    cloud = path("room300k.pcd")
    native.write_pcd(cloud, pts_np, cols_np)
    a, b = native.read_pcd(cloud), pcd.read(cloud)
    check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
          and np.array_equal(a[0], pts_np),
          "[12] the native and NumPy PCD readers differ")
    out_pcd, ckpt = path("gp.pcd"), path("gp.npz")
    l0 = counted("sogp_train.launches")
    lines = run("gp-compress", ["gp-compress", "--cloud", cloud, "--out",
                                out_pcd, "--checkpoint", ckpt])
    launches = counted("sogp_train.launches") - l0
    check(launches == 2, f"[12] gp-compress launched the kernel {launches} "
                         "times, expected 2")
    got = {f: field(lines, p) for f, p in (
        ("n_points", "Size of original"), ("n_patches", "Number of"),
        ("mean_added", "Mean added"), ("max_added", "Max added"),
        ("rms", "RMS error"), ("n_out", "Size of transformed"))}
    jax_runs = CLI_JAX["gp_compress"]
    for f in ("n_points", "n_patches"):
        check(got[f] == jax_runs[0][f], f"[12] gp-compress {f} {got[f]} != "
                                        f"JAX's {jax_runs[0][f]}")
    # ~98% of the depth patches end astray and sanitize empties them, in
    # JAX and in the port (ROADMAP Queue 3): the survivors' statistics
    # vary with the bank order
    for f, floor, rel in (("mean_added", 0.0, 0.0), ("max_added", 2.0, 0.0),
                          ("rms", 0.0, 0.05)):
        vals = [r[f] for r in jax_runs]
        check(near_jax(got[f], vals, floor, rel),
              f"[12] gp-compress {f} {got[f]} too far from JAX's {vals}")
    # the patches that emit points, a rare outcome (~1.4%) counted over
    # 1,675 patches: within 3 Poisson standard deviations of JAX's mean
    G = 20 * 20
    m = sum(r["n_out"] for r in jax_runs) / len(jax_runs) / G
    check(abs(got["n_out"] / G - m) <= 3 * math.sqrt(m) + 1,
          f"[12] gp-compress emits {got['n_out'] / G} patches, JAX "
          f"{[r['n_out'] / G for r in jax_runs]}")
    gcfg = cli_config(0.15, 20)
    pts, cols = (torch.from_numpy(x).to(dev) for x in b)
    valid = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    like = compressor.compress(pts, cols, valid, gcfg,
                               generator=torch.Generator(device=dev))
    loaded = checkpoint.load(ckpt, like, strict=True)
    check(checkpoint.load_meta(ckpt) == {"kind": "gp_compressed"},
          "[12] checkpoint meta")
    world, colors, ok, *_ = compressor.decompress(loaded, gcfg)
    again = path("gp_again.pcd")
    native.write_pcd(again, world[ok].cpu().numpy(), colors[ok].cpu().numpy())
    with open(again, "rb") as f1, open(out_pcd, "rb") as f2:
        check(f1.read() == f2.read(), "[12] the checkpoint decompresses to "
                                      "other points than --out holds")

    # the kernel at the command line's banks (the checkpoint's: the CLI's
    # own) against its plain version, the plain version in float64 as
    # referee
    batch = loaded.patch
    dkp, ckp = compressor.default_params(gcfg, dev)
    site = {}
    for g, kp, Y in ((gcfg.depth_gp, dkp, batch.y),
                     (gcfg.rgb_gp, ckp, batch.rgb)):
        init = sparse_gp.init_batch(g, batch.mask.shape[0], device=dev)
        res, stats = kernel_at_site(kp, g, init, batch.X, Y, batch.mask,
                                    None, None, dev, rule="arbitrated")
        site[g.dout] = stats
        say(f"[12] kernel at the gp-compress banks D={g.dout} on {kind} "
            f"({card}): {json.dumps(res)}; {json.dumps(stats)}")

    # ---- compress -> decompress (the K-SVD artifact) at the defaults
    name = path("ksvd")
    l0 = counted("sogp_train.launches")
    lines = run("compress", ["compress", "--name", name], show=False)
    check(counted("sogp_train.launches") == l0,
          "[12] compress launched the training kernel")
    iters = [int(ln.split()[2].rstrip(":")) for ln in lines
             if ln.startswith("ksvd iter")]
    split = iters.index(1, 1)           # each ksvd call counts from 1
    got = {"rms": field(lines, "RMS error"), "depth_iters": iters[split - 1],
           "rgb_iters": iters[-1]}
    say(f"[12] compress: {json.dumps(got)}")
    jax_runs = CLI_JAX["compress"]
    # phase 10's margins (RMS 5%, sweeps 2), or JAX's own spread over its
    # keys where wider (without atom blocks, the stop sweep varies by ~10)
    for f, floor, rel in (("rms", 0.0, 0.05), ("depth_iters", 2, 0.0),
                          ("rgb_iters", 2, 0.0)):
        vals = [r[f] for r in jax_runs]
        check(near_jax(got[f], vals, floor, rel),
              f"[12] compress {f} {got[f]} too far from JAX's {vals}")
    art = artifact.read(name)
    check(art.means.shape[0] > 0 and art.sz == 20, "[12] artifact read back")
    dec = path("ksvd.pcd")
    lines = run("decompress", ["decompress", "--name", name, "--out", dec])
    # every occupied raster cell: the raster's claims agree with JAX's to
    # a few points in float32 (phase 3's 0.1% on banked points)
    n_out = int(field(lines, "Size of transformed"))
    check(abs(n_out - jax_runs[0]["n_out"]) <= 1e-3 * jax_runs[0]["n_out"],
          f"[12] decompress emits {n_out} points, JAX {jax_runs[0]['n_out']}")
    check(native.read_pcd(dec)[0].shape == (n_out, 3),
          "[12] the decompressed .pcd")

    # ---- gp-accuracy: the synthetic pair with ICP, then the TUM fixture
    l0 = counted("sogp_train.launches")
    got = json.loads(run("gp-accuracy", ["gp-accuracy", "--baseline",
                                         "icp"])[-1])
    check(counted("sogp_train.launches") - l0 == 2,
          "[12] gp-accuracy: kernel launches")
    ja = CLI_JAX["gp_accuracy"]
    check(got["initial_mean_err_m"] == ja["initial_mean_err_m"],
          f"[12] gp-accuracy's injected error {got['initial_mean_err_m']} != "
          f"JAX's {ja['initial_mean_err_m']}")
    # one pair of phase 11's protocol, whose 20 pairs phase 11 holds to
    # JAX's as a sample: here each final error lies within the span of
    # JAX's 20 (+10%), and the GP run within its step budget
    check(1 <= got["steps"] <= 150, f"[12] gp-accuracy steps {got['steps']}")
    for m, v in (("gp", got["final_mean_err_m"]),
                 ("icp", got["icp"]["final_mean_err_m"])):
        check(math.isfinite(v) and v <= 1.1 * max(ACC_JAX[m]),
              f"[12] gp-accuracy {m} final error {v} beyond JAX's 20 pairs")
    fixture, _ = tum.make_fixture(path("tum"), n_frames=4)
    lines = run("gp-accuracy --dataset", [
        "gp-accuracy", "--dataset", fixture, "--frame-stride", "1",
        "--n-pairs", "3"])
    pairs = [json.loads(ln) for ln in lines]
    jt = CLI_JAX["tum_accuracy"]
    check(len(pairs) == len(jt[0]) == 4, "[12] TUM pairs")
    for i, p in enumerate(pairs[:3]):
        ref = [r[i] for r in jt]
        check(p["pair"] == ref[0]["pair"]
              and p["gt_trans_m"] == ref[0]["gt_trans_m"],
              f"[12] TUM pair {p} against JAX's {ref[0]}")
        for f, floor in (("trans_err_m", 5e-3), ("rot_err", 2e-3)):
            vals = [r[f] for r in ref]
            check(near_jax(p[f], vals, floor),
                  f"[12] TUM pair {i} {f} {p[f]} too far from JAX's {vals}")

    # ---- calibrate: MAP and HMC, in float32 as JAX's command line
    got = json.loads(run("calibrate --map", ["calibrate", "--map"])[-1])
    jm = CLI_JAX["calibrate_map"]
    for f in ("sigmaf_sq", "l_sq", "s20"):
        check(math.isfinite(got[f]) and abs(math.log(got[f] / jm[f])) <= 0.1,
              f"[12] calibrate --map {f} {got[f]} not within 0.1 of JAX's "
              f"{jm[f]} in log space")
    # float32 HMC from the reference constants puts each of JAX's chains
    # in one of two modes (sigma_f^2 ~16.6 with s20 -> 0, or the cm-scale
    # mode), so the 2-chain means spread over both and their mixture
    # across JAX's 12 keys (ROADMAP Queue 3): each value within that
    # spread, or within phase 9's 0.3 in log space of one of the runs
    got = json.loads(run("calibrate", ["calibrate"])[-1])
    vals = {f: [r[f] for r in CLI_JAX["calibrate_hmc"]]
            for f in ("sigmaf_sq", "l_sq", "s20")}
    for f, v in vals.items():
        check(math.isfinite(got[f]) and (min(v) <= got[f] <= max(v) or min(
            abs(math.log(got[f] / a)) for a in v) <= 0.3),
            f"[12] calibrate (HMC) {f} {got[f]} not within 0.3 of JAX's "
            f"{v} in log space")

    # ---- gp-mapping: 5 synthetic scans with --out
    def scans(lines):
        """(the scans' printed info dicts, the map points each --out
        write reports)."""
        return ([ast.literal_eval(ln.partition(": ")[2]) for ln in lines
                 if ln.startswith("scan")],
                [int(ln.split("(")[1].split()[0]) for ln in lines
                 if ln.startswith("wrote")])

    got, written = scans(run("gp-mapping", ["gp-mapping", "--out",
                                            path("map.pcd")]))
    ref = CLI_JAX["gp_mapping"]
    check(len(got) == len(ref["scans"]) and len(written) == len(
        ref["written"]), "[12] gp-mapping: scans or writes missing")
    for a, b in zip(ref["scans"], got):
        check(list(b) == list(a) and b["diverged"] == a["diverged"]
              and abs(b.get("n_patches", 0) - a.get("n_patches", 0))
              <= 0.01 * a.get("n_patches", 0),
              f"[12] gp-mapping: {b} against JAX's {a}")
    # the map's patches that emit points are the rare survivors of
    # float32 training, as in gp-compress (3 Poisson deviations)
    for na, nb in zip(ref["written"], written):
        check(abs(na / 225 - nb / 225) <= 3 * math.sqrt(na / 225) + 1,
              f"[12] gp-mapping wrote {nb} map points, JAX {na}")

    # ---- gp-mapping --dataset on the fixture of each seed. Registration
    # against a float32 map at the reference constants takes from ~12 to
    # past the 60-step cap from scan to scan, by either trainer (ROADMAP
    # Queue 3): the steps of the scans after the first are held to JAX's
    # as a sample (phase 11's rank-sum rule), the first scan's insert
    # exactly
    steps = {"port": [], "jax": []}
    drops = {"port": 0, "jax": 0}
    for seed, ref in sorted(CLI_JAX["tum_mapping_seeds"].items()):
        fx, _ = tum.make_fixture(path(f"tum_seed{seed}"), n_frames=4,
                                 seed=seed)
        got, _ = scans(run(f"gp-mapping --dataset (fixture seed {seed})",
                           ["gp-mapping", "--dataset", fx]))
        check(len(got) == len(ref) and got[0] == ref[0],
              f"[12] gp-mapping --dataset, seed {seed}: {got} against "
              f"JAX's {ref}")
        for who, infos in (("port", got), ("jax", ref)):
            steps[who] += [i["reg_steps"] for i in infos[1:]]
            drops[who] += sum(i["diverged"] for i in infos[1:])
    p_val = rank_sum_p(steps["port"], steps["jax"])
    say(f"[12] gp-mapping --dataset: registration steps port "
        f"{steps['port']} (dropped {drops['port']}), JAX {steps['jax']} "
        f"(dropped {drops['jax']}); rank-sum p {p_val:.4f}")
    check(p_val >= 0.01, f"[12] gp-mapping --dataset: the port's "
                         f"registration steps differ from JAX's (p {p_val})")
    say(f"[12] walls (s) on {kind} ({card}): {json.dumps(walls)}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    return site


SHARD_RANKS = 2           # phase 13: ranks sharing cuda:0 over gloo
FRONT_END_SEEDS = (0, 1, 2, 3)   # room_cloud seeds of the front-end check
# what the sharded round trip measured per rank while every rank still ran
# the front end on the whole cloud (NVIDIA H100 80GB HBM3, 700.00 W): the
# calibrated round trip's peak (MB) by number of ranks, and the round trip's
# wall (ms) on a card per rank of 4
REPLICATED_PEAK_MB = {2: 743, 4: 688}
REPLICATED_WALL_MS = (26.8, 44.0)
# the leaves a front end's check compares: exact ones, then the float ones
# whose float64 sums the ranks add up in another order
FRONT_END_EXACT = ("claims", "counts", "W", "mask")
FRONT_END_FLOAT = ("rotations", "means", "rgb_means", "X", "y", "rgb")


def bits_equal(a, b) -> bool:
    """Bit-for-bit equality of two tensors (NaN-safe)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def row_bits_equal(a, b) -> torch.Tensor:
    """[B] bool: row b of a and of b are equal bit for bit."""
    u = a.reshape(a.shape[0], -1).contiguous()
    v = b.reshape(b.shape[0], -1).contiguous()
    if u.dtype.itemsize > 1:
        u, v = u.view(torch.uint8), v.view(torch.uint8)
    return (u == v).all(1)


def grid_digest(grid) -> str:
    """sha256 of a voxel grid's leaf keys, count, bounds and dense table."""
    import hashlib
    h = hashlib.sha256()
    for t in grid:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def front_end_diff(got: dict, want: dict) -> dict:
    """How two whole front ends (dicts of FRONT_END_* leaves on the CPU)
    differ: claims that differ, exact leaves equal, and per float leaf the
    patch rows that differ and the largest difference."""
    out = {"claims_differ": int((got["claims"] != want["claims"]).sum())}
    out.update({f"{k}_equal": torch.equal(got[k], want[k])
                for k in FRONT_END_EXACT[1:]})
    rows = torch.zeros(want["mask"].shape[0], dtype=torch.bool)
    for k in FRONT_END_FLOAT:
        eq = row_bits_equal(got[k], want[k])
        rows |= ~eq
        out[f"{k}_rows_differ"] = int((~eq).sum())
        out[f"{k}_max_abs"] = float((got[k].double()
                                     - want[k].double()).abs().max())
    out["rows_differ"] = int(rows.sum())
    return out


def front_end_leaves(batch) -> dict:
    return {k: getattr(batch, k).cpu()
            for k in FRONT_END_EXACT + FRONT_END_FLOAT}


def single_front_ends(ccfg, dev) -> dict:
    """The single process's front end on room_cloud seeds FRONT_END_SEEDS,
    run twice each (the float64 atomics of its sums may reorder between
    runs: the second run says how far one process differs from itself)."""
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    out = {}
    for seed in FRONT_END_SEEDS:
        p, c = (torch.from_numpy(a).to(dev)
                for a in synthetic.room_cloud(n=N_POINTS, seed=seed))
        v = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
        first = front_end_leaves(compressor.project(p, c, v, ccfg))
        again = front_end_leaves(compressor.project(p, c, v, ccfg))
        out[seed] = (first, front_end_diff(again, first))
    return out


def sharded_rank(outdir: str, backend: str, full: bool) -> int:
    """One rank of phase 13 (or of shard_probe.py), started by run_ranks
    with torchrun's variables on cuda:{LOCAL_RANK % device_count}, in a
    `backend` group of WORLD_SIZE ranks. On a (world, 1) mesh: the round
    trip from this rank's block of the cloud (only the block reaches the
    card), its walls by stage, the front end again (the same rows, and the
    same grid on every rank by checksum); with `full`, also the front end
    of room_cloud seeds FRONT_END_SEEDS, the kernel on this rank's rows,
    the calibrated round trip on (world, 1) and (1, world) meshes, register
    and shard_report. Prints one JSON line; rank 0 saves the gathered round
    trip and front ends to outdir."""
    import torch.distributed as dist

    from gp_compressor_tpu_torch.config import MeshConfig, RegistrationConfig
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.geometry import transforms
    from gp_compressor_tpu_torch.inference import hmc
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.parallel import distributed
    from gp_compressor_tpu_torch.parallel import mesh as mesh_lib
    from gp_compressor_tpu_torch.parallel.shard_report import shard_report
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor, registration

    distributed.initialize(backend=backend, device_type="cuda")
    dev = distributed.local_device("cuda")
    torch.cuda.set_device(dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    sogp_train.build()
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "card": torch.cuda.get_device_name(dev),
           "build_s": sogp_train.BUILD_INFO["seconds"]}
    ccfg = bench_config()
    mesh = mesh_lib.make_mesh(MeshConfig(), "cuda")       # (world, 1)
    rows = mesh_lib.point_rows(N_POINTS, mesh)
    res["point_rows"] = [rows.start, rows.stop]

    def cloud(seed):
        p, c = synthetic.room_cloud(n=N_POINTS, seed=seed)
        return (torch.from_numpy(p), torch.from_numpy(c),
                torch.ones(N_POINTS, dtype=torch.bool))

    def block(whole, m):
        """This rank's block of a whole host cloud, on the card."""
        return [t.to(dev) for t in compressor.shard_points(*whole, m)]

    host = cloud(0)
    blk = block(host, mesh)
    walls = {}

    # ---- the round trip: 1 warm-up, TIMED_RUNS timed, launches counted
    def round_trip():
        comp, out = compressor.compress_decompress(*blk, ccfg, mesh=mesh)
        torch.cuda.synchronize()
        return comp, out

    round_trip()
    dist.barrier()
    l0 = counted("sogp_train.launches")
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        comp, out = round_trip()
        times.append(time.perf_counter() - t0)
    res["launches"] = counted("sogp_train.launches") - l0
    walls["round_trip"] = times
    res["rmse"] = float(compressor.reconstruction_rmse(comp, ccfg,
                                                       mesh=mesh))
    res["local_rows"] = int(comp.patch.mask.shape[0])
    res["claim_rows"] = int(comp.patch.claims.shape[0])
    B, G = ccfg.patch.max_patches, ccfg.patch.sz ** 2
    whole = compressor.gather_cloud(comp, mesh, n_points=N_POINTS)
    valid_out = mesh_lib.gather_leading(out[2], mesh, B * G)
    if rank == 0:
        torch.save({**front_end_leaves(whole.patch),
                    "n_leaves": whole.patch.n_leaves.cpu(),
                    "valid": valid_out.cpu(),
                    "depth_gp": [t.cpu() for t in whole.depth_gp],
                    "rgb_gp": [t.cpu() for t in whole.rgb_gp]},
                   f"{outdir}/round_trip.pt")
    del whole, valid_out

    # ---- walls by stage (TIMED_RUNS times, the ranks lined up first: a
    # rank's first collective waits for the last rank to arrive), then the
    # front end's rows again, bit for bit, and its replicated grid the same
    # on every rank
    walls["stages"] = {"front_end": [], "training": [], "decompress": []}
    for _ in range(TIMED_RUNS):
        dist.barrier()
        stages = {}
        batch = synced(lambda: compressor.project(*blk, ccfg, mesh=mesh),
                       stages, "front_end")
        staged = synced(lambda: compressor.train(batch, ccfg, mesh=mesh),
                        stages, "training")
        synced(lambda: compressor.decompress(staged, ccfg, mesh=mesh),
               stages, "decompress")
        for k, v in stages.items():
            walls["stages"][k].append(v)
    del staged
    digests = [None] * world
    dist.all_gather_object(digests, grid_digest(batch.grid))
    res["digests"] = digests
    res["rows_match_front_end"] = all(
        bits_equal(getattr(comp.patch, k), getattr(batch, k))
        for k in compressor.BANK_LEAVES + ("claims",))
    if not full:
        print(json.dumps({**res, "walls": walls}), flush=True)
        dist.destroy_process_group()
        return 0

    # ---- with a card per rank: each rank's front end under the profiler,
    # the ranks lined up first (not on a shared card: one card's queue
    # would serve both ranks' traces)
    if torch.cuda.device_count() >= world:
        dist.barrier()
        res["front_end_trace"] = front_end_trace(
            lambda: compressor.project(*blk, ccfg, mesh=mesh))

    # ---- the front end of more clouds, gathered for the parent's check
    for seed in FRONT_END_SEEDS:
        b = batch if seed == 0 else compressor.project(
            *block(cloud(seed), mesh), ccfg, mesh=mesh)
        g = compressor.gather_batch(b, mesh, n_points=N_POINTS)
        if rank == 0:
            torch.save(front_end_leaves(g), f"{outdir}/front_end_{seed}.pt")
        del b, g

    # ---- the kernel on this rank's shard, both ranks launching at once
    lb = comp.patch
    dkp, ckp = compressor.default_params(ccfg, dev)
    kern_res = {}
    for gpcfg, kp, Y in ((ccfg.depth_gp, dkp, lb.y), (ccfg.rgb_gp, ckp,
                                                       lb.rgb)):
        init = sparse_gp.init_batch(gpcfg, lb.mask.shape[0], device=dev)
        st = sparse_gp.SOGPState(*[torch.empty_like(a) for a in init])
        row = sogp_train.hyper_row(kp, gpcfg, dev)
        kern = lambda: sogp_train.launch(gpcfg, init, st, lb.X, Y, lb.mask,
                                         row)
        plain = lambda: sogp_train.add_points_batch_plain(
            kp, gpcfg, init, lb.X, Y, lb.mask)
        kern()
        torch.cuda.synchronize()
        dist.barrier()
        p1, k1, k2, p2 = (event_ms(plain, 1), event_ms(kern, KERNEL_REPS),
                          event_ms(kern, KERNEL_REPS), event_ms(plain, 1))
        bound = train_bound(gpcfg, lb.X, lb.mask, st)
        kern_res[gpcfg.dout] = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                                "bound_ms": bound["bound_ms"],
                                "bound_by": bound["bound_by"]}
    res["kernel"] = kern_res

    # ---- the calibrated round trip (MAP in float64) on both meshes, each
    # from its blocks (the (1, world) mesh's one data block is the whole
    # cloud), against the single process on the whole cloud
    meshes = {"data": mesh,
              "chain": mesh_lib.make_mesh(MeshConfig(chain_size=world),
                                          "cuda")}
    host_dev = [t.to(dev) for t in host]
    cal = {}
    # an untimed single run first, so no timed run carries the warm-up
    for name, m in [("warm-up", None), ("single", None), *meshes.items()]:
        args = host_dev if m is None else block(host, m)
        t0 = time.perf_counter()
        c, kp, s20, _ = compressor.compress_decompress_calibrated(
            *args, ccfg, calib_dtype=torch.float64, mesh=m)
        torch.cuda.synchronize()
        walls[f"calibrated_{name}"] = time.perf_counter() - t0
        cal[name] = (c, kp, s20)
    del walls["calibrated_warm-up"]
    th = {k: torch.stack([v[1].sigmaf_sq, v[1].l_sq, v[2]]) for k, v in
          cal.items()}
    res["calibrated_theta"] = th["single"].tolist()
    res["calibrated_equal"] = {k: bits_equal(th[k], th["single"])
                               for k in meshes}
    # the float64 MAP itself on the subsample gathered from the owners: on
    # (world, 1) every rank ascends all 4 starts as the single run does;
    # on (1, world) fewer each, and a start's gradient then differs in its
    # last bits (the broadcast's backward reduces over the patches with a
    # launch chosen by the number of outputs)
    logpost, theta0 = compressor._calib_logpost(comp.patch, ccfg, 32, 64,
                                                torch.float64, mesh=mesh)
    t64 = {k: hmc.map_estimate_multi(logpost, theta0, mesh=m)[0]
           for k, m in [("single", None), *meshes.items()]}
    res["map64_theta"] = t64["single"].tolist()
    res["map64_equal"] = {k: bits_equal(t64[k], t64["single"])
                          for k in meshes}
    res["map64_rel"] = {k: float(((t64[k] - t64["single"])
                                  / t64["single"]).abs().max())
                        for k in meshes}

    # ---- register the moved scan (phase 7's motion) on the calibrated
    # map; the scan is whole (registration cuts only the map)
    ang = torch.tensor(PERTURB_ANG, device=dev)
    moved = transforms.apply(host_dev[0], transforms.euler_xyz(ang),
                             torch.tensor(PERTURB_T, device=dev))
    rcfg = RegistrationConfig(max_steps=80, step_mode="rprop")
    reg = {}
    for name, m in (("warm-up", None), ("single", None), ("data", mesh)):
        c, kp, s20 = cal[name if m is not None else "single"]
        t0 = time.perf_counter()
        st, _ = registration.register(c, moved, host_dev[1], host_dev[2],
                                      ccfg, rcfg, depth_kp=kp,
                                      depth_s20=s20, mesh=m)
        torch.cuda.synchronize()
        walls[f"register_{name}"] = time.perf_counter() - t0
        reg[name] = st
    del walls["register_warm-up"]
    res["register"] = {
        "steps": [int(reg[k].step_nbr) for k in ("single", "data")],
        "pose_max_diff": max(float((reg["data"].R_cloud
                                    - reg["single"].R_cloud).abs().max()),
                             float((reg["data"].t_cloud
                                    - reg["single"].t_cloud).abs().max()))}
    del cal, reg, moved, host_dev

    t0 = time.perf_counter()
    res["shard_report"] = shard_report(ccfg, N_POINTS, mesh, rcfg=rcfg,
                                       device=dev)
    walls["shard_report"] = time.perf_counter() - t0
    res["walls"] = walls
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(outdir, backend: str, n: int, full: bool) -> list:
    """Run n ranks of sharded_rank (torchrun's variables, each rank's
    LOCAL_RANK its rank: on a one-card machine every rank lands on
    cuda:0) and return their JSON lines; any rank's failure fails."""
    import os

    from gp_compressor_tpu_torch.testing import dist_worker

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(
        free_port()), WORLD_SIZE=str(n))
    argv = [sys.executable, os.path.abspath(__file__), "--sharded-rank",
            str(outdir), backend, "full" if full else "round_trip"]
    ranks = dist_worker.run_ranks(
        [argv] * n, [dict(env, RANK=str(r), LOCAL_RANK=str(r))
                     for r in range(n)], outdir, timeout=600)
    for r, (rc, _, err) in enumerate(ranks):
        check(rc == 0, f"[13] {backend} rank {r} exited {rc}:\n"
                       f"{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in ranks]


def hold_states(gathered, comp) -> int:
    """Check that a gathered round trip's GP states equal the single
    process's `comp` bit for bit on every patch row whose banks (X, y, rgb,
    mask) are equal; returns the number of rows whose banks differ."""
    same = torch.ones(comp.patch.mask.shape[0], dtype=torch.bool)
    for k in ("X", "y", "rgb", "mask"):
        same &= row_bits_equal(gathered[k], getattr(comp.patch, k).cpu())
    for name in ("depth_gp", "rgb_gp"):
        single = getattr(comp, name)
        bad = [f for f, a, b in zip(single._fields, gathered[name], single)
               if not bool(row_bits_equal(a[same], b.cpu()[same]).all())]
        check(not bad, f"[13] gathered {name} differs from the single kernel "
                       f"run on rows with equal banks: {bad}")
    return int((~same).sum())


def hold_ranks(ranks, outdir, comp, rmse, ccfg, card, single_fe) -> dict:
    """The checks of a full sharded run (run_ranks(..., full=True))
    against the single-process round trip `comp`, `rmse` and front ends
    `single_fe` (single_front_ends): every rank's line printed, its point
    and patch rows, launches, checksums, RMSE, calibrated theta, register,
    shard layout (every leaf cut, the points and claims too), the claims
    that differ (held at 0 on the bench cloud, printed for every seed),
    and rank 0's gathered states bit-equal to `comp` where the banks are.
    Returns the sharded kernel's line for the kernels object."""
    B = ccfg.patch.max_patches
    n = len(ranks)
    mb = lambda v: None if v is None else round(v / 1e6, 1)
    for r in ranks:
        rep = r["shard_report"]
        peaks = {k: [mb(v), mb(rep["stage_start_bytes"][k])]
                 for k, v in rep["stage_peak_bytes"].items()}
        cal, reg = rep["calibrated_pipeline"], rep["register"]
        say(f"[13] rank {r['rank']} of {r['world']} ({r['backend']}, "
            f"{r['device']}, {r['card']}; nvidia-smi: {card}): point rows "
            f"{r['point_rows']} of {N_POINTS}, patch rows {r['local_rows']} "
            f"of {B}; walls (s) {json.dumps(r['walls'])}; [peak, live at "
            f"start] MB by stage {json.dumps(peaks)}, calibrated round trip "
            f"{[mb(cal['peak_bytes']), mb(cal['start_bytes'])]}, register "
            f"{[mb(reg['peak_bytes']), mb(reg['start_bytes'])]} (when "
            f"every rank ran the front end on the whole cloud: calibrated "
            f"{REPLICATED_PEAK_MB.get(n, REPLICATED_PEAK_MB)} MB per rank, "
            f"round trip {REPLICATED_WALL_MS[0]}-{REPLICATED_WALL_MS[1]} ms "
            f"per rank of 4); kernel at B={r['local_rows']}: "
            f"{json.dumps(r['kernel'])}; rmse {r['rmse']!r}; launches "
            f"{r['launches']} in {TIMED_RUNS} round trips; register "
            f"{json.dumps(r['register'])}; calibrated theta "
            f"{r['calibrated_theta']}, float64 MAP bit-equal "
            f"{json.dumps(r['map64_equal'])}, relative difference "
            f"{json.dumps(r['map64_rel'])}; shard report "
            f"{json.dumps(rep)}")
        if "front_end_trace" in r:
            say(f"[13] rank {r['rank']}'s front end traced: "
                f"{json.dumps(r['front_end_trace'])}")
            check(r["front_end_trace"]["launches"] > 0,
                  "[13] the profiler saw no launch in a rank's front end")
        check(r["build_s"] == 0.0, "[13] a rank rebuilt the kernel")
        check(r["local_rows"] == B // n, "[13] patch rows per rank")
        check(r["claim_rows"] == r["point_rows"][1] - r["point_rows"][0]
              == -(-N_POINTS // n), "[13] point rows per rank")
        check(r["launches"] == 2 * TIMED_RUNS,
              f"[13] rank {r['rank']}: {r['launches']} kernel launches in "
              f"{TIMED_RUNS} round trips, expected {2 * TIMED_RUNS}")
        check(len(set(r["digests"])) == 1,
              f"[13] the ranks' grids differ: {r['digests']}")
        check(r["rows_match_front_end"],
              "[13] a rank's front end differs between two runs")
        check(abs(r["rmse"] - rmse) <= 1e-6 * rmse,
              f"[13] sharded rmse {r['rmse']} vs single {rmse}")
        # the calibrated values (float32, what training uses) bit-equal on
        # both meshes; the float64 MAP bit-equal where each rank ascends
        # every start, and to float64 rounding where the starts split
        check(all(r["calibrated_equal"].values())
              and r["map64_equal"]["data"]
              and r["map64_rel"]["chain"] <= 1e-10,
              f"[13] calibrated theta differs across meshes: "
              f"{r['calibrated_equal']}; MAP float64 {r['map64_equal']}, "
              f"relative {r['map64_rel']}")
        steps = r["register"]["steps"]
        check(steps[0] == steps[1] and steps[0] < 80
              and r["register"]["pose_max_diff"] <= 2e-6,
              f"[13] sharded register {r['register']}")
        bad = {k: v for k, v in rep["calibrated_pipeline"]["leaves"].items()
               if v["layout"] != ("partitioned" if n > 1 else "whole")}
        check(not bad, f"[13] shard report: whole on a rank: {bad}")
    check(len({r["rmse"] for r in ranks}) == 1
          and len({str(r["calibrated_theta"]) for r in ranks}) == 1,
          "[13] the ranks disagree on a reduced value")

    # the front end of every seed against the single process's
    for seed in FRONT_END_SEEDS:
        single, itself = single_fe[seed]
        d = front_end_diff(torch.load(f"{outdir}/front_end_{seed}.pt",
                                      weights_only=True), single)
        say(f"[13] front end of room_cloud seed {seed}, {n} ranks against "
            f"one process: {json.dumps(d)}; one process against itself: "
            f"{json.dumps(itself)}")
        check(all(d[f"{k}_equal"] for k in FRONT_END_EXACT[1:])
              or d["claims_differ"] > 0,
              f"[13] seed {seed}: equal claims but other banks or masks")
    # the gathered round trip against phase 3's single-process run
    gathered = torch.load(f"{outdir}/round_trip.pt", weights_only=True)
    flips = int((gathered["claims"] != comp.patch.claims.cpu()).sum())
    check(flips == 0, f"[13] {flips} claims differ from phase 3's")
    check(torch.equal(gathered["mask"], comp.patch.mask.cpu())
          and int(gathered["n_leaves"]) == int(comp.patch.n_leaves),
          "[13] gathered masks or n_leaves differ from phase 3's")
    rows = hold_states(gathered, comp)
    say(f"[13] gathered round trip: claims equal to phase 3's; {rows} patch "
        f"rows' banks differ; both GP states bit-equal to the single "
        f"process's on every row whose banks are")
    check(rows == 0, f"[13] {rows} patch rows' banks differ from phase 3's "
                     f"on the bench cloud")

    k = [r["kernel"] for r in ranks]
    mean = lambda key, d: sum(sum(x[d][key]) / 2 for x in k) / len(k)
    return {"launches_per_rank": ranks[0]["launches"] // TIMED_RUNS,
            "ms": sum(mean("kernel_ms", d) for d in ("1", "3")),
            "plain_ms": sum(mean("plain_ms", d) for d in ("1", "3")),
            "bound_ms": sum(sum(x[d]["bound_ms"] for x in k) / len(k)
                            for d in ("1", "3")),
            "bound_by": k[0]["1"]["bound_by"]}


def sharded_phase(comp, rmse, ccfg, dev, kind, card) -> dict:
    """Phase 13: the multi-device layer on the card. Two ranks share cuda:0
    over gloo (the kernel is built already: the ranks load it), then one
    rank runs under NCCL. Held to phase 3's single-process round trip
    (`comp`, `rmse`) and to the single process's front ends."""
    import os
    import shutil

    t_phase = time.perf_counter()
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_sharded")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    B = ccfg.patch.max_patches

    single_fe = single_front_ends(ccfg, dev)
    shard = hold_ranks(run_ranks(outdir, "gloo", SHARD_RANKS, True), outdir,
                       comp, rmse, ccfg, card, single_fe)

    # one rank: its block is the whole cloud, routed to itself, so its
    # round trip is one process's bit for bit
    nccl = run_ranks(outdir, "nccl", 1, False)[0]
    say(f"[13] one rank under {nccl['backend']}: rmse {nccl['rmse']!r}, "
        f"walls {json.dumps(nccl['walls'])}")
    check(nccl["backend"] == "nccl" and nccl["launches"] == 2 * TIMED_RUNS
          and nccl["rows_match_front_end"] and nccl["local_rows"] == B
          and nccl["rmse"] == rmse, f"[13] NCCL rank: {nccl}")
    gathered = torch.load(f"{outdir}/round_trip.pt", weights_only=True)
    check(all(bits_equal(gathered[k], getattr(comp.patch, k).cpu())
              for k in ("claims", "mask", "X", "y", "rgb")),
          "[13] the NCCL rank's claims or banks differ from phase 3's")
    check(all(bits_equal(a, b.cpu()) for name in ("depth_gp", "rgb_gp")
              for a, b in zip(gathered[name], getattr(comp, name))),
          "[13] the NCCL rank's states differ from the single run")
    say("[13] one NCCL rank: rmse, claims, banks and both GP states "
        "bit-equal to phase 3's")
    wall = time.perf_counter() - t_phase
    say(f"[13] phase wall {wall:.2f} s on {kind} ({card})")
    return shard


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.testing import sogp_regimes
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    # ---- 0. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60).stdout.strip()
    say(f"[0] device: {kind}; nvidia-smi: {card}; SM clock now, max: {clocks};"
        f" torch {torch.__version__} cuda {torch.version.cuda}; count "
        f"{torch.cuda.device_count()}")

    # ---- 1. build
    sogp_train.build()
    info = sogp_train.BUILD_INFO
    say(f"[1] built {info['path']} in {info['seconds']:.2f} s")
    ptxas = ptxas_report(info["ptxas"])
    say(f"[1] ptxas per instantiation: {json.dumps(ptxas)}")
    for d in (1, 3):
        rep = ptxas.get(f"D={d} R=1", {})
        check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
              f"the 32-slot D={d} kernel spills or is missing: {rep}")

    # ---- 2. kernel against its plain version
    def bits(t):
        return t.contiguous().view(torch.uint8)

    def both(cfg, X, Y, M, init=None, **kw):
        kp = sogp_regimes.params(dev)
        if init is None:
            init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
        before = [a.clone() for a in init]
        out = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(before, init)),
              "the kernel changed its input state")
        ref = sogp_train.add_points_batch_plain(kp, cfg, init, X, Y, M, **kw)
        torch.cuda.synchronize()
        return ref, out

    def on_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def run(name, rule=None, **kw):
        cfg, X, Y, M = sogp_regimes.regime(name, **kw)
        X, Y, M = on_dev(X, Y, M)
        ref, out = both(cfg, X, Y, M)
        return sogp_regimes.compare(rule or name, ref, out, X, Y, M)

    a, b = on_dev(*sogp_regimes.division_cases())
    ref = a / b
    nan = torch.isnan(ref)
    for q in sogp_train.inline_division(a, b):
        check(torch.equal(nan, torch.isnan(q))
              and torch.equal(bits(q[~nan]), bits(ref[~nan])),
              "the kernel's inline division differs from IEEE a / b")
    say(f"[2] inline division: bit-equal to IEEE a / b on {a.numel()} pairs")
    del a, b, ref, nan, q

    max_err = 0.0
    for name in sogp_regimes.REGIMES:
        res = run(name)
        if name.startswith("strict"):
            max_err = max(max_err, res["max_abs_err"])
        say(f"[2] {name}: {json.dumps(res)}")
    for name in ("strict_d1", "strict_d3"):
        errs = {}
        for slots in sogp_regimes.SLOT_SWEEP:
            errs[slots] = run(name, slots=slots)["max_abs_err"]
        max_err = max(max_err, *errs.values())
        say(f"[2] {name} over slots, max |d|: {json.dumps(errs)}")
    res = run("realistic", slots=32)
    say(f"[2] realistic at 32 slots: {json.dumps(res)}")

    cfg, first, second = sogp_regimes.nan_case()
    first, second = on_dev(*first), on_dev(*second)
    kp = sogp_regimes.params(dev)
    init = sparse_gp.init_batch(cfg, first[0].shape[0], device=dev)
    seeded = sogp_train.add_points_batch_plain(kp, cfg, init, *first)
    ref, out = both(cfg, *second, init=sogp_regimes.poison(seeded))
    res = sogp_regimes.compare("nan", ref, out, *second)
    max_err = max(max_err, res["max_abs_err"])
    say(f"[2] NaN in patch {sogp_regimes.NAN_PATCH}'s C: {json.dumps(res)}")

    cfg, X, Y, M = sogp_regimes.regime("geometric")
    X, Y, M = on_dev(X, Y, M)
    init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
    t = lambda v: torch.tensor(v, device=dev)
    a = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M)
    b = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M,
                                         geom=(t(0.05), t(3.0), t(1e-2)))
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(a, b)),
          "override row differs from the static config")
    say("[2] override row: bit-equal to the static config")

    ccfg = bench_config()
    pts_np, cols_np = synthetic.room_cloud(n=N_POINTS, seed=0)
    pts, cols = on_dev(pts_np, cols_np)
    valid = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    batch = compressor.project(pts, cols, valid, ccfg)
    dkp, ckp = compressor.default_params(ccfg, dev)
    # no bench patch reaches capacity, so there is no deletion churn: the
    # strict rule plus a maximum prediction gap < 1e-3
    bounds = {}
    for gpcfg, kp, Y in ((ccfg.depth_gp, dkp, batch.y),
                         (ccfg.rgb_gp, ckp, batch.rgb)):
        out = compressor.train_gp(batch, gpcfg, kp, Y, use_kernel=True)
        torch.cuda.synchronize()
        ref = compressor.train_gp(batch, gpcfg, kp, Y, use_kernel=False)
        torch.cuda.synchronize()
        bounds[gpcfg.dout] = train_bound(gpcfg, batch.X, batch.mask, out)
        sizes = torch.bincount(sparse_gp.size(out), minlength=4)[:4].tolist()
        say(f"[2] bench banks D={gpcfg.dout}: kernel BV-count histogram "
            f"(0..3): {sizes}")
        check(int(sparse_gp.size(ref).max()) < gpcfg.capacity,
              "a bench patch reached capacity: the strict rule does not apply")
        res = sogp_regimes.compare("bench", ref, out, batch.X, Y, batch.mask,
                                   kp=kp, s20=gpcfg.s20)
        max_err = max(max_err, res["max_abs_err"])
        say(f"[2] bench banks D={gpcfg.dout}: {json.dumps(res)}")

    # ---- 3. the main path
    def round_trip():
        comp, out = compressor.compress_decompress(pts, cols, valid, ccfg)
        torch.cuda.synchronize()
        return comp, out

    round_trip()                                   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    l0 = counted("sogp_train.launches")
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        comp, out = round_trip()
        times.append(time.perf_counter() - t0)
    launches = counted("sogp_train.launches") - l0
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches == 2 * TIMED_RUNS,
          f"kernel launches {launches}, expected {2 * TIMED_RUNS}")
    n_leaves = int(comp.patch.n_leaves)
    banked = int(comp.patch.mask.sum())
    rmse = float(compressor.reconstruction_rmse(comp, ccfg))
    world, colors, pvalid = out[0], out[1], out[2]
    G = ccfg.patch.sz ** 2
    say(f"[3] n_leaves {n_leaves}, banked {banked}, rmse {rmse:.6f} m, "
        f"emitted {int(pvalid.sum())} points")
    check(n_leaves == EXPECT_LEAVES, f"n_leaves {n_leaves} != {EXPECT_LEAVES}")
    check(abs(banked - EXPECT_BANKED) <= 1e-3 * EXPECT_BANKED,
          f"banked {banked} not within 0.1% of {EXPECT_BANKED}")
    check(math.isfinite(rmse) and rmse <= RMSE_MAX,
          f"rmse {rmse} above {RMSE_MAX}")
    check(abs(rmse - RMSE_JAX) <= 0.02 * RMSE_JAX,
          f"rmse {rmse} not within 2% of the JAX package's {RMSE_JAX}")
    check(world.shape == (2048 * G, 3) and colors.shape == (2048 * G, 3),
          "decompress output shape")
    check(bool(torch.isfinite(world[pvalid]).all())
          and bool(torch.isfinite(colors).all()), "non-finite output")
    best = min(times)
    say(f"[3] round trip on {kind} ({card}): wall {times} s, best "
        f"{best:.4f} s = {N_POINTS / best:.1f} points/s; kernel launches "
        f"{launches} in {TIMED_RUNS} runs; peak memory {peak} B")

    # per-stage split, synchronised between stages
    stages = {}
    batch = synced(lambda: compressor.project(pts, cols, valid, ccfg),
                   stages, "project")
    dstates = synced(lambda: compressor.train_gp(
        batch, ccfg.depth_gp, dkp, batch.y), stages, "depth_train")
    cstates = synced(lambda: compressor.train_gp(
        batch, ccfg.rgb_gp, ckp, batch.rgb), stages, "rgb_train")
    dstates, cstates, n_bad_d, n_bad_c = synced(
        lambda: compressor.sanitize(batch, ccfg, dstates, cstates, dkp, ckp,
                                    ccfg.depth_gp.s20), stages, "sanitize")
    comp = compressor.CompressedCloud(batch, dstates, cstates)
    synced(lambda: compressor.decompress(comp, ccfg), stages, "decompress")
    say(f"[3] stages (s) on {kind} ({card}): {json.dumps(stages)}; "
        f"sanitize resets depth {int(n_bad_d)} rgb {int(n_bad_c)}")

    # ---- 4. kernel time against plain-version time at the bench shapes
    timing = {}
    for gpcfg, kp, Y in ((ccfg.depth_gp, dkp, batch.y),
                         (ccfg.rgb_gp, ckp, batch.rgb)):
        init = sparse_gp.init_batch(gpcfg, batch.mask.shape[0], device=dev)
        out = sparse_gp.SOGPState(*[torch.empty_like(a) for a in init])
        row = sogp_train.hyper_row(kp, gpcfg, dev)
        kern = lambda: sogp_train.launch(gpcfg, init, out, batch.X, Y,
                                         batch.mask, row)
        plain = lambda: sogp_train.add_points_batch_plain(
            kp, gpcfg, init, batch.X, Y, batch.mask)
        train = lambda: compressor.train_gp(batch, gpcfg, kp, Y,
                                            use_kernel=True)
        kern(), train()
        torch.cuda.synchronize()
        p1, k1, k2, p2 = (event_ms(plain, 2), event_ms(kern, KERNEL_REPS),
                          event_ms(kern, KERNEL_REPS), event_ms(plain, 2))
        t1 = event_ms(train, KERNEL_REPS)
        bound = bounds[gpcfg.dout]
        ms = (k1 + k2) / 2
        # the longest patch's rows are one dependent chain: the launch
        # cannot end before it does
        rows_max = int(batch.mask.sum(1).max())
        timing[gpcfg.dout] = (ms, (p1 + p2) / 2, bound)
        say(f"[4] D={gpcfg.dout} B=2048 P=256 S=32 on {kind} ({card}): "
            f"kernel {k1:.4f}/{k2:.4f} ms per launch, plain {p1:.4f}/"
            f"{p2:.4f} ms, train_gp (init + row + launch) {t1:.4f} ms; "
            f"bound {bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']} "
            f"({bound['bytes']} B, {bound['flops']:.4g} FLOP needed, "
            f"{bound['flops_dense']:.4g} dense), share of "
            f"bound {bound['bound_ms'] / ms:.4f}; longest patch {rows_max} "
            f"valid rows, {ms * 1e3 / rows_max:.3f} us per row of it")

    # ---- 5. where the round trip's time goes
    profile_phase(pts, cols, valid, ccfg, best, kind, card)

    # ---- 6. the calibrated round trip, and the kernel in its regime
    comp_cal, kp_cal, s20_cal = calibrated_phase(pts, cols, valid, ccfg, dev,
                                                 kind, card)

    # ---- 7. registration against the calibrated and the headline maps
    registration_phase(pts, cols, valid, ccfg, comp_cal, kp_cal, s20_cal,
                       comp, dev, kind, card)

    # ---- 8. the mapping stream, and the kernel at its second call site
    smc_ctx = mapping_phase(pts, cols, valid, ccfg, dev, kind, card)

    # ---- 9. the Bayesian layer
    bayes_phase(pts, cols, valid, ccfg, comp, smc_ctx, dev, kind, card)

    # ---- 10. the K-SVD codec
    ksvd_kernel = ksvd_phase(pts, cols, valid, ccfg, dev, kind, card)

    # ---- 11. ICP, the accuracy pairs, and the MAP calibration's dtype
    icp_accuracy_phase(pts, valid, ccfg, comp, dev, kind, card)

    # ---- 12. the command line
    site = cli_phase(dev, kind, card)

    # ---- 13. the multi-device layer: two ranks on the card, one on NCCL
    shard = sharded_phase(comp, rmse, ccfg, dev, kind, card)

    # one D=1 and one D=3 launch per round trip: ms and plain_ms are their sum
    kernels = [{
        "name": "sogp_train",
        "route": "cuda",
        "source": "gp_compressor_tpu_torch/csrc/sogp_train.cu",
        "replaces": "gp_compressor_tpu/pallas_kernels/sogp_train.py:327",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing[1][0] + timing[3][0],
        "plain_ms": timing[1][1] + timing[3][1],
        "bound_ms": timing[1][2]["bound_ms"] + timing[3][2]["bound_ms"],
        "bound_by": timing[1][2]["bound_by"],
        "library_ms": None,     # no PyTorch call runs the online SOGP loop
        # the command line's call site (gp-compress at its defaults: 4096
        # x 256 banks, 101 slots): its launches, ms per D=1 + D=3 launch
        # pair and bound
        "cli_launches": 2,
        "cli_ms": sum(sum(site[d]["kernel_ms"]) / 2 for d in (1, 3)),
        "cli_plain_ms": sum(sum(site[d]["plain_ms"]) / 2 for d in (1, 3)),
        "cli_bound_ms": sum(site[d]["bound_us"] for d in (1, 3)) / 1e3,
        "cli_bound_by": site[1]["bound_by"],
        # the sharded call site (phase 13: each of 2 ranks sharing the card
        # trains its 1024 x 256 rows): launches per rank per round trip,
        # ms per D=1 + D=3 launch pair (mean over the ranks, launched at
        # once), the plain version's, and the bound at B = 1024
        "sharded_launches": shard["launches_per_rank"],
        "sharded_ms": shard["ms"],
        "sharded_plain_ms": shard["plain_ms"],
        "sharded_bound_ms": shard["bound_ms"],
        "sharded_bound_by": shard["bound_by"],
    }, ksvd_kernel]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def probe_say(tag, card, d):
    print(json.dumps({"probe": tag, "card": card, **d}), flush=True)


def probe_f64_pairs(dev, card):
    import numpy as np

    from gp_compressor_tpu_torch.config import RegistrationConfig
    from gp_compressor_tpu_torch.workloads import compressor

    rcfg = RegistrationConfig(step=0.005, max_steps=150)
    ones = torch.ones(ACC_POINTS // 2, dtype=torch.bool, device=dev)
    rows = []
    for seed in range(ACC_PAIRS):
        row = {"seed": seed}
        for name, dt, use in (("kernel_f32", torch.float32, True),
                              ("plain_f64", torch.float64, False)):
            cfg = accuracy_config(dt)
            mp, mc, truth, scan, scols, Rt, tt = accuracy_pair(seed, dt,
                                                               dev)
            batch = compressor.project(
                mp, mc, ones, cfg,
                generator=torch.Generator(device=dev).manual_seed(seed))
            comp = compressor.train(batch, cfg, use_kernel=use)
            row[name] = align_pair(comp, cfg, rcfg, scan, scols, truth,
                                   Rt, tt)
            row["initial_mean_err_m"] = mean_err(scan, truth)
            row["patches_with_points"] = int(batch.mask.any(1).sum())
        rows.append(row)
        probe_say("f64_pair", card, row)
    out = {}
    for m in ("gp", "icp"):
        e = {r: [p[r][m]["final_mean_err_m"] for p in rows]
             for r in ("kernel_f32", "plain_f64")}
        out[m] = {"median_" + r: float(np.median(v)) for r, v in e.items()}
        out[m]["median_jax_f32"] = float(np.median(ACC_JAX[m]))
        out[m]["p_kernel_f32_vs_plain_f64"] = rank_sum_p(*e.values())
        out[m]["p_plain_f64_vs_jax_f32"] = rank_sum_p(e["plain_f64"],
                                                      ACC_JAX[m])
    for r in ("kernel_f32", "plain_f64"):
        out[r + "_gp_pairs_at_step_cap"] = sum(
            p[r]["gp"]["steps"] == rcfg.max_steps for p in rows)
        out[r + "_depth_emptied_share"] = sum(
            p[r]["depth_emptied"] for p in rows) / sum(
            p["patches_with_points"] for p in rows)
    probe_say("f64_summary", card, out)


def probe_arbitrate(dev, card):
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    def held(tag, kp, gcfg, X, Y, M, s20=None, eps=None):
        init = sparse_gp.init_batch(gcfg, M.shape[0], device=dev)
        try:
            res, stats = kernel_at_site(kp, gcfg, init, X, Y, M, s20, eps,
                                        dev, rule="arbitrated")
        except AssertionError as e:
            res, stats = {"fails": str(e)}, {}
        probe_say("arbitrate", card, {"bank": tag, **res, "launch": stats})

    acfg = accuracy_config()
    dkp, ckp = compressor.default_params(acfg, dev)
    ones = torch.ones(ACC_POINTS // 2, dtype=torch.bool, device=dev)
    for seed in range(3):
        mp, mc = accuracy_pair(seed, torch.float32, dev)[:2]
        b = compressor.project(
            mp, mc, ones, acfg,
            generator=torch.Generator(device=dev).manual_seed(seed))
        held(f"accuracy pair {seed} depth", dkp, acfg.depth_gp, b.X, b.y,
             b.mask)
        held(f"accuracy pair {seed} rgb", ckp, acfg.rgb_gp, b.X, b.rgb,
             b.mask)
    ccfg = bench_config()
    v = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    for seed in range(4):
        p, c = (torch.from_numpy(a).to(dev)
                for a in synthetic.room_cloud(n=N_POINTS, seed=seed))
        for dt in (torch.float32, torch.float64):
            comp, kp, s20, _ = compressor.compress_decompress_calibrated(
                p, c, v, ccfg, calib_dtype=dt)
            eps = ccfg.depth_gp.eps_tol * kp.sigmaf_sq \
                / ccfg.depth_gp.sigmaf_sq
            b = comp.patch
            held(f"calibrated cloud {seed} MAP {dt}", kp, ccfg.depth_gp,
                 b.X, b.y, b.mask, s20=s20, eps=eps)


def reform_only(R, W, dj, xj, using, iters):
    """ksvd_power.block_power with no user row staged in shared memory:
    every pass re-forms each user row from R and W (the path the kernel
    takes past a CTA's rows_cap), for timing the staging against it."""
    from gp_compressor_tpu_torch.cuda_kernels import ksvd_power

    (n, l), b, size = R.shape, dj.shape[0], R.element_size()
    geo = ksvd_power.power_geometry(n, l, size)
    u = torch.empty((b, l), dtype=R.dtype, device=R.device)
    x = torch.empty((b, n), dtype=R.dtype, device=R.device)
    rmax = torch.linalg.vector_norm(R, math.inf)
    err = ksvd_power.build().ksvd_power_launch(
        R.data_ptr(), W.data_ptr(), dj.data_ptr(), dj.stride(0),
        dj.stride(1), xj.data_ptr(), using.data_ptr(), rmax.data_ptr(),
        u.data_ptr(), x.data_ptr(), b, n, l, iters, geo.idx_cap, 0,
        geo.smem_bytes - geo.rows_cap * l * size, size,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return u, x


def probe_ksvd_block(dev, card):
    """The K-SVD atom block kernel at the benchmark's shapes: its build and
    ptxas report, how many atoms' clusters the card runs at once, phase
    10's float32 check over every atom block of one compress of the bench
    cloud (seed 0; users per atom, gaps, card ms per launch, bytes bound),
    and on each block of the first depth and colour sweep: the gap in
    float64, and card ms per launch as the mean of 50 launches of the
    kernel, of the kernel with no row staged (reform_only), of its max
    |R| reduction alone, and of 5 of the plain version."""
    from gp_compressor_tpu_torch.cuda_kernels import ksvd_power
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.utils import synthetic

    ksvd_power.build()
    info = ksvd_power.BUILD_INFO
    probe_say("ksvd_build", card, {
        "seconds": info["seconds"],
        "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                  if "registers" in ln or "spill" in ln],
        "max_active_clusters": {
            f"n={n} {dt}": ksvd_power.max_active_clusters(n, 400, dt)
            for n in (2048, 6144) for dt in (torch.float32, torch.float64)},
        "geometry": {f"n={n} itemsize={sz}": ksvd_power.power_geometry(
            n, 400, sz)._asdict() for n in (2048, 6144) for sz in (4, 8)}})

    ccfg = bench_config()
    pts, cols = (torch.from_numpy(a).to(dev)
                 for a in synthetic.room_cloud(n=N_POINTS, seed=0))
    valid = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    first = {"depth": -(-ccfg.ksvd.dict_size // ccfg.ksvd.atom_block),
             "rgb": -(-ccfg.rgb_ksvd.dict_size // ccfg.rgb_ksvd.atom_block)}
    blk = ksvd_block_run(pts, cols, valid, ccfg, dev, seed=0,
                         keep=max(first.values()))
    for key, nb in first.items():
        res = block_summary(blk[key], blk["patch_rows"]
                            * (3 if key == "rgb" else 1))
        res["sweeps"] = res["launches"] // nb
        per = []
        for R, W, dj, xj, using in blk[key]["kept"][:nb]:
            a64 = [t.double() if t.is_floating_point() else t
                   for t in (R, W, dj, xj, using)]
            got = ksvd_power.block_power(*a64, 20)
            want = dictionary._block_update_plain(*a64, 20)
            staged = ksvd_power.block_power(R, W, dj, xj, using, 20)
            reform = reform_only(R, W, dj, xj, using, 20)
            per.append({
                "gap_f64": max(float((g - w).abs().max()
                                     / w.abs().max().clamp(min=1e-30))
                               for g, w in zip(got, want)),
                "reform_vs_staged": max(float((g - w).abs().max()
                                              / w.abs().max().clamp(
                                                  min=1e-30))
                                        for g, w in zip(reform, staged)),
                "kernel_ms": event_ms(lambda: ksvd_power.block_power(
                    R, W, dj, xj, using, 20), 50),
                "reform_ms": event_ms(lambda: reform_only(
                    R, W, dj, xj, using, 20), 50),
                "rmax_ms": event_ms(lambda: torch.linalg.vector_norm(
                    R, math.inf), 50),
                "plain_ms": event_ms(lambda: dictionary._block_update_plain(
                    R, W, dj, xj, using, 20), 5)})
        res["first_sweep"] = {f: {"mean": sum(p[f] for p in per) / len(per),
                                  "max": max(p[f] for p in per)}
                              for f in per[0]}
        res["first_sweep"]["blocks"] = len(per)
        probe_say(f"ksvd_block_{key}", card, res)


def probe(sections) -> int:
    """`--probe`: the card-side probes phase 11 runs only in part, and
    (`ksvd_block`, only when named) the K-SVD atom block kernel."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train

    dev = torch.device("cuda", 0)
    card = card_line()
    sogp_train.build()
    if "arbitrate" in sections:
        probe_arbitrate(dev, card)
    if "f64_pairs" in sections:
        probe_f64_pairs(dev, card)
    if "ksvd_block" in sections:
        probe_ksvd_block(dev, card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(sys.argv[2], sys.argv[3],
                              sys.argv[4] == "full"))
    if sys.argv[1:2] == ["--probe"]:
        sys.exit(probe(set(sys.argv[2:]) or {"f64_pairs", "arbitrate"}))
    sys.exit(main())
