"""Card-side probes of the Bayesian layer that chip_smoke.py does not run.

    python3 bayes_probe.py [nuts_seeds] [hmc_dtype]

on a machine with a CUDA card, from the repository root (both sections
when none is named; each prints JSON lines with the card's name and power
limit):

  * nuts_seeds — the 16-chain NUTS row of chip_smoke.py's phase 9
    (bench.py:414-433: 50 warmup + 100 samples on the headline banks'
    16 x 48 subsample, float32) at generator seeds 100-105: max
    split-R-hat, posterior std and each chain's mean per run, the spread
    one run cannot show;
  * hmc_dtype — the calibration of compress_calibrated(method="hmc") (2
    chains from the reference constants and + 0.3, 400 warmup + 400
    samples, the 32 x 64 subsample): in float32 on the card at seeds 0-2,
    in float32 on the card and on the CPU from the same CPU-drawn
    normals and uniforms, and in float64 on the card from those draws;
    each chain's mean and the float32 posterior there (evaluated in
    float64). Then the float32 log posterior's error against that exact
    value, on the card and on the CPU, over 4,000 random theta of the
    region the warmup crosses.

It takes ~10 minutes. The port's tests do not run it.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

import chip_smoke as cs


def say(tag, card, d):
    print(json.dumps({"probe": tag, "card": card, **d}), flush=True)


def headline(dev):
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    ccfg = cs.bench_config()
    p, c = synthetic.room_cloud(n=cs.N_POINTS, seed=0)
    pts, cols = torch.from_numpy(p).to(dev), torch.from_numpy(c).to(dev)
    valid = torch.ones(cs.N_POINTS, dtype=torch.bool, device=dev)
    return ccfg, compressor.project(pts, cols, valid, ccfg)


def nuts_seeds(batch, dev, card):
    from gp_compressor_tpu_torch.config import HMCConfig
    from gp_compressor_tpu_torch.inference import hmc, nuts
    from gp_compressor_tpu_torch.workloads import compressor

    Xc, yc, mc = compressor.calib_subsample(batch, 16, 48)
    logpost = hmc.make_patch_logpost(Xc, yc, mc.to(Xc.dtype))
    theta0 = torch.tensor([math.log(100.0), 0.0, math.log(0.1)], device=dev)
    cfg = HMCConfig(num_warmup=cs.NUTS_WARMUP, num_samples=100,
                    num_chains=16)
    for seed in range(100, 106):
        g = torch.Generator(device=dev).manual_seed(seed)
        th0 = theta0 + 0.2 * torch.randn((16, 3), generator=g, device=dev)
        (s, acc, _), wall = cs.timed(lambda: nuts.nuts_sample_chains(
            logpost, th0, cfg, generator=g))
        say("nuts16", card, {
            "seed": seed, "wall_s": wall,
            "max_rhat": float(hmc.split_rhat(s).max()),
            "std": s.double().reshape(-1, 3).std(0).tolist(),
            "accept": float(acc.mean()),
            "chain_means": s.double().mean(1).tolist()})


def hmc_dtype(batch, ccfg, dev, card):
    from gp_compressor_tpu_torch.config import HMCConfig
    from gp_compressor_tpu_torch.inference import hmc
    from gp_compressor_tpu_torch.workloads import compressor

    Xc, yc, mc = compressor.calib_subsample(batch, 32, 64)
    # each dtype's own noise floor, as compress_calibrated builds it
    # (float32: 1e-4 sigma_f^2, float64: none); `exact` is the float32
    # posterior evaluated in float64
    lps = {(d, dt): hmc.make_patch_logpost(
        Xc.to(d, dt), yc.to(d, dt), mc.to(d, dt))
        for d in ("cpu", dev) for dt in (torch.float32, torch.float64)}
    exact = hmc.make_patch_logpost(Xc.cpu().double(), yc.cpu().double(),
                                   mc.cpu().double(), noise_floor_rel=1e-4)
    g = ccfg.depth_gp
    th0 = torch.tensor([math.log(g.sigmaf_sq), math.log(g.l_sq),
                        math.log(g.s20)], dtype=torch.float64)
    start = torch.stack([th0, th0 + 0.3])
    cfg = HMCConfig(num_warmup=400, num_samples=400, num_chains=2)
    cpu_g = torch.Generator().manual_seed(0)
    fixed = hmc.HMCDraws(torch.randn((2, 800, 3), generator=cpu_g,
                                     dtype=torch.float64),
                         torch.rand((2, 800), generator=cpu_g,
                                    dtype=torch.float64))
    runs = [(f"card float32, seed {k}", dev, torch.float32, k)
            for k in range(3)]
    runs += [("card float32, CPU draws", dev, torch.float32, None),
             ("cpu float32, CPU draws", "cpu", torch.float32, None),
             ("card float64, CPU draws", dev, torch.float64, None)]
    for label, d, dt, seed in runs:
        lp = lps[(d, dt)]
        draws = None if seed is not None else hmc.HMCDraws(
            *[a.to(d, dt) for a in fixed])
        gen = None if seed is None else \
            torch.Generator(device=d).manual_seed(seed)
        t0 = time.perf_counter()
        s, acc, _ = hmc.hmc_sample_chains(lp, start.to(d, dt), cfg,
                                          generator=gen, draws=draws)
        means = s.double().mean(1)
        say("hmc_calibration", card, {
            "run": label, "wall_s": time.perf_counter() - t0,
            "chain_means": means.tolist(), "accept": acc.tolist(),
            "theta_mean_exp": torch.exp(s.double().reshape(-1, 3).mean(0))
            .tolist(),
            "float32_posterior_at_chain_means": exact(means.cpu()).tolist()})
    # float32 against float64 over the region the warmup crosses
    cpu_g = torch.Generator().manual_seed(0)
    th = torch.stack([torch.empty(4000).uniform_(-8, 6, generator=cpu_g),
                      torch.empty(4000).uniform_(-7, 1.5, generator=cpu_g),
                      torch.empty(4000).uniform_(-25, -1, generator=cpu_g)],
                     1)
    ref = exact(th.double())
    for d in (dev, "cpu"):
        v = lps[(d, torch.float32)](th.to(d)).cpu().double()
        ok = torch.isfinite(ref) & torch.isfinite(v)
        err = (v - ref)[ok].abs()
        say("float32_logpost_error", card, {
            "device": str(d), "thetas": int(ok.sum()),
            "median": float(err.median()), "p99": float(err.quantile(0.99)),
            "max": float(err.max())})


def main(sections) -> int:
    if not torch.cuda.is_available():
        print("bayes_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    ccfg, batch = headline(dev)
    if "nuts_seeds" in sections:
        nuts_seeds(batch, dev, card)
    if "hmc_dtype" in sections:
        hmc_dtype(batch, ccfg, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(set(sys.argv[1:]) or {"nuts_seeds", "hmc_dtype"}))
