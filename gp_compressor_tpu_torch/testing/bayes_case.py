"""The Bayesian layer's device check: the same draws through the samplers
on the CPU and on a card, in float64.

`device_parity` runs one NUTS transition, a few HMC steps and a few ADVI
steps on a patch-bank posterior, and `smc_parity` one SMC refinement step
against a map, each once with CPU tensors and once with the card's, the
draws made on the CPU from a seed and copied to both. The card tests run
them on the small cases here; `chip_smoke.py` on the bench posterior and
the bench map. `bank()` is a tiny patch bank drawn from a GP.
"""

from __future__ import annotations

import numpy as np
import torch

from gp_compressor_tpu_torch.config import HMCConfig, SMCConfig
from gp_compressor_tpu_torch.inference import hmc, nuts, smc, vi

PRIOR = dict(prior_mean=(0.0, -1.0, -4.0), prior_std=4.0)
THETA0 = ((0.5, -0.5, -4.0), (1.0, -2.0, -5.0))


def bank(B: int = 4, n: int = 12, seed: int = 0):
    """(X [B, n, 2], y [B, n], mask [B, n]) float64: a GP draw at
    sigma_f^2 2, l^2 0.25, s20 0.01, three rows of one patch masked."""
    r = np.random.default_rng(seed)
    X = r.uniform(-1.0, 1.0, (B, n, 2))
    d2 = np.sum((X[:, :, None] - X[:, None]) ** 2, -1)
    K = 2.0 * np.exp(-0.5 * d2 / 0.25) + 0.01 * np.eye(n)
    y = np.stack([r.multivariate_normal(np.zeros(n), K[b]) for b in range(B)])
    mask = np.ones((B, n))
    mask[1, -3:] = 0.0
    return X, y, mask


def to_device(x, device, dtype=torch.float64):
    """x (a tensor or nested NamedTuples of tensors) on device, floating
    tensors cast to dtype."""
    if isinstance(x, tuple):
        items = [to_device(a, device, dtype) for a in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if x is None:
        return None
    return x.to(device, dtype if x.is_floating_point() else x.dtype)


def _err(a, b) -> float:
    return float(torch.max(torch.abs(a.cpu() - b.cpu())))


def device_parity(X, y, mask, theta0, device, eps: float,
                  max_depth: int = 8, hmc_steps: int = 2,
                  advi_steps: int = 5, seed: int = 0, prior=None) -> dict:
    """CPU against `device`, float64, same draws: one NUTS transition of
    the chains theta0 [C, 3] at step eps (unit metric), hmc_steps HMC steps
    (half warmup, half sampling), advi_steps ADVI steps from theta0[0].
    Returns the largest absolute differences and both leapfrog counts."""
    g = torch.Generator().manual_seed(seed)
    theta0 = torch.as_tensor(theta0, dtype=torch.float64)
    C, dim = theta0.shape
    nd = nuts.draw_transition(C, dim, max_depth, torch.float64, "cpu", g)
    hd = hmc.HMCDraws(torch.randn((C, hmc_steps, dim), generator=g,
                                  dtype=torch.float64),
                      torch.rand((C, hmc_steps), generator=g,
                                 dtype=torch.float64))
    ad = torch.randn((advi_steps, 8, dim), generator=g, dtype=torch.float64)
    hcfg = HMCConfig(num_warmup=hmc_steps // 2,
                     num_samples=hmc_steps - hmc_steps // 2, num_chains=C)
    runs = []
    for dev in ("cpu", device):
        on = lambda a: to_device(torch.as_tensor(a), dev)
        lp = hmc.make_patch_logpost(on(X), on(y), on(mask), **(prior or {}))
        th = on(theta0)
        n = nuts.nuts_step(lp, th, eps, torch.ones_like(th), max_depth,
                           draws=to_device(nd, dev))
        h = hmc.hmc_sample_chains(lp, th, hcfg, draws=to_device(hd, dev))
        a = vi.fit_advi(lp, th[0], steps=advi_steps, eps=on(ad))
        runs.append((n, h, a))
    (n0, h0, a0), (n1, h1, a1) = runs
    return {
        "nuts_theta": _err(n0[0], n1[0]), "nuts_accept": _err(n0[1], n1[1]),
        "nuts_leapfrogs_cpu": n0[2].tolist(),
        "nuts_leapfrogs_device": n1[2].tolist(),
        "hmc": max(_err(a, b) for a, b in zip(h0, h1)),
        "advi": max(_err(a, b) for a, b in zip(a0, a1))}


def smc_parity(state, points, colors, valid, cfg, device,
               num_particles: int = 64, n_eval_points: int = 512,
               seed: int = 0, depth_kp=None, depth_s20=None) -> dict:
    """CPU against `device`, float64, same draws: smc_refine_pose with one
    SMC step of the map `state` over the scan. Returns the largest absolute
    differences of the refined pose and of the particles."""
    from gp_compressor_tpu_torch.workloads import mapping

    P = num_particles
    g = torch.Generator().manual_seed(seed)
    draws = (torch.randn((P, 6), generator=g, dtype=torch.float64),
             smc.draw_steps(1, P, torch.float64, "cpu", g))
    scfg = SMCConfig(num_particles=P, pose_proposal_std_t=0.012,
                     pose_proposal_std_r=0.004)
    runs = []
    for dev in ("cpu", device):
        on = lambda a: to_device(a, dev)
        (R, t), st, trace = mapping.smc_refine_pose(
            on(state), on(points), on(colors), on(valid), cfg, scfg,
            n_iters=1, n_eval_points=n_eval_points, draws=on(draws),
            depth_kp=on(depth_kp), depth_s20=on(depth_s20))
        runs.append((R, t, st.poses, st.log_weights, trace))
    return {"smc_pose": max(_err(a, b) for a, b in zip(runs[0][:2],
                                                       runs[1][:2])),
            "smc_particles": max(_err(a, b) for a, b in zip(runs[0][2:],
                                                            runs[1][2:]))}
