"""Sequential Monte Carlo over scan poses.

The port of `gp_compressor_tpu.inference.smc`: a particle population over
6-DoF pose perturbations (t, Euler angles) is weighted by a data
log-likelihood, resampled systematically when its effective sample size
collapses, and jittered by a random-walk proposal. Particles are one batch
dim; a step reads nothing back (the resampling decision is a predicate).

The randomness of a step is one `SMCDraws` (the jitter's normals and the
resampling offset), drawn from a `torch.Generator` (seed 0 when None) or
passed in; init_particles takes its normals the same way.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gp_compressor_tpu_torch.config import SMCConfig
from gp_compressor_tpu_torch.geometry import transforms
from gp_compressor_tpu_torch.inference.nuts import _generator


class ParticleState(NamedTuple):
    poses: torch.Tensor        # [P, 6] (t, Euler angles) perturbations
    log_weights: torch.Tensor  # [P]


class SMCDraws(NamedTuple):
    """One step's draws: the jitter's standard normals [P, 6] (translation
    then rotation columns) and the systematic-resampling offset u0 in
    [0, 1/P) (0-dim). With a leading [n_iters] dim, a run's draws."""

    normals: torch.Tensor
    u0: torch.Tensor


def draw_steps(n: int, P: int, dtype, device,
               generator: Optional[torch.Generator] = None) -> SMCDraws:
    """SMCDraws of n steps ([n, P, 6], [n]): one normal, one uniform draw."""
    g = _generator(generator, device)
    return SMCDraws(
        torch.randn((n, P, 6), generator=g, dtype=dtype, device=device),
        torch.rand((n,), generator=g, dtype=dtype, device=device) / P)


def init_particles(cfg: SMCConfig, generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device="cuda",
                   normals: Optional[torch.Tensor] = None) -> ParticleState:
    """P particles around the identity: translation std pose_proposal_std_t,
    rotation std pose_proposal_std_r; particle 0 is the identity."""
    P = cfg.num_particles
    if normals is None:
        normals = torch.randn((P, 6), generator=_generator(generator, device),
                              dtype=dtype, device=device)
    poses = torch.cat([cfg.pose_proposal_std_t * normals[:, :3],
                       cfg.pose_proposal_std_r * normals[:, 3:]], dim=-1)
    poses = torch.cat([torch.zeros_like(poses[:1]), poses[1:]])
    return ParticleState(poses=poses, log_weights=torch.zeros(
        (P,), dtype=poses.dtype, device=poses.device))


def pose_matrices(poses: torch.Tensor):
    """[P, 6] -> (R [P, 3, 3], t [P, 3]) by the Euler composition
    R = Rx Ry Rz of the registration step (transforms.euler_xyz)."""
    a = poses[:, 3:].T                                       # [3, P]
    Rx, Ry, Rz = (f(x).permute(2, 0, 1) for f, x in zip(
        (transforms.rot_x, transforms.rot_y, transforms.rot_z), a))
    return transforms.matmul3(transforms.matmul3(Rx, Ry), Rz), poses[:, :3]


def ess(log_weights: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(log_weights, dim=0)
    return 1.0 / torch.sum(w * w)


def systematic_resample(state: ParticleState,
                        u0: torch.Tensor) -> ParticleState:
    """Systematic resampling at offsets u0 + i / P: the cumulative weights
    inverted by a left-side searchsorted, clipped to the last particle."""
    P = state.poses.shape[0]
    w = torch.softmax(state.log_weights, dim=0)
    cum = torch.cumsum(w, dim=0)
    u = u0 + torch.arange(P, dtype=w.dtype, device=w.device) / P
    idx = torch.clamp(torch.searchsorted(cum, u), 0, P - 1)
    return ParticleState(poses=state.poses[idx],
                         log_weights=torch.zeros_like(state.log_weights))


def smc_step(state: ParticleState,
             loglik_fn: Callable[[torch.Tensor], torch.Tensor],
             cfg: SMCConfig, generator: Optional[torch.Generator] = None,
             draws: Optional[SMCDraws] = None
             ) -> Tuple[ParticleState, torch.Tensor]:
    """One SMC iteration: jitter (particle 0 keeps its pose) -> reweight by
    loglik_fn ([P, 6] -> [P]) -> resample where the ESS falls below
    ess_threshold * P. Returns (state, weighted-mean pose [6])."""
    P = state.poses.shape[0]
    if draws is None:
        d = draw_steps(1, P, state.poses.dtype, state.poses.device,
                       generator)
        draws = SMCDraws(d.normals[0], d.u0[0])
    jit = torch.cat([cfg.pose_proposal_std_t * draws.normals[:, :3],
                     cfg.pose_proposal_std_r * draws.normals[:, 3:]], dim=-1)
    poses = torch.cat([state.poses[:1], (state.poses + jit)[1:]])

    logw = state.log_weights + loglik_fn(poses)
    logw = logw - torch.logsumexp(logw, dim=0)
    st = ParticleState(poses=poses, log_weights=logw)
    do_resample = ess(logw) < cfg.ess_threshold * P
    res = systematic_resample(st, draws.u0)
    st = ParticleState(*[torch.where(do_resample, a, b)
                         for a, b in zip(res, st)])
    w = torch.softmax(st.log_weights, dim=0)
    return st, torch.sum(w[:, None] * st.poses, dim=0)
