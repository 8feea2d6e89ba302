"""The training entry the frozen modules call, in its plain form only.

The program launches a CUDA kernel here for device tensors; the reference
never does: `add_points_batch_plain` is the plain per-point loop of
`models.sparse_gp` for every device, fed the same hyperparameter row that
the program's kernel reads, in the GP configuration's dtype.
"""

from __future__ import annotations

import torch

from portbench.reference.config import GPConfig
from portbench.reference.models import sparse_gp
from portbench.reference.models.sparse_gp import SOGPState
from portbench.reference.ops.kernels import RBFParams
from portbench.reference.ops.noise import GaussianNoise


def hyper_row(kp: RBFParams, cfg: GPConfig, device, s20=None, eps_tol=None,
              geom=None, dtype=torch.float32) -> torch.Tensor:
    """[sigmaf^2, l^2, s20, eps_tol, kappa, geom_max_bv,
    gamma_min * sigmaf^2] in `dtype`; geom: optional (dmin, max_bv,
    gamma_min_rel) override."""
    dt = dtype

    def t(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=dt, device=device)
        return torch.full((), v, dtype=dt, device=device)
    sf, l2 = t(kp.sigmaf_sq), t(kp.l_sq)
    g_dmin, g_maxbv, g_gmin = (cfg.geom_dmin, cfg.geom_max_bv,
                               cfg.geom_gamma_min_rel) if geom is None else geom
    kappa = sf * torch.exp(t(-0.5) * t(g_dmin) ** 2 / l2)
    return torch.stack([sf, l2, t(cfg.s20 if s20 is None else s20),
                        t(cfg.eps_tol if eps_tol is None else eps_tol),
                        kappa, t(g_maxbv), t(g_gmin) * sf])


def add_points_batch_plain(kp: RBFParams, cfg: GPConfig, states: SOGPState,
                           X: torch.Tensor, Y: torch.Tensor,
                           mask: torch.Tensor, s20=None, eps_tol=None,
                           geom=None, tally=None) -> SOGPState:
    """Train a bank of patch GPs by the per-point loop, in the states'
    dtype (X and Y are cast to it). tally: optional [B, 5] int64 counts
    of the work (see sparse_gp.add_point)."""
    dt = states.C.dtype
    row = hyper_row(kp, cfg, X.device, s20=s20, eps_tol=eps_tol, geom=geom,
                    dtype=dt)
    return sparse_gp.add_points_batch(
        RBFParams(row[0], row[1]), GaussianNoise(row[2]), cfg, states,
        X.to(dt), Y.to(dt), mask, eps_tol=row[3], geom=(row[4], row[5],
                                                        row[6]),
        tally=tally)

