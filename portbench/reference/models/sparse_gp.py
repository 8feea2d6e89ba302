"""Sparse online Gaussian process (Csató–Opper) over a batch of patches.

The port of `gp_compressor_tpu.models.sparse_gp`: a capacity-padded state
record with a per-slot `active` mask; "append" writes the first free slot
and "delete" is a masked rank-1 downdate. JAX writes the update for one
patch and `vmap`s it; here every function takes the patch axis B as the
leading dimension of every state tensor, and the point loop (`lax.scan`
there) is a Python loop.

This is the unfused path: each point costs a few dozen small batched
torch ops over [B, S, S]. It is the plain version of the fused CUDA
training kernel (`cuda_kernels.sogp_train`) and the reference the kernel
is compared with. Arithmetic is float32 with the same guards as the JAX
package: difference-form distances, the s2 >= gamma clamp, the gamma_tiny
floor and the sanitize pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference.config import GPConfig
from portbench.reference.ops import kernels
from portbench.reference.ops.kernels import RBFParams
from portbench.reference.ops.noise import GaussianNoise


class SOGPState(NamedTuple):
    """Capacity-padded sparse-GP state of a bank of B patches (S = slots).

      bv:     [B, S, dim]   basis-vector inputs
      alpha:  [B, S, dout]  weight vector(s)
      C:      [B, S, S]     negative-precision-like matrix
      Q:      [B, S, S]     inverse Gram over the BVs
      active: [B, S] bool   slot occupancy mask
    Inactive slots are exactly zero in every array.
    """

    bv: torch.Tensor
    alpha: torch.Tensor
    C: torch.Tensor
    Q: torch.Tensor
    active: torch.Tensor

    @property
    def slots(self) -> int:
        return self.C.shape[-1]


def init_batch(cfg: GPConfig, n: int, device="cuda") -> SOGPState:
    """A bank of n empty patch GPs on `device`."""
    z = lambda *s: torch.zeros((n,) + s, dtype=cfg.dtype, device=device)
    return SOGPState(bv=z(cfg.slots, cfg.dim), alpha=z(cfg.slots, cfg.dout),
                     C=z(cfg.slots, cfg.slots), Q=z(cfg.slots, cfg.slots),
                     active=torch.zeros((n, cfg.slots), dtype=torch.bool,
                                        device=device))


def size(state: SOGPState) -> torch.Tensor:
    return torch.sum(state.active, dim=-1)


def _select(pred: torch.Tensor, new: SOGPState, old: SOGPState) -> SOGPState:
    """Per-patch select; pred: [B] bool."""
    return SOGPState(*[torch.where(pred.reshape((-1,) + (1,) * (a.ndim - 1)),
                                   a, b) for a, b in zip(new, old)])


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, S, S] x [B, S] -> [B, S]."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _onehot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (torch.arange(n, device=idx.device) == idx[:, None]).to(dtype)


def _delete_bv(state: SOGPState, loc: torch.Tensor) -> SOGPState:
    """Masked rank-1 removal of slot loc[b] from every patch b (no
    compaction). For the surviving slots
      alpha -= (Q+C)_:loc alpha*_loc / (q* + c*)
      C     += Q_:loc Q_:loc^T / q* - (Q+C)_:loc (Q+C)_:loc^T / (q* + c*)
      Q     -= Q_:loc Q_:loc^T / q*
    then row/col loc is zeroed and the slot deactivated."""
    dt = state.C.dtype
    oh = _onehot(loc, state.slots, dt)                           # [B, S]
    ix = loc[:, None]
    astar = torch.gather(state.alpha, 1,
                         ix[:, :, None].expand(-1, 1, state.alpha.shape[2]))
    Ccol = torch.gather(state.C, 2, ix[:, None, :].expand(-1, state.slots, 1))
    Qcol = torch.gather(state.Q, 2, ix[:, None, :].expand(-1, state.slots, 1))
    Ccol, Qcol = Ccol[..., 0], Qcol[..., 0]                      # [B, S]
    cstar = torch.gather(Ccol, 1, ix)                            # [B, 1]
    qstar = torch.gather(Qcol, 1, ix)
    keep = 1.0 - oh
    Cs = Ccol * keep
    Qs = Qcol * keep
    qc = Qs + Cs
    denom = qstar + cstar                                        # [B, 1]
    alpha = state.alpha - qc[:, :, None] * astar / denom[:, :, None]
    C = (state.C + Qs[:, :, None] * Qs[:, None, :] / qstar[:, :, None]
         - qc[:, :, None] * qc[:, None, :] / denom[:, :, None])
    Q = state.Q - Qs[:, :, None] * Qs[:, None, :] / qstar[:, :, None]
    kk = keep[:, :, None] * keep[:, None, :]
    return SOGPState(bv=state.bv * keep[:, :, None],
                     alpha=alpha * keep[:, :, None], C=C * kk, Q=Q * kk,
                     active=state.active & (oh == 0))


def _capacity_scores(state: SOGPState) -> torch.Tensor:
    """Csató eq. 3.26 scores |alpha_i|^2 / (Q_ii + C_ii); +inf when inactive."""
    diag = (torch.diagonal(state.Q, dim1=-2, dim2=-1)
            + torch.diagonal(state.C, dim1=-2, dim2=-1))
    s = torch.sum(state.alpha ** 2, dim=-1) / diag
    return torch.where(state.active, s, torch.inf)


def _geometric_scores(state: SOGPState) -> torch.Tensor:
    """1 / Q_ii; +inf when inactive."""
    return torch.where(state.active,
                       1.0 / torch.diagonal(state.Q, dim1=-2, dim2=-1),
                       torch.inf)


def add_point(kp: RBFParams, noise: GaussianNoise, cfg: GPConfig,
              state: SOGPState, x: torch.Tensor, y: torch.Tensor,
              valid: torch.Tensor, eps_tol=None, geom=None,
              tally: Optional[torch.Tensor] = None) -> SOGPState:
    """One Csató–Opper update on every patch of the bank.

    x: [B, dim], y: [B, dout], valid: [B] bool (an invalid row is a no-op).
    Both the sparse and the full update are computed and selected per patch.
    eps_tol: None (cfg.eps_tol), a 0-dim tensor, or a [B] tensor.
    geom: None (thresholds from cfg), or the resolved geometric admission
    thresholds (kappa, max_bv, gamma_min) as 0-dim tensors — the entries
    4-6 of the training kernel's hyperparameter row.
    tally: optional [B, 5] int64 counts, incremented in place per patch:
    basis vectors added, capacity deletions, geometric deletions, and the
    sums over valid rows of the BV count a row starts with and of its
    square (what the row's work scales with)."""
    dt = state.C.dtype
    S = state.slots
    act = state.active.to(dt)
    if tally is not None:
        n_in = size(state) * valid
        tally[:, 3] += n_in
        tally[:, 4] += n_in * n_in

    kstar = kp.sigmaf_sq
    k = kernels.gram(kp, x[:, None, :], state.bv)[:, 0, :] * act    # [B, S]
    m = torch.einsum('bsd,bs->bd', state.alpha, k)                  # [B, D]
    Ck = _mv(state.C, k)
    s2 = kstar + torch.sum(k * Ck, dim=-1)                          # [B]
    e_hat = _mv(state.Q, k)
    gamma = kstar - torch.sum(k * e_hat, dim=-1)
    gamma = torch.where(gamma < cfg.gamma_tiny, 0.0, gamma)
    # s2 >= gamma holds in exact arithmetic; enforcing it bounds the
    # sparse-update gain eta = 1 / (1 + gamma r) against f32 rounding
    s2 = torch.maximum(s2, gamma)
    r = noise.dx2_ln(y, m, s2)                                      # [B]
    q = noise.dx_ln(y, m, s2[:, None])                              # [B, D]

    # sparse update: project onto the existing BVs
    eta = 1.0 / (1.0 + gamma * r)
    s_hat = Ck + e_hat
    alpha_s = state.alpha + s_hat[:, :, None] * q[:, None, :] * eta[:, None, None]
    C_s = state.C + (r * eta)[:, None, None] * (s_hat[:, :, None] * s_hat[:, None, :])

    # full update: activate the first free slot
    slot = torch.argmin(act, dim=-1)
    oh = _onehot(slot, S, dt)
    s_f = Ck + oh
    alpha_f = state.alpha + s_f[:, :, None] * q[:, None, :]
    C_f = state.C + r[:, None, None] * (s_f[:, :, None] * s_f[:, None, :])
    e_f = e_hat - oh
    Q_f = state.Q + (e_f[:, :, None] * e_f[:, None, :]) \
        / torch.clamp(gamma, min=cfg.gamma_tiny)[:, None, None]
    bv_f = state.bv * (1.0 - oh)[:, :, None] + oh[:, :, None] * x[:, None, :]
    active_f = state.active | (oh > 0)

    if cfg.novelty_mode == "geometric":
        if geom is None:
            kappa = kp.sigmaf_sq * torch.exp(
                torch.tensor(-0.5 * cfg.geom_dmin ** 2, dtype=dt,
                             device=k.device) / kp.l_sq)
            max_bv, gamma_min = cfg.geom_max_bv, \
                cfg.geom_gamma_min_rel * kp.sigmaf_sq
        else:
            kappa, max_bv, gamma_min = geom
        admit = (torch.sum(act, dim=-1) < max_bv) \
            & (torch.amax(k, dim=-1) < kappa) & (gamma > gamma_min)
        use_sparse = ~admit
    else:
        use_sparse = gamma < (cfg.eps_tol if eps_tol is None else eps_tol)
    new = _select(use_sparse, SOGPState(state.bv, alpha_s, C_s, state.Q,
                                        state.active),
                  SOGPState(bv_f, alpha_f, C_f, Q_f, active_f))

    # capacity deletion: one add grows by at most one BV
    over = size(new) > cfg.capacity
    new = _select(over, _delete_bv(new, torch.argmin(_capacity_scores(new),
                                                     dim=-1)), new)
    if tally is not None:
        tally[:, 0] += ~use_sparse & valid
        tally[:, 1] += over & valid

    # bounded geometric deletions
    for _ in range(cfg.max_geometric_deletes):
        g = _geometric_scores(new)
        pred = (torch.amin(g, dim=-1) < cfg.geom_tol) & (size(new) > 1)
        new = _select(pred, _delete_bv(new, torch.argmin(g, dim=-1)), new)
        if tally is not None:
            tally[:, 2] += pred & valid

    return _select(valid, new, state)


def add_points_batch(kp: RBFParams, noise: GaussianNoise, cfg: GPConfig,
                     states: SOGPState, X: torch.Tensor, Y: torch.Tensor,
                     mask: torch.Tensor, keys=None, eps_tol=None,
                     geom=None, tally=None) -> SOGPState:
    """Insert each patch's points in bank order: X [B, n, dim],
    Y [B, n, dout], mask [B, n].

    eps_tol: None, a scalar (0-dim tensor or float), or [B, n] per-point
    thresholds. keys: None (bank order), or [B, n] per-patch permutations
    of the rows, the insertion order (JAX draws `permutation(keys[b], n)`
    for patch b); per-point thresholds follow their rows. geom, tally: see
    add_point."""
    per_point = isinstance(eps_tol, torch.Tensor) and eps_tol.ndim == 2
    if keys is not None:
        p = keys.long().to(X.device)
        take = lambda a: torch.take_along_dim(
            a, p.reshape(p.shape + (1,) * (a.ndim - 2)), dim=1)
        X, Y, mask = take(X), take(Y), take(mask)
        if per_point:
            eps_tol = take(eps_tol)
    for p in range(X.shape[1]):
        e = eps_tol[:, p] if per_point else eps_tol
        states = add_point(kp, noise, cfg, states, X[:, p], Y[:, p],
                           mask[:, p], eps_tol=e, geom=geom, tally=tally)
    return states


def predict(kp: RBFParams, s20, state: SOGPState,
            Xstar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior predictive mean [..., m, dout] and observation variance
    [..., m] (includes s20) of batched states at Xstar [..., m, dim]:
    f* = k^T alpha, var = s20 + max(k** + k^T C k, 0)."""
    act = state.active.to(state.C.dtype)
    K = kernels.gram(kp, Xstar, state.bv) * act[..., None, :]    # [.., m, S]
    mean = torch.matmul(K, state.alpha)
    KC = torch.matmul(K, state.C)
    latent = kernels.kdiag(kp, Xstar) + torch.sum(KC * K, dim=-1)
    return mean, s20 + torch.clamp(latent, min=0.0)


# the state, the queries and the result all carry the patch axis already
predict_batch = predict


def sanitize_batch(states: SOGPState, kp: Optional[RBFParams] = None,
                   s20=None, max_pred: float = 1e3,
                   probes: Optional[torch.Tensor] = None):
    """Reset patches whose state went non-finite or predicts garbage;
    returns (states, n_bad) with n_bad a 0-dim tensor.

    With kernel params, health is judged on the patch's own predictions at
    its BV sites plus the shared `probes` [m, dim] across the footprint."""
    bad = torch.zeros(states.C.shape[0], dtype=torch.bool,
                      device=states.C.device)
    for leaf in (states.bv, states.alpha, states.C, states.Q):
        bad = bad | ~torch.isfinite(leaf).flatten(1).all(dim=1)
    if kp is not None:
        sites = states.bv
        if probes is not None:
            B = states.bv.shape[0]
            sites = torch.cat([sites, probes.expand((B,) + probes.shape)],
                              dim=1)
        mean, var = predict_batch(kp, s20, states, sites)
        pred_ok = (torch.isfinite(mean) & (torch.abs(mean) < max_pred)) \
            .flatten(1).all(dim=1) & torch.isfinite(var).all(dim=1)
        bad = bad | ~pred_ok

    def fix(a):
        return torch.where(bad.reshape((-1,) + (1,) * (a.ndim - 1)),
                           torch.zeros_like(a), a)

    return SOGPState(*[fix(a) for a in states]), torch.sum(bad)
