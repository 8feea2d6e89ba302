"""Masked OMP and masked K-SVD, written from the source's description.

The source (nilsbore/gp_compressor) codes each patch row one at a time:
`orthogonal_matching_pursuit::omp_match_vector` and
`ksvd_decomposition` (SURVEY.md §2.2). This file keeps its steps and
writes each as plainly as a check that runs on the card in seconds
allows: the rows of a problem are coded side by side, but each atom of
the dictionary update is its own loop over the rows that use it.

  * OMP: per step, the greedy atom is the argmax of |r^T D| over the atoms
    the row has not used yet (a non-finite correlation counts as 0); the
    coefficients of the k + 1 atoms selected so far are solved directly
    from their masked Gram matrix with a unit diagonal (the source's
    "assuming ||x_k+1|| = 1") against the masked correlations; a row
    stops at `words_max` words or when its masked residual^2 falls below
    `proj_error`.
  * K-SVD: replace the atoms no row used by normalised data rows, encode
    every row, update the atoms, until the masked MSE changes by less
    than `stop_diff` or `max_iters` sweeps ran; then encode once more.
  * Atom update: for each atom j, its users' masked residual with atom
    j's part restored, A = W o (R + x_j d_j^T), and its largest singular
    pair by NIPALS; d_j <- u, x_j <- sigma v.

Departures from the source, each the configuration's (its `assumed`):

  * atoms are updated in blocks of `atom_block`: every atom of a block
    starts from the residual at the block's start and the block's rank-1
    corrections are applied together (the source: one atom at a time,
    `atom_block` 1);
  * NIPALS runs a fixed `power_iters` iterations from u = 1 / sqrt(l)
    (the source stops early at a relative change of 0.01);
  * the source's incremental inverse-Gram update is a direct solve, the
    same arithmetic in another order;
  * the random data rows of the replacement are given (`init`,
    `sweeps`: row indices), not drawn here;
  * in a dtype below float32 (the control) the small solves run in
    float32 and are rounded back: torch has no solver in bfloat16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class KSVDConfig:
    """The codec's constants (the configuration's `ksvd` or `rgb_ksvd`)."""

    dict_size: int
    words_max: int
    proj_error: float
    stop_diff: float
    max_iters: int
    power_iters: int
    atom_block: int


class Code(NamedTuple):
    X: torch.Tensor    # [n, words_max] coefficients
    I: torch.Tensor    # [n, words_max] atom of each word
    nw: torch.Tensor   # [n] words used


class KSVDResult(NamedTuple):
    D: torch.Tensor     # [l, K] unit atoms
    code: Code
    error: torch.Tensor  # 0-dim masked MSE of the final code
    iters: int


def _solve(G: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """G x = c for a batch of small systems; a singular G gives
    non-finite values, not an error."""
    dt = G.dtype
    work = dt if dt in (torch.float32, torch.float64) else torch.float32
    x = torch.linalg.solve_ex(G.to(work), c.to(work)[..., None],
                              check_errors=False)[0][..., 0]
    return x.to(dt)


def omp(D: torch.Tensor, S: torch.Tensor, W: torch.Tensor,
        valid: torch.Tensor, cfg: KSVDConfig) -> Code:
    """Masked OMP of every row of S [n, l] (mask W [n, l] of 0 / 1,
    valid [n] bool: an invalid row takes no word) against D [l, K]."""
    n, l = S.shape
    K = D.shape[1]
    dev, dt = S.device, S.dtype
    Sm = S * W
    r = Sm.clone()
    used = torch.zeros((n, K), dtype=torch.bool, device=dev)
    I = torch.zeros((n, cfg.words_max), dtype=torch.int64, device=dev)
    X = torch.zeros((n, cfg.words_max), dtype=dt, device=dev)
    nw = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    for k in range(cfg.words_max):
        go = valid & (torch.sum(r * r, dim=1) >= cfg.proj_error)
        corr = (r @ D).abs()
        corr = torch.where(torch.isfinite(corr), corr, 0.0)
        corr = torch.where(used, -1.0, corr)
        j = torch.argmax(corr, dim=1)
        I[go, k] = j[go]
        used[rows[go], j[go]] = True
        # the words so far: atoms [n, k + 1, l], masked Gram, unit diagonal
        A = D.T[I[:, :k + 1]]
        G = (A * W[:, None, :]) @ A.transpose(1, 2)
        G.diagonal(dim1=1, dim2=2).fill_(1.0)
        c = (A @ Sm[:, :, None])[..., 0]
        x = _solve(G, c)
        X[go, :k + 1] = x[go]
        nw[go] = k + 1
        res = Sm - W * (x[:, None, :] @ A)[:, 0, :]
        r[go] = res[go]
    return Code(X=X, I=I, nw=nw)


def reconstruct(D: torch.Tensor, code: Code) -> torch.Tensor:
    """Row i: sum over its words k < nw[i] of X[i, k] D[:, I[i, k]]."""
    kmax = code.X.shape[1]
    use = torch.arange(kmax, device=code.X.device)[None, :] \
        < code.nw[:, None]
    x = torch.where(use, code.X, 0.0)
    return (x[:, None, :] @ D.T[code.I.long()])[:, 0, :]


def masked_error(D, code: Code, S, W, valid) -> torch.Tensor:
    """ksvd_decomposition::compute_error: the mean over valid rows of the
    squared masked residual."""
    R = (S - reconstruct(D, code)) * W * valid[:, None].to(S.dtype)
    return torch.sum(R * R) / max(int(valid.sum()), 1)


def replace_unused(D, used_count, S, rows) -> torch.Tensor:
    """Atom j, if no row used it, <- data row S[rows[j]] normalised (a zero
    row is taken as it is)."""
    D = D.clone()
    for j in torch.nonzero(used_count == 0)[:, 0].tolist():
        s = S[rows[j]]
        norm = torch.linalg.vector_norm(s)
        D[:, j] = s / norm if float(norm) > 0 else s
    return D


def nipals(A: torch.Tensor, iters: int):
    """Largest singular pair of A [l, m]: (u [l] unit, v [m] unit,
    sigma)."""
    l = A.shape[0]
    u = torch.full((l,), 1.0 / math.sqrt(l), dtype=A.dtype, device=A.device)

    def unit(t):
        return t / torch.clamp(torch.linalg.vector_norm(t), min=1e-30)

    for _ in range(iters):
        v = unit(u @ A)
        u = A @ v
    sigma = torch.linalg.vector_norm(u)
    u = u / torch.clamp(sigma, min=1e-30)
    return u, unit(u @ A), sigma


def update_atoms(D, code: Code, S, W, valid, cfg: KSVDConfig):
    """ksvd_decomposition::optimize_dictionary, in blocks of
    `atom_block` atoms. Returns (D, code with the new coefficients)."""
    n, l = S.shape
    K = D.shape[1]
    kmax = code.X.shape[1]
    use = (torch.arange(kmax, device=S.device)[None, :] < code.nw[:, None]) \
        & valid[:, None]
    X = torch.where(use, code.X, 0.0)
    R = (S - reconstruct(D, code)) * W * valid[:, None].to(S.dtype)
    D = D.clone()
    blk = max(1, min(cfg.atom_block, K))
    for j0 in range(0, K, blk):
        updates = []
        for j in range(j0, min(j0 + blk, K)):
            hit = use & (code.I == j)
            users = torch.nonzero(hit.any(dim=1))[:, 0]
            if users.numel() == 0:
                continue
            pos = torch.argmax(hit[users].to(torch.int32), dim=1)  # 1st word
            x = X[users, pos]
            d = D[:, j]
            A = R[users] + W[users] * (x[:, None] * d[None, :])    # [m, l]
            u, v, sigma = nipals(A.T, cfg.power_iters)
            updates.append((j, users, pos, x, d, u, sigma * v))
        for j, users, pos, x, d, u, x_new in updates:
            R[users] += W[users] * (x[:, None] * d[None, :]
                                    - x_new[:, None] * u[None, :])
            D[:, j] = u
            X[users, pos] = x_new
    return D, code._replace(X=torch.where(use, X, code.X))


def ksvd(S, W, valid, cfg: KSVDConfig, init: torch.Tensor,
         sweeps: torch.Tensor) -> KSVDResult:
    """ksvd_decomposition::decompose on S [n, l] with mask W and row
    validity `valid`; init [K] and sweeps [max_iters, K]: the data rows
    that replace unused atoms at the start and after each sweep."""
    K = cfg.dict_size
    dt, dev = S.dtype, S.device
    W = W.to(dt)
    D = replace_unused(torch.zeros((S.shape[1], K), dtype=dt, device=dev),
                       torch.zeros(K, dtype=torch.int64, device=dev), S,
                       init)
    last = math.inf
    it = 0
    for it in range(1, cfg.max_iters + 1):
        code = omp(D, S, W, valid, cfg)
        words = torch.arange(cfg.words_max, device=dev)[None, :] \
            < code.nw[:, None]
        used_count = torch.bincount(code.I[words], minlength=K)
        D, code = update_atoms(D, code, S, W, valid, cfg)
        err = masked_error(D, code, S, W, valid)
        D = replace_unused(D, used_count, S, sweeps[it - 1])
        if abs(float(err) - last) < cfg.stop_diff:
            break
        last = float(err)
    code = omp(D, S, W, valid, cfg)
    return KSVDResult(D=D, code=code,
                      error=masked_error(D, code, S, W, valid), iters=it)
