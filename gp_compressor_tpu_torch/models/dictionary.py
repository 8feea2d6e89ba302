"""Dictionary codec: batched masked OMP and K-SVD.

The port of `gp_compressor_tpu.models.dictionary`. Reference semantics
(src/orthogonal_matching_pursuit.cpp, src/ksvd_decomposition.cpp):

  * OMP takes the greedy argmax of |residual^T D| over unused atoms, then
    re-solves the coefficients of all selected atoms against the *masked*
    signal with a Gram matrix of *unit diagonal* (the reference's
    approximation, kept unless KSVDConfig.exact_gram_diag). It stops at
    words_max atoms or when residual^2 < proj_error.
  * K-SVD loops: replace unused atoms with random normalized data rows,
    OMP-code every patch, update each atom from the largest singular pair
    of the masked residual restricted to its users (NIPALS power
    iteration), until the masked MSE changes by less than stop_diff.

Every per-patch loop is a batched tensor op over all n patches; the greedy
word order and the atom sweep stay loops. The atom sweep updates
`atom_block` atoms at a time against the block-start residual (1 is the
reference's Gauss-Seidel order): their power iterations run as batched
matrix-vector products over a [blk, n, l] stack, and a short last block
holds only the real atoms.

The OMP solve keeps JAX's semantics for a singular Gram (an atom chosen
twice once the residual is orthogonal to every unused atom): the solve
returns non-finite coefficients instead of raising, and the row stops.

JAX's `lax.while_loop` over sweeps is a host loop here: each sweep ends in
one device-to-host read of its stop test (counted as `ksvd.reads`; the
sweeps as `ksvd.sweeps`, the atom blocks they update as `ksvd.atom_blocks`).
The random data rows of the atom replacement are explicit draws
(KSVDDraws), or come from a `torch.Generator`; the tests feed the draws
JAX's keys make.

Each sweep's stages are spans: `ksvd.omp` (also the final encoding),
`ksvd.sweep` and `ksvd.replace`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gp_compressor_tpu_torch.config import KSVDConfig
from gp_compressor_tpu_torch.utils.profiling import count, span


class OMPCode(NamedTuple):
    X: torch.Tensor   # [n, kmax] coefficients
    I: torch.Tensor   # [n, kmax] int32 atom indices
    nw: torch.Tensor  # [n] int32 number of words used


class KSVDResult(NamedTuple):
    D: torch.Tensor       # [l, K]
    code: OMPCode
    error: torch.Tensor   # 0-dim final masked MSE
    iters: int            # sweeps performed


class KSVDDraws(NamedTuple):
    """The data rows _replace_unused samples: `init` for the initial
    dictionary, `sweeps[i]` after sweep i + 1."""

    init: torch.Tensor     # [K] int64 row indices
    sweeps: torch.Tensor   # [max_iters, K] int64 row indices


def draw_ksvd(valid: torch.Tensor, cfg: KSVDConfig,
              generator: Optional[torch.Generator] = None) -> KSVDDraws:
    """KSVDDraws for one ksvd call: rows drawn uniformly, with replacement,
    among the valid ones."""
    K = cfg.dict_size
    idx = torch.multinomial(valid.to(torch.float32), (cfg.max_iters + 1) * K,
                            replacement=True, generator=generator)
    return KSVDDraws(init=idx[:K], sweeps=idx[K:].reshape(cfg.max_iters, K))


def omp_encode(D: torch.Tensor, S: torch.Tensor, W: torch.Tensor,
               valid: torch.Tensor, cfg: KSVDConfig) -> OMPCode:
    """Batched masked OMP. D: [l, K], S: [n, l], W: [n, l] float mask,
    valid: [n] bool (padding patches are no-ops)."""
    n, l = S.shape
    K = D.shape[1]
    kmax = cfg.words_max
    dt, dev = S.dtype, S.device
    DT = D.T
    rows = torch.arange(n, device=dev)
    ar = torch.arange(kmax, device=dev)
    eye = torch.eye(kmax, dtype=dt, device=dev)

    Sm = S * W                                    # masked signals
    r = Sm
    used = torch.zeros((n, K), dtype=torch.bool, device=dev)
    I = torch.zeros((n, kmax), dtype=torch.int32, device=dev)
    X = torch.zeros((n, kmax), dtype=dt, device=dev)
    G = eye.expand(n, kmax, kmax).clone()
    c = torch.zeros((n, kmax), dtype=dt, device=dev)
    nw = torch.zeros((n,), dtype=torch.int32, device=dev)

    for k in range(kmax):
        active = (torch.sum(r * r, dim=1) >= cfg.proj_error) & valid  # [n]
        w = r @ D                                                     # [n, K]
        w = torch.where(used | ~torch.isfinite(w), 0.0, w)
        ind = torch.argmax(torch.abs(w), dim=1)                       # [n]

        used_n = used.clone()
        used_n[rows, ind] = True
        I_n = I.clone()
        I_n[:, k] = ind.to(torch.int32)

        d_new = DT[ind]                                               # [n, l]
        d_new_m = d_new * W
        # Gram row against the earlier words (masked new vs raw old: the
        # symmetric masked Gram, the 0/1 mask being idempotent)
        Dsel = DT[I_n.long()]                                # [n, kmax, l]
        g = torch.where(ar < k, (Dsel @ d_new_m[:, :, None])[..., 0], 0.0)
        G_n = G.clone()
        G_n[:, k, :] = g
        G_n[:, :, k] = g
        if cfg.exact_gram_diag:
            G_n[:, k, k] = torch.clamp(torch.sum(d_new_m * d_new, dim=1),
                                       min=1e-12)
        else:
            G_n[:, k, k] = 1.0            # the reference's unit diagonal
        c_n = c.clone()
        c_n[:, k] = torch.sum(Sm * d_new, dim=1)

        # the identity-padded [kmax, kmax] solve == the solve over the first
        # k + 1 words; a singular Gram gives non-finite values, not an error
        sel = ar <= k
        Gk = torch.where(sel[None, :, None] & sel[None, None, :], G_n, eye)
        ck = torch.where(sel[None, :], c_n, 0.0)
        X_n = torch.linalg.solve_ex(Gk, ck[..., None],
                                    check_errors=False)[0][..., 0]

        # the masked residual at the re-solved coefficients
        recon = (X_n[:, None, :] @ Dsel)[:, 0, :]
        r_n = Sm - recon * W

        a1, a2 = active[:, None], active[:, None, None]
        r = torch.where(a1, r_n, r)
        used = torch.where(a1, used_n, used)
        I = torch.where(a1, I_n, I)
        X = torch.where(a1, X_n, X)
        G = torch.where(a2, G_n, G)
        c = torch.where(a1, c_n, c)
        nw = nw + active.to(torch.int32)
    return OMPCode(X=X, I=I, nw=nw)


def mp_encode(D: torch.Tensor, S: torch.Tensor, W: torch.Tensor,
              valid: torch.Tensor, cfg: KSVDConfig) -> OMPCode:
    """Plain matching pursuit, the reference's mp_match_vector: each step
    takes the greedy atom with its raw correlation as coefficient and
    subtracts its masked contribution from the residual."""
    n, l = S.shape
    K = D.shape[1]
    kmax = cfg.words_max
    dt, dev = S.dtype, S.device
    rows = torch.arange(n, device=dev)
    r = S * W
    used = torch.zeros((n, K), dtype=torch.bool, device=dev)
    I = torch.zeros((n, kmax), dtype=torch.int32, device=dev)
    X = torch.zeros((n, kmax), dtype=dt, device=dev)
    nw = torch.zeros((n,), dtype=torch.int32, device=dev)
    for k in range(kmax):
        active = (torch.sum(r * r, dim=1) >= cfg.proj_error) & valid
        w = r @ D
        w = torch.where(used | ~torch.isfinite(w), 0.0, w)
        ind = torch.argmax(torch.abs(w), dim=1)
        coef = w[rows, ind]
        hit = torch.zeros_like(used)
        hit[rows, ind] = True
        used = used | (hit & active[:, None])
        I[:, k] = torch.where(active, ind.to(torch.int32), I[:, k])
        X[:, k] = torch.where(active, coef, X[:, k])
        d_sel = D.T[ind] * W                                   # masked atom
        r = torch.where(active[:, None], r - coef[:, None] * d_sel, r)
        nw = nw + active.to(torch.int32)
    return OMPCode(X=X, I=I, nw=nw)


def reconstruct(D: torch.Tensor, code: OMPCode) -> torch.Tensor:
    """S_rec[n, l] = sum_k X[n, k] D[:, I[n, k]] over the used words."""
    kmax = code.X.shape[1]
    usek = torch.arange(kmax, device=code.X.device)[None, :] < code.nw[:, None]
    Dsel = D.T[code.I.long()]                                 # [n, kmax, l]
    return ((code.X * usek)[:, None, :] @ Dsel)[:, 0, :]


def masked_error(D, code, S, W, valid) -> torch.Tensor:
    """Mean over valid patches of the squared masked residual norm
    (ksvd_decomposition::compute_error). valid: [n] float."""
    R = (S - reconstruct(D, code)) * W * valid[:, None]
    nv = torch.clamp(torch.sum(valid), min=1.0)
    return torch.sum(R * R) / nv


def _power_iteration(A: torch.Tensor, iters: int):
    """Largest singular pair of each A [..., l, n] by NIPALS with a fixed
    iteration count. Returns (u [..., l] unit, v [..., n] unit,
    sigma [...])."""
    l = A.shape[-2]
    dt = A.dtype
    u = torch.full(A.shape[:-2] + (l,), 1.0, dtype=dt, device=A.device) \
        / torch.sqrt(torch.tensor(l, dtype=dt, device=A.device))

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True),
                               min=1e-30)

    for _ in range(iters):
        v = unit((u[..., None, :] @ A)[..., 0, :])
        u = (A @ v[..., None])[..., 0]
    sigma = torch.sqrt(torch.sum(u * u, dim=-1))
    u = u / torch.clamp(sigma, min=1e-30)[..., None]
    v = unit((u[..., None, :] @ A)[..., 0, :])
    return u, v, sigma


def _replace_unused(D: torch.Tensor, usage_count: torch.Tensor,
                    S: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Unused atoms <- the normalized data rows S[idx] (idx [K]: one draw
    per atom, KSVDDraws), ksvd_decomposition::replace_unused."""
    cand = S[idx]                                          # [K, l]
    norm = torch.linalg.vector_norm(cand, dim=1, keepdim=True)
    cand = torch.where(norm > 0, cand / torch.clamp(norm, min=1e-30), cand)
    return torch.where((usage_count == 0)[None, :], cand.T, D)


def _atom_sweep(D, code: OMPCode, S, W, valid, cfg: KSVDConfig):
    """Dictionary update over all atoms (ksvd_decomposition::
    optimize_dictionary), the masked residual R = W o (S - D X) kept
    incrementally. Blocks of cfg.atom_block atoms each update against the
    block-start residual, their rank-1 corrections applied jointly
    (atom_block 1: the reference's Gauss-Seidel order).
    Returns (D, code with the updated coefficients, R)."""
    n, l = S.shape
    K = D.shape[1]
    kmax = code.X.shape[1]
    dev = S.device
    blk = max(1, min(cfg.atom_block, K))
    ar = torch.arange(kmax, device=dev)
    usek = (ar[None, :] < code.nw[:, None]) & valid[:, None]
    Xeff = code.X * usek
    R = (S - reconstruct(D, code)) * W * valid[:, None]    # [n, l]
    D = D.clone()
    I = code.I[None]
    count("ksvd.atom_blocks", -(-K // blk))
    for j0 in range(0, K, blk):
        jb = torch.arange(j0, min(j0 + blk, K), device=dev)   # [b]
        hit = (I == jb[:, None, None]) & usek[None]            # [b, n, kmax]
        using = torch.any(hit, dim=2)                          # [b, n]
        kpos = torch.argmax(hit.to(torch.int32), dim=2)        # first True
        xj = torch.gather(Xeff.expand(jb.shape[0], n, kmax), 2,
                          kpos[..., None])[..., 0] * using     # [b, n]
        dj = D[:, jb].T                                        # [b, l]
        # the masked residual with atom j's part restored, restricted to
        # its users: A = sel o (R + W o (x_j d_j^T))
        A = (R + (xj[:, :, None] * dj[:, None, :]) * W) * using[:, :, None]
        u, v, sigma = _power_iteration(A.transpose(1, 2), cfg.power_iters)
        xj_new = sigma[:, None] * v * using
        any_user = torch.any(using, dim=1)[:, None]
        u = torch.where(any_user, u, dj)
        xj_new = torch.where(any_user, xj_new, xj)
        usf = using.to(S.dtype)
        old = (xj * usf).T @ dj                                # [n, l]
        new = (xj_new * usf).T @ u
        R = R + (old - new) * W
        D[:, jb] = u.T
        upd = (ar[None, None, :] == kpos[:, :, None]) & using[:, :, None]
        Xeff = torch.where(torch.any(upd, dim=0),
                           torch.sum(torch.where(upd, xj_new[:, :, None], 0.0),
                                     dim=0), Xeff)
    return D, code._replace(X=torch.where(usek, Xeff, code.X)), R


def _ksvd_sweep(D, idx, S, W, valid, cfg: KSVDConfig):
    """One outer K-SVD iteration: OMP-code every patch, sweep the atoms,
    the masked MSE, then swap unused atoms for the data rows S[idx]
    (ksvd_decomposition::decompose body). valid: [n] bool.
    Returns (D_next, code, err, mean_words)."""
    dt = S.dtype
    with span("ksvd.omp"):
        code = omp_encode(D, S, W, valid, cfg)
    kmax = cfg.words_max
    used = torch.arange(kmax, device=S.device)[None, :] < code.nw[:, None]
    usage = torch.zeros(cfg.dict_size, dtype=torch.int64,
                        device=S.device).index_add_(
        0, code.I.reshape(-1).long(), used.reshape(-1).to(torch.int64))
    with span("ksvd.sweep"):
        D2, code2, _ = _atom_sweep(D, code, S, W, valid, cfg)
    err = masked_error(D2, code2, S, W, valid.to(dt))
    with span("ksvd.replace"):
        D3 = _replace_unused(D2, usage, S, idx)
    return D3, code2, err, torch.mean((code.nw * valid).to(dt))


def ksvd(S: torch.Tensor, W: torch.Tensor, valid: torch.Tensor,
         cfg: KSVDConfig, generator: Optional[torch.Generator] = None,
         draws: Optional[KSVDDraws] = None,
         verbose: bool = False) -> KSVDResult:
    """Full K-SVD decomposition (ksvd_decomposition::decompose).

    S: [n, l] patch rows, W: [n, l] float mask, valid: [n] patch validity.
    Sweeps until |err_i - err_{i-1}| < stop_diff (compared on the device
    in S's dtype, as JAX's while_loop does) or max_iters, then encodes
    once more against the settled dictionary. Each sweep's stop test is
    one host read. The atom replacement draws `draws`, or draws from
    `generator` (seed 0 when None). verbose prints each sweep's masked MSE
    and mean words, like the reference."""
    dt = S.dtype
    W = W.to(dt)
    valid = valid.to(torch.bool)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=S.device).manual_seed(0)
        draws = draw_ksvd(valid, cfg, generator)
    D = _replace_unused(
        torch.zeros((S.shape[1], cfg.dict_size), dtype=dt, device=S.device),
        torch.zeros(cfg.dict_size, dtype=torch.int64, device=S.device), S,
        draws.init)
    last = torch.full((), math.inf, dtype=dt, device=S.device)
    it = 0
    for it in range(1, cfg.max_iters + 1):
        D, _, err, mean_words = _ksvd_sweep(D, draws.sweeps[it - 1], S, W,
                                            valid, cfg)
        if verbose:
            print(f"ksvd iter {it}: masked MSE {float(err):.6f}, "
                  f"mean words {float(mean_words):.2f}")
        count("ksvd.sweeps")
        count("ksvd.reads")
        if bool(torch.abs(err - last) < cfg.stop_diff):
            break
        last = err
    with span("ksvd.omp"):
        code = omp_encode(D, S, W, valid, cfg)
    err = masked_error(D, code, S, W, valid.to(dt))
    return KSVDResult(D=D, code=code, error=err, iters=it)
