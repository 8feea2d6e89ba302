"""The K-SVD codec's device check: the same draws through the dictionary
code on the CPU and on a card, in float64.

`sweep_parity` runs `omp_encode` and one outer `_ksvd_sweep` (blocked
atom sweep included) from the dictionary the draws' `init` rows make,
once with CPU tensors and once with the card's. The card tests run it on
`problem()`, a small sparse problem; `chip_smoke.py` on the bench cloud's
depth raster.
"""

from __future__ import annotations

import numpy as np
import torch

from gp_compressor_tpu_torch.config import KSVDConfig
from gp_compressor_tpu_torch.models import dictionary


def problem(l: int = 49, K: int = 40, n: int = 300, words: int = 3,
            seed: int = 0):
    """(S [n, l], W [n, l], valid [n]) float64: rows sparse in a random
    unit-column dictionary of K atoms plus noise, 20% of each row
    masked, the last 10 rows padding."""
    r = np.random.default_rng(seed)
    D = r.standard_normal((l, K))
    D /= np.linalg.norm(D, axis=0)
    X = np.zeros((n, K))
    for i in range(n):
        X[i, r.choice(K, size=words, replace=False)] = r.standard_normal(words)
    S = X @ D.T + 0.01 * r.standard_normal((n, l))
    W = (r.uniform(size=(n, l)) > 0.2).astype(np.float64)
    return S, W, np.arange(n) < n - 10


def sweep_parity(S, W, valid, cfg: KSVDConfig, device, seed: int = 0) -> dict:
    """Max |card - CPU| of the initial OMP code's coefficients and of one
    outer sweep's dictionary, coefficients and masked MSE, in float64,
    with draws made on the CPU from `seed`; and whether the atom indices
    and word counts are equal."""
    cpu = [torch.as_tensor(a).cpu().to(dt) for a, dt in
           ((S, torch.float64), (W, torch.float64), (valid, torch.bool))]
    draws = dictionary.draw_ksvd(cpu[2], cfg,
                                 torch.Generator().manual_seed(seed))
    out = {}
    for where in ("cpu", "device"):
        S_, W_, v_ = (a.to(device) if where == "device" else a for a in cpu)
        dr = dictionary.KSVDDraws(*(d.to(S_.device) for d in draws))
        D0 = dictionary._replace_unused(
            torch.zeros((S_.shape[1], cfg.dict_size), dtype=S_.dtype,
                        device=S_.device),
            torch.zeros(cfg.dict_size, dtype=torch.int64, device=S_.device),
            S_, dr.init)
        code = dictionary.omp_encode(D0, S_, W_, v_, cfg)
        D1, code1, err, _ = dictionary._ksvd_sweep(D0, dr.sweeps[0], S_, W_,
                                                   v_, cfg)
        out[where] = [t.cpu() for t in (code.X, code.I, code.nw, D1,
                                        code1.X, code1.I, code1.nw, err)]
    c, d = out["cpu"], out["device"]
    diff = lambda a, b: float(torch.max(torch.abs(a - b)))
    return {"omp_X": diff(c[0], d[0]), "sweep_D": diff(c[3], d[3]),
            "sweep_X": diff(c[4], d[4]), "sweep_err": diff(c[7], d[7]),
            "indices_equal": bool(torch.equal(c[1], d[1])
                                  and torch.equal(c[2], d[2])
                                  and torch.equal(c[5], d[5])
                                  and torch.equal(c[6], d[6]))}


def block_problem(n: int, l: int, b: int, n_valid: int, seed: int = 0,
                  share: float = 0.05):
    """One atom block's inputs as `_atom_sweep` forms them, float64:
    (R [n, l], W [n, l], D [l, b + 4], xj [b, n], using [b, n] bool); the
    block's atoms are D's columns 2 .. b + 1 (`D[:, 2:b + 2].T`, a
    strided view). Rows from n_valid on are padding (R and W zero, no
    atom's user). Atom 0 has no user, atom 1 one user, atom 2 every valid
    row, atom 3 half of them; the others `share` of the valid rows. x_j
    is the atom's coefficient on its users, 0 elsewhere; R is a small
    residual under the mask, so each A_j has a dominant pair."""
    r = np.random.default_rng(seed)
    D = r.standard_normal((l, b + 4))
    D /= np.linalg.norm(D, axis=0)
    W = (r.uniform(size=(n, l)) > 0.2).astype(np.float64)
    W[n_valid:] = 0.0
    R = 0.05 * r.standard_normal((n, l)) * W
    using = r.uniform(size=(b, n)) < share
    using[0] = False
    using[1] = False
    using[1, r.integers(n_valid)] = True
    using[2] = True
    using[3] = r.uniform(size=n) < 0.5
    using[:, n_valid:] = False
    xj = r.standard_normal((b, n)) * using
    return R, W, D, xj, using
