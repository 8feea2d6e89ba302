"""Serial NumPy re-derivation of the reference sparse-GP math.

Two roles, mirroring how the reference used `matlab/sogp.m` and
`gaussian_process` as numerical oracles (SURVEY.md §4):

  1. Parity oracle — float64, literal growth/shrink semantics (dynamic
     arrays, swap-with-last deletion) so the padded/masked state in
     `models.sparse_gp` can be tested update-for-update against an
     independent implementation of the same equations
     (src/sparse_gp.hpp:90-295, matlab/sogp.m:58-191).
  2. Single-CPU baseline — the reference publishes no numbers
     (BASELINE.md), so this serial implementation *is* the measured CPU
     baseline for bench.py, running the same per-point O(N^2) loop the
     C++ does.

Deliberately dependency-light: NumPy only, no JAX.

A copy of `gp_compressor_tpu.models.oracle`, which the port may not
import; tests/test_torch_io.py holds the two copies' outputs equal.
"""

from __future__ import annotations

import numpy as np


class SerialSOGP:
    """Dynamic-size Csató–Opper sparse GP, scalar or vector output."""

    def __init__(self, capacity=100, s20=1e-1, sigmaf_sq=100.0, l_sq=1.0,
                 eps_tol=1e-6, dout=1):
        self.capacity = capacity
        self.s20 = s20
        self.sigmaf_sq = sigmaf_sq
        self.l_sq = l_sq
        self.eps_tol = eps_tol
        self.dout = dout
        self.reset()

    # ---- kernel ----------------------------------------------------------
    def kern(self, X, Z):
        X = np.atleast_2d(X)
        Z = np.atleast_2d(Z)
        d2 = ((X[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
        return self.sigmaf_sq * np.exp(-0.5 / self.l_sq * d2)

    # ---- state -----------------------------------------------------------
    def reset(self):
        self.bv = np.zeros((0, 2))
        self.alpha = np.zeros((0, self.dout))
        self.C = np.zeros((0, 0))
        self.Q = np.zeros((0, 0))

    @property
    def size(self):
        return self.bv.shape[0]

    # ---- update ----------------------------------------------------------
    def add(self, x, y):
        x = np.asarray(x, float).reshape(-1)
        y = np.atleast_1d(np.asarray(y, float))
        kstar = self.sigmaf_sq
        if self.size == 0:
            denom = kstar + self.s20
            self.alpha = (y / denom)[None, :]
            self.C = np.array([[-1.0 / denom]])
            self.Q = np.array([[1.0 / kstar]])
            self.bv = x[None, :]
            return
        k = self.kern(x[None], self.bv)[0]
        m = self.alpha.T @ k
        s2 = kstar + k @ self.C @ k
        r = -1.0 / (self.s20 + s2)          # Gaussian noise dx2_ln
        q = (y - m) / (self.s20 + s2)       # Gaussian noise dx_ln
        e_hat = self.Q @ k
        gamma = kstar - k @ e_hat
        if gamma < 1e-12:
            gamma = 0.0
        if gamma < self.eps_tol:
            eta = 1.0 / (1.0 + gamma * r)
            s_hat = self.C @ k + e_hat
            self.alpha = self.alpha + np.outer(s_hat, q) * eta
            self.C = self.C + r * eta * np.outer(s_hat, s_hat)
        else:
            n = self.size
            s = np.concatenate([self.C @ k, [1.0]])
            self.alpha = np.vstack([self.alpha, np.zeros((1, self.dout))])
            self.alpha = self.alpha + np.outer(s, q)
            C = np.zeros((n + 1, n + 1))
            C[:n, :n] = self.C
            self.C = C + r * np.outer(s, s)
            Q = np.zeros((n + 1, n + 1))
            Q[:n, :n] = self.Q
            e = np.concatenate([e_hat, [-1.0]])
            self.Q = Q + np.outer(e, e) / gamma
            self.bv = np.vstack([self.bv, x[None, :]])
        while self.size > self.capacity:
            diag = np.diag(self.Q) + np.diag(self.C)
            scores = (self.alpha ** 2).sum(-1) / diag
            self.delete_bv(int(np.argmin(scores)))
        while self.size > 1:
            scores = 1.0 / np.diag(self.Q)
            loc = int(np.argmin(scores))
            if scores[loc] >= 1e-9:
                break
            self.delete_bv(loc)

    def delete_bv(self, loc):
        """Swap-with-last then rank-1 downdate (the reference layout)."""
        n = self.size
        last = n - 1
        astar = self.alpha[loc].copy()
        cstar = self.C[loc, loc]
        qstar = self.Q[loc, loc]
        # column loc with entry loc replaced by the last entry, then shrink
        Cs = self.C[:, loc].copy()
        Cs[loc] = Cs[last]
        Cs = Cs[:last]
        Qs = self.Q[:, loc].copy()
        Qs[loc] = Qs[last]
        Qs = Qs[:last]

        def shrink(M):
            M = M.copy()
            rep = M[:, last].copy()
            rep[loc] = rep[last]
            M[loc, :] = rep
            M[:, loc] = rep
            return M[:last, :last]

        self.C = shrink(self.C)
        self.Q = shrink(self.Q)
        self.alpha[loc] = self.alpha[last]
        self.alpha = self.alpha[:last]
        self.bv[loc] = self.bv[last]
        self.bv = self.bv[:last]

        qc = Qs + Cs
        denom = qstar + cstar
        self.alpha = self.alpha - np.outer(qc, astar) / denom
        self.C = self.C + np.outer(Qs, Qs) / qstar - np.outer(qc, qc) / denom
        self.Q = self.Q - np.outer(Qs, Qs) / qstar

    def add_measurements(self, X, Y, order=None):
        X = np.asarray(X, float)
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        if order is None:
            order = np.arange(X.shape[0])
        for i in order:
            self.add(X[i], Y[i])

    # ---- predict ---------------------------------------------------------
    def predict(self, Xstar):
        Xstar = np.atleast_2d(Xstar)
        kstar = self.sigmaf_sq
        if self.size == 0:
            return (np.zeros((Xstar.shape[0], self.dout)),
                    np.full(Xstar.shape[0], kstar + self.s20))
        K = self.kern(Xstar, self.bv)
        mean = K @ self.alpha
        var = self.s20 + kstar + np.einsum('mi,ij,mj->m', K, self.C, K)
        return mean, np.maximum(var, 0.0)
