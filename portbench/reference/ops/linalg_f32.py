"""Small-matrix Cholesky and triangular solves, batched over leading dims.

The port of `gp_compressor_tpu.ops.linalg_f32` (same names, so that a
reader finds the counterpart). The JAX routines are elementwise loops that
exist only to keep XLA's internal bfloat16 passes out of the TPU's
factorizations; on this card `torch.linalg.cholesky_ex` and
`torch.linalg.solve_triangular` run at full precision with TF32 off (the
package sets it), and torch's own autograd replaces the custom VJPs.

One behaviour is kept on purpose: a matrix that is not positive definite
factors to all NaN, as the JAX routine's sqrt of a negative pivot spreads
NaN through the factor, because the callers' guards key on that NaN.
`cholesky_ex` instead returns a finite partial factor with `info > 0`, so
the factor is set to NaN wherever `info` is nonzero. `info` is never read
on the host (that would synchronise the stream).

b arguments are [..., n] (one vector per matrix: b.ndim == L.ndim - 1) or
[..., n, k].
"""

from __future__ import annotations

import torch


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric positive-definite [..., n, n]
    matrices; all NaN where a matrix is not positive definite."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, torch.nan), L)


def _solve(L: torch.Tensor, b: torch.Tensor, transpose: bool) -> torch.Tensor:
    vec = b.ndim == L.ndim - 1
    B = b.unsqueeze(-1) if vec else b
    A = L.transpose(-1, -2) if transpose else L
    x = torch.linalg.solve_triangular(A, B, upper=transpose)
    return x.squeeze(-1) if vec else x


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b by forward substitution."""
    return _solve(L, b, False)


def solve_lower_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b by back substitution."""
    return _solve(L, b, True)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given the lower factor."""
    return solve_lower_t(L, solve_lower(L, b))
