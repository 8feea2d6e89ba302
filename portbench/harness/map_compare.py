"""The numbers that decide `correct` in the mapping stream, from the
program's poses and maps and the reference's on the same inputs
(`portbench/reference/workloads/registration_source.py`,
`mapping_source.py`).

  * trans_err_mm, rot_err_deg  the largest error over every frame the
        run sent, between the program's accumulated pose after the frame
        and the trajectory's truth (registration holding the motion);
  * drop_share     the share of those frames whose registration reached
        the cap and which the program dropped;
  * patch_overflow the new leaves that found no free row of the map, over
        every frame from the first (the program's own count; the map has
        to hold the deployment);
  * grad_gap       on the checked frames, |g - g_ref| / |g_ref| of the
        first step's twist gradient [6], the reference's computed from the
        program's own map, scan and start pose (claims, banks, density
        gradient, twist mean);
  * insert_differ  on the checked frames, from the program's map before
        the frame and its scan at the program's registered pose: the share
        of the map's patches whose existence, occupancy mask W or count of
        pending points differs from the reference's insert (the claims,
        which patches are new, the W masks, the pending banks), a new leaf
        that found no free row counted as one more;
  * insert_gap     on the same frames, over the patches the two agree on,
        in mm: the larger of the 99th percentile, over the sz x sz grid of
        every patch the frame trained, of the gap between the two maps'
        predicted depths (the banked values, through training: float32
        training leaves a few patches astray, which moves the widest gap
        and not this), and the widest shift of a new patch's frame at its
        edge (res / 2) or of its mean, or of a pending point.

A map here is the reference's record (`mapping_source.Map`); `as_map`
reads one from the program's map state by field name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.models import sparse_gp
from portbench.reference.models.sparse_gp import SOGPState
from portbench.reference.ops.kernels import RBFParams
from portbench.reference.workloads import mapping_source as ms
from portbench.reference.workloads import registration_source as rs


def _gp(state, dt=None):
    return SOGPState(*[a.to(dt) if dt is not None and a.is_floating_point()
                       else a for a in (state.bv, state.alpha, state.C,
                                        state.Q, state.active)])


def as_map(state, dt=None) -> ms.Map:
    """The program's MapState as the reference's record (floating tensors
    in dt when given)."""
    def f(a):
        return a.to(dt) if dt is not None else a
    return ms.Map(origin=f(state.origin), dims=state.dims,
                  key_to_leaf=state.key_to_leaf,
                  n_patches=int(state.n_patches), created=state.created,
                  rotations=f(state.rotations), means=f(state.means),
                  rgb_means=f(state.rgb_means), W=state.W,
                  pend_pts=f(state.pend_pts), pend_cols=f(state.pend_cols),
                  pend_count=state.pend_count,
                  depth_gp=_gp(state.depth_gp, dt),
                  rgb_gp=_gp(state.rgb_gp, dt))


def registration_map(m: ms.Map, res: float, depth_kp, depth_s20) -> rs.Map:
    g = m.depth_gp
    return rs.Map(origin=m.origin, dims=m.dims, res=res,
                  key_to_leaf=m.key_to_leaf, created=m.created,
                  rotations=m.rotations, means=m.means,
                  depth=rs.GP(bv=g.bv, alpha=g.alpha, C=g.C, active=g.active,
                              sigmaf_sq=float(depth_kp.sigmaf_sq),
                              l_sq=float(depth_kp.l_sq),
                              s20=float(depth_s20)))


def pose_error(R, t, R_true, t_true) -> tuple:
    """(mm, degrees) between a pose (x -> R x + t) and the truth. The
    angle of A = R^T R_true is taken as atan2(sin, cos) from A's skew and
    trace parts, which resolves angles that arccos of the trace alone
    loses to the rounding of a float32 R."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    A = R.T @ R_true
    sin = 0.5 * np.linalg.norm([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0],
                                A[1, 0] - A[0, 1]])
    cos = 0.5 * (np.trace(A) - 1.0)
    return (1e3 * float(np.linalg.norm(t - t_true)),
            math.degrees(math.atan2(sin, cos)))


def grad_gap(g, g_ref) -> float:
    g, g_ref = g.double().cpu(), g_ref.double().cpu()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    return float(torch.linalg.norm(g - g_ref)
                 / max(float(torch.linalg.norm(g_ref)), 1e-300))


def _max(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def insert(got: ms.Map, want: ms.Map, before: ms.Map, res: float, kp_depth,
           s20, sz: int) -> dict:
    """insert_differ and insert_gap of one insert."""
    n = max(want.n_patches, got.n_patches, 1)
    B = want.created.shape[0]
    live = torch.arange(B, device=want.created.device) < n
    differ = ((got.created != want.created)
              | (got.W != want.W).any(1)
              | (got.pend_count.long() != want.pend_count.long())) & live
    differ_share = (float(differ.sum()) + abs(got.n_patches - want.n_patches)
                    + float((got.key_to_leaf != want.key_to_leaf).sum())
                    + want.lost) / n
    agree = live & ~differ
    new = agree & want.created & ~before.created

    def gap_mm(a, b, scale=1.0):
        return 1e3 * scale * _max((a.double() - b.double()).abs())
    Pp = want.pend_pts.shape[1]
    slot = (torch.arange(Pp, device=live.device)[None]
            < want.pend_count[:, None].long()) & agree[:, None]
    gaps = [gap_mm(got.rotations[new], want.rotations[new], res / 2.0),
            gap_mm(got.means[new], want.means[new]),
            gap_mm(got.pend_pts[slot], want.pend_pts[slot])]
    # predicted depth on the grid of every patch the frame trained
    trained = agree & want.created & (
        (want.W != before.W).any(1) | ~before.created)
    idx = torch.nonzero(trained).flatten()
    grid = ms.prediction_grid_of(res, sz, torch.float64, live.device)
    kp = RBFParams(torch.as_tensor(kp_depth.sigmaf_sq).double(),
                   torch.as_tensor(kp_depth.l_sq).double())
    s20 = torch.as_tensor(s20).double()

    def depth(m):
        st = SOGPState(*[a[idx].double() if a.is_floating_point() else a[idx]
                         for a in m.depth_gp])
        mean, _ = sparse_gp.predict_batch(
            kp, s20, st, grid.expand(idx.shape[0], -1, -1))
        return mean
    d = (depth(got) - depth(want)).abs().flatten() * 1e3
    if not bool(torch.isfinite(d).all()):
        return {"insert_differ": differ_share, "insert_gap": math.inf}
    if d.numel():
        gaps.append(float(torch.quantile(d, 0.99)))
    return {"insert_differ": differ_share, "insert_gap": max(gaps)}
