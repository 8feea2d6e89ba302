"""The source's scan-to-map registration in plain torch: the twist
gradient of one step, and the loop's step and stop rule.

Written from nilsbore/gp_compressor `src/gp_registration.cpp:94-215` and
`:40-92` (as SURVEY.md §2 and §3.3 describe them): for each scan point
near a map patch, its local coordinates in the patch's frame
(`get_local_points`), the derivative of the depth GP's predictive
density there (`compute_derivatives`, `sparse_gp.hpp:478-508`), rotated
back to world and chained through the twist Jacobian J(x) = [I | -[x]x]
(`get_transform_jacobian`), averaged over the points used (the running
mean into P, `:214-215`); then the small-angle step R = Rx Ry Rz, t,
applied to the scan; the loop stops after more than `min_steps` steps at
the cap or at convergence (`registration_done`, `:67-71`). It imports
nothing of the program under test.

Departures from the source, each one the configuration states, so that
the program and this reference can agree:

  * a point counts for one patch only, the first that claims it: among
    the created patches of the 27 voxels around the point's own voxel
    (clamped into the map's box), those whose search sphere (radius
    sqrt(3)/2 res about the voxel's centre) holds the point and whose
    frame clip |u|, |v| <= res/2 passes, the one of least linear voxel
    key; the source's radius search lets a point count for each such
    patch;
  * a patch takes at most `bank_points` of its points, the first in scan
    order; the caller passes every `reg_stride`-th point of the scan;
  * the claims run every `reclaim_every` steps; between them the banked
    points ride each step's transform and are clipped again against the
    sphere and frame of their own patch (the source claims every step);
  * the depth field alone moves the pose (the source's blend alpha = 1,
    `:198-199`): the colour GP takes no part;
  * the step is iRprop- per twist axis (each axis moves eta * sign of its
    gradient, eta grows 1.2 times while the sign holds and halves, the
    axis standing still, when it flips; an axis with a zero gradient
    halves too; eta within [eta_min, eta_max]), and convergence is every
    eta under `tol`, in place of the fixed step 0.1 and both gradient
    norms under 0.1.

The density's derivative is taken by autograd of the density written
here, not from a closed form.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SQRT3_2 = 0.8660254037844386
CHUNK = 2048
OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]


class GP(NamedTuple):
    """One GP per patch: basis vectors [B, S, 2], weights [B, S, D], the
    C matrix [B, S, S], the slots in use [B, S], and the kernel's signal
    variance, squared length scale and noise variance."""

    bv: torch.Tensor
    alpha: torch.Tensor
    C: torch.Tensor
    active: torch.Tensor
    sigmaf_sq: float
    l_sq: float
    s20: float


class Map(NamedTuple):
    """What registration reads of a map: the box (origin [3], dims [3],
    voxel edge res), the dense voxel -> patch table [n_cells] (-1 where
    none), which patches exist [B], their frames [B, 3, 3] (column 0 the
    normal) and means [B, 3], and the depth GPs."""

    origin: torch.Tensor
    dims: torch.Tensor
    res: float
    key_to_leaf: torch.Tensor
    created: torch.Tensor
    rotations: torch.Tensor
    means: torch.Tensor
    depth: GP


class Rule(NamedTuple):
    """The loop's step and stop rule."""

    min_steps: int
    max_steps: int
    eta0: float
    eta_min: float
    eta_max: float
    tol: float
    reclaim_every: int
    bank_points: int


def _keys(points, m: Map):
    return torch.floor((points - m.origin) * (1.0 / m.res)).long()


def claim(points, valid, m: Map):
    """First claim of each point: (patch [N] long, -1 where none)."""
    N = points.shape[0]
    dims = m.dims.long()
    home = torch.minimum(torch.clamp(_keys(points, m), min=0), dims - 1)
    best_key = torch.full((N,), 2 ** 62, dtype=torch.long,
                          device=points.device)
    best = torch.full((N,), -1, dtype=torch.long, device=points.device)
    half = m.res / 2.0
    for off in OFFSETS:
        nb = home + torch.tensor(off, device=points.device)
        inside = torch.all((nb >= 0) & (nb < dims), dim=1)
        lin = (nb[:, 0] * dims[1] + nb[:, 1]) * dims[2] + nb[:, 2]
        g = torch.where(inside, m.key_to_leaf[torch.where(inside, lin, 0)]
                        .long(), -1)
        gs = torch.clamp(g, min=0)
        ok = valid & (g >= 0) & m.created[gs]
        rel = points - (m.origin + (nb.to(points.dtype) + 0.5) * m.res)
        sphere = torch.sum(rel * rel, dim=1) <= (SQRT3_2 * m.res) ** 2
        u = torch.sum(m.rotations[gs, :, 1] * rel, dim=1)
        v = torch.sum(m.rotations[gs, :, 2] * rel, dim=1)
        clip = (u.abs() <= half) & (v.abs() <= half)
        better = ok & sphere & clip & (lin < best_key)
        best_key = torch.where(better, lin, best_key)
        best = torch.where(better, g, best)
    return best


def bank(patch, limit: int):
    """The points each patch keeps: its first `limit` in scan order."""
    N = patch.shape[0]
    order = torch.argsort(patch, stable=True)
    sp = patch[order]
    first = torch.ones(N, dtype=torch.bool, device=patch.device)
    first[1:] = sp[1:] != sp[:-1]
    idx = torch.arange(N, device=patch.device)
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    keep = torch.zeros(N, dtype=torch.bool, device=patch.device)
    keep[order] = (idx - start) < limit
    return keep & (patch >= 0)


def _clip_again(points, patch, m: Map):
    """A banked point still in its patch's sphere and frame clip."""
    cell = torch.nonzero(m.key_to_leaf >= 0).flatten()
    key_of = torch.zeros(m.created.shape[0], dtype=torch.long,
                         device=points.device)
    key_of[m.key_to_leaf[cell].long()] = cell
    g = torch.clamp(patch, min=0)
    lin, dims = key_of[g], m.dims.long()
    k3 = torch.stack([lin // (dims[1] * dims[2]), (lin // dims[2]) % dims[1],
                      lin % dims[2]], 1)
    rel = points - (m.origin + (k3.to(points.dtype) + 0.5) * m.res)
    loc = torch.einsum('nji,nj->ni', m.rotations[g], points - m.means[g])
    half = m.res / 2.0
    return ((patch >= 0)
            & (torch.sum(rel * rel, dim=1) <= (SQRT3_2 * m.res) ** 2)
            & (loc[:, 1].abs() <= half) & (loc[:, 2].abs() <= half))


def density(local, patch, gp: GP):
    """The depth GP's predictive density of each point at its local
    (depth, u, v): N(depth; k.alpha, s20 + max(k** + k'Ck, 0))."""
    g = torch.clamp(patch, min=0)
    act = gp.active[g].to(local.dtype)
    d = local[:, None, 1:] - gp.bv[g]
    k = gp.sigmaf_sq * torch.exp(-0.5 * torch.sum(d * d, -1) / gp.l_sq) * act
    mean = torch.sum(k * gp.alpha[g][..., 0], -1)
    latent = gp.sigmaf_sq + torch.einsum('ns,nst,nt->n', k, gp.C[g], k)
    var = gp.s20 + torch.clamp(latent, min=0.0)
    r = local[:, 0] - mean
    return torch.exp(-0.5 * torch.log(2.0 * math.pi * var) - 0.5 * r * r
                     / var)


def twist_mean(points, patch, used, m: Map):
    """The mean over the used points of each one's density gradient in
    world coordinates, chained through J(x): ([6] as (t, omega), count)."""
    pts, g = points[used], patch[used]
    local = torch.einsum('nji,nj->ni', m.rotations[g], pts - m.means[g])
    dl = torch.zeros_like(local)
    for i in range(0, local.shape[0], CHUNK):  # each point gathers its C
        x = local[i:i + CHUNK].detach().requires_grad_(True)
        with torch.enable_grad():
            (dl[i:i + CHUNK],) = torch.autograd.grad(
                density(x, g[i:i + CHUNK], m.depth).sum(), x)
    gw = torch.einsum('nij,nj->ni', m.rotations[g], dl)
    contrib = torch.cat([gw, torch.linalg.cross(pts, gw, dim=1)], 1)
    n = int(used.sum())
    return contrib.sum(0) / max(n, 1), n


def twist_gradient(points, valid, m: Map, bank_points: int):
    """The first step's gradient of a scan already at its start pose."""
    patch = claim(points, valid, m)
    return twist_mean(points, patch, bank(patch, bank_points), m)


def euler_xyz(w):
    """R = Rx(w0) Ry(w1) Rz(w2)."""
    c, s = torch.cos(w), torch.sin(w)
    one, zero = torch.ones_like(w[0]), torch.zeros_like(w[0])
    rx = torch.stack([one, zero, zero, zero, c[0], -s[0], zero, s[0], c[0]])
    ry = torch.stack([c[1], zero, s[1], zero, one, zero, -s[1], zero, c[1]])
    rz = torch.stack([c[2], -s[2], zero, s[2], c[2], zero, zero, zero, one])
    return rx.reshape(3, 3) @ ry.reshape(3, 3) @ rz.reshape(3, 3)


def irprop(delta, prev, eta, rule: Rule):
    """One iRprop- step: (motion [6], the gradient kept as the next
    step's previous one, the new step sizes)."""
    flip = delta * prev < 0
    eta = torch.clamp(torch.where(flip | (delta == 0), 0.5 * eta, 1.2 * eta),
                      rule.eta_min, rule.eta_max)
    move = torch.where(flip, 0.0, torch.sign(delta)) * eta
    return move, torch.where(flip, 0.0, delta), eta


def register(points, valid, m: Map, rule: Rule):
    """The loop: (R [3, 3], t [3], steps) that move the scan onto the
    map, composed exactly (x -> R x + t)."""
    dt, dev = points.dtype, points.device
    R_acc = torch.eye(3, dtype=dt, device=dev)
    t_acc = torch.zeros(3, dtype=dt, device=dev)
    eta = torch.full((6,), rule.eta0, dtype=dt, device=dev)
    prev = torch.zeros(6, dtype=dt, device=dev)
    pts, step = points, 0
    while True:
        if step % rule.reclaim_every == 0:
            patch = claim(pts, valid, m)
            kept = bank(patch, rule.bank_points)
            W, Wp = pts[kept], patch[kept]
        delta, _ = twist_mean(W, Wp, _clip_again(W, Wp, m), m)
        move, prev, eta = irprop(delta, prev, eta, rule)
        R = euler_xyz(move[3:])
        pts = pts @ R.T + move[:3]
        W = W @ R.T + move[:3]
        R_acc, t_acc = R @ R_acc, R @ t_acc + move[:3]
        step += 1
        if step > rule.min_steps and (step >= rule.max_steps
                                      or bool(torch.all(eta < rule.tol))):
            return R_acc, t_acc, step
