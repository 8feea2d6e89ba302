"""The small mapping case that holds the port's mapping stream against the
JAX package (CPU tests) and the kernel against its plain version at the
mapping call site (card tests).

Three 3000-point scans of a 2 m room (`room_cloud(extent=2.0)`) in the
world box [-1, 4]^3 at res 0.3, so that the map's ~200 leaves fit 256
patches:

  * scan 0: the room (the first scan: every touched voxel becomes a patch);
  * scan 1: the room and a sparse plane at z = 3.05 over 5 x 5 voxels no
    patch claims, whose voxels stay below min_points_new_patch (30) and
    keep their points as pending evidence;
  * scan 2: the room, as many plane points again (pending plus sphere
    evidence now cross the threshold: patches are created from pending
    evidence), and a dense cluster of 160 points on one floor voxel, more
    than the main bank (64) and the spill bank (32) hold.

The config builders take the config module (`gp_compressor_tpu.config` or
`gp_compressor_tpu_torch.config`), so both packages get the same values.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gp_compressor_tpu_torch.utils import synthetic

BOX = ([-1.0, -1.0, -1.0], [4.0, 4.0, 4.0])
PENDING = 64
N_SCAN = 3000
# the stream's calibrated-style depth hyperparameters (sigma_f^2, l^2, s20)
CAL = (2e-3, 4e-3, 3e-4)
# the known motion of scans 1 and 2 in the stream (rotation vector, m)
ROTVEC = (0.0, 0.004, -0.003)
T_MOVE = (0.01, -0.008, 0.005)


def compressor_config(m, dtype):
    """res 0.3, sz 10, 256 patches of 64 points, 16 slots of capacity 12;
    the depth GP at well-conditioned centimetre-scale constants."""
    return m.CompressorConfig(
        patch=m.PatchConfig(res=0.3, sz=10, max_patches=256,
                            max_points_per_patch=64,
                            approx_sphere_moments=True,
                            bank_order="center_out"),
        depth_gp=m.GPConfig(capacity=12, slots=16, sigmaf_sq=1e-2, l_sq=1e-2,
                            s20=1e-3, eps_tol=2e-4, dtype=dtype),
        rgb_gp=dataclasses.replace(m.rgb_gp_config(slots=16, capacity=12),
                                   eps_tol=2.0, dtype=dtype))


def mapping_config(m, **kw):
    """min_points_new_patch 30, spill bank 32, exact carving of the box,
    registration on every 2nd point, no scan dropped."""
    base = dict(min_points_new_patch=30, max_ray_steps=53, carve_stride=1,
                drop_on_reg_cap=False, reg_stride=2, spill_bank=32)
    return m.MappingConfig(**{**base, **kw})


def registration_config(m):
    return m.RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                                bank_points=32)


def _plane(n, seed):
    r = np.random.default_rng(seed)
    xy = r.uniform(0.2, 1.7, size=(n, 2))
    z = 3.05 + 0.004 * r.standard_normal(n)
    cols = 128.0 + 20.0 * r.standard_normal((n, 3))
    return np.stack([xy[:, 0], xy[:, 1], z], -1), cols


def _cluster(n, seed):
    r = np.random.default_rng(seed)
    xy = r.uniform(-0.1, 0.1, size=(n, 2)) + np.array([0.35, 1.55])
    z = 0.004 * r.standard_normal(n)
    cols = 90.0 + 10.0 * r.standard_normal((n, 3))
    return np.stack([xy[:, 0], xy[:, 1], z], -1), cols


def scans(dtype=np.float64):
    """[(points [N, 3], colours [N, 3], valid [N])] for scans 0, 1, 2."""
    parts = [[synthetic.room_cloud(n=N_SCAN, seed=0, extent=2.0)],
             [synthetic.room_cloud(n=N_SCAN - 240, seed=1, extent=2.0),
              _plane(240, 21)],
             [synthetic.room_cloud(n=N_SCAN - 400, seed=2, extent=2.0),
              _plane(240, 22), _cluster(160, 23)]]
    out = []
    for p in parts:
        pts = np.concatenate([a for a, _ in p]).astype(dtype)
        cols = np.concatenate([c for _, c in p]).astype(dtype)
        out.append((pts, np.clip(cols, 0.0, 255.0), np.ones(len(pts), bool)))
    return out


def moved_scans(dtype=np.float64):
    """scans() with scans 1 and 2 under the known motion (ROTVEC, T_MOVE):
    what the stream registers."""
    w = np.asarray(ROTVEC)
    th = np.linalg.norm(w)
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1.0 - np.cos(th)) * k @ k  # Rodrigues
    out = []
    for i, (p, c, v) in enumerate(scans(np.float64)):
        if i > 0:
            p = p @ R.T + np.asarray(T_MOVE)
        out.append((p.astype(dtype), c.astype(dtype), v))
    return out
