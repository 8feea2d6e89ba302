"""Synthetic coloured point clouds for tests and benchmarks.

Numpy copies of `room_cloud` and `rigid_transform` from
`gp_compressor_tpu.utils.synthetic`: the port may not import the JAX
package, and the tests require these copies to return byte-identical
arrays for the same arguments.
"""

from __future__ import annotations

import numpy as np


def room_cloud(n: int = 100_000, seed: int = 0, extent: float = 3.0,
               noise: float = 0.004):
    """A simple room: floor + two walls + a sphere + a sinusoidal ridge.

    Returns (points [n, 3] float32, colors [n, 3] float32 in 0..255).
    """
    r = np.random.default_rng(seed)
    counts = np.array([0.3, 0.2, 0.2, 0.15, 0.15])
    ns = (counts * n).astype(int)
    ns[-1] = n - ns[:-1].sum()
    parts = []
    cols = []

    # floor z = 0 with gentle height texture
    u = r.uniform(0, extent, size=(ns[0], 2))
    z = 0.02 * np.sin(3 * u[:, 0]) * np.cos(2 * u[:, 1])
    parts.append(np.stack([u[:, 0], u[:, 1], z], -1))
    cols.append(np.stack([120 + 40 * np.sin(2 * u[:, 0]),
                          90 + 30 * np.cos(3 * u[:, 1]),
                          60 + 0 * z], -1))

    # wall x = 0
    u = r.uniform(0, extent, size=(ns[1], 2))
    x = 0.015 * np.sin(4 * u[:, 0] + 2 * u[:, 1])
    parts.append(np.stack([x, u[:, 0], u[:, 1] * 0.8], -1))
    cols.append(np.stack([200 - 30 * u[:, 0] / extent * 3,
                          180 + 0 * x, 150 + 50 * u[:, 1] / extent], -1))

    # wall y = 0
    u = r.uniform(0, extent, size=(ns[2], 2))
    y = 0.015 * np.cos(3 * u[:, 0]) * np.sin(2 * u[:, 1])
    parts.append(np.stack([u[:, 0], y, u[:, 1] * 0.8], -1))
    cols.append(np.stack([90 + 60 * u[:, 1] / extent, 140 + 0 * y,
                          220 - 40 * u[:, 0] / extent], -1))

    # sphere
    c = np.array([extent * 0.5, extent * 0.5, 0.5])
    rad = 0.4
    phi = r.uniform(0, 2 * np.pi, ns[3])
    costh = r.uniform(-1, 1, ns[3])
    sinth = np.sqrt(1 - costh ** 2)
    sp = c + rad * np.stack([sinth * np.cos(phi), sinth * np.sin(phi), costh], -1)
    parts.append(sp)
    cols.append(np.stack([255 * (0.5 + 0.5 * costh), 80 + 0 * phi,
                          255 * (0.5 - 0.5 * costh)], -1))

    # sinusoidal ridge surface
    u = r.uniform(0, extent, size=(ns[4], 2))
    z = 0.3 + 0.15 * np.sin(2.5 * u[:, 0]) + 0.1 * np.cos(1.5 * u[:, 1])
    parts.append(np.stack([u[:, 0], u[:, 1], z], -1))
    cols.append(np.stack([50 + 150 * (z - 0.05) / 0.5, 200 - 100 * u[:, 0] / extent,
                          100 + 100 * u[:, 1] / extent], -1))

    pts = np.concatenate(parts).astype(np.float32)
    colors = np.clip(np.concatenate(cols), 0, 255).astype(np.float32)
    pts = pts + noise * r.standard_normal(pts.shape).astype(np.float32)
    perm = r.permutation(n)
    return pts[perm], colors[perm]


def rigid_transform(points: np.ndarray, rotvec, t):
    """Apply an axis-angle + translation rigid transform (for registration
    ground truth, replacing TUM trajectories)."""
    rotvec = np.asarray(rotvec, np.float64)
    th = np.linalg.norm(rotvec)
    if th < 1e-12:
        R = np.eye(3)
    else:
        k = rotvec / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    return (points @ R.T + np.asarray(t)).astype(points.dtype), R
