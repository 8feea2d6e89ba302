"""Typed configuration tree of the port.

Field for field the dataclasses of `gp_compressor_tpu.config` that the
checks use (names, defaults and meaning; the comments there explain each
constant). Only `dtype` differs: it is a `torch.dtype`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Sparse-GP engine configuration (reference defaults: capacity 100,
    s20 1e-1, RBF (sigmaf_sq, l_sq) = (100, 1), eps_tol 1e-6)."""

    capacity: int = 100          # max number of retained basis vectors
    slots: int = 128             # padded state size; must be >= capacity + 1
    dim: int = 2                 # input dimension (u, v in the patch plane)
    dout: int = 1                # output dimension (1 = depth, 3 = RGB)
    sigmaf_sq: float = 100.0     # RBF signal variance
    l_sq: float = 1.0            # RBF squared lengthscale
    s20: float = 1e-1            # observation noise variance
    eps_tol: float = 1e-6        # novelty threshold: gamma below => sparse update
    novelty_mode: str = "gamma"  # "gamma" or "geometric" (see the JAX config)
    geom_dmin: float = 0.05      # [m] minimum BV separation ("geometric")
    geom_max_bv: int = 3         # BV budget per patch ("geometric")
    geom_gamma_min_rel: float = 1e-2  # admission floor, relative to sigmaf_sq
    gamma_tiny: float = 1e-12    # numerical floor
    geom_tol: float = 1e-9       # geometric deletion threshold on 1 / Q_ii
    max_geometric_deletes: int = 2  # per added point
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.slots < self.capacity + 1:
            raise ValueError("slots must fit capacity+1 BVs")


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Voxel-patching front end. `max_patches` and `max_points_per_patch`
    are static padding bounds of the patch banks."""

    res: float = 0.15            # voxel edge length [m]
    sz: int = 20                 # patch grid resolution (sz x sz predictions)
    max_patches: int = 1024      # static bound on number of leaves
    max_points_per_patch: int = 512  # static bound on claimed points per leaf
    min_points_for_rotation: int = 4  # below: identity rotation
    max_cells: int = 1 << 20     # dense voxel-key -> leaf table budget; 0 = none
    approx_sphere_moments: bool = False  # octant-resolution plane-fit support
    bank_order: str = "shuffle"  # "shuffle", "native", "center_out", ...


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    patch: PatchConfig
    depth_gp: GPConfig
    rgb_gp: GPConfig
