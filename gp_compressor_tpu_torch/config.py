"""Typed configuration tree of the port.

Field for field the dataclasses of `gp_compressor_tpu.config` (names,
defaults and meaning; the comments there explain each constant). `dtype`
differs: it is a `torch.dtype`. `PORT_ONLY` names the fields the JAX
package lacks; their defaults keep its behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def rgb_gp_config(slots: int = 128, capacity: int = 100,
                  dtype: torch.dtype = torch.float32) -> GPConfig:
    """Field-GP (RGB) defaults, reference src/sparse_gp_field.h:43."""
    return GPConfig(capacity=capacity, slots=slots, dout=3, s20=1e2,
                    eps_tol=1e-4, dtype=dtype)


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
class KSVDConfig:
    """Dictionary codec constants (depth pipeline of the reference's
    test_compress demo; models/dictionary.py). atom_block > 1 updates that
    many atoms per step against the block-start residual."""

    dict_size: int = 200
    words_max: int = 10
    proj_error: float = 5e-3
    stop_diff: float = 1e-5
    max_iters: int = 30
    power_iters: int = 20
    power_threshold: float = 0.01
    atom_block: int = 1
    exact_gram_diag: bool = False


def rgb_ksvd_config(dict_size: int = 600, words_max: int = 20) -> KSVDConfig:
    """RGB-pipeline K-SVD constants, scaled to 0-255 colour residuals."""
    return KSVDConfig(dict_size=dict_size, words_max=words_max,
                      proj_error=5e4, stop_diff=1e3)


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """GP-gradient scan-to-map registration (reference defaults step 0.1,
    300 steps, grad_tol 0.1; the JAX config documents each option)."""

    step: float = 1e-1
    max_steps: int = 300
    min_steps: int = 10
    grad_tol: float = 0.1        # convergence: |dt| < tol and |dr| < tol
    grad_tol_step_ref: Optional[float] = None  # tol *= step / step_ref
    color_blend: float = 1.0     # "alpha" blend: 1 => depth-only gradient
    blend_mode: str = "alpha"    # "alpha" or "likelihood" cross-weighting
    max_motion: Optional[float] = None  # per-step cap on |t| and |omega|
    reclaim_every: int = 4       # re-run the scan->map claims every k steps
    step_mode: str = "fixed"     # "fixed" or "rprop" (iRprop- per axis)
    rprop_eta0: float = 1e-3
    rprop_eta_min: float = 1e-6
    rprop_eta_max: float = 4e-3
    rprop_tol: float = 2e-5      # rprop stops when every eta < this
    bank_points: Optional[int] = None  # registration bank width override


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Incremental mapping (reference min_nbr 100, src/gp_mapping.cpp:7;
    the JAX config documents each option)."""

    min_points_new_patch: int = 100   # evidence for a voxel to become a patch
    max_ray_steps: int = 64           # bound on a carving ray's voxel walk
    carve_stride: int = 1             # carve every k-th scan ray
    drop_on_reg_cap: bool = True      # drop a scan whose registration caps
    reg_stride: int = 1               # register every k-th scan point
    spill_bank: int = 128             # width of the overflow training bank
    table_update_max: int = 96        # incremental claim-table update bound
    # False: the stored pose adds the registration's per-step translations
    # (the reference's t_cloud), off the pose the scan was inserted at by
    # (R - I) t; True: composed exactly (mapping.add_cloud_fused)
    exact_pose: bool = False


# fields of the port's configs that the JAX package's lack
PORT_ONLY = {"MappingConfig": ("exact_pose",)}


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """NUTS/HMC over kernel hyperparameters."""

    num_chains: int = 8
    num_warmup: int = 200
    num_samples: int = 200
    max_tree_depth: int = 8
    target_accept: float = 0.8
    init_step_size: float = 0.1


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    """SMC over scan poses for mapping."""

    num_particles: int = 64
    ess_threshold: float = 0.5
    pose_proposal_std_t: float = 0.01
    pose_proposal_std_r: float = 0.005


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Patch axis shards over `data`; chains/particles
    over `chain`."""

    data_axis: str = "data"
    chain_axis: str = "chain"
    data_size: Optional[int] = None   # None => all ranks on the data axis
    chain_size: int = 1


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    patch: PatchConfig = dataclasses.field(default_factory=PatchConfig)
    depth_gp: GPConfig = dataclasses.field(default_factory=GPConfig)
    rgb_gp: GPConfig = dataclasses.field(default_factory=rgb_gp_config)
    ksvd: KSVDConfig = dataclasses.field(default_factory=KSVDConfig)
    rgb_ksvd: KSVDConfig = dataclasses.field(
        default_factory=lambda: rgb_ksvd_config())
