"""Carry weights and state across from the JAX package.

Each function takes a dict of numpy arrays keyed by the JAX NamedTuple's
field names (`nt._asdict()` with `np.asarray` applied to each leaf, nested
NamedTuples as nested dicts) and returns the port's NamedTuple on
`device` (the card unless the caller names another). Config dataclasses
convert field by field from `dataclasses.asdict` of the JAX config, with
numpy dtypes mapped to torch dtypes. Nothing here imports the JAX
package: the dicts are plain data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gp_compressor_tpu_torch import config as config_mod
from gp_compressor_tpu_torch.geometry.patches import PatchBatch, RasterBatch
from gp_compressor_tpu_torch.geometry.voxel import VoxelGrid
from gp_compressor_tpu_torch.inference.smc import ParticleState
from gp_compressor_tpu_torch.inference.vi import VIResult
from gp_compressor_tpu_torch.models.dictionary import KSVDResult, OMPCode
from gp_compressor_tpu_torch.models.sparse_gp import SOGPState
from gp_compressor_tpu_torch.workloads.compressor import CompressedCloud
from gp_compressor_tpu_torch.workloads.ksvd_compressor import KSVDCompressed
from gp_compressor_tpu_torch.workloads.mapping import MapState
from gp_compressor_tpu_torch.workloads.registration import (ClaimTables,
                                                           RegistrationState)


def _t(a, device):
    return None if a is None else torch.tensor(np.asarray(a), device=device)


def _tuple(cls, d, device):
    return cls(**{f: _t(d.get(f), device) for f in cls._fields})


def state_from_numpy(d, device="cuda") -> SOGPState:
    return _tuple(SOGPState, d, device)


def grid_from_numpy(d, device="cuda") -> VoxelGrid:
    return _tuple(VoxelGrid, d, device)


def patch_batch_from_numpy(d, device="cuda") -> PatchBatch:
    fields = {f: _t(d[f], device) for f in PatchBatch._fields if f != "grid"}
    return PatchBatch(grid=grid_from_numpy(d["grid"], device), **fields)


def compressed_from_numpy(d, device="cuda") -> CompressedCloud:
    return CompressedCloud(patch=patch_batch_from_numpy(d["patch"], device),
                           depth_gp=state_from_numpy(d["depth_gp"], device),
                           rgb_gp=state_from_numpy(d["rgb_gp"], device))


def ksvd_result_from_numpy(d, device="cuda") -> KSVDResult:
    return KSVDResult(D=_t(d["D"], device),
                      code=_tuple(OMPCode, d["code"], device),
                      error=_t(d["error"], device), iters=int(d["iters"]))


def ksvd_compressed_from_numpy(d, device="cuda") -> KSVDCompressed:
    """KSVDCompressed from the JAX KSVDCompressed's fields (raster, depth
    and rgb as nested dicts, cfg as `dataclasses.asdict` of the JAX
    CompressorConfig)."""
    fields = {f: _t(d["raster"][f], device) for f in RasterBatch._fields
              if f != "grid"}
    raster = RasterBatch(grid=grid_from_numpy(d["raster"]["grid"], device),
                         **fields)
    return KSVDCompressed(raster=raster,
                          depth=ksvd_result_from_numpy(d["depth"], device),
                          rgb=ksvd_result_from_numpy(d["rgb"], device),
                          cfg=compressor_config_from_dict(d["cfg"]))


def _config(cls, d):
    own = config_mod.PORT_ONLY.get(cls.__name__, ())
    kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
          if f.name not in own or f.name in d}
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, np.dtype(kw["dtype"]).name)
    return cls(**kw)


def registration_config_from_dict(d) -> config_mod.RegistrationConfig:
    """RegistrationConfig from `dataclasses.asdict` of the JAX config."""
    return _config(config_mod.RegistrationConfig, d)


def hmc_config_from_dict(d) -> config_mod.HMCConfig:
    """HMCConfig from `dataclasses.asdict` of the JAX config."""
    return _config(config_mod.HMCConfig, d)


def smc_config_from_dict(d) -> config_mod.SMCConfig:
    """SMCConfig from `dataclasses.asdict` of the JAX config."""
    return _config(config_mod.SMCConfig, d)


def particle_state_from_numpy(d, device="cuda") -> ParticleState:
    return _tuple(ParticleState, d, device)


def vi_result_from_numpy(d, device="cuda") -> VIResult:
    return _tuple(VIResult, d, device)


def registration_state_from_numpy(d, device="cuda") -> RegistrationState:
    return _tuple(RegistrationState, d, device)


def claim_tables_from_numpy(d, device="cuda") -> ClaimTables:
    return _tuple(ClaimTables, d, device)


def map_state_from_numpy(d, device="cuda") -> MapState:
    """MapState from the JAX MapState's fields (depth_gp, rgb_gp and
    tables as nested dicts)."""
    nested = {"depth_gp": state_from_numpy, "rgb_gp": state_from_numpy,
              "tables": claim_tables_from_numpy}
    return MapState(**{f: nested[f](d[f], device) if f in nested
                       else _t(d[f], device) for f in MapState._fields})


def mapping_config_from_dict(d) -> config_mod.MappingConfig:
    """MappingConfig from `dataclasses.asdict` of the JAX config."""
    return _config(config_mod.MappingConfig, d)


def compressor_config_from_dict(d) -> config_mod.CompressorConfig:
    """CompressorConfig from `dataclasses.asdict` of the JAX config."""
    return config_mod.CompressorConfig(
        patch=_config(config_mod.PatchConfig, d["patch"]),
        depth_gp=_config(config_mod.GPConfig, d["depth_gp"]),
        rgb_gp=_config(config_mod.GPConfig, d["rgb_gp"]),
        ksvd=_config(config_mod.KSVDConfig, d["ksvd"]),
        rgb_ksvd=_config(config_mod.KSVDConfig, d["rgb_ksvd"]))
