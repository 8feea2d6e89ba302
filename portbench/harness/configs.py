"""A configuration file -> the program's or the reference's config tree.

Both packages define the same dataclasses (`PatchConfig`, `GPConfig`,
`CompressorConfig`) with the same fields, so one function serves both:
pass the package's config module.
"""

from __future__ import annotations

import torch


def dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}[name]


def compressor_config(mod, config: dict, gp_dtype: torch.dtype = None):
    """mod.CompressorConfig from the file's `patch`, `depth_gp`, `rgb_gp`
    and `dtype` (gp_dtype overrides the GP states' dtype)."""
    dt = gp_dtype or dtype(config["dtype"])
    return mod.CompressorConfig(
        patch=mod.PatchConfig(**config["patch"]),
        depth_gp=mod.GPConfig(**config["depth_gp"], dtype=dt),
        rgb_gp=mod.GPConfig(**config["rgb_gp"], dtype=dt))
