"""Per-rank layout and memory of the sharded pipelines.

The counterpart of `gp_compressor_tpu.parallel.aot_check.aot_shard_report`.
JAX compiles the programs ahead of time and reads the compiled output
shardings and `memory_analysis()`; torch compiles nothing ahead, so this
runs the sharded calibrated round trip (`compress_decompress_calibrated`)
and `register` once, on a `room_cloud` of the given size on this rank's
device, and reports for this rank:

  * the leading size of every bank, GP-state and decompress leaf against
    its whole size, marked "partitioned" (this rank holds a cut of it) or
    "whole";
  * the peak device memory of each run (`torch.cuda.max_memory_allocated`
    after a reset; JAX's report reads `temp_bytes`), None on the CPU.

Every rank of the mesh must call it with the same arguments.
"""

from __future__ import annotations

from typing import Optional

import torch

from gp_compressor_tpu_torch.config import (CompressorConfig,
                                            RegistrationConfig)
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib


def _peak(device, fn):
    """(fn(), peak allocated bytes during it; None off CUDA)."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, int(torch.cuda.max_memory_allocated(device))


def shard_report(cfg: CompressorConfig, n_points: int, mesh,
                 rcfg: Optional[RegistrationConfig] = None,
                 dtype: torch.dtype = torch.float32,
                 calib_patches: int = 32, calib_points: int = 64,
                 seed: int = 0, device=None) -> dict:
    """Run the calibrated round trip (and register the cloud against its
    own map when rcfg is given) on `mesh` at these shapes; return this
    rank's layout flags and peak memory. device: this rank's device (by
    default the mesh's device type through `distributed.local_device`)."""
    from gp_compressor_tpu_torch.parallel import distributed
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor, registration

    if device is None:
        device = distributed.local_device(mesh.device_type)
    pts_np, cols_np = synthetic.room_cloud(n=n_points, seed=seed)
    pts = torch.from_numpy(pts_np).to(device=device, dtype=dtype)
    cols = torch.from_numpy(cols_np).to(device=device, dtype=dtype)
    valid = torch.ones(n_points, dtype=torch.bool, device=device)

    (comp, kp, s20, out), peak = _peak(device, lambda: (
        compressor.compress_decompress_calibrated(
            pts, cols, valid, cfg, calib_patches=calib_patches,
            calib_points=calib_points, mesh=mesh)))
    B, G = cfg.patch.max_patches, cfg.patch.sz ** 2
    leaves = {
        "patch.X": (comp.patch.X, B), "patch.y": (comp.patch.y, B),
        "patch.rgb": (comp.patch.rgb, B), "patch.mask": (comp.patch.mask, B),
        "patch.W": (comp.patch.W, B),
        "patch.rotations": (comp.patch.rotations, B),
        "patch.means": (comp.patch.means, B),
        "patch.claims": (comp.patch.claims, n_points),
        "depth_gp.C": (comp.depth_gp.C, B),
        "depth_gp.alpha": (comp.depth_gp.alpha, B),
        "rgb_gp.C": (comp.rgb_gp.C, B),
        "decompress.world": (out[0], B * G),
        "decompress.colors": (out[1], B * G),
        "decompress.valid": (out[2], B * G),
    }
    report = {
        "n_ranks": mesh.size(),
        "coordinate": {a: mesh_lib.axis_index(mesh, a)
                       for a in mesh.mesh_dim_names},
        "n_points": n_points,
        "max_patches": B,
        "slots": cfg.depth_gp.slots,
        "device": str(device),
        "calibrated_pipeline": {
            "leaves": {k: {"rows": int(t.shape[0]), "of": n,
                           "layout": ("partitioned" if t.shape[0] < n
                                      else "whole")}
                       for k, (t, n) in leaves.items()},
            "peak_bytes": peak,
        },
    }
    if rcfg is not None:
        (st, _), peak = _peak(device, lambda: registration.register(
            comp, pts, cols, valid, cfg, rcfg, depth_kp=kp, depth_s20=s20,
            mesh=mesh))
        report["register"] = {"steps": int(st.step_nbr), "peak_bytes": peak}
    return report
