"""Per-rank layout and memory of the sharded pipelines.

The counterpart of `gp_compressor_tpu.parallel.aot_check.aot_shard_report`.
JAX compiles the programs ahead of time and reads the compiled output
shardings and `memory_analysis()`; torch compiles nothing ahead, so this
runs the sharded pipelines once, on this rank's block of a `room_cloud`
of the given size (only the block reaches the device), and reports for
this rank:

  * its rows of the cloud's point axis (`mesh.point_rows`);
  * the peak device memory of each stage of the round trip, run on its
    own: the front end (`compressor.project`), training and decompress
    (`torch.cuda.max_memory_allocated` after a reset; JAX's report reads
    `temp_bytes`), and what was allocated when the stage began (the
    caller's tensors and what earlier stages left alive, which the peak
    includes), None on the CPU;
  * the leading size of every point, bank, GP-state and decompress leaf
    of the calibrated round trip (`compress_decompress_calibrated`)
    against its whole size, marked "partitioned" (this rank holds a cut
    of it) or "whole", and that run's peak and start;
  * with rcfg, register's steps, peak and start (its scan is whole: the
    registration loop cuts only the map).

Every rank of the mesh must call it with the same arguments.
"""

from __future__ import annotations

from typing import Optional

import torch

from gp_compressor_tpu_torch.config import (CompressorConfig,
                                            RegistrationConfig)
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib


def _peak(device, fn):
    """(fn(), {"peak": allocated bytes at most during it, "start":
    allocated bytes when it began}; both None off CUDA)."""
    if device.type != "cuda":
        return fn(), {"peak": None, "start": None}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    start = int(torch.cuda.memory_allocated(device))
    out = fn()
    torch.cuda.synchronize(device)
    return out, {"peak": int(torch.cuda.max_memory_allocated(device)),
                 "start": start}


def shard_report(cfg: CompressorConfig, n_points: int, mesh,
                 rcfg: Optional[RegistrationConfig] = None,
                 dtype: torch.dtype = torch.float32,
                 calib_patches: int = 32, calib_points: int = 64,
                 seed: int = 0, device=None) -> dict:
    """Run the round trip by stages and the calibrated round trip (and
    register the cloud against its own map when rcfg is given) on `mesh`
    at these shapes; return this rank's rows, layout flags and peak
    memory. device: this rank's device (by default the mesh's device type
    through `distributed.local_device`)."""
    from gp_compressor_tpu_torch.parallel import distributed
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor, registration

    if device is None:
        device = distributed.local_device(mesh.device_type)
    pts_np, cols_np = synthetic.room_cloud(n=n_points, seed=seed)
    pts, cols, valid = compressor.shard_points(
        torch.from_numpy(pts_np).to(dtype), torch.from_numpy(cols_np).to(dtype),
        torch.ones(n_points, dtype=torch.bool), mesh)
    pts, cols, valid = pts.to(device), cols.to(device), valid.to(device)
    rows = mesh_lib.point_rows(n_points, mesh)

    stages = {}
    gen = compressor._shuffle_source(pts, cfg, None, None)
    batch, stages["front_end"] = _peak(device, lambda: compressor.project(
        pts, cols, valid, cfg, generator=gen, mesh=mesh))
    comp, stages["training"] = _peak(
        device, lambda: compressor.train(batch, cfg, mesh=mesh))
    _, stages["decompress"] = _peak(
        device, lambda: compressor.decompress(comp, cfg, mesh=mesh))
    del batch, comp

    (comp, kp, s20, out), mem = _peak(device, lambda: (
        compressor.compress_decompress_calibrated(
            pts, cols, valid, cfg, calib_patches=calib_patches,
            calib_points=calib_points, mesh=mesh)))
    B, G = cfg.patch.max_patches, cfg.patch.sz ** 2
    leaves = {
        "points": (pts, n_points),
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
        "point_rows": [rows.start, rows.stop],
        "max_patches": B,
        "slots": cfg.depth_gp.slots,
        "device": str(device),
        "stage_peak_bytes": {k: v["peak"] for k, v in stages.items()},
        "stage_start_bytes": {k: v["start"] for k, v in stages.items()},
        "calibrated_pipeline": {
            "leaves": {k: {"rows": int(t.shape[0]), "of": n,
                           "layout": ("partitioned" if t.shape[0] < n
                                      else "whole")}
                       for k, (t, n) in leaves.items()},
            "peak_bytes": mem["peak"],
            "start_bytes": mem["start"],
        },
    }
    if rcfg is not None:
        scan = torch.from_numpy(pts_np).to(device=device, dtype=dtype)
        scan_cols = torch.from_numpy(cols_np).to(device=device, dtype=dtype)
        ones = torch.ones(n_points, dtype=torch.bool, device=device)
        (st, _), mem = _peak(device, lambda: registration.register(
            comp, scan, scan_cols, ones, cfg, rcfg, depth_kp=kp,
            depth_s20=s20, mesh=mesh))
        report["register"] = {"steps": int(st.step_nbr),
                              "peak_bytes": mem["peak"],
                              "start_bytes": mem["start"]}
    return report
