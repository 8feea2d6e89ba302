"""front_end_ms.ksvd: mean host ms per cloud of the dictionary codec's
front end, `patches.build_raster_patches` (grid, sphere moments, Jacobi
plane fits, claims, the per-cell sums of the raster), in a span
synchronised at its edges."""

SPANS = [("gp_compressor_tpu_torch.geometry.patches",
          "build_raster_patches")]


def read(run):
    v = run.trace.per_request("build_raster_patches")
    return 1e3 * sum(v) / len(v) if v else None
