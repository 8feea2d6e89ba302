"""calib_ms: mean host ms per cloud of the calibration's MAP ascent
(`hmc.map_estimate_multi` over the exact-GP marginal posterior of the
bank subsample), in a span synchronised at its edges."""

SPANS = [("gp_compressor_tpu_torch.inference.hmc", "map_estimate_multi")]


def read(run):
    v = run.trace.per_request("map_estimate_multi")
    return 1e3 * sum(v) / len(v) if v else None
