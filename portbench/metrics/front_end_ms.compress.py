"""front_end_ms.compress: mean host ms per cloud of the front end,
`compressor.project` (grid, sphere moments, Jacobi plane fits, claims,
banks), in a span synchronised at its edges."""

SPANS = [("gp_compressor_tpu_torch.workloads.compressor", "project")]


def read(run):
    v = run.trace.per_request("project")
    return 1e3 * sum(v) / len(v) if v else None
