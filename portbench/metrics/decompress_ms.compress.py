"""decompress_ms.compress: mean host ms per cloud of sanitize and
decompression (`compressor.sanitize`, `compressor.decompress`: the GPs'
predictions on the grid, reprojection), in spans synchronised at their
edges."""

SPANS = [("gp_compressor_tpu_torch.workloads.compressor", "sanitize"),
         ("gp_compressor_tpu_torch.workloads.compressor", "decompress")]


def read(run):
    tr = run.trace
    if not tr.calls.get("sanitize") and not tr.calls.get("decompress"):
        return None
    total = sum(s for n in ("sanitize", "decompress")
                for _, s, _ in tr.calls.get(n, ()))
    return 1e3 * total / tr.requests
