"""omp_ms.ksvd: mean host ms per call of the batched masked OMP,
`dictionary.omp_encode` (one call per K-SVD sweep and one final encoding
per K-SVD), in a span synchronised at its edges. Per call, so that the
number of sweeps, which the data sets, does not move it."""

SPANS = [("gp_compressor_tpu_torch.models.dictionary", "omp_encode")]


def read(run):
    calls = run.trace.calls.get("omp_encode")
    return 1e3 * sum(s for _, s, _ in calls) / len(calls) if calls else None
