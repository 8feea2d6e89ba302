"""sweep_ms.ksvd: mean host ms per call of the atom sweep,
`dictionary._atom_sweep` (every atom of the dictionary updated once, in
blocks, by power iterations), in a span synchronised at its edges. Per
call, so that the number of sweeps, which the data sets, does not move
it."""

SPANS = [("gp_compressor_tpu_torch.models.dictionary", "_atom_sweep")]


def read(run):
    calls = run.trace.calls.get("_atom_sweep")
    return 1e3 * sum(s for _, s, _ in calls) / len(calls) if calls else None
