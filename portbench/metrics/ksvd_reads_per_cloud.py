"""ksvd_reads_per_cloud: the program's `ksvd.reads` count (one host read
of the stop test per K-SVD sweep) per request of the traced window, as
the entry records it; none where the program does not count it."""


def read(run):
    v = run.trace.counters.get("ksvd.reads")
    return sum(v) / len(v) if v else None
