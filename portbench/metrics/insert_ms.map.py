"""insert_ms.map: mean host ms per frame of the program's span
`map.insert` (`mapping.map_insert`: leaves, plane fits, claims, banks,
training, sanitize, pending points, carving), as the entry records it in
the traced window; none where the program has no such span. The span
does not synchronise at its end: device work still queued then is left
to the request's closing synchronise."""


def read(run):
    v = run.trace.counters.get("map.insert")
    return sum(v) / len(v) if v else None
