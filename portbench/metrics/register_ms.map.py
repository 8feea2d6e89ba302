"""register_ms.map: mean host ms per frame of the program's span
`map.register` (the frame moved by the accumulated pose, and the
registration loop to its stop: claims, density gradients, a stop read a
step), as the entry records it in the traced window; none where the
program has no such span. The loop ends on a read of the device, so the
span's end finds the registration's device work done."""


def read(run):
    v = run.trace.counters.get("map.register")
    return sum(v) / len(v) if v else None
