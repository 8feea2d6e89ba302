"""reg_steps_per_scan: the program's `reg.steps` count (gradient steps of
the registration loop) per frame of the traced window, as the entry
records it; none where the program does not count it."""


def read(run):
    v = run.trace.counters.get("reg.steps")
    return sum(v) / len(v) if v else None
