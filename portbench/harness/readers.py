"""Reader arithmetic that several metrics share (each metric's own file
under metrics/ names which it uses)."""


def idle_share(run):
    p = run.trace.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernels_per_request(run):
    p = run.trace.profile
    if not p or not p["requests"]:
        return None
    return p["kernels"] / p["requests"]
