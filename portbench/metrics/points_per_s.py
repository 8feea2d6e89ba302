"""points_per_s: every point of every request the window finished, over
the window's whole length on the host's clock."""


def read(run):
    return run.window.units / run.window.seconds
