"""setup_s: seconds from the run's start (before torch is imported) to the
window: imports, the pool, the kernel's build or load, warm-up."""


def read(run):
    return run.window.setup_s
