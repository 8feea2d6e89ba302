"""cloud_ms_p95: the 95th percentile over every request of the window of
its latency on the device's clock, from the cloud's host-to-device copy
to the synchronised decompressed cloud."""

from portbench.harness.stats import percentile


def read(run):
    return percentile(run.window.latency_ms, 95)
