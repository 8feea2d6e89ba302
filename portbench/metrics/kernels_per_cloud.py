"""kernels_per_cloud: device kernels (copies and sets left out) per
request in the profiled requests."""

from portbench.harness.readers import kernels_per_request as read  # noqa: F401
