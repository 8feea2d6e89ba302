"""idle_share.compress: 1 - (union of the device's operation intervals)
/ (the profiled window's wall), in %, over the requests run under
torch.profiler."""

from portbench.harness.readers import idle_share as read  # noqa: F401
