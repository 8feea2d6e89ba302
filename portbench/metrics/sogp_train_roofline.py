"""sogp_train_roofline: the training kernel's share of its roofline, in %.

The least time of the profiled requests' training launches
(harness/roofline.py: bytes from the banks' and states' shapes,
operations from the reference's own BV and deletion counts, against the
H100 SXM peaks) over the device time of those launches in the profiler's
trace (the device operations named `sogp_train`), over the profiled
requests whose clouds the reference checked."""

KERNEL = "sogp_train"


def read(run):
    tr = run.trace
    bounds = tr.bounds_ms.get("sogp_train", {})
    spent_s, bound_ms = 0.0, 0.0
    for k, ops in (tr.profile or {}).get("device_s", {}).values():
        s = sum(v for name, v in ops.items() if KERNEL in name)
        if k in bounds and s > 0:
            spent_s += s
            bound_ms += bounds[k]
    return 100.0 * bound_ms / (1e3 * spent_s) if spent_s > 0 else None
