"""Device idle time and kernel launches of profiled requests, by the layer
of the port whose host code caused them.

The port marks its layers with spans (`gp_compressor_tpu_torch.utils.
profiling`); with its tracing on, each span is also a range on the
profiler's host timeline, on the clock the device's activity is stamped
on. `keep` takes from a torch.profiler trace what the attribution needs:
the program spans' host ranges, the CUDA runtime calls (launches and
synchronising calls) and the device operations; `attribute` then splits

  * the device's idle time over the requests' ranges, each idle gap to
    the innermost program span open on the host when the gap began;
  * the device kernels (copies and sets left out), each to the span open
    when the host call that launched it began: the runtime event that the
    kernel's correlation id names, not the kernel's own start, since the
    device runs behind the host;
  * the synchronising runtime calls that lie inside a `round_trip`.

Both compare times on every thread: autograd's backward launches from its
own thread while the main thread sits in `calibration.step`. A span's
layer is the layer span open at that time (LAYERS); a time inside a
`round_trip` but in no layer span falls to "round_trip", a time outside
every `round_trip` (between requests, the harness's own copies and
synchronisations) to "outside". The parts sum to the whole by
construction: idle over the requests' ranges, and every kernel.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from portbench.harness.stats import merged_intervals

REQUEST = "portbench.request."       # the harness's request ranges
ROOT = "round_trip"
# layer spans of the port -> the layer they belong to
LAYERS = {"front_end": "front_end", "train.depth": "train",
          "train.rgb": "train", "sanitize": "decompress",
          "decompress": "decompress", "calibration": "calib"}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
COPIES = ("Memcpy", "Memset")


def keep(events, names) -> dict:
    """From profiler events (`prof.events()`: name, device_type,
    time_range in microseconds, id, the correlation id of a runtime call
    and of the device operation it launched): the host ranges of the
    program spans (CPU events named in `names`) and of the requests, the
    start of each CUDA runtime call by correlation id, the starts of the
    synchronising calls, and the device operations (start, end, name,
    correlation id)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    out = {"spans": [], "requests": [], "launch_at": {}, "syncs": [],
           "device": []}
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == cpu:
            if e.name in names:
                out["spans"].append((t0, t1, e.name))
            elif e.name.startswith(REQUEST):
                out["requests"].append((t0, t1))
            elif e.name.startswith("cu"):          # cudaXxx and cuXxx API calls
                out["launch_at"][e.id] = t0
                if e.name in SYNCS:
                    out["syncs"].append(t0)
        elif e.device_type == cuda and not e.name.startswith(REQUEST):
            out["device"].append((t0, t1, e.name, e.id))
    return out


def _labels(times, spans):
    """For each time t, (innermost span open at t, its layer): the span
    with the latest start among those with start <= t < end (None when
    none is open), and the layer of the layer span open then, else ROOT
    when a `round_trip` is open, else "outside"."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    spans = sorted(spans)
    out = [None] * len(times)
    open_, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            open_.append(spans[j])
            j += 1
        open_ = [s for s in open_ if s[1] > t]
        inner = max(open_, key=lambda s: s[0])[2] if open_ else None
        layer = max(((s[0], LAYERS[s[2]]) for s in open_
                     if s[2] in LAYERS), default=(None, None))[1]
        if layer is None:
            layer = ROOT if any(s[2] == ROOT for s in open_) else "outside"
        out[i] = (inner, layer)
    return out


def attribute(kept: dict, window_s: float = None) -> dict:
    """The split of a kept trace (see the module docstring): requests;
    idle_s {layer, ROOT, "outside": seconds} over the requests' ranges
    and idle_by_span {innermost span or "(no span)": seconds}, both with
    the rest of `window_s` (the profiled window on the host's clock,
    which holds the ranges) as idle "outside" when it is given; launches
    {layer, ROOT, "outside": kernels} (a kernel whose runtime call is
    missing counts "outside" and in `unmatched`), kernels (all of them);
    syncs (synchronising calls inside a ROOT span) and round_trips (ROOT
    spans); named_as_span (device operations that carry a program span's
    name: none should); range_s, the requests' ranges from the first
    start to the last end, busy_in_s and busy_out_s, the device's busy
    time inside and outside them."""
    reqs = kept["requests"]
    res = {"requests": len(reqs),
           "round_trips": sum(s[2] == ROOT for s in kept["spans"]),
           "idle_s": defaultdict(float),
           "idle_by_span": defaultdict(float), "launches": defaultdict(int),
           "kernels": 0, "unmatched": 0, "syncs": 0, "named_as_span": 0,
           "range_s": 0.0, "busy_in_s": 0.0, "busy_out_s": 0.0}
    if not reqs:
        return res
    w0, w1 = min(r[0] for r in reqs), max(r[1] for r in reqs)
    busy = merged_intervals([(s, e) for s, e, _, _ in kept["device"]])
    inside = sum(max(0.0, min(e, w1) - max(s, w0)) for s, e in busy)
    res["range_s"] = (w1 - w0) / 1e6
    res["busy_in_s"] = inside / 1e6
    res["busy_out_s"] = (sum(e - s for s, e in busy) - inside) / 1e6
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(max(a, w0), min(b, w1)) for a, b in zip(edges[::2], edges[1::2])
            if min(b, w1) > max(a, w0)]
    for (a, b), (inner, layer) in zip(gaps, _labels([a for a, _ in gaps],
                                                      kept["spans"])):
        res["idle_s"][layer] += (b - a) / 1e6
        res["idle_by_span"][inner or "(no span)"] += (b - a) / 1e6
    if window_s is not None:
        res["idle_s"]["outside"] += window_s - res["range_s"]
        res["idle_by_span"]["(no span)"] += window_s - res["range_s"]

    names = {s[2] for s in kept["spans"]}
    kernels = [d for d in kept["device"] if not d[2].startswith(COPIES)]
    res["named_as_span"] = sum(d[2] in names for d in kept["device"])
    at = [kept["launch_at"].get(d[3]) for d in kernels]
    found = [t for t in at if t is not None]
    for _, layer in _labels(found, kept["spans"]):
        res["launches"][layer] += 1
    res["unmatched"] = len(at) - len(found)
    res["launches"]["outside"] += res["unmatched"]
    res["kernels"] = len(kernels)
    res["syncs"] = sum(layer != "outside" for _, layer in
                       _labels(kept["syncs"], kept["spans"]))
    res["idle_s"], res["idle_by_span"], res["launches"] = (
        dict(res["idle_s"]), dict(res["idle_by_span"]),
        dict(res["launches"]))
    return res


def per_cloud(res: dict) -> dict:
    """The would-be per-layer metrics of a split: `<layer>_idle_ms` and
    `<layer>_launches` per request for each layer it saw, and
    `syncs_per_cloud` where it saw a `round_trip`; none where the trace
    holds no request."""
    n = res["requests"]
    if not n:
        return {}
    out = {}
    for layer in sorted(set(LAYERS.values())):
        if layer in res["idle_s"] or layer in res["launches"]:
            out[f"{layer}_idle_ms"] = 1e3 * res["idle_s"].get(layer, 0.0) / n
            out[f"{layer}_launches"] = res["launches"].get(layer, 0) / n
    if res["round_trips"]:
        out["syncs_per_cloud"] = res["syncs"] / n
    return out


def setup_program_s(records) -> float:
    """Seconds inside the program's outermost spans among `records` (the
    port's SpanRecords of a run's set-up): the kernel build or load, the
    cold calibration, the warm-up round trips."""
    return sum(r.end - r.start for r in records if r.parent is None)
