"""Spans around calls into the program, and the profiled requests.

A span wraps a module function of the program for the traced window only
(the way the port's smoke script's `front_end_trace` wraps one): the
device is synchronised at both edges, so the host wall of a call is its
own work, and a pair of CUDA events gives its device-timeline time.
Spans inside the program are a later change; these live in the
benchmark's own files.

`profile_requests` runs a few requests under torch.profiler and reduces
the trace: device busy time (the union of device intervals), the window,
kernels per request, each request's device time by operation, the device
operations that took most time, and the longest idle gaps by what the
host was doing.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict

import torch

from portbench.harness.stats import interval_union_us, merged_intervals


class Trace:
    """What a traced run gathered, for the per-layer metric readers.

    calls[name]: one (request, host seconds, device ms) per call of the
    span `name`; requests: requests in the span window; pool_of[r]: the
    pool input request r used; counters[name]: per-request values an entry
    records; bounds_ms[name][pool index]: the least time of the span's
    work on that input (roofline.py); profile: profile_requests' result."""

    def __init__(self):
        self.calls = defaultdict(list)
        self.requests = 0
        self.pool_of = []
        self.counters = defaultdict(list)
        self.bounds_ms = defaultdict(dict)
        self.profile = None
        self.request = -1

    def add(self, name: str, host_s: float, device_ms: float):
        self.calls[name].append((self.request, host_s, device_ms))

    def per_request(self, name: str) -> list:
        """Host seconds of span `name` summed per request that called it."""
        out = defaultdict(float)
        for r, s, _ in self.calls.get(name, ()):
            out[r] += s
        return list(out.values())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """While open, each (module, function) of `targets` is replaced by a
    wrapper that synchronises, times the call (host clock and CUDA
    events) and records it in `trace` under the function's name."""

    def __init__(self, targets, trace: Trace, device: torch.device):
        self.targets = sorted(set(targets))
        self.trace = trace
        self.device = device
        self.saved = []

    def _wrap(self, name, fn):
        trace, dev = self.trace, self.device

        def wrapped(*a, **k):
            _sync(dev)
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if dev.type == "cuda":
                e1.record()
            _sync(dev)
            host = time.perf_counter() - t0
            trace.add(name, host, e0.elapsed_time(e1)
                      if dev.type == "cuda" else host * 1e3)
            return out
        return wrapped

    def __enter__(self):
        for mod_name, fn_name in self.targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, self._wrap(fn_name, fn))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in reversed(self.saved):
            setattr(mod, fn_name, fn)
        self.saved = []
        return False


REQUEST = "portbench.request."


def profile_requests(run, indices, pool_index, device: torch.device):
    """run(i) for each i of `indices` under torch.profiler, each in a
    range named REQUEST + i. Returns (profile, breakdown): profile holds
    busy_s (the union of the device's operation intervals), window_s
    (the profiled wall), kernels (device kernels, copies and sets left
    out), requests, and device_s: per request, (its pool input, {device
    operation: seconds}) from the operations that start inside its range
    (a request synchronises at its end, so its work ends inside it too);
    breakdown holds device_ops, the 10 device operations with the most
    time, and idle_gaps, the idle time between device operations summed
    by what the host was doing when each gap began (the innermost host
    operation open then), 10 at most, all in seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in indices:
            with record_function(REQUEST + str(i)):
                run(i)
        _sync(device)
        window = time.perf_counter() - t0
    events = prof.events()
    # the request ranges also show on the device's timeline (as user
    # annotations spanning each request): they are no device work
    dev_ev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(REQUEST)]
    spans = [(e.time_range.start, e.time_range.end) for e in dev_ev]
    busy_us = interval_union_us(spans)
    kernels = [e for e in dev_ev
               if not e.name.startswith(("Memcpy", "Memset"))]
    by_op = defaultdict(float)
    for e in dev_ev:
        by_op[e.name[:120]] += (e.time_range.end - e.time_range.start) / 1e6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]

    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda x: x[0])
    ranges = [(h[0], h[1], int(h[2][len(REQUEST):])) for h in host
              if h[2].startswith(REQUEST)]
    host = [h for h in host if not h[2].startswith(REQUEST)]
    device_s = {i: (pool_index(i), defaultdict(float)) for i in indices}
    for e in dev_ev:
        for s0, e0, i in ranges:
            if s0 <= e.time_range.start <= e0:
                device_s[i][1][e.name[:120]] += (
                    e.time_range.end - e.time_range.start) / 1e6
                break

    # idle gaps between merged device intervals, by the host's innermost
    # operation open at the gap's start
    gaps = defaultdict(float)
    merged = merged_intervals(spans)
    open_, j = [], 0                      # host events open at the sweep
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        while j < len(host) and host[j][0] <= e0:
            open_.append(host[j])
            j += 1
        open_ = [h for h in open_ if h[1] > e0]
        # nested host events: the innermost one began last
        label = max(open_, key=lambda h: h[0])[2] if open_ \
            else "(no host operation)"
        gaps[label[:120]] += (s1 - e0) / 1e6
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    prof_out = {"busy_s": busy_us / 1e6, "window_s": window,
                "kernels": len(kernels), "requests": len(indices),
                "device_s": device_s}
    breakdown = {"device_ops": [[k, v] for k, v in device_ops],
                 "idle_gaps": [[k, v] for k, v in idle_gaps]}
    return prof_out, breakdown
