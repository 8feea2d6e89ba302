"""One run of one cell: set-up, the measured window, the trace, `correct`.

The window is a closed loop: request i starts when request i - 1 has
finished (the entry synchronises at its end), and requests start until
`seconds` have passed; every request started is finished and counted.
Each request's latency is taken on the device's clock, by a CUDA event
recorded before its first host-to-device copy and one after its last
operation (the stream is empty when the first is recorded, so it fires at
once); the window's length is taken on the host's clock.

With trace, the window runs with the spans its per-layer metrics ask for
(`SPANS` in each reader), then a few more requests, those the entry's
`profile_order` picks, run under torch.profiler without spans. The
device's peak memory is read when the window and the trace are over,
before the reference runs.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from portbench.harness import spec as spec_mod
from portbench.harness.trace import Spans, Trace, profile_requests


class Window:
    """The measured window: units of work finished (points),
    requests, seconds on the host's clock, and each request's latency."""

    def __init__(self):
        self.units = 0
        self.requests = 0
        self.seconds = 0.0
        self.latency_ms = []
        self.setup_s = None


class Run:
    """What the metric readers read: the window and, traced, the trace."""

    def __init__(self, window: Window, trace: Trace = None):
        self.window = window
        self.trace = trace


def _event_pair(device):
    if device.type != "cuda":
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def measure(entry, seconds: float, device: torch.device,
            trace: Trace = None, span_targets=()) -> Window:
    """Drive entry.request(0), (1), ... for `seconds` (closed loop)."""
    win = Window()
    ctx = Spans(span_targets, trace, device) if trace is not None \
        else contextlib.nullcontext()
    n, units = 0, 0
    lat = []
    with ctx:
        t0 = time.perf_counter()
        while True:
            if trace is not None:
                trace.request = n
                trace.pool_of.append(entry.pool_index(n))
            ev = _event_pair(device)
            h0 = time.perf_counter()
            if ev:
                ev[0].record()
            units += entry.request(n)
            if ev:
                ev[1].record()
                ev[1].synchronize()
                lat.append(ev[0].elapsed_time(ev[1]))
            else:
                lat.append((time.perf_counter() - h0) * 1e3)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        win.seconds = time.perf_counter() - t0
    win.units, win.requests, win.latency_ms = units, n, lat
    if trace is not None:
        trace.requests = n
    return win


# the control's precision: the one below the configuration's
CONTROL_DTYPE = {"float32": torch.bfloat16, "float64": torch.float32}


def control_entry(Entry, low: torch.dtype):
    """The cell's entry with its control in the program's place: each
    request the run checks returns the reference computed in `low`
    (`Entry.reference(k, low)`) instead of the program's output, also
    where the window closed before it (the other requests run the
    program, and nothing judges them). The class's `compared` counts the
    requests its last check judged."""

    class Control(Entry):
        def _control(self, i: int):
            k = self.pool_index(i)
            comp, out, _ = self.reference(k, low)
            self.kept[i] = (k, comp, out)

        def request(self, i: int) -> int:
            if i in self.sample and i not in self.kept:
                self._control(i)
                return self.n
            return super().request(i)

        def end_window(self):
            for i in sorted(self.sample):
                if i not in self.kept:
                    self._control(i)
            super().end_window()

        def check(self, trace=None) -> dict:
            type(self).compared = len(self.kept)
            return super().check(trace)

    return Control


def run_cell(pieces: dict, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             entry_class=None) -> dict:
    """One run of a cell (pieces: spec.cell's dict; entry_class: the
    entry to drive in place of the cell's own, as control_entry's).
    Returns the result line's fields and `checks`: {name: [value,
    limit]}."""
    traffic, limits = pieces["traffic"], pieces["limits"]
    metrics = pieces["per_layer"] if traced else pieces["end_to_end"]
    readers = {m["name"]: spec_mod.metric_reader(m["name"], pieces["root"])
               for m in metrics}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    Entry = entry_class or spec_mod.entry_class(traffic["entry"])
    entry = Entry(pieces["config"], traffic, seed, device)
    entry.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    trace = Trace() if traced else None
    if trace is not None:
        entry.trace = trace
    targets = [t for r in readers.values() for t in getattr(r, "SPANS", ())]
    # no collector pauses inside the window (its garbage is freed by
    # reference counts; the cycles wait for the window's end)
    gc.collect()
    gc.disable()
    try:
        win = measure(entry, seconds, device, trace, targets)
    finally:
        gc.enable()
    win.setup_s = setup_s
    breakdown = None
    if trace is not None:
        entry.trace = None
        indices = entry.profile_order(win.requests,
                                      int(traffic["profile_requests"]))
        trace.profile, breakdown = profile_requests(
            entry.request, indices, entry.pool_index, device)
        attempted = win.requests + int(traffic["profile_requests"])
    else:
        attempted = win.requests
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    entry.end_window()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.check(trace)
    # the cell's limits name the numbers it compares; a number missing,
    # NaN or above its limit makes the run not correct
    checks = {k: [numbers.get(k), limits[k]] for k in sorted(limits)}
    correct = all(v is not None and v == v and v <= lim
                  for v, lim in checks.values())

    run = Run(win, trace)
    out_metrics = {}
    units = {m["name"]: m["unit"] for m in metrics}
    for name, reader in readers.items():
        v = reader.read(run)
        if v is not None:
            out_metrics[name] = {"value": float(v), "unit": units[name]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace is not None:
        dev["busy_s"] = trace.profile["busy_s"]
        dev["window_s"] = trace.profile["window_s"]
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": out_metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
