"""The port's spans against the card's trace, in the benchmark's cells.

Run from the repository root on a machine with a CUDA card:

    python3 trace_probe.py --cells compress.stream,compress.calibrated,\
ksvd.stream --seeds 1234567891,2345678912,3456789123 --seconds 51

For each cell and seed it sets the cell's entry up (`portbench/entries/`)
with the port's tracing on (`setup_program_s`: the seconds inside the
set-up's outermost spans) and measures two closed-loop windows of
`--seconds` (the benchmark's `runner.measure`), tracing off and on, the
order alternating by seed: `points_per_s` of each, and the port's
counts made in each (`calibration.*`: eager ascents, graph captures and
replays; `ksvd.*`: sweeps, atom blocks, block kernel launches, stop
reads, OMP's eager encodings, graph captures and replays). Then it
sets the first seed's entry up again and profiles the cell's profiled requests
through the benchmark's own `trace.profile_requests`, twice with tracing
off and twice on, in turns, and splits the last traced profile by layer
(`portbench/harness/layers.py`): per-cloud idle and launches of each
layer, synchronising calls inside `round_trip`, and the closure of the
split against the benchmark's own `busy_s`, `window_s` and `kernels`;
in the K-SVD codec's cell (`ksvd.stream`), whose spans are none of those
layers, per-cloud idle and launches by the innermost `ksvd.*` span
(`ksvd.front_end`, `.omp`, `.sweep`, `.replace`, `.decompress`, and the
rest of `ksvd.depth`, `ksvd.rgb` and `ksvd.compress`) and the
synchronising calls inside `ksvd.compress` and `ksvd.decompress`. It
counts the synchronising calls of one request with tracing off and on
(torch's sync debug mode), and last times one span off and on on the
host. Every result is a JSON line (also written to `--out`); the last
line sums them up, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from collections import Counter

# the port's counts a window records: the MAP ascent's eager ascents, graph
# captures and replays; the K-SVD codec's sweeps, atom blocks, block kernel
# launches, stop reads, and OMP's eager encodings, graph captures and replays
WINDOW_COUNTS = ("calibration.", "ksvd.")
# the K-SVD codec's spans (workloads/ksvd_compressor.py, models/dictionary.py)
KSVD_SPANS = {"ksvd.compress", "ksvd.front_end", "ksvd.depth", "ksvd.rgb",
              "ksvd.omp", "ksvd.sweep", "ksvd.replace", "ksvd.decompress"}


def _profile(entry, indices, device, tracing: bool):
    """trace.profile_requests on `indices` with the port's tracing on or
    off: (profile, breakdown, profiler events, span records)."""
    import torch.profiler
    from gp_compressor_tpu_torch.utils import profiling
    from portbench.harness import trace

    made = []
    base = torch.profiler.profile

    class Kept(base):                  # the profile profile_requests makes
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    profiling.take()
    profiling.tracing(tracing)
    torch.profiler.profile = Kept
    try:
        prof, breakdown = trace.profile_requests(
            entry.request, indices, entry.pool_index, device)
    finally:
        torch.profiler.profile = base
        profiling.tracing(False)
    return prof, breakdown, made[0].events(), profiling.take()


def _syncs(entry, i: int, tracing: bool) -> int:
    """The synchronising CUDA calls of request i, counted by torch's sync
    debug mode."""
    import warnings

    import torch
    from gp_compressor_tpu_torch.utils import profiling

    profiling.tracing(tracing)
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                entry.request(i)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        profiling.tracing(False)
        profiling.take()
    # (the mode's own "prototype feature" notice is not a call)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _setup(pieces, seed, device):
    """The cell's entry for `seed`, set up with tracing on: (entry, row)
    with the set-up's wall and the seconds inside its outermost spans."""
    import torch
    from gp_compressor_tpu_torch.utils import profiling
    from portbench.harness import layers, spec

    Entry = spec.entry_class(pieces["traffic"]["entry"])
    entry = Entry(pieces["config"], pieces["traffic"], seed, device)
    profiling.take()
    profiling.tracing(True)
    t0 = time.perf_counter()
    try:
        entry.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        profiling.tracing(False)
    recs = profiling.take()
    return entry, {
        "cell": pieces["workload"]["name"], "seed": seed,
        "setup_wall_s": time.perf_counter() - t0,
        "setup_program_s": layers.setup_program_s(recs),
        "setup_spans": sorted({r.name for r in recs if r.parent is None})}


def _drop(entry, device):
    import torch

    entry.end_window()
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _windows(entry, row, seconds, device, first_on: bool):
    """Closed-loop windows (runner.measure) with tracing off and on, in
    the given order: points_per_s, requests and span records of each."""
    from gp_compressor_tpu_torch.utils import profiling
    from portbench.harness import runner

    for mode in ((True, False) if first_on else (False, True)):
        profiling.take()
        before = profiling.counters()
        profiling.tracing(mode)
        gc.collect()
        gc.disable()
        try:
            win = runner.measure(entry, seconds, device)
        finally:
            gc.enable()
            profiling.tracing(False)
        row[f"points_per_s_tracing_{int(mode)}"] = win.units / win.seconds
        row[f"requests_tracing_{int(mode)}"] = win.requests
        row[f"records_tracing_{int(mode)}"] = len(profiling.take())
        row[f"window_counts_tracing_{int(mode)}"] = {
            k: v - before.get(k, 0) for k, v in profiling.counters().items()
            if k.startswith(WINDOW_COUNTS)}


def _split(entry, row, pieces, device):
    """The profiled requests, twice with tracing off and twice on, in
    turns; the last traced profile split by layer; syncs of a request."""
    from portbench.harness import layers

    n = int(pieces["traffic"]["profile_requests"])
    idx = entry.profile_order(1000, n)
    for mode in (False, True, False, True):
        prof, brk, events, recs = _profile(entry, idx, device, mode)
        row.setdefault(f"profile_tracing_{int(mode)}", []).append({
            "busy_s": prof["busy_s"], "window_s": prof["window_s"],
            "kernels": prof["kernels"], "requests": prof["requests"],
            "idle_share": 100 * (1 - prof["busy_s"] / prof["window_s"]),
            "kernels_per_cloud": prof["kernels"] / prof["requests"],
            "idle_gaps": brk["idle_gaps"]})
    names = {r.name for r in recs}
    top = {r.name for r in recs if r.parent is None}
    kept = layers.keep(events, names)
    res = layers.attribute(kept, prof["window_s"])
    idle = prof["window_s"] - prof["busy_s"]
    inside = sum(v for key, v in res["idle_s"].items() if key != "outside")
    row["layers"] = {
        "split": res, "per_cloud": layers.per_cloud(res),
        "closure_idle_rel": sum(res["idle_s"].values()) / idle - 1.0,
        "closure_kernels": sum(res["launches"].values()) - prof["kernels"],
        "layer_share_of_round_trip_idle":
            1.0 - res["idle_s"].get("round_trip", 0.0) / inside
            if inside else None,
        "span_records": len(recs),
        # the profiler's clock against the host's: the outermost spans'
        # ranges in the trace over the same spans' records
        "clock_ratio": sum(e - s for s, e, nm in kept["spans"]
                           if nm in top) / 1e6
        / sum(r.end - r.start for r in recs if r.parent is None)}
    if names & KSVD_SPANS:
        row["ksvd_split"] = span_split(events, names & KSVD_SPANS,
                                       prof["window_s"])
    if device.type == "cuda":
        row["syncs_tracing_0"] = _syncs(entry, 1000 + n, False)
        row["syncs_tracing_1"] = _syncs(entry, 1001 + n, True)


def span_split(events, names, window_s: float) -> dict:
    """Per profiled request: device idle (ms) and kernel launches by the
    innermost of the spans `names` open when each idle gap began or each
    kernel's launching call was made ("(no span)" outside them), and the
    synchronising calls inside them."""
    from portbench.harness import layers

    kept = layers.keep(events, names)
    res = layers.attribute(kept, window_s)
    n = res["requests"]
    if not n:
        return {}
    kernels = [d for d in kept["device"] if not d[2].startswith(layers.COPIES)]
    at = [kept["launch_at"].get(d[3]) for d in kernels]
    found = [t for t in at if t is not None]
    launches = Counter(inner or "(no span)" for inner, _ in
                       layers._labels(found, kept["spans"]))
    launches["(no span)"] += len(at) - len(found)
    syncs = sum(inner is not None for inner, _ in
                layers._labels(kept["syncs"], kept["spans"]))
    return {"idle_ms": {k: 1e3 * v / n
                        for k, v in res["idle_by_span"].items()},
            "launches": {k: v / n for k, v in launches.items()},
            "unmatched": res["unmatched"], "syncs_per_cloud": syncs / n,
            "busy_in_ms": 1e3 * res["busy_in_s"] / n}


def probe_cell(pieces: dict, seeds, seconds: float, device) -> list:
    """The probe's rows of one cell (pieces: portbench.harness.spec.cell's
    dict). The windows of every seed run before any profiler in the
    process (a profiled session can leave the runtime slower after it),
    tracing off first for the even seeds and on first for the odd; then
    the first seed's entry is set up again and profiled."""
    out = []
    for k, seed in enumerate(seeds):
        entry, row = _setup(pieces, seed, device)
        _windows(entry, row, seconds, device, first_on=k % 2 == 1)
        print(json.dumps(row), flush=True)
        out.append(row)
        _drop(entry, device)
    entry, row = _setup(pieces, seeds[0], device)
    _split(entry, row, pieces, device)
    print(json.dumps(row), flush=True)
    out.append(row)
    _drop(entry, device)
    return out


def span_cost_us(n: int = 200_000) -> dict:
    """Host microseconds of one `with span(...)` with tracing off and on
    (no profiler running), the least of 5 loops of n."""
    from gp_compressor_tpu_torch.utils import profiling

    out = {}
    for mode in (False, True):
        profiling.tracing(mode)
        best = float("inf")
        try:
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(n):
                    with profiling.span("probe"):
                        pass
                best = min(best, time.perf_counter() - t0)
                profiling.take()
        finally:
            profiling.tracing(False)
        out[f"tracing_{int(mode)}"] = 1e6 * best / n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="compress.stream,compress.calibrated,"
                    "ksvd.stream")
    ap.add_argument("--seeds", default="1234567891,2345678912,3456789123")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="chiprun_out/trace_probe.jsonl")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_probe: needs a CUDA card", file=sys.stderr)
        return 1
    # as portbench/run.py: one thread, two fixed cores
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    from portbench.harness import spec

    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for cell in args.cells.split(","):
        rows += probe_cell(spec.cell(spec.benchmark(), cell), seeds,
                           args.seconds, device)
    cost = span_cost_us()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    summary = {"card": card, "torch": torch.__version__,
               "span_cost_us": cost, "cells": {}}
    for r in rows:
        c = summary["cells"].setdefault(r["cell"], {"on": [], "off": []})
        if "layers" not in r:
            c["on"].append(r["points_per_s_tracing_1"])
            c["off"].append(r["points_per_s_tracing_0"])
        else:
            c["per_cloud"] = r["layers"]["per_cloud"]
            c["closure_idle_rel"] = r["layers"]["closure_idle_rel"]
            c["closure_kernels"] = r["layers"]["closure_kernels"]
            c["named_as_span"] = r["layers"]["split"]["named_as_span"]
            c["syncs"] = [r.get("syncs_tracing_0"),
                          r.get("syncs_tracing_1")]
            if "ksvd_split" in r:
                c["ksvd_split"] = r["ksvd_split"]
    for c in summary["cells"].values():
        c["cost"] = [1.0 - on / off for on, off in zip(c["on"], c["off"])]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
