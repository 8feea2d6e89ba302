"""Profiling and structured logging.

The reference's only observability is printf (SURVEY.md §5: "Tracing /
profiling: none"). The port of `gp_compressor_tpu.utils.profiling`: phase
timers that synchronise the card at their boundaries (a CUDA call returns
before the device finishes, so a timer without a synchronise measures the
enqueue), a `torch.profiler` trace written as a Chrome trace, and JSONL
metric logging in the JAX module's format.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def device_sync(*trees) -> float:
    """Wait for the card to finish the work queued for the tensors in
    `trees` (nested tuples, lists, dicts): one `torch.cuda.synchronize` of
    each CUDA device they lie on; nothing for CPU tensors. Returns the
    seconds spent waiting."""
    t0 = time.perf_counter()
    devices = {t.device for tree in trees for t in _leaves(tree) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return time.perf_counter() - t0


class PhaseTimer:
    """Accumulates per-phase wall times with device sync at boundaries.

    with timer.phase("train", sync=lambda: state): ...
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[Callable[[], Any]] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync())
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.times.items()}


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A `torch.profiler` trace of the block (host, and the card's
    kernels when CUDA is available), written to `logdir/trace.json` in
    Chrome's trace format, when logdir is given. Yields the profiler (None
    without logdir)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricLogger:
    """Append-only JSONL metrics (the reference prints scalars to stdout —
    SURVEY.md §5 'Metrics / logging: printed scalars only')."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, **metrics):
        rec = {"t": round(time.time(), 3), **{
            k: (float(v) if hasattr(v, "dtype") else v)
            for k, v in metrics.items()}}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line)

    def close(self):
        if self._fh:
            self._fh.close()
