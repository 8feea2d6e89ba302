"""Spans, counters and the profiler trace of the port.

The reference's only observability is printf (SURVEY.md §5: "Tracing /
profiling: none"). The port marks its layers with spans and its work with
counters, in one process-wide tracer:

  * `span(name)`, a context manager and a decorator. With tracing on
    (`tracing(True)`), each span leaves a `SpanRecord` in memory until
    `take()`: its name, its request (the sequence number of the outermost
    span open on its thread), its parent and its start and end on the
    host's clock. While a `torch.profiler` session runs, the span is also
    a range on the profiler's host timeline (a `RecordFunctionFast` in
    the function scope, which the profiler does not mirror onto the
    device's timeline as it does `record_function`'s user ranges), so
    spans, kernel launches and device idle share one clock. A span never
    synchronises the device. With tracing off (the default) a span costs
    a flag check and records nothing.
  * `count(name, n=1)`, always on: adds n to the process's total of
    `name` (`counters()`, `reset_counters()`) and, with tracing on, to
    the innermost open span's `counts`. n may be a 0-dim device tensor,
    which is added without being read.
  * `trace(logdir)`: a `torch.profiler` trace of a block, with tracing on,
    written as a Chrome trace that carries the spans.

Spans mark stages, never per-element loops. Turn tracing on and off
outside any open span.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch


class SpanRecord:
    """One closed span: id (in opening order), name, request (the
    sequence number, among outermost spans, of the outermost span open on
    its thread when it opened), parent (the enclosing span's id, None for
    an outermost span), start and end
    (seconds on `time.perf_counter`'s clock) and counts ({name: total}
    of the counts made while it was the innermost open span, or None)."""

    __slots__ = ("id", "name", "request", "parent", "start", "end",
                 "counts")

    def __init__(self, id: int, name: str, request: int,
                 parent: Optional[int], start: float):
        self.id, self.name, self.request, self.parent = id, name, request, \
            parent
        self.start, self.end, self.counts = start, None, None


_on = False
_lock = threading.Lock()
_local = threading.local()        # .stack: [(SpanRecord, profiler range)]
_records = []
_ids = {"span": 0, "request": 0}
_totals = {}
_spans = {}


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    """The span of one name (made once per name: see span)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _on:
            st = _stack()
            with _lock:
                sid = _ids["span"]
                _ids["span"] += 1
                if st:
                    request, parent = st[-1][0].request, st[-1][0].id
                else:
                    request, parent = _ids["request"], None
                    _ids["request"] += 1
            rf = torch._C._profiler._RecordFunctionFast(self.name)
            rf.__enter__()
            st.append((SpanRecord(sid, self.name, request, parent,
                                  time.perf_counter()), rf))
        return self

    def __exit__(self, *exc):
        if _on:
            st = _stack()
            # a span opened while tracing was off has nothing to close
            if st and st[-1][0].name == self.name:
                rec, rf = st.pop()
                rec.end = time.perf_counter()
                rf.__exit__(None, None, None)
                _records.append(rec)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)
        return wrapped


def span(name: str) -> _Span:
    """The span `name`: `with span(name): ...` or `@span(name)`."""
    s = _spans.get(name)
    if s is None:
        s = _spans.setdefault(name, _Span(name))
    return s


def tracing(on: bool) -> None:
    """Turn tracing on or off (off by default). Either way the spans left
    open on this thread are dropped."""
    global _on
    _on = bool(on)
    _stack().clear()


def take() -> list:
    """The closed spans recorded since the last take, in closing order
    (a span closes after the spans it encloses); the store is emptied."""
    global _records
    out, _records = _records, []
    return out


def count(name: str, n=1) -> None:
    """Add n to the total of `name` and, with tracing on, to the
    innermost open span's counts."""
    _totals[name] = _totals.get(name, 0) + n
    if _on:
        st = _stack()
        if st:
            rec = st[-1][0]
            if rec.counts is None:
                rec.counts = {}
            rec.counts[name] = rec.counts.get(name, 0) + n


def counters() -> dict:
    """{name: total} of every count since the last reset_counters."""
    return dict(_totals)


def reset_counters() -> None:
    _totals.clear()


@contextmanager
def trace(logdir: Optional[str]):
    """A `torch.profiler` trace of the block (host, and the card's
    kernels when CUDA is available), with tracing on, written to
    `logdir/trace.json` in Chrome's trace format, when logdir is given.
    Yields the profiler (None without logdir). The block's spans stay in
    memory for `take()`."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _on
    tracing(True)
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        tracing(was)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
