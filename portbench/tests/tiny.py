"""Cells cut to a size a CPU test can hold: a few thousand points, small
banks, short calibrations. The limits, metrics and entries are the
cells' own; only the sizes change."""

from __future__ import annotations

import time

import torch

from portbench.harness import runner, spec

CPU = torch.device("cpu")
CELLS = ("compress.stream", "compress.calibrated")
# seconds of window that reach every sampled request at these sizes
WINDOW = {"compress.stream": 2.0, "compress.calibrated": 2.0}


def pieces(cell: str, root=spec.ROOT) -> dict:
    p = spec.cell(spec.benchmark(root), cell, root)
    c, t = p["config"], p["traffic"]
    c["n_points"] = 3000
    c["patch"].update(res=0.4, sz=6, max_patches=128,
                      max_points_per_patch=64)
    t.update(pool=3, check_requests=2, profile_requests=1)
    for k in ("cold", "warm"):
        if k in t:
            t[k]["steps"] = 5
    return p


def run(cell: str, traced: bool = False, seed: int = 2 ** 31 + 7,
        p: dict = None, entry_class=None) -> dict:
    p = p or pieces(cell)
    return runner.run_cell(p, seed, WINDOW[cell], traced, CPU,
                           time.perf_counter(), entry_class=entry_class)
