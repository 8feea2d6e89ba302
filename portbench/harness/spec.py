"""What a cell is made of, found by name from BENCHMARK.json.

Every piece of a cell sits in a file of its own under `portbench/`, so a
later change adds a configuration, a traffic mix, an entry or a
per-layer metric by adding files and entries, and edits none:

  * configuration   the `file` that BENCHMARK.json names for it;
  * traffic mix     `traffic/<traffic>.json`, read by the general
                    generator (`harness/traffic.py`); its `entry` names
                    the program entry the window drives;
  * entry           `entries/<entry>.py`, one class `Entry`;
  * limits          `limits/<cell>.json`, each compared number's limit;
  * per-layer metric `metrics/<name>.py`, one function `read(trace)`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The cell's pieces: its BENCHMARK.json entry, configuration, traffic
    mix, limits, and its end-to-end and per-layer metrics' entries (root:
    the checkout that holds the files)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def applies(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in e2e_names and applies(m)]
    return {
        "workload": w,
        "config": load_json(root / conf["file"]),
        "traffic": load_json(root / "portbench" / "traffic"
                             / f"{w['traffic']}.json"),
        "limits": load_json(root / "portbench" / "limits" / f"{name}.json"),
        "root": root,
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def entry_class(name: str):
    """The `Entry` class of `entries/<name>.py`."""
    return importlib.import_module(f"portbench.entries.{name}").Entry


def metric_reader(name: str, root: Path = ROOT):
    """The module of `metrics/<name>.py`, with its `read` function and the
    `SPANS` it asks for (metric names hold dots, so the file is loaded by
    its path)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
