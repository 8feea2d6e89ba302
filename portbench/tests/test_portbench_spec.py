"""The harness finds every piece of a cell by name, and prints the
contract's result line."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import spec
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _copy_files(tmp: Path):
    (tmp / "portbench").mkdir()
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "portbench" / d, tmp / "portbench" / d)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")


def test_new_files_are_found_by_name_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer
    metric added as new files and entries run with no edit of an existing
    file."""
    _copy_files(tmp_path)
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "gp_compress.room.json").read_text())
    conf["name"] = "gp_compress.other"
    conf["patch"]["sz"] = 5
    (pb / "configs" / "gp_compress.other.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "compress.stream.json").read_text())
    mix["pool"] = 2
    (pb / "traffic" / "compress.pair.json").write_text(json.dumps(mix))
    (pb / "limits" / "other.pair.json").write_text(
        (pb / "limits" / "compress.stream.json").read_text())
    (pb / "metrics" / "requests_seen.py").write_text(
        "SPANS = [('gp_compressor_tpu_torch.workloads.compressor', "
        "'decompress')]\n\n\ndef read(run):\n"
        "    return len(run.trace.calls['decompress'])\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "gp_compress.other", "source": "x",
                         "file": "portbench/configs/gp_compress.other.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "other.pair", "config":
                           "gp_compress.other", "traffic": "compress.pair",
                           "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "points_per_s":
            m["workloads"].append("other.pair")
    b["per_layer"].append({"name": "requests_seen", "unit": "requests",
                           "better": "higher", "source": "program_span",
                           "layer": "decompress", "moves": "points_per_s",
                           "workloads": ["other.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    p = tiny.pieces("other.pair", root=tmp_path)
    assert p["config"]["patch"]["sz"] == 6      # cut to the test's size
    assert p["traffic"]["entry"] == "compress_decompress"
    assert [m["name"] for m in p["per_layer"]] == ["requests_seen"]
    r = tiny.runner.run_cell(p, 5, 1.0, True, tiny.CPU, 0.0)
    assert r["metrics"]["requests_seen"]["value"] >= 1
    assert r["correct"] is True


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(traced):
    r = tiny.run("compress.stream", traced)
    keys = RESULT_KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(r) == keys                       # checks last
    dev = ["platform", "kind", "count", "memory_peak_bytes"] + (
        ["busy_s", "window_s"] if traced else [])
    assert list(r["device"]) == dev
    names = {m["name"] for m in tiny.pieces("compress.stream")[
        "per_layer" if traced else "end_to_end"]}
    assert set(r["metrics"]) <= names
    if not traced:
        assert set(r["metrics"]) == names
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    for name, (value, limit) in r["checks"].items():
        assert isinstance(value, float) and value <= limit
    if traced:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(r)


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "compress.stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_directory_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "compress.stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_every_cell_names_existing_files():
    b = spec.benchmark()
    for w in b["workloads"]:
        p = spec.cell(b, w["name"])
        assert spec.entry_class(p["traffic"]["entry"]) is not None
        for m in p["end_to_end"] + p["per_layer"]:
            assert callable(spec.metric_reader(m["name"]).read)
        assert any(m["name"] == "setup_s" for m in p["end_to_end"])
        assert len(p["end_to_end"]) >= 2 and p["per_layer"]
