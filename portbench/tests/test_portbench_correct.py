"""`correct` against its control and against faults in the timed path.

Each cell runs here on the CPU at a size a test can hold, with the
cell's own limits: unbroken it is correct; its control (the reference in
bfloat16 put in the program's place) is not; and a run whose timed path
is broken underneath is not, once for each fault the cell can have: a
step that returns its state unchanged, half of the batch left out, and
an answer altered where it is produced. (One card per cell: no exchange
between chips to leave out.)
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import runner, spec
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    r = tiny.run(cell)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(cell):
    """A whole run with the control in the program's place on every
    request it checks."""
    p = tiny.pieces(cell)
    Control = runner.control_entry(spec.entry_class(p["traffic"]["entry"]),
                                   torch.bfloat16)
    r = tiny.run(cell, seed=11, p=p, entry_class=Control)
    assert Control.compared == p["traffic"]["check_requests"]
    assert r["correct"] is False, r["checks"]


def _unchanged_state(monkeypatch, cell):
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    monkeypatch.setattr(sogp_train, "add_points_batch_cuda",
                        lambda kp, cfg, states, *a, **k: states)


def _half_batch(monkeypatch, cell):
    from gp_compressor_tpu_torch.workloads import compressor
    project = compressor.project

    def half(valid):
        keep = torch.arange(valid.shape[0], device=valid.device) \
            < valid.shape[0] // 2
        return valid & keep
    monkeypatch.setattr(compressor, "project",
                        lambda p, c, v, *a, **k: project(p, c, half(v),
                                                         *a, **k))


def _altered_answer(monkeypatch, cell):
    from gp_compressor_tpu_torch.workloads import compressor
    decompress = compressor.decompress

    def moved(*a, **k):
        world, *rest = decompress(*a, **k)
        return (world + 0.2, *rest)
    monkeypatch.setattr(compressor, "decompress", moved)


FAULTS = {"state_unchanged": _unchanged_state, "half_batch": _half_batch,
          "answer_altered": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    r = tiny.run(cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_on_the_card(cell):
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483653", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
