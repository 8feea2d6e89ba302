"""The K-SVD codec's cell on the CPU, and its plain reference against the
port.

The cell `ksvd.stream` cut to a size a test can hold (3,000 points, sz 6,
dictionaries of 24 and 48 atoms) with its own limits: unbroken it is
correct; its control (the reference in bfloat16 in the program's place)
is not; and a run whose timed path is broken underneath is not, once for
each fault: an atom sweep that returns its dictionary unchanged, half the
patches left out, and decompressed points moved by 0.2 m. Then, in
float64, the port's OMP, one atom sweep and a whole K-SVD against the
reference's, which follows the source's description and shares no code
with the port: the same atoms, codes within 1e-9.
"""

import time

import pytest
import torch

from gp_compressor_tpu_torch.config import KSVDConfig as PortKSVD
from gp_compressor_tpu_torch.models import dictionary as pd
from gp_compressor_tpu_torch.testing import ksvd_case
from portbench.harness import runner, spec
from portbench.reference.models import dictionary as rd

CPU = torch.device("cpu")
CELL = "ksvd.stream"


def pieces() -> dict:
    p = spec.cell(spec.benchmark(), CELL)
    c, t = p["config"], p["traffic"]
    c["n_points"] = 3000
    c["patch"].update(res=0.4, sz=6, max_patches=128,
                      max_points_per_patch=64)
    c["ksvd"]["dict_size"] = 24
    c["rgb_ksvd"]["dict_size"] = 48
    t.update(pool=2, check_requests=2, profile_requests=1)
    return p


def run(traced=False, entry_class=None, seed=2 ** 31 + 7) -> dict:
    return runner.run_cell(pieces(), seed, 1.0, traced, CPU,
                           time.perf_counter(), entry_class=entry_class)


def test_sound_run_is_correct_and_reads_its_metrics():
    r = run(traced=True)
    assert r["correct"] is True, r["checks"]
    for name in ("front_end_ms.ksvd", "omp_ms.ksvd", "sweep_ms.ksvd",
                 "ksvd_reads_per_cloud", "kernels_per_cloud",
                 "idle_share.compress"):
        assert name in r["metrics"], name
    assert r["metrics"]["ksvd_reads_per_cloud"]["value"] >= 2


def test_control_is_not_correct():
    Control = runner.control_entry(spec.entry_class("ksvd_round_trip"),
                                   torch.bfloat16)
    r = run(entry_class=Control, seed=11)
    assert Control.compared == 2
    assert r["correct"] is False, r["checks"]


def _sweep_unchanged(monkeypatch):
    monkeypatch.setattr(pd, "_atom_sweep",
                        lambda D, code, *a, **k: (D, code, None))


def _half_the_patches(monkeypatch):
    from gp_compressor_tpu_torch.geometry import patches
    build = patches.build_raster_patches

    def half(*a, **k):
        r = build(*a, **k)
        return r._replace(n_leaves=r.n_leaves // 2)
    monkeypatch.setattr(patches, "build_raster_patches", half)


def _points_moved(monkeypatch):
    from gp_compressor_tpu_torch.workloads import ksvd_compressor
    decompress = ksvd_compressor.decompress

    def moved(*a, **k):
        world, *rest = decompress(*a, **k)
        return (world + 0.2, *rest)
    monkeypatch.setattr(ksvd_compressor, "decompress", moved)


FAULTS = {"sweep_unchanged": _sweep_unchanged,
          "half_the_patches": _half_the_patches,
          "points_moved": _points_moved}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run()
    assert r["correct"] is False, r["checks"]


# ---- the port against the reference, float64

def _configs(block: int):
    kw = dict(dict_size=40, words_max=4, proj_error=1e-3, stop_diff=1e-7,
              max_iters=6, power_iters=20, atom_block=block)
    return PortKSVD(**kw), rd.KSVDConfig(**kw)


def _problem():
    S, W, v = ksvd_case.problem(n=200, seed=3)
    return (torch.from_numpy(S), torch.from_numpy(W),
            torch.from_numpy(v))


def _draws(valid, cfg, seed=5):
    return pd.draw_ksvd(valid, cfg, torch.Generator().manual_seed(seed))


def _same_code(a, b):
    assert torch.equal(a.nw.long(), b.nw.long())
    use = torch.arange(a.X.shape[1])[None, :] < b.nw[:, None]
    assert torch.equal(torch.where(use, a.I.long(), 0),
                       torch.where(use, b.I.long(), 0))
    gap = (torch.where(use, a.X, 0.0) - torch.where(use, b.X, 0.0)).abs()
    assert float(gap.max()) <= 1e-9


@pytest.mark.parametrize("block", [1, 16])
def test_port_equals_reference_in_float64(block):
    """omp_encode, one _atom_sweep and a whole ksvd from the same draws."""
    S, W, valid = _problem()
    pc, rc = _configs(block)
    dr = _draws(valid, pc)
    D0 = rd.replace_unused(torch.zeros((S.shape[1], 40), dtype=S.dtype),
                           torch.zeros(40, dtype=torch.int64), S, dr.init)
    code = pd.omp_encode(D0, S, W, valid, pc)
    _same_code(code, rd.omp(D0, S, W, valid, rc))
    D1, code1, _ = pd._atom_sweep(D0, code, S, W, valid, pc)
    D1r, code1r = rd.update_atoms(D0, code, S, W, valid, rc)
    assert float((D1 - D1r).abs().max()) <= 1e-9
    _same_code(code1, code1r)
    p = pd.ksvd(S, W, valid, pc, draws=dr)
    r = rd.ksvd(S, W, valid, rc, dr.init, dr.sweeps)
    assert p.iters == r.iters >= 2
    assert float((p.D - r.D).abs().max()) <= 1e-9
    _same_code(p.code, r.code)
    assert abs(float(p.error) - float(r.error)) <= 1e-9
