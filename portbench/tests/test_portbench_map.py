"""The mapping stream's cell on the CPU, its trajectory and its checks.

The cell `map.stream` cut to a size a test can hold (4,000-point frames,
res 0.3, sz 10, 1,024 leaves where its first 30 frames make ~670, 16-slot
GPs at calibrated-style values, the calibration's ascent left out) under
the cell's limits, the pose's widened to this size: unbroken it is
correct; its control (the reference in bfloat16 in the program's place)
is not; nor is a run with the JAX package's 8-step bench registration,
with half the leaves (`portbench/map_fault.py`'s faults), or with an
insert that keeps the map as it was. The trajectory closes after 360
frames at 11 mm and 1.0 deg a frame, and the truth pose never reaches
the program.
"""

import math
import time

import numpy as np
import pytest
import torch

from portbench import map_fault
from portbench.entries import map_stream
from portbench.harness import runner, spec

CPU = torch.device("cpu")
CELL = "map.stream"
# seconds of window that reach ~14 frames at this size
WINDOW = 20.0


def pieces() -> dict:
    p = spec.cell(spec.benchmark(), CELL)
    c, t = p["config"], p["traffic"]
    c["n_points"] = 4000
    c["patch"].update(res=0.3, sz=10, max_patches=1024,
                      max_points_per_patch=32)
    c["depth_gp"].update(capacity=12, slots=16, sigmaf_sq=2e-3, l_sq=4e-3,
                         s20=3e-4, eps_tol=2e-4 * 2e-3 / 1e-2)
    c["rgb_gp"].update(capacity=12, slots=16)
    c["mapping"].update(spill_bank=8, min_points_new_patch=30,
                        max_ray_steps=16, carve_stride=4, reg_stride=2)
    c["registration"].update(bank_points=32)
    c["pending_capacity"] = 32
    c["calibration"].update(steps=1, lr=1e-6, starts=1)
    t.update(pool=4, check_requests=2, check_among=4, profile_requests=1)
    # a 4,000-point frame at res 0.3 holds the pose less tightly (4.0 mm,
    # 0.19 deg over a window) than the cell's frames (0.79 mm, 0.040 deg,
    # whose limits are 6 mm and 0.15 deg): here the pose is held to 12 mm
    # and 0.5 deg, which the 8-step setting still fails
    p["limits"].update(trans_err_mm=12, rot_err_deg=0.5)
    return p


def run(p=None, traced=False, entry_class=None, seed=2 ** 31 + 7,
        seconds=WINDOW) -> dict:
    return runner.run_cell(p or pieces(), seed, seconds, traced, CPU,
                           time.perf_counter(), entry_class=entry_class)


def test_trajectory_closes_after_360_frames():
    tr = pieces()["config"]["trajectory"]
    R0, c0 = map_stream.camera(0, tr)
    R, c = map_stream.camera(tr["frames"], tr)
    np.testing.assert_allclose(R, R0, atol=1e-12)
    np.testing.assert_allclose(c, c0, atol=1e-12)
    R, t = map_stream.truth(tr["frames"], tr)
    np.testing.assert_allclose(R, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(t, 0.0, atol=1e-12)
    for k in (0, 17, 359):
        (Ra, ca), (Rb, cb) = (map_stream.camera(j, tr) for j in (k, k + 1))
        # an 11 mm arc: its chord is 2 r sin(step / 2)
        assert abs(np.linalg.norm(cb - ca) - 0.011) < 1e-6
        angle = math.degrees(math.acos((np.trace(Ra.T @ Rb) - 1) / 2))
        assert abs(angle - 1.0) < 1e-9
        assert ca[2] == 1.0 and Ra[2, 2] == 0.0      # level, looking ahead


def test_sound_run_is_correct_and_reads_its_metrics():
    r = run(traced=True)
    assert r["correct"] is True, r["checks"]
    for name in ("register_ms.map", "insert_ms.map", "reg_steps_per_scan",
                 "kernels_per_cloud", "idle_share.compress"):
        assert name in r["metrics"], name
    assert r["metrics"]["reg_steps_per_scan"]["value"] > 10


def test_truth_never_reaches_the_program(monkeypatch):
    """The program's poses are the same when the entry's truth is wrong;
    only the check sees it, and fails; and every frame the program gets
    is the pool's cloud in that frame's camera coordinates."""
    from gp_compressor_tpu_torch.workloads import mapping
    seen = []
    add = mapping.add_cloud_fused

    def spy(state, points, *a, **k):
        seen.append(points.clone())
        return add(state, points, *a, **k)
    monkeypatch.setattr(mapping, "add_cloud_fused", spy)

    class Keep(map_stream.Entry):
        def check(self, trace=None):
            Keep.poses = [(k, R.clone(), t.clone()) for k, R, t in self.poses]
            return super().check(trace)

    p = pieces()
    r0 = run(p, entry_class=Keep, seconds=3.0)
    poses0, frames0 = Keep.poses, list(seen)
    monkeypatch.setattr(map_stream, "truth",
                        lambda k, tr: (np.eye(3), np.full(3, 0.5)))
    seen.clear()
    r1 = run(p, entry_class=Keep, seconds=3.0)
    assert r0["correct"] is True and r1["correct"] is False
    n = min(len(poses0), len(Keep.poses))
    assert n >= 2
    for (k0, R0, t0), (k1, R1, t1) in zip(poses0[:n], Keep.poses[:n]):
        assert k0 == k1 and torch.equal(R0, R1) and torch.equal(t0, t1)
    tr = p["config"]["trajectory"]
    from portbench.harness import traffic
    pool = traffic.make_pool(p["traffic"], p["config"], 2 ** 31 + 7)
    for k, pts in enumerate(frames0[:6]):
        want = map_stream.to_camera(pool["points"][k % 4], k, tr)
        assert np.array_equal(pts.numpy(), want)


def test_control_is_not_correct():
    Control = runner.control_entry(spec.entry_class("map_stream"),
                                   torch.bfloat16)
    r = run(entry_class=Control, seed=11, seconds=3.0)
    assert Control.compared == 2
    assert r["correct"] is False, r["checks"]


def _insert_keeps_the_map(p, monkeypatch):
    from gp_compressor_tpu_torch.workloads import mapping
    monkeypatch.setattr(mapping, "map_insert",
                        lambda state, *a, **k: (state, mapping._zero_info(
                            state.origin.device)))


@pytest.mark.parametrize("fault", ["eight_steps", "small_map",
                                   "insert_keeps_the_map"])
def test_fault_is_not_correct(fault, monkeypatch):
    p = pieces()
    if fault in map_fault.FAULTS:
        map_fault.FAULTS[fault](p)
    else:
        _insert_keeps_the_map(p, monkeypatch)
    r = run(p)
    assert r["correct"] is False, r["checks"]
    lim, c = p["limits"], r["checks"]
    if fault == "eight_steps":
        assert (c["trans_err_mm"][0] > lim["trans_err_mm"]
                or c["rot_err_deg"][0] > lim["rot_err_deg"]), c
    elif fault == "small_map":
        assert c["patch_overflow"][0] > lim["patch_overflow"], c


def test_kept_gradient_is_the_timed_registrations_first():
    """The gradient a checked request keeps is the one its own
    registration took in its first step: a one-step registration from the
    map before the frame, at the pose it started from, gives it bit for
    bit; and the program's registration is itself again afterwards."""
    import dataclasses

    from gp_compressor_tpu_torch.workloads import registration
    step = registration._bank_step
    p = pieces()
    e = map_stream.Entry(p["config"], p["traffic"], 2 ** 31 + 7, CPU)
    e.setup()
    e.sample = {0}
    e.request(0)
    assert registration._bank_step is step
    k, before, (_, _, _, grad) = e.kept[0]
    s = e.mcfg.reg_stride
    pts = e._frame(k)[0] @ before.R_cloud.T + before.t_cloud
    view, tables = e.mapping.registration_view(before, e.cfg)
    one = dataclasses.replace(e.rcfg, min_steps=0, max_steps=1)
    st, _ = registration.register(
        view, pts[::s], e._frame(k)[1][::s], e.valid[::s], e.cfg, one,
        depth_kp=e.calib["depth_kp"], depth_s20=e.calib["depth_s20"],
        tables=tables)
    assert torch.equal(grad, st.delta)
    assert float(torch.linalg.norm(grad)) > 0
