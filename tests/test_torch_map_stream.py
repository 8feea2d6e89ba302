"""The map.stream cell's trajectory at a small size on the CPU: under the
source's stop rule the port's registration holds the source's motion (11
mm and 1.0 deg a frame) over 12 frames, and the JAX package's 8-step
bench setting does not. Float64; the trajectory and the pose error are
the benchmark entry's (`portbench/entries/map_stream.py`,
`portbench/harness/map_compare.py`)."""

import dataclasses

import pytest
import torch

from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.ops.kernels import RBFParams
from gp_compressor_tpu_torch.testing import mapping_case as case
from gp_compressor_tpu_torch.utils import synthetic
from gp_compressor_tpu_torch.workloads import mapping as tmap
from portbench.entries import map_stream as entry
from portbench.harness import map_compare

torch.set_num_threads(1)


def _stream(rcfg, mcfg, frames=12):
    """The map.stream trajectory (11 mm and 1.0 deg a frame) at a small
    size: 4,000-point frames of the 3 m room at res 0.3, calibrated-style
    depth values, 1,024 leaves where the 13 frames make ~560, frame 0 inserted
    unregistered. Returns the largest pose error over frames 1..frames,
    (mm, degrees), and the leaves the map could not hold."""
    f64 = torch.float64
    base = case.compressor_config(tcfg, f64)
    cfg = tcfg.CompressorConfig(
        patch=tcfg.PatchConfig(res=0.3, sz=10, max_patches=1024,
                               max_points_per_patch=32,
                               approx_sphere_moments=True,
                               bank_order="center_out"),
        depth_gp=base.depth_gp, rgb_gp=base.rgb_gp)
    sf, l2, s20 = (torch.tensor(v, dtype=f64) for v in case.CAL)
    kw = dict(depth_kp=RBFParams(sf, l2), depth_s20=s20,
              depth_eps=base.depth_gp.eps_tol * sf / base.depth_gp.sigmaf_sq)
    tr = {"step_m": 0.011, "step_deg": 1.0, "center": [1.5, 1.5],
          "height": 1.0, "frames": 360}
    box = entry.map_box({"room": {"x": [0.0, 3.0], "y": [0.0, 3.0],
                                  "z": [-0.05, 2.45]},
                         "trajectory": tr, "box_margin": 0.3})
    st = tmap.map_init(cfg, mcfg, *box, dtype=torch.float64,
                       pending_capacity=32, device="cpu")
    pool = [synthetic.room_cloud(n=4000, seed=i) for i in range(4)]
    valid = torch.ones(4000, dtype=torch.bool)
    worst, lost = (0.0, 0.0), 0
    for k in range(frames + 1):
        w, col = pool[k % 4]
        st, _, _, info = tmap.add_cloud_fused(
            st, torch.from_numpy(entry.to_camera(w, k, tr)).double(),
            torch.from_numpy(col).double(),
            valid, cfg, mcfg, rcfg=rcfg, **kw)
        e = map_compare.pose_error(st.R_cloud.numpy(), st.t_cloud.numpy(),
                                   *entry.truth(k, tr))
        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        lost += int(info["patch_overflow"])
    return worst, lost


# the stream's bound at this size: the source's rule keeps within 3.3 mm
# and 0.17 deg over 12 frames (measured 3.24 mm, 0.161 deg), the 8-step
# setting drifts past 13 mm
STREAM_BOUND = (6.0, 0.25)


@pytest.mark.parametrize("rule", ["source", "eight_steps"])
def test_stream_at_the_source_motion(rule):
    """12 frames of the cell's trajectory: under the source's stop rule
    (more than 10 steps, the cap of 300 dropping the frame) the pose stays
    within STREAM_BOUND and no frame is dropped; the JAX package's bench
    setting (8 steps at most, 2 at least, no drop) leaves it."""
    mcfg = tcfg.MappingConfig(min_points_new_patch=30, max_ray_steps=16,
                              carve_stride=4, reg_stride=2, spill_bank=8,
                              exact_pose=True)
    if rule == "source":
        rcfg = tcfg.RegistrationConfig(step_mode="rprop", min_steps=10,
                                       max_steps=300, bank_points=32)
        err, lost = _stream(rcfg, mcfg)
        assert err[0] <= STREAM_BOUND[0] and err[1] <= STREAM_BOUND[1], err
        assert lost == 0
    else:
        rcfg = tcfg.RegistrationConfig(step_mode="rprop", min_steps=2,
                                       max_steps=8, bank_points=32)
        err, _ = _stream(rcfg, dataclasses.replace(mcfg,
                                                   drop_on_reg_cap=False))
        assert err[0] > STREAM_BOUND[0] or err[1] > STREAM_BOUND[1], err
