"""Entry `map_stream`: the source's mapping loop, one sensor frame per
request, into one map that persists from request to request.

The sensor moves as the configuration's `trajectory` says: along a
horizontal circle about the vertical through the room's centre, at a
fixed height, heading along the circle, `step_m` and `step_deg` a frame,
so that the circle closes after `frames` frames. Frame k is pool cloud
k mod pool (a `room_cloud` draw in the room's coordinates) in the
camera's frame at pose k: x to the right, y down, z ahead. The map lives
in the camera frame of frame 0; the truth of frame k, T_0^-1 T_k, stays
in this entry and never reaches the program.

Set-up makes the pool and every frame on the host, calibrates the depth
hyperparameters once on frame 0 (`compressor.compress_decompress_
calibrated`, the configuration's `calibration`), makes the map
(`mapping.map_init` over the room's box in frame 0's coordinates, widened
by `box_margin`), inserts frame 0 unregistered and runs frames 1-3 as
requests run them. Request i then takes frame (i + 4) mod frames: it
copies the frame's points and colours to the card, calls
`mapping.add_cloud_fused` (register to the map, then insert, or drop a
frame whose registration reached the cap) and synchronises. It counts
the frame's points when the frame was inserted and none when it was
dropped. Requests that the run profiles continue the stream.

`correct` (harness/map_compare.py): the accumulated pose after every
frame against the truth, the share of frames dropped, the leaves the map
could not hold (the program's `patch_overflow`, summed over the frames),
and on `check_requests` frames drawn from the seed among the first
`check_among` requests, the first step's twist gradient and the insert,
each against the plain reference computed from the program's own map
before the frame, its scan and its poses. The program's gradient is the
one its timed registration of the frame computed in its first step
(`first_step_gradient`). Traced, each request's host ms
in the program's spans `map.register` and `map.insert`, and its counts
`reg.steps`, `reg.reads`, `reg.reclaims` and `map.dropped`, go to the
trace's counters; where the program has no such span or count, nothing
is recorded.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench.harness import configs, map_compare, traffic

SPANS = ("map.register", "map.insert")
COUNTS = ("reg.steps", "reg.reads", "reg.reclaims", "map.dropped")
WARM = 4                        # frame 0 and the warm-up frames 1-3


def camera(k: int, tr: dict):
    """Pose k of the trajectory: (R [3, 3] camera -> room, centre [3])."""
    step = math.radians(tr["step_deg"])
    r = tr["step_m"] / step
    th = k * step
    c = np.array([tr["center"][0] + r * math.cos(th),
                  tr["center"][1] + r * math.sin(th), tr["height"]])
    ahead = np.array([-math.sin(th), math.cos(th), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    return np.stack([np.cross(down, ahead), down, ahead], 1), c


def truth(k: int, tr: dict):
    """Frame k's pose in the map (frame 0's camera coordinates):
    (R, t), x_map = R x_camera + t."""
    R0, c0 = camera(0, tr)
    Rk, ck = camera(k, tr)
    return R0.T @ Rk, R0.T @ (ck - c0)


def to_camera(points: np.ndarray, k: int, tr: dict) -> np.ndarray:
    R, c = camera(k, tr)
    return ((points.astype(np.float64) - c) @ R).astype(np.float32)


def map_box(config: dict):
    """The room's box in frame 0's camera coordinates, widened by the
    configuration's margin: (lo [3], hi [3])."""
    room, tr = config["room"], config["trajectory"]
    R0, c0 = camera(0, tr)
    corners = np.array([[x, y, z] for x in room["x"] for y in room["y"]
                        for z in room["z"]])
    m = (corners - c0) @ R0
    return m.min(0) - config["box_margin"], m.max(0) + config["box_margin"]


@contextlib.contextmanager
def first_step_gradient(registration):
    """Within it, the program's registration keeps the twist gradient
    [6] of the first step it takes (its `_bank_step`'s first output) in
    the list this yields; a step adds one copy on the card and no read."""
    got = []
    step = registration._bank_step

    def keep(*a, **k):
        out = step(*a, **k)
        if not got:
            got.append(out[0].clone())
        return out
    registration._bank_step = keep
    try:
        yield got
    finally:
        registration._bank_step = step


def program_configs(mod, config: dict):
    """(CompressorConfig, MappingConfig, RegistrationConfig) of the
    program's config module."""
    return (configs.compressor_config(mod, config),
            mod.MappingConfig(**config["mapping"]),
            mod.RegistrationConfig(**config["registration"]))


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, \
            device
        self.trace = None
        self.kept = {}

    # ---- the program
    def setup(self):
        from gp_compressor_tpu_torch import config as pconf
        from gp_compressor_tpu_torch.utils import profiling
        from gp_compressor_tpu_torch.workloads import (compressor, mapping,
                                                       registration)
        self.mapping, self.profiling = mapping, profiling
        self.registration = registration
        # first, so that a program without these settings fails at once
        self.cfg, self.mcfg, self.rcfg = program_configs(pconf, self.config)
        tr = self.config["trajectory"]
        self.n_frames = int(tr["frames"])
        pool = traffic.make_pool(self.mix, self.config, self.seed)
        self.colors = [torch.from_numpy(c) for c in pool["colors"]]
        self.frames = [torch.from_numpy(to_camera(
            pool["points"][k % len(self.colors)], k, tr))
            for k in range(self.n_frames)]
        self.n = self.frames[0].shape[0]
        self.valid = torch.ones(self.n, dtype=torch.bool, device=self.device)
        rng = np.random.default_rng(traffic.item_seed(self.seed, 1 << 20))
        self.sample = set(int(i) for i in rng.choice(
            int(self.mix["check_among"]), int(self.mix["check_requests"]),
            replace=False))
        cal = self.config["calibration"]
        p0, c0 = self._frame(0)
        _, kp, s20, _ = compressor.compress_decompress_calibrated(
            p0, c0, self.valid, self.cfg, calib_patches=cal["patches"],
            calib_points=cal["points"], calib_steps=cal["steps"],
            calib_lr=cal["lr"], calib_starts=cal["starts"])
        self.calib = dict(
            depth_kp=kp, depth_s20=s20,
            depth_eps=self.cfg.depth_gp.eps_tol * kp.sigmaf_sq
            / self.cfg.depth_gp.sigmaf_sq)
        lo, hi = map_box(self.config)
        self.state = mapping.map_init(
            self.cfg, self.mcfg, lo, hi, pending_capacity=int(
                self.config["pending_capacity"]), device=self.device)
        self.poses, self.dropped, self.overflow = [], [], []
        for k in range(WARM):
            self._add(k)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _frame(self, k: int):
        return (self.frames[k].to(self.device),
                self.colors[k % len(self.colors)].to(self.device))

    def _add(self, k: int) -> bool:
        """Frame k into the map; whether the program dropped it. Keeps the
        insert's count of leaves past the map's rows (read at the check)."""
        p, c = self._frame(k)
        self.state, dropped, _, info = self.mapping.add_cloud_fused(
            self.state, p, c, self.valid, self.cfg, self.mcfg,
            rcfg=self.rcfg, **self.calib)
        self.overflow.append(info["patch_overflow"])
        return bool(dropped)

    def pool_index(self, i: int) -> int:
        """The frame that request i sends."""
        return (i + WARM) % self.n_frames

    def profile_order(self, first: int, n: int) -> list:
        """The stream goes on: the n requests from `first`."""
        return list(range(first, first + n))

    def request(self, i: int) -> int:
        k = self.pool_index(i)
        before = self.state
        traced = self.trace is not None
        if traced:
            counts0 = self.profiling.counters()
            self.profiling.take()
            self.profiling.tracing(True)
        kept = i in self.sample and i not in self.kept
        with (first_step_gradient(self.registration) if kept
              else contextlib.nullcontext([])) as grad:
            dropped = self._add(k)
        self._sync()
        if traced:
            self.profiling.tracing(False)
            self._record(counts0)
        self.poses.append((k, self.state.R_cloud, self.state.t_cloud))
        self.dropped.append(dropped)
        if kept:
            self.kept[i] = (k, before, ("program", self.state, dropped,
                                        grad[0] if grad else None))
        return 0 if dropped else self.n

    def _record(self, counts0: dict):
        spans = {}
        for r in self.profiling.take():
            if r.name in SPANS and r.end is not None:
                spans[r.name] = spans.get(r.name, 0.0) + r.end - r.start
        for name, s in spans.items():
            self.trace.counters[name].append(1e3 * s)
        counts = self.profiling.counters()
        for name in COUNTS:
            if name in counts:
                self.trace.counters[name].append(
                    float(counts[name] - counts0.get(name, 0)))

    def end_window(self):
        """Run on to the sampled requests that a short window did not
        reach, so that every run judges `check_requests` frames."""
        i = len(self.poses)
        while any(j not in self.kept for j in self.sample):
            self.request(i)
            i += 1

    # ---- the reference
    def _settings(self, dtype):
        from portbench.reference import config as rconf
        from portbench.reference.workloads import mapping_source as ms
        cfg = configs.compressor_config(rconf, self.config, dtype)
        p, mp = self.config["patch"], self.config["mapping"]
        return ms.Settings(
            res=p["res"], sz=p["sz"], min_nbr=mp["min_points_new_patch"],
            min_points_for_rotation=p["min_points_for_rotation"],
            bank=p["max_points_per_patch"], spill=mp["spill_bank"],
            depth_gp=cfg.depth_gp, rgb_gp=cfg.rgb_gp)

    def _scan_at(self, k: int, R, t, dtype):
        """Frame k's points at the pose (R, t), and its colours, in dtype
        (the rounding a lower precision makes of them)."""
        p, c = self._frame(k)
        pts = p @ R.T + t
        return pts.to(dtype).to(pts.dtype) if dtype is not None else pts, c

    def reference(self, k: int, dtype=None):
        """The reference's first-step gradient and insert for frame k from
        the program's current map, the insert at that map's own pose:
        (the map, ("reference", gradient [6], map after, pose), None).
        dtype: the control's precision: the scan, the map's floating values
        and the computation in it."""
        from portbench.reference.ops.kernels import RBFParams
        from portbench.reference.workloads import mapping_source as ms
        before = self.state
        R, t = before.R_cloud, before.t_cloud
        grad = self._reference_gradient(k, before, R, t, dtype)
        dt = dtype or torch.float32
        kp, s20, eps = (self.calib[n] for n in ("depth_kp", "depth_s20",
                                                "depth_eps"))
        pts, c = self._scan_at(k, R, t, dtype)
        m = map_compare.as_map(before, dtype)
        after = ms.insert(m, pts.to(dt), c.to(dt), self.valid,
                          self._settings(dtype),
                          RBFParams(kp.sigmaf_sq.to(dt), kp.l_sq.to(dt)),
                          s20.to(dt), eps.to(dt))
        return before, ("reference", grad, after, (R, t)), None

    def _reference_gradient(self, k, before, R, t, dtype=None):
        from portbench.reference.workloads import registration_source as rs
        s = self.config["mapping"]["reg_stride"]
        pts, _ = self._scan_at(k, R, t, dtype)
        dt = dtype or torch.float32
        m = map_compare.registration_map(
            map_compare.as_map(before, dtype), self.config["patch"]["res"],
            self.calib["depth_kp"], self.calib["depth_s20"])
        g, _ = rs.twist_gradient(pts[::s].to(dt), self.valid[::s], m,
                                 self.config["registration"]["bank_points"])
        return g

    def check(self, trace=None) -> dict:
        tr = self.config["trajectory"]
        worst_t = worst_r = 0.0
        for k, R, t in self.poses:
            e = map_compare.pose_error(R.double().cpu().numpy(),
                                       t.double().cpu().numpy(),
                                       *truth(k, tr))
            worst_t, worst_r = max(worst_t, e[0]), max(worst_r, e[1])
        out = {"trans_err_mm": worst_t, "rot_err_deg": worst_r,
               "drop_share": sum(self.dropped) / max(len(self.dropped), 1),
               "patch_overflow": float(sum(int(o) for o in self.overflow))}
        readings = []
        for _, (k, before, rec) in sorted(self.kept.items()):
            readings.append(self._compare(k, before, rec))
        self.kept = {}
        for r in readings:
            for name, v in r.items():
                if name not in out or v != v or (out[name] == out[name]
                                                 and v > out[name]):
                    out[name] = v
        return out

    def _compare(self, k, before, rec) -> dict:
        from portbench.reference.ops.kernels import RBFParams
        from portbench.reference.workloads import mapping_source as ms
        kp, s20, eps = (self.calib[n] for n in ("depth_kp", "depth_s20",
                                                "depth_eps"))
        if rec[0] == "program":
            _, after, dropped, grad = rec
            got = None if dropped else map_compare.as_map(after)
            R, t = after.R_cloud, after.t_cloud
        else:
            _, grad, got, (R, t) = rec
        R0, t0 = before.R_cloud, before.t_cloud
        out = {"grad_gap": math.inf if grad is None else map_compare.grad_gap(
            grad, self._reference_gradient(k, before, R0, t0))}
        if got is not None:
            pts, c = self._scan_at(k, R, t, None)
            m = map_compare.as_map(before)
            want = ms.insert(m, pts, c, self.valid, self._settings(None),
                             RBFParams(kp.sigmaf_sq, kp.l_sq), s20, eps)
            out.update(map_compare.insert(
                got, want, m, self.config["patch"]["res"], kp, s20,
                self.config["patch"]["sz"]))
        return out
