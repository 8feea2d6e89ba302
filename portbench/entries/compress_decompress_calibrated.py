"""Entry `compress_decompress_calibrated`: the calibrated round trip, one
cloud per request, warm-started.

Set-up runs a cold calibration on pool cloud 0 (`calibration`: Adam
steps, starts) and keeps its log hyperparameters as every request's warm
start, so that each request can be checked on its own. A request copies
its cloud to the card and runs `compressor.compress_decompress_calibrated`
(front end, the MAP ascent of the exact-GP marginal posterior over
(sigma_f^2, l^2, s20) on a bank subsample from the warm start, training
at the calibrated values, sanitize, decompression), then synchronises.

`correct`: the reference calibrates cold on cloud 0 itself, then runs the
calibrated round trip on the sampled requests' clouds from its own warm
start; the round trips are compared as in `compress_decompress`, and the
calibrated values by calib_gap, the widest gap of a log hyperparameter.
"""

from __future__ import annotations

import math

import torch

from portbench.entries import compress_decompress
from portbench.harness import compare, configs


class Entry(compress_decompress.Entry):

    def setup(self):
        from gp_compressor_tpu_torch.workloads import compressor
        self.compressor = compressor
        self.theta_init = None
        self._prepare()
        cold = self.mix["cold"]
        p0, c0 = (t.to(self.device) for t in self.host[0])
        _, kp, s20, _ = compressor.compress_decompress_calibrated(
            p0, c0, self.valid, self.cfg, calib_patches=cold["patches"],
            calib_points=cold["points"], calib_steps=cold["steps"],
            calib_lr=cold["lr"], calib_starts=cold["starts"])
        self.theta_init = torch.log(torch.stack([kp.sigmaf_sq, kp.l_sq,
                                                 s20]))
        self._warm_up()

    def _round_trip(self, k: int):
        pts, cols = self.host[k]
        p, c = pts.to(self.device), cols.to(self.device)
        w = self.mix["warm"]
        comp, kp, s20, out = self.compressor.compress_decompress_calibrated(
            p, c, self.valid, self.cfg, calib_patches=w["patches"],
            calib_points=w["points"], calib_steps=w["steps"],
            calib_lr=w["lr"], calib_starts=w["starts"],
            theta_init=self.theta_init)
        return (comp, (kp.sigmaf_sq, kp.l_sq, s20)), out

    # ---- the reference
    def _calibrate(self, batch, cfg, mix: dict, theta_init=None):
        from portbench.reference.inference import hmc as rh
        from portbench.reference.workloads import compressor as rc
        logpost, theta0 = rc._calib_logpost(batch, cfg, mix["patches"],
                                            mix["points"], torch.float32)
        theta, _ = rh.map_estimate_multi(
            logpost, theta0, steps=mix["steps"], lr=mix["lr"],
            n_starts=mix["starts"], theta_init=theta_init)
        return theta

    def reference(self, k: int, gp_dtype=None, tally: bool = False):
        """The reference's calibrated round trip on pool cloud k from its
        own cold calibration on cloud 0: ((comp, theta), outputs, tallies
        or None). gp_dtype: the control's precision (the cloud rounded to
        it; banks, training, sanitize and decompression in it; the
        calibration in float32 on the rounded cloud, as bfloat16 has no
        Cholesky factorisation on the card)."""
        from portbench.reference import config as rconf
        from portbench.reference.cuda_kernels import sogp_train as rs
        from portbench.reference.models import sparse_gp as rsg
        from portbench.reference.ops.kernels import RBFParams
        from portbench.reference.workloads import compressor as rc

        cfg = configs.compressor_config(rconf, self.config, gp_dtype)
        cfg32 = configs.compressor_config(rconf, self.config)

        def batch_of(j):
            pts, cols = (t.to(self.device) for t in self.host[j])
            if gp_dtype is not None:
                pts = pts.to(gp_dtype).to(pts.dtype)
            return rc.project(pts, cols, self.valid, cfg32)
        theta_init = self._calibrate(batch_of(0), cfg32, self.mix["cold"])
        batch = batch_of(k)
        theta = self._calibrate(batch, cfg32, self.mix["warm"], theta_init)
        if gp_dtype is not None:
            batch = batch._replace(**{
                f: getattr(batch, f).to(gp_dtype) for f in (
                    "rotations", "means", "rgb_means", "X", "y", "rgb")})
        dt = batch.X.dtype
        sf, l2, s20 = torch.exp(theta).to(dt).unbind()
        dkp = RBFParams(sigmaf_sq=sf, l_sq=l2)
        eps = cfg.depth_gp.eps_tol * sf / cfg.depth_gp.sigmaf_sq
        _, ckp = rc.default_params(cfg, self.device)
        B = batch.mask.shape[0]
        tal = [torch.zeros((B, 5), dtype=torch.int64, device=self.device)
               for _ in range(2)] if tally else [None, None]
        d = rs.add_points_batch_plain(
            dkp, cfg.depth_gp, rsg.init_batch(cfg.depth_gp, B, self.device),
            batch.X, batch.y, batch.mask, s20=s20, eps_tol=eps,
            tally=tal[0])
        c = rs.add_points_batch_plain(
            ckp, cfg.rgb_gp, rsg.init_batch(cfg.rgb_gp, B, self.device),
            batch.X, batch.rgb, batch.mask, tally=tal[1])
        d, c, _, _ = rc.sanitize(batch, cfg, d, c, dkp, ckp, s20,
                                 full_probes=True)
        comp = rc.CompressedCloud(patch=batch, depth_gp=d, rgb_gp=c)
        out = rc.decompress(comp, cfg, depth_kp=dkp, depth_s20=s20)
        return (comp, (sf, l2, s20)), out, (tal if tally else None)

    def compare(self, prog, prog_out, ref, ref_out) -> dict:
        (pcomp, ptheta), (rcomp, rtheta) = prog, ref
        out = compare.round_trip(pcomp, prog_out, rcomp, ref_out,
                                 self.config["patch"]["res"])
        out["calib_gap"] = max(
            abs(math.log(float(a) / float(b))) if float(a) > 0 < float(b)
            else math.inf for a, b in zip(ptheta, rtheta))
        return out

    def bound_ms(self, ref, tal) -> float:
        return super().bound_ms(ref[0], tal)
