"""Entry `compress_decompress`: the production round trip, one cloud per
request.

A request copies its cloud from host memory to the card, runs
`compressor.compress_decompress` (front end, depth and RGB training,
sanitize, decompression on the sz x sz grid) and synchronises. Set-up
makes the pool, builds or loads the training kernel and runs every pool
cloud once. `correct` compares the outputs of `check_requests` requests
drawn from the seed among the window's first pool cycle with the
reference's round trip on the same clouds (harness/compare.py).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import compare, configs, roofline, traffic


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, \
            device
        self.trace = None
        self.kept = {}

    # ---- the program
    def setup(self):
        from gp_compressor_tpu_torch.workloads import compressor
        self.compressor = compressor
        self._prepare()
        self._warm_up()

    def _prepare(self):
        """The program's config, the pool on the host, the sample."""
        from gp_compressor_tpu_torch import config as pconf
        self.cfg = configs.compressor_config(pconf, self.config)
        pool = traffic.make_pool(self.mix, self.config, self.seed)
        self.host = [(torch.from_numpy(p), torch.from_numpy(c))
                     for p, c in zip(pool["points"], pool["colors"])]
        self.n = self.host[0][0].shape[0]
        self.valid = torch.ones(self.n, dtype=torch.bool, device=self.device)
        rng = np.random.default_rng(traffic.item_seed(self.seed, 1 << 20))
        self.sample = set(int(i) for i in rng.choice(
            len(self.host), int(self.mix["check_requests"]), replace=False))

    def _warm_up(self):
        for k in range(len(self.host)):          # every shape, once
            self._round_trip(k)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pool_index(self, i: int) -> int:
        return i % len(self.host)

    def profile_order(self, first: int, n: int) -> list:
        """The n requests from `first` on whose clouds the run checks (so
        that the roofline has their least time)."""
        out, i = [], first
        while len(out) < n:
            if self.pool_index(i) in self.sample:
                out.append(i)
            i += 1
        return out

    def _round_trip(self, k: int):
        pts, cols = self.host[k]
        p = pts.to(self.device)
        c = cols.to(self.device)
        return self.compressor.compress_decompress(p, c, self.valid,
                                                   self.cfg)

    def request(self, i: int) -> int:
        k = self.pool_index(i)
        comp, out = self._round_trip(k)
        self._sync()
        if i in self.sample and i not in self.kept:
            self.kept[i] = (k, comp, out)
        return self.n

    def end_window(self):
        self.compressor = None

    # ---- the reference
    def reference(self, k: int, gp_dtype=None, tally: bool = False):
        """The reference's round trip on pool cloud k: (comp, outputs,
        (depth tally, rgb tally) or None). gp_dtype: the control's
        precision: the cloud is rounded to it, and the banks, frames,
        training, sanitize and decompression are computed in it."""
        from portbench.reference import config as rconf
        from portbench.reference.cuda_kernels import sogp_train as rs
        from portbench.reference.models import sparse_gp as rsg
        from portbench.reference.workloads import compressor as rc

        cfg = configs.compressor_config(rconf, self.config, gp_dtype)
        pts, cols = (t.to(self.device) for t in self.host[k])
        if gp_dtype is not None:
            pts = pts.to(gp_dtype).to(pts.dtype)
        batch = rc.project(pts, cols, self.valid, cfg)
        if gp_dtype is not None:
            batch = batch._replace(**{
                f: getattr(batch, f).to(gp_dtype) for f in (
                    "rotations", "means", "rgb_means", "X", "y", "rgb")})
        dkp, ckp = rc.default_params(cfg, self.device)
        B = batch.mask.shape[0]
        tal = [torch.zeros((B, 5), dtype=torch.int64, device=self.device)
               for _ in range(2)] if tally else [None, None]
        d = rs.add_points_batch_plain(
            dkp, cfg.depth_gp, rsg.init_batch(cfg.depth_gp, B, self.device),
            batch.X, batch.y, batch.mask, tally=tal[0])
        c = rs.add_points_batch_plain(
            ckp, cfg.rgb_gp, rsg.init_batch(cfg.rgb_gp, B, self.device),
            batch.X, batch.rgb, batch.mask, tally=tal[1])
        d, c, _, _ = rc.sanitize(batch, cfg, d, c, dkp, ckp,
                                 cfg.depth_gp.s20)
        comp = rc.CompressedCloud(patch=batch, depth_gp=d, rgb_gp=c)
        return comp, rc.decompress(comp, cfg), (tal if tally else None)

    def bound_ms(self, comp, tal) -> float:
        """The least time of the request's two training launches."""
        B, P = comp.patch.mask.shape
        return sum(roofline.train_bound_ms(
            B, P, g["slots"], g["dout"], g["capacity"], comp.patch.mask,
            t)["ms"] for g, t in ((self.config["depth_gp"], tal[0]),
                                  (self.config["rgb_gp"], tal[1])))

    def compare(self, prog, prog_out, ref, ref_out) -> dict:
        return compare.round_trip(prog, prog_out, ref, ref_out,
                                  self.config["patch"]["res"])

    def check(self, trace=None) -> dict:
        readings = []
        for i, (k, comp, out) in sorted(self.kept.items()):
            rcomp, rout, tal = self.reference(k, tally=trace is not None)
            readings.append(self.compare(comp, out, rcomp, rout))
            if trace is not None:
                trace.bounds_ms["sogp_train"][k] = self.bound_ms(rcomp, tal)
            del rcomp, rout
        self.kept = {}
        return compare.worst(readings)
