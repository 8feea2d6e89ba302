"""Entry `ksvd_round_trip`: the dictionary codec's round trip, one cloud
per request.

A request copies its cloud from host memory to the card, runs
`ksvd_compressor.compress` (raster front end, depth K-SVD, colour K-SVD)
and `ksvd_compressor.decompress`, and synchronises. The data rows that
replace unused atoms are drawn once per pool cloud at set-up, on the
host, from the run's seed, and handed to the program and the reference
alike (a generator on the card draws another stream than one on the
host). Set-up makes the pool, finds each cloud's patch rows (the
program's raster) for its draws, and runs every pool cloud once.
`correct` judges the outputs of `check_requests` requests drawn from the
seed among the window's first pool cycle (harness/ksvd_compare.py); a
sampled cloud that a short window did not reach runs after it.
Traced, each request's count of the program's `ksvd.reads` goes to the
trace's counters.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import compare, configs, ksvd_compare, traffic

def program_config(mod, config: dict):
    """The program's CompressorConfig from the file's `patch`, `ksvd` and
    `rgb_ksvd` (the GPs, which this path never runs, at their
    defaults)."""
    return mod.CompressorConfig(patch=mod.PatchConfig(**config["patch"]),
                                ksvd=mod.KSVDConfig(**config["ksvd"]),
                                rgb_ksvd=mod.KSVDConfig(**config["rgb_ksvd"]))


def reference_config(config: dict):
    from portbench.reference import config as rconf
    from portbench.reference.models.dictionary import KSVDConfig
    from portbench.reference.workloads.ksvd_compressor import \
        KSVDCompressorConfig
    return KSVDCompressorConfig(patch=rconf.PatchConfig(**config["patch"]),
                                ksvd=KSVDConfig(**config["ksvd"]),
                                rgb_ksvd=KSVDConfig(**config["rgb_ksvd"]))


def draw_rows(valid: torch.Tensor, ksvd: dict, g: torch.Generator):
    """(init [K], sweeps [max_iters, K]): data rows drawn uniformly, with
    replacement, among the valid rows, on the host."""
    K, iters = ksvd["dict_size"], ksvd["max_iters"]
    idx = torch.multinomial(valid.to(torch.float32), (iters + 1) * K,
                            replacement=True, generator=g)
    return idx[:K], idx[K:].reshape(iters, K)


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
        from gp_compressor_tpu_torch.workloads import ksvd_compressor
        self.kc, self.profiling = ksvd_compressor, profiling
        self.cfg = program_config(pconf, self.config)
        pool = traffic.make_pool(self.mix, self.config, self.seed)
        self.host = [(torch.from_numpy(p), torch.from_numpy(c))
                     for p, c in zip(pool["points"], pool["colors"])]
        self.n = self.host[0][0].shape[0]
        self.valid = torch.ones(self.n, dtype=torch.bool, device=self.device)
        rng = np.random.default_rng(traffic.item_seed(self.seed, 1 << 20))
        self.sample = set(int(i) for i in rng.choice(
            len(self.host), int(self.mix["check_requests"]), replace=False))
        self._draw()
        for k in range(len(self.host)):          # every shape, once
            self._round_trip(k)
        self._sync()

    def _draw(self):
        """Per pool cloud, the depth and the colour K-SVD's rows: self.rows
        (device tensors for the reference) and self.draws (the program's
        KSVDDraws)."""
        from gp_compressor_tpu_torch.geometry import patches
        from gp_compressor_tpu_torch.models.dictionary import KSVDDraws
        B = self.config["patch"]["max_patches"]
        self.rows, self.draws = [], []
        for k, (pts, cols) in enumerate(self.host):
            n_leaves = int(patches.build_raster_patches(
                pts.to(self.device), cols.to(self.device), self.valid,
                self.cfg.patch).n_leaves)
            ok = torch.arange(B) < n_leaves
            g = torch.Generator().manual_seed(
                traffic.item_seed(self.seed, (1 << 21) + k))
            rows = [tuple(t.to(self.device) for t in draw_rows(v, c, g))
                    for v, c in ((ok, self.config["ksvd"]),
                                 (torch.cat([ok] * 3),
                                  self.config["rgb_ksvd"]))]
            self.rows.append(rows)
            self.draws.append(tuple(KSVDDraws(*r) for r in rows))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pool_index(self, i: int) -> int:
        return i % len(self.host)

    def profile_order(self, first: int, n: int) -> list:
        """The n requests from `first` on whose clouds the run checks."""
        out, i = [], first
        while len(out) < n:
            if self.pool_index(i) in self.sample:
                out.append(i)
            i += 1
        return out

    def _round_trip(self, k: int):
        pts, cols = self.host[k]
        comp = self.kc.compress(pts.to(self.device), cols.to(self.device),
                                self.valid, self.cfg, draws=self.draws[k])
        return comp, self.kc.decompress(comp)

    def request(self, i: int) -> int:
        k = self.pool_index(i)
        if self.trace is not None:
            before = self.profiling.counters().get("ksvd.reads", 0)
        comp, out = self._round_trip(k)
        self._sync()
        if self.trace is not None:
            self.trace.counters["ksvd.reads"].append(
                self.profiling.counters().get("ksvd.reads", 0) - before)
        if i in self.sample and i not in self.kept:
            self.kept[i] = (k, comp, out)
        return self.n

    def end_window(self):
        """Run the sampled clouds that the window closed before reaching
        (a short window), so that every run judges `check_requests`."""
        for i in sorted(self.sample):
            if i not in self.kept:
                self.request(i)
        self.kc = None

    # ---- the reference
    def reference(self, k: int, dtype=None):
        """The reference's round trip on pool cloud k: (compressed, the
        decompressed cloud, None). dtype: the control's precision: the
        cloud is rounded to it, and the raster, both K-SVDs and the
        decompression are computed in it."""
        from portbench.reference.workloads import ksvd_compressor as rk
        rcfg = reference_config(self.config)
        pts, cols = (t.to(self.device) for t in self.host[k])
        if dtype is not None:
            pts, cols = (t.to(dtype).to(t.dtype) for t in (pts, cols))
        comp = rk.compress(pts, cols, self.valid, rcfg, self.rows[k], dtype)
        p = self.config["patch"]
        return comp, rk.decompress(comp, p["sz"], p["res"]), None

    def compare(self, k: int, comp, out) -> dict:
        """The numbers of harness/ksvd_compare.py for one request."""
        from portbench.reference.models import dictionary as rd
        from portbench.reference.workloads import ksvd_compressor as rk
        rcfg = reference_config(self.config)
        p = self.config["patch"]
        pts, cols = (t.to(self.device) for t in self.host[k])
        prog = _as(comp, configs.dtype(self.config["dtype"]))
        nums = ksvd_compare.front_end(
            prog.raster, rk.raster(pts, cols, self.valid, rcfg.patch),
            p["res"])
        ok = rk.patch_rows(prog.raster)
        S3, W3 = rk.rgb_rows(prog.raster)
        enc, mse = [], []
        for S, W, v, res, kcfg in (
                (prog.raster.S, prog.raster.W, ok, prog.depth, rcfg.ksvd),
                (S3, W3, torch.cat([ok] * 3), prog.rgb, rcfg.rgb_ksvd)):
            W = W.to(S.dtype)
            enc.append(ksvd_compare.encoding(
                res.code, rd.omp(res.D, S, W, v, kcfg), v))
            mse.append(ksvd_compare.mse_gap(
                res.error, rd.masked_error(res.D, res.code, S, W, v)))
        nums["coef_gap"] = ksvd_compare.largest(e["coef_gap"] for e in enc)
        nums["mse_gap"] = ksvd_compare.largest(mse)
        nums["omp_differ"] = sum(e["differ"] for e in enc) \
            / max(sum(e["rows"] for e in enc), 1)
        nums["nonfinite_rows"] = sum(e["nonfinite"] for e in enc)
        own = rk.compress(pts, cols, self.valid, rcfg, self.rows[k])
        got, want = rk.rms_errors(prog, cols), rk.rms_errors(own, cols)
        nums["rms_excess_depth"] = ksvd_compare.rms_excess(got[0], want[0])
        nums["rms_excess_color"] = ksvd_compare.rms_excess(got[1], want[1])
        nums.update(ksvd_compare.decode(
            out, rk.decompress(prog, p["sz"], p["res"])))
        return nums

    def check(self, trace=None) -> dict:
        readings = [self.compare(k, comp, out)
                    for _, (k, comp, out) in sorted(self.kept.items())]
        self.kept = {}
        return compare.worst(readings)


def _as(comp, dt: torch.dtype):
    """A compressed cloud (the program's, or the control's) as the
    reference's record, its floating tensors in dt."""
    from portbench.reference.models import dictionary as rd
    from portbench.reference.workloads import ksvd_compressor as rk
    r = comp.raster
    raster = rk.Raster(**{f: getattr(r, f).to(dt)
                          if getattr(r, f).is_floating_point()
                          else getattr(r, f) for f in rk.Raster._fields})

    def res(x):
        return rd.KSVDResult(D=x.D.to(dt), code=rd.Code(
            X=x.code.X.to(dt), I=x.code.I, nw=x.code.nw),
            error=x.error.to(dt), iters=x.iters)

    return rk.KSVDCompressed(raster=raster, depth=res(comp.depth),
                             rgb=res(comp.rgb))
