"""One rank of the port's multi-process checks on the CPU (gloo).

    python -m gp_compressor_tpu_torch.testing.dist_worker cases OUTDIR \
        INIT_METHOD RANK WORLD_SIZE
    python -m gp_compressor_tpu_torch.testing.dist_worker cluster OUTDIR

`cases` joins the group from its arguments and runs the sharded entry
points on (2, 2) and (4, 1) meshes of 4 ranks against the same calls
without a mesh: the mesh layout, the all-to-all route, training, the
global RMSE, chain-sharded HMC and MAP, the point-sharded front end (each
rank projects its block of the cloud), the round trip (float32, and float64 beside JAX's),
registration, the calibrated round trip and the shard report. Where
OUTDIR holds `jax.npz` (the JAX package's runs on its 8-device CPU mesh,
written by tests/test_torch_parallel.py), it also runs the port's
sharded decompress, RMSE and register on JAX's states.
`cluster` joins through `initialize()` from torchrun's environment
variables and runs a sharded train-and-predict step whose RMSE reduction
crosses the processes (the port of tests/distributed_worker.py).

Each rank prints one JSON line of results; rank 0 also writes the
gathered arrays to OUTDIR/arrays.npz. Imports no JAX. `run_ranks` starts
the ranks of a check (here, and chip_smoke.py's phase 13 on the card).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.cuda_kernels import sogp_train
from gp_compressor_tpu_torch.geometry import patches, transforms
from gp_compressor_tpu_torch.inference import hmc
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.models import sparse_gp
from gp_compressor_tpu_torch.ops.kernels import RBFParams
from gp_compressor_tpu_torch.parallel import distributed
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib
from gp_compressor_tpu_torch.parallel.shard_report import shard_report
from gp_compressor_tpu_torch.utils import synthetic
from gp_compressor_tpu_torch.workloads import compressor, registration

F64 = torch.float64
T = torch.from_numpy


def pipe_config(max_patches: int = 128, bank_order: str = "center_out",
                approx: bool = True, dtype=torch.float32):
    """tests/test_parallel.py's PIPE_CFG (__graft_entry__.dryrun_multichip
    takes it with 16 patches per data rank); the other bank orders, exact
    sphere moments and float64 GPs for the front-end and float64 cases."""
    return tcfg.CompressorConfig(
        patch=tcfg.PatchConfig(res=0.5, sz=8, max_patches=max_patches,
                               max_points_per_patch=128,
                               approx_sphere_moments=approx,
                               bank_order=bank_order),
        depth_gp=tcfg.GPConfig(capacity=20, slots=32, eps_tol=2.0,
                               dtype=dtype),
        rgb_gp=tcfg.rgb_gp_config(slots=32, capacity=20, dtype=dtype))


def train_case(B: int, n: int, seed: int):
    """tests/test_parallel.py's training inputs: float64, 16 slots,
    capacity 10, the reference constants."""
    r = np.random.default_rng(seed)
    X = T(r.uniform(-5, 5, size=(B, n, 2)))
    Y = T(r.normal(size=(B, n, 1)))
    cfg = tcfg.GPConfig(capacity=10, slots=16, dtype=F64)
    kp = RBFParams(torch.tensor(100.0, dtype=F64),
                   torch.tensor(1.0, dtype=F64))
    return cfg, kp, X, Y, torch.ones((B, n), dtype=torch.bool)


def train(cfg, kp, X, Y, mask):
    """The training wrapper (the plain version on CPU tensors)."""
    init = sparse_gp.init_batch(cfg, X.shape[0], device=X.device)
    return sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, mask)


def max_diff(a, b) -> float:
    """Largest |a - b| over the leaves (0 for equal integer leaves; inf
    where a shape differs or one side is non-finite and the other not)."""
    out = 0.0
    for u, v in zip(a, b):
        if u.shape != v.shape or not torch.equal(torch.isfinite(u.double()),
                                                  torch.isfinite(v.double())):
            return float("inf")
        ok = torch.isfinite(u.double())
        if ok.any():
            out = max(out, float((u.double() - v.double())[ok].abs().max()))
    return out


def equal(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def nest(flat: dict) -> dict:
    """{'a.b': x} -> {'a': {'b': x}}."""
    out: dict = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split(".")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def case_layout(meshes) -> dict:
    res = {}
    for name, m in meshes.items():
        dg, cg = mesh_lib.data_group(m), mesh_lib.chain_group(m)
        res[name] = {
            "ranks": m.mesh.tolist(),
            "coordinate": [mesh_lib.axis_index(m, "data"),
                           mesh_lib.axis_index(m, "chain")],
            "group_rank": [dist.get_rank(dg), dist.get_rank(cg)],
            "data_group": dist.get_process_group_ranks(dg),
            "chain_group": dist.get_process_group_ranks(cg),
            "patch_rows_16": [mesh_lib.patch_rows(16, m).start,
                              mesh_lib.patch_rows(16, m).stop],
        }
    sl = {n: distributed.process_local_slice(n)
          for n in (0, 1, 3, 4, 7, 10, 17, 2048)}
    res["process_local_slice"] = {n: [s.start, s.stop] for n, s in sl.items()}
    errors = []
    for fn in (lambda: mesh_lib.make_mesh(tcfg.MeshConfig(data_size=3),
                                          "cpu"),
               lambda: mesh_lib.patch_rows(6, meshes["4x1"])):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    res["errors"] = errors
    return res


def route_rows(rank: int, k: int):
    """Rank `rank`'s rows for case_route: mixed dtypes and shapes, a
    destination in [0, k) per row; rank 1 sends nothing."""
    g = torch.Generator().manual_seed(rank)
    n = 0 if rank == 1 else 5 + 3 * rank
    rows = (torch.randn(n, 3, generator=g),
            torch.randn(n, generator=g, dtype=F64),
            torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                          dtype=torch.int32),
            torch.rand(n, 2, generator=g) > 0.5)
    return rows, torch.randint(0, k, (n,), generator=g)


def case_route(meshes) -> dict:
    """all_to_all_rows against the rows every source sends this rank, in
    source coordinate order and each source's row order."""
    res = {}
    for name, m in meshes.items():
        k, i = mesh_lib.axis_size(m, "data"), mesh_lib.axis_index(m, "data")
        group = dist.get_process_group_ranks(mesh_lib.data_group(m))
        got = mesh_lib.all_to_all_rows(*route_rows(dist.get_rank(), k), m)
        want = [[] for _ in got]
        for src in group:
            rows, dest = route_rows(src, k)
            for w, t in zip(want, rows):
                w.append(t[dest == i])
        res[name] = {"received": int(got[0].shape[0]),
                     "equal": all(a.dtype == b.dtype and torch.equal(a, b)
                                  for a, b in zip(got, (torch.cat(w)
                                                        for w in want)))}
    return res


def case_train(meshes, arrays) -> dict:
    cfg, kp, X, Y, M = train_case(16, 30, 0)
    whole = train(cfg, kp, X, Y, M)
    res = {}
    for name, m in meshes.items():
        Xs, Ys, Ms = mesh_lib.shard_patch_batch((X, Y, M), m)
        out = mesh_lib.gather_leading(train(cfg, kp, Xs, Ys, Ms), m, 16)
        res[name] = {"local_rows": int(Xs.shape[0]),
                     "max_diff": max_diff(out, whole),
                     "equal": equal(out, whole)}
        arrays.update({f"train.{name}.{k}": v for k, v in
                       out._asdict().items()})
    return res


def case_rmse(meshes, arrays) -> dict:
    cfg, kp, X, Y, M = train_case(24, 20, 1)
    ccfg = tcfg.CompressorConfig(depth_gp=cfg)
    empty = patches.PatchBatch(*([None] * len(patches.PatchBatch._fields)))

    def rmse(X, Y, M, mesh=None):
        comp = compressor.CompressedCloud(
            empty._replace(X=X, y=Y, mask=M), train(cfg, kp, X, Y, M), None)
        return float(compressor.reconstruction_rmse(
            comp, ccfg, depth_kp=kp, depth_s20=0.1, mesh=mesh))

    single = rmse(X, Y, M)
    res = {"single": single}
    for name, m in meshes.items():
        res[name] = rmse(*mesh_lib.shard_patch_batch((X, Y, M), m), mesh=m)
    return res


def patch_logpost():
    """A small patch bank's exact-GP log posterior, float64."""
    r = np.random.default_rng(4)
    X = T(r.uniform(-0.2, 0.2, size=(4, 12, 2)))
    y = T(0.05 * np.sin(8 * X[..., 0].numpy()) + 0.01 * r.normal(size=(4, 12)))
    mask = torch.ones((4, 12), dtype=F64)
    mask[1, 9:] = 0.0
    return hmc.make_patch_logpost(X, y, mask)


def case_chains(meshes) -> dict:
    """HMC chains and MAP starts over `chain`: the same draws, the same
    results as the single run."""
    res = {}
    runs = {
        "quadratic": (lambda th: -0.5 * torch.sum(th ** 2, dim=-1),
                      torch.zeros((4, 3), dtype=F64),
                      tcfg.HMCConfig(num_warmup=50, num_samples=50), 16),
        "patch_logpost": (patch_logpost(),
                          torch.tensor([[-3.0, -3.0, -2.0]], dtype=F64)
                          + 0.2 * torch.arange(4, dtype=F64)[:, None],
                          tcfg.HMCConfig(num_warmup=15, num_samples=15), 8),
    }
    for case, (lp, th0, cfg, nl) in runs.items():
        gen = lambda: torch.Generator().manual_seed(3)
        single = hmc.hmc_sample_chains(lp, th0, cfg, nl, generator=gen())
        res[case] = {}
        for name, m in meshes.items():
            out = hmc.hmc_sample_chains(lp, th0, cfg, nl, generator=gen(),
                                        mesh=m)
            res[case][name] = {"equal": equal(out, single),
                               "max_diff": max_diff(out, single),
                               "shape": list(out[0].shape)}
    lp = patch_logpost()
    th0 = torch.tensor([np.log(100.0), 0.0, np.log(0.1)], dtype=F64)
    single = hmc.map_estimate_multi(lp, th0, steps=30)
    res["map"] = {}
    for name, m in meshes.items():
        out = hmc.map_estimate_multi(lp, th0, steps=30, mesh=m)
        res["map"][name] = {"equal": equal(out, single),
                            "max_diff": max_diff(out, single)}
    return res


def cloud(n: int, seed: int, dtype=torch.float32):
    pts, cols = synthetic.room_cloud(n=n, seed=seed)
    return (T(pts).to(dtype), T(cols).to(dtype),
            torch.ones(n, dtype=torch.bool))


def gathered_out(out, mesh, B: int, G: int):
    """The decompress outputs of every rank, whole."""
    return (mesh_lib.gather_leading(out[:3], mesh, B * G)
            + mesh_lib.gather_leading(out[3:], mesh, B))


# not a multiple of 2 or 4: every mesh's last block ends in padding rows
# (zeros, invalid), which the cloud, moved by FRONT_END_SHIFT, does not
# reach: a padding row that counted would move the grid's bounds
FRONT_END_POINTS = 4999
FRONT_END_SHIFT = 5.0
FRONT_END_VARIANTS = {"center_out": dict(bank_order="center_out"),
                      "shuffle": dict(bank_order="shuffle"),
                      "native_exact": dict(bank_order="native",
                                           approx=False)}
FLOAT_LEAVES = ("rotations", "means", "rgb_means", "X", "y", "rgb")


def banked_ids(batch) -> torch.Tensor:
    """[B, P] cloud row in each bank slot (-1 where empty) of a batch
    projected with each point's row index as its first colour: the colour
    bank holds the index less the patch's mean colour."""
    ids = torch.round(batch.rgb[..., 0] + batch.rgb_means[:, None, 0])
    return torch.where(batch.mask, ids.to(torch.int64), -1)


def case_front_end(meshes) -> dict:
    """compressor.project on each rank's block of a cloud whose size the
    ranks do not divide, gathered, against project on the whole cloud:
    the grid, claims, counts, W and mask exactly, the banked cloud rows
    (a second projection with row indices as colours), and the float
    leaves' largest differences and rows that differ at all."""
    n = FRONT_END_POINTS
    pts, cols, valid = cloud(n, 3)
    pts = pts + FRONT_END_SHIFT
    ids = torch.zeros_like(cols)
    ids[:, 0] = torch.arange(n, dtype=cols.dtype)
    res = {}
    for variant, kw in FRONT_END_VARIANTS.items():
        cfg = pipe_config(**kw)
        gen = lambda: torch.Generator().manual_seed(11)
        single = compressor.project(pts, cols, valid, cfg, generator=gen())
        single_ids = banked_ids(compressor.project(pts, ids, valid, cfg,
                                                   generator=gen()))
        res[variant] = {}
        for name, m in meshes.items():
            blk = compressor.shard_points(pts, cols, valid, m)
            local = compressor.project(*blk, cfg, generator=gen(), mesh=m)
            got = compressor.gather_batch(local, m, n_points=n)
            got_ids = banked_ids(compressor.gather_batch(compressor.project(
                *compressor.shard_points(pts, ids, valid, m), cfg,
                generator=gen(), mesh=m), m))
            differ = torch.zeros(cfg.patch.max_patches, dtype=torch.bool)
            for k in FLOAT_LEAVES:
                a, b = getattr(got, k), getattr(single, k)
                differ |= (a != b).reshape(a.shape[0], -1).any(1)
            res[variant][name] = {
                "local_rows": int(local.mask.shape[0]),
                "claim_rows": int(local.claims.shape[0]),
                "pad_rows": int((~blk[2]).sum()),
                "pad_claims_unclaimed": bool((local.claims[~blk[2]]
                                              == -1).all()),
                "grid_equal": all(
                    torch.equal(a, b) for a, b in zip(local.grid,
                                                      single.grid)
                    if a is not None),
                "n_leaves": int(local.n_leaves),
                "claims_differ": int((got.claims != single.claims).sum()),
                **{f"{k}_equal": torch.equal(getattr(got, k),
                                             getattr(single, k))
                   for k in ("W", "mask", "counts")},
                "ids_equal": torch.equal(got_ids, single_ids),
                "banked": int(single.mask.sum()),
                "max_diff": {k: max_diff([getattr(got, k)],
                                         [getattr(single, k)])
                             for k in FLOAT_LEAVES},
                "rows_differ": int(differ.sum()),
            }
    return res


def case_round_trip(meshes, jax_runs, arrays) -> dict:
    cfg = pipe_config()
    B, G = cfg.patch.max_patches, cfg.patch.sz ** 2
    pts, cols, valid = cloud(5000, 3)
    comp1, out1 = compressor.compress_decompress(pts, cols, valid, cfg)
    rmse1 = float(compressor.reconstruction_rmse(comp1, cfg))
    res = {"single_rmse": rmse1}
    for name, m in meshes.items():
        comp, out = compressor.compress_decompress(
            *compressor.shard_points(pts, cols, valid, m), cfg, mesh=m)
        rmse = float(compressor.reconstruction_rmse(comp, cfg, mesh=m))
        whole = compressor.gather_cloud(comp, m, n_points=5000)
        out = gathered_out(out, m, B, G)
        res[name] = {
            "local_rows": int(comp.patch.mask.shape[0]),
            "claim_rows": int(comp.patch.claims.shape[0]),
            "claims_equal": torch.equal(whole.patch.claims,
                                        comp1.patch.claims),
            "n_leaves_equal": int(whole.patch.n_leaves)
            == int(comp1.patch.n_leaves),
            "mask_equal": torch.equal(whole.patch.mask, comp1.patch.mask),
            "valid_equal": torch.equal(out[2], out1[2])
            and torch.equal(out[5], out1[5]),
            "banks_equal": all(torch.equal(getattr(whole.patch, k),
                                           getattr(comp1.patch, k))
                               for k in compressor.BANK_LEAVES),
            "states_max_diff": max_diff(whole.depth_gp + whole.rgb_gp,
                                        comp1.depth_gp + comp1.rgb_gp),
            "out_max_diff": max_diff(out[:2] + out[3:5],
                                     out1[:2] + out1[3:5]),
            "rmse": rmse,
        }
        arrays.update({f"round_trip.{name}.claims": whole.patch.claims,
                       f"round_trip.{name}.mask": whole.patch.mask,
                       f"round_trip.{name}.valid": out[2]})
    if jax_runs is not None:
        # JAX's mesh-trained states through the port's sharded decompress
        m = meshes["2x2"]
        jcomp = compressor.shard_cloud(convert.compressed_from_numpy(
            jax_runs["round_trip"]["comp"], device="cpu"), m)
        out = gathered_out(compressor.decompress(jcomp, cfg, mesh=m), m, B, G)
        res["jax_state_rmse"] = float(compressor.reconstruction_rmse(
            jcomp, cfg, mesh=m))
        arrays.update({"round_trip.jax_state.world": out[0],
                       "round_trip.jax_state.colors": out[1],
                       "round_trip.jax_state.valid": out[2]})
    return res


def case_round_trip64(meshes) -> dict:
    """The round trip at PIPE_CFG with a float64 cloud and float64 GPs,
    where training is reproducible across packages: the RMSE of the
    single process and of each mesh (JAX's 8-device run is beside it in
    jax.npz)."""
    cfg = pipe_config(dtype=F64)
    pts, cols, valid = cloud(5000, 3, F64)
    comp = compressor.compress(pts, cols, valid, cfg)
    res = {"single": float(compressor.reconstruction_rmse(comp, cfg))}
    for name, m in meshes.items():
        comp = compressor.compress(
            *compressor.shard_points(pts, cols, valid, m), cfg, mesh=m)
        res[name] = float(compressor.reconstruction_rmse(comp, cfg, mesh=m))
    return res


REG_W = (0.004, -0.003, 0.002)
REG_T = (0.008, -0.006, 0.004)


def moved(pts):
    """tests/test_parallel.py's small rigid perturbation of the cloud."""
    w = torch.tensor(REG_W, dtype=pts.dtype)
    return transforms.apply(pts, transforms.euler_xyz(w),
                            torch.tensor(REG_T, dtype=pts.dtype))


def reg_summary(st) -> dict:
    return {"steps": int(st.step_nbr), "R": st.R_cloud.tolist(),
            "t": st.t_cloud.tolist(), "delta": st.delta.tolist()}


def case_register(meshes, jax_runs) -> dict:
    cfg = pipe_config()
    rcfg = tcfg.RegistrationConfig(max_steps=8, min_steps=2, reclaim_every=2,
                                   step_mode="rprop")
    pts, cols, valid = cloud(4000, 5)
    scan = moved(pts)
    comp = compressor.compress(pts, cols, valid, cfg)
    st1, pts1 = registration.register(comp, scan, cols, valid, cfg, rcfg)
    res = {"single": reg_summary(st1)}
    for name, m in meshes.items():
        st, out = registration.register(compressor.shard_cloud(comp, m),
                                        scan, cols, valid, cfg, rcfg, mesh=m)
        res[name] = reg_summary(st)
        res[name]["points_max_diff"] = float((out - pts1).abs().max())
    if jax_runs is not None:
        j = jax_runs["register"]
        jcomp = convert.compressed_from_numpy(j["comp"], device="cpu")
        m = meshes["2x2"]
        st, _ = registration.register(
            compressor.shard_cloud(jcomp, m), T(j["scan"]), cols, valid,
            cfg, rcfg, mesh=m)
        res["jax_map"] = reg_summary(st)
    return res


def case_calibrated(meshes, jax_runs) -> dict:
    """__graft_entry__.dryrun_multichip's configuration on the 2 x 2 mesh,
    the MAP in float64 as under JAX's x64."""
    m = meshes["2x2"]
    cfg = pipe_config(16 * mesh_lib.axis_size(m, "data"))
    kw = dict(calib_patches=8, calib_points=32, calib_steps=25,
              calib_starts=4, calib_dtype=F64)
    rcfg = tcfg.RegistrationConfig(max_steps=8, min_steps=2, reclaim_every=2,
                                   step_mode="rprop")
    pts, cols, valid = cloud(6000, 3)
    scan = moved(pts)

    def run(mesh=None):
        blk = (pts, cols, valid) if mesh is None else \
            compressor.shard_points(pts, cols, valid, mesh)
        comp, kp, s20, _ = compressor.compress_decompress_calibrated(
            *blk, cfg, mesh=mesh, **kw)
        rmse = float(compressor.reconstruction_rmse(
            comp, cfg, depth_kp=kp, depth_s20=s20, mesh=mesh))
        st, _ = registration.register(comp, scan, cols, valid, cfg, rcfg,
                                      depth_kp=kp, mesh=mesh)
        theta = [float(kp.sigmaf_sq), float(kp.l_sq), float(s20)]
        return {"theta": theta, "rmse": rmse, **reg_summary(st)}

    res = {"single": run(), "2x2": run(m)}
    if jax_runs is not None:
        j = jax_runs["calibrated"]
        jcomp = compressor.shard_cloud(
            convert.compressed_from_numpy(j["comp"], device="cpu"), m)
        jkp = RBFParams(*torch.tensor(j["kp"]).unbind())
        st, _ = registration.register(jcomp, scan, cols, valid, cfg, rcfg,
                                      depth_kp=jkp, mesh=m)
        res["jax_state"] = {"rmse": float(compressor.reconstruction_rmse(
            jcomp, cfg, depth_kp=jkp, depth_s20=torch.tensor(j["s20"]),
            mesh=m)),
            **reg_summary(st)}
    return res


def load_jax(outdir: Path):
    path = outdir / "jax.npz"
    if not path.exists():
        return None
    with np.load(path) as z:
        return nest({k: z[k] for k in z.files})


def scenario_cases(outdir: Path, init_method: str, rank: int,
                   world: int) -> dict:
    distributed.initialize(init_method, world, rank, device_type="cpu")
    meshes = {"2x2": mesh_lib.make_mesh(tcfg.MeshConfig(chain_size=2), "cpu"),
              "4x1": mesh_lib.make_mesh(tcfg.MeshConfig(), "cpu")}
    jax_runs = load_jax(outdir)
    arrays: dict = {}
    res = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    res["layout"] = case_layout(meshes)
    res["route"] = case_route(meshes)
    res["train"] = case_train(meshes, arrays)
    res["rmse"] = case_rmse(meshes, arrays)
    res["chains"] = case_chains(meshes)
    res["front_end"] = case_front_end(meshes)
    res["round_trip"] = case_round_trip(meshes, jax_runs, arrays)
    res["round_trip64"] = case_round_trip64(meshes)
    res["register"] = case_register(meshes, jax_runs)
    res["calibrated"] = case_calibrated(meshes, jax_runs)
    res["shard_report"] = shard_report(
        pipe_config(), 5000, meshes["2x2"],
        rcfg=tcfg.RegistrationConfig(max_steps=6, min_steps=2,
                                     step_mode="rprop"), seed=3)
    if res["rank"] == 0:
        np.savez(outdir / "arrays.npz",
                 **{k: v.numpy() for k, v in arrays.items()})
    return res


def graft_example(B: int, Pn: int, G: int, seed: int, res: float = 0.15,
                  depth_amp: float = 0.03, noise_sd: float = 0.005):
    """__graft_entry__._example's patch banks (numpy, float32)."""
    r = np.random.default_rng(seed)
    half = res / 2.0
    uv = r.uniform(-half, half, size=(B, Pn, 2))
    a = r.normal(size=(B, 3)) * depth_amp / half
    depth = (a[:, None, 0] * uv[..., 0] + a[:, None, 1] * uv[..., 1]
             + a[:, None, 2] * (uv[..., 0] ** 2 - uv[..., 1] ** 2) / half
             + noise_sd * r.normal(size=(B, Pn)))
    X = T(uv.astype(np.float32))
    Y = T(depth[..., None].astype(np.float32))
    Xs = T(r.uniform(-half, half, size=(B, G, 2)).astype(np.float32))
    return X, Y, torch.ones((B, Pn), dtype=torch.bool), Xs


def scenario_cluster() -> dict:
    """tests/distributed_worker.py's step: B = 16 patches per rank, trained
    on this rank's rows, its RMSE and sums reduced across the processes,
    against the same step on the whole bank in this process."""
    distributed.initialize(device_type="cpu")
    world = dist.get_world_size()
    mesh = distributed.global_mesh(tcfg.MeshConfig(), "cpu")
    cfg = tcfg.GPConfig(capacity=50, slots=64, dout=1, eps_tol=2.0)
    kp = RBFParams(torch.tensor(100.0), torch.tensor(1.0))
    B = 16 * world
    X, Y, mask, Xs = graft_example(B, 24, 32, 3)

    def step(X, Y, mask, Xs, mesh=None):
        st = train(cfg, kp, X, Y, mask)
        mean, var = sparse_gp.predict_batch(kp, cfg.s20, st, Xs)
        tmean, _ = sparse_gp.predict_batch(kp, cfg.s20, st, X)
        err2 = torch.sum(torch.where(mask, (tmean[..., 0] - Y[..., 0]) ** 2,
                                     0.0))
        sums = torch.stack([err2, torch.sum(mask).float(), torch.sum(mean),
                            torch.sum(var)])
        if mesh is not None:
            sums = mesh_lib.all_reduce_sum(sums, mesh)
        return (float(torch.sqrt(sums[0] / torch.clamp(sums[1], min=1))),
                float(sums[2]), float(sums[3]))

    sl = distributed.process_local_slice(B)
    dist_out = step(X[sl], Y[sl], mask[sl], Xs[sl], mesh)
    single = step(X, Y, mask, Xs)
    return {"rank": dist.get_rank(), "nproc": world,
            "backend": dist.get_backend(), "is_distributed":
            distributed.is_distributed(), "rows": [sl.start, sl.stop],
            "rmse_dist": dist_out[0], "rmse_single": single[0],
            "sum_mean_dist": dist_out[1], "sum_mean_single": single[1],
            "sum_var_dist": dist_out[2], "sum_var_single": single[2]}


def run_ranks(argvs, envs, logdir, timeout: float, cwd=None) -> list:
    """Start one process per argument list (with its environment, in cwd),
    its output in logdir/rank{i}.out / .err, and wait for all of them; as soon
    as one fails, or at the timeout, the others are killed (a rank whose
    peer died waits in its next collective). Returns [(returncode, stdout,
    stderr)] in order."""
    logdir = Path(logdir)
    procs, files = [], []
    try:
        for i, (argv, env) in enumerate(zip(argvs, envs)):
            out = open(logdir / f"rank{i}.out", "w")
            err = open(logdir / f"rank{i}.err", "w")
            files += [out, err]
            procs.append(subprocess.Popen(argv, stdout=out, stderr=err,
                                          env=env, cwd=cwd))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    return [(p.returncode, (logdir / f"rank{i}.out").read_text(),
             (logdir / f"rank{i}.err").read_text())
            for i, p in enumerate(procs)]


def main(argv) -> int:
    torch.set_num_threads(1)
    scenario, outdir = argv[0], Path(argv[1])
    if scenario == "cases":
        res = scenario_cases(outdir, argv[2], int(argv[3]), int(argv[4]))
    elif scenario == "cluster":
        res = scenario_cluster()
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
