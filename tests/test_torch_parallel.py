"""The port's multi-device layer on the CPU: 4 gloo ranks against the
single-process port and against the JAX package's runs on the 8-device
virtual CPU mesh (tests/conftest.py).

One module fixture runs the JAX references (tests/test_parallel.py's and
__graft_entry__.dryrun_multichip's sharded programs, float32 pipelines
with the MAP in float64 under x64, and the round trip with a float64 cloud
and float64 GPs), writes them to `jax.npz`, then spawns
4 ranks of `gp_compressor_tpu_torch.testing.dist_worker cases` (explicit
rendezvous arguments) and 2 ranks of its `cluster` scenario (torchrun's
environment variables), each of which prints one JSON line. The cases
below are parametrised over those results.

Float32 training at these constants is not reproducible across the two
packages (the round trip's RMSE is 0.145 m in the port and 0.122 m in JAX
on this cloud; tests/test_torch_compressor.py bounds the gap at 2%), so
the float outputs of JAX's mesh run are held against the port's sharded
decompress, RMSE and register run on JAX's own states, at the tolerances
JAX's tests hold its mesh run to its single run. The sharded port is held
to the single-process port at those tolerances or exactly. Under a mesh
each rank takes its block of the cloud's points (`compressor.shard_points`)
and keeps its patch rows: the point-sharded front end is held to the
single process's `project` exactly (the float64 moment and mean sums add
up in another order there, which these clouds do not show).
"""

import json
import os
import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.geometry import transforms as jtf
from gp_compressor_tpu.models import sparse_gp as jsg
from gp_compressor_tpu.ops.kernels import RBFParams as JRBF
from gp_compressor_tpu.ops.noise import GaussianNoise
from gp_compressor_tpu.parallel import distributed as jdist
from gp_compressor_tpu.parallel import mesh as jmesh
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu.workloads import registration as jreg
from gp_compressor_tpu_torch.testing import dist_worker

REPO = Path(__file__).resolve().parents[1]
WORKER = "gp_compressor_tpu_torch.testing.dist_worker"
MESHES = ("2x2", "4x1")
REG_W = (0.004, -0.003, 0.002)
REG_T = (0.008, -0.006, 0.004)


def _pipe_cfg(max_patches=128, dtype=jnp.float32):
    return jcfg.CompressorConfig(
        patch=jcfg.PatchConfig(res=0.5, sz=8, max_patches=max_patches,
                               max_points_per_patch=128,
                               approx_sphere_moments=True,
                               bank_order="center_out"),
        depth_gp=jcfg.GPConfig(capacity=20, slots=32, eps_tol=2.0,
                               dtype=dtype),
        rgb_gp=jcfg.rgb_gp_config(slots=32, capacity=20, dtype=dtype))


def _rcfg():
    return jcfg.RegistrationConfig(max_steps=8, min_steps=2, reclaim_every=2,
                                   step_mode="rprop")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _flat(tree, prefix, out):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}.{k}", out)
    elif tree is not None:
        out[prefix] = np.asarray(tree)
    return out


def _cloud(n, seed):
    pts, cols = synthetic.room_cloud(n=n, seed=seed)
    return jnp.asarray(pts), jnp.asarray(cols), jnp.ones((n,), bool)


def _moved(pts):
    w = jnp.asarray(REG_W, pts.dtype)
    t = jnp.asarray(REG_T, pts.dtype)
    return jtf.apply(pts, jtf.euler_xyz(w), t)


def _jax_train(B, n, seed, m8, rmse: bool):
    """tests/test_parallel.py's sharded training (and its global RMSE) on
    the 8-device mesh."""
    cfg = jcfg.GPConfig(capacity=10, slots=16, dtype=jnp.float64)
    kp = JRBF(sigmaf_sq=jnp.asarray(100.0), l_sq=jnp.asarray(1.0))
    noise = GaussianNoise(s20=jnp.asarray(0.1))
    r = np.random.default_rng(seed)
    X = jnp.asarray(r.uniform(-5, 5, size=(B, n, 2)))
    Y = jnp.asarray(r.normal(size=(B, n, 1)))
    mask = jnp.ones((B, n), bool)
    sh = jmesh.patch_sharding(m8)

    @jax.jit
    def run(states, X, Y, mask):
        st = jsg.add_points_batch(kp, noise, cfg, states, X, Y, mask)
        if not rmse:
            return st
        mean, _ = jsg.predict_batch(kp, cfg.s20, st, X)
        return jnp.sqrt(jnp.mean((mean - Y) ** 2))

    return run(*(jax.device_put(a, sh) for a in
                 (jsg.init_batch(cfg, B), X, Y, mask)))


def _jax_runs(m8, m42):
    sh = NamedSharding(m8, P("data"))
    put = lambda *a: [jax.device_put(x, sh) for x in a]
    out = {}
    out["train"] = _jax_train(16, 30, 0, m8, rmse=False)
    out["rmse"] = _jax_train(24, 20, 1, m8, rmse=True)

    cfg = _pipe_cfg()
    pts, cols, valid = _cloud(5000, 3)
    comp, o = jcomp.compress_decompress(*put(pts, cols, valid), cfg,
                                        jax.random.key(7), mesh=m8)
    out["round_trip"] = {"comp": comp, "world": o[0], "colors": o[1],
                         "valid": o[2],
                         "rmse": jcomp.reconstruction_rmse(comp, cfg)}

    cfg64 = _pipe_cfg(dtype=jnp.float64)
    pts, cols, valid = (a.astype(jnp.float64) if a.dtype != bool else a
                        for a in _cloud(5000, 3))
    comp, _ = jcomp.compress_decompress(*put(pts, cols, valid), cfg64,
                                        jax.random.key(7), mesh=m8)
    out["round_trip64"] = jcomp.reconstruction_rmse(comp, cfg64)

    pts, cols, valid = _cloud(4000, 5)
    comp = jcomp.compress(pts, cols, valid, cfg, jax.random.key(0))
    scan = _moved(pts)
    st, _ = jreg.register(comp, scan, cols, valid, cfg, _rcfg(), mesh=m8)
    out["register"] = {"comp": comp, "scan": scan, "state": st}

    cfg = _pipe_cfg(32)
    pts, cols, valid = _cloud(6000, 3)
    comp, kp, s20, _ = jcomp.compress_decompress_calibrated(
        *put(pts, cols, valid), cfg, jax.random.key(0), calib_patches=8,
        calib_points=32, calib_steps=25, calib_starts=4, mesh=m42)
    scan = _moved(pts)
    st, _ = jreg.register(comp, jax.device_put(scan, NamedSharding(
        m42, P("data"))), cols, valid, cfg, _rcfg(), depth_kp=kp, mesh=m42)
    out["calibrated"] = {
        "comp": comp, "kp": jnp.stack([kp.sigmaf_sq, kp.l_sq]), "s20": s20,
        "rmse": jcomp.reconstruction_rmse(comp, cfg, depth_kp=kp,
                                          depth_s20=s20),
        "scan": scan, "state": st}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("torch_parallel")
    assert len(jax.devices()) == 8
    m8 = jmesh.make_mesh(jcfg.MeshConfig())
    m42 = jmesh.make_mesh(jcfg.MeshConfig(chain_size=2))
    jr = _jax_runs(m8, m42)
    flat = {}
    for k in ("round_trip", "register", "calibrated"):
        _flat(jr[k], k, flat)
    np.savez(outdir / "jax.npz", **flat)

    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    init = f"tcp://127.0.0.1:{_free_port()}"
    port = str(_free_port())
    worker = [sys.executable, "-m", WORKER]
    argvs = [worker + ["cases", str(outdir), init, str(r), "4"]
             for r in range(4)] + [worker + ["cluster", str(outdir)]] * 2
    envs = [env] * 4 + [dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                             WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r))
                        for r in range(2)]
    ranks = dist_worker.run_ranks(argvs, envs, outdir, timeout=300,
                                  cwd=REPO)
    for rc, _, err in ranks:
        assert rc == 0, f"rank failed ({rc}):\n{err[-4000:]}"
    outs = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in ranks]
    with np.load(outdir / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return {"cases": outs[:4], "cluster": outs[4:], "arrays": arrays,
            "jax": jr}


@pytest.mark.parametrize("name,chain", [("2x2", 2), ("4x1", 1)])
def test_mesh_layout_matches_jax(runs, name, chain):
    """Rank r sits where JAX's make_mesh puts device r; the coordinate is
    the rank in each group, and the data rows are contiguous blocks."""
    ids = jmesh.make_mesh(jcfg.MeshConfig(chain_size=chain),
                          jax.devices()[:4]).devices
    ids = np.vectorize(lambda d: d.id)(ids).tolist()
    data = 4 // chain
    for o in runs["cases"]:
        lay = o["layout"][name]
        assert lay["ranks"] == ids
        d, c = divmod(o["rank"], chain)
        assert lay["coordinate"] == lay["group_rank"] == [d, c]
        assert lay["data_group"] == [row[c] for row in ids]
        assert lay["chain_group"] == ids[d]
        assert lay["patch_rows_16"] == [d * 16 // data, (d + 1) * 16 // data]


def test_process_local_slice_matches_jax(runs, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    for o in runs["cases"]:
        monkeypatch.setattr(jax, "process_index", lambda r=o["rank"]: r)
        for n, got in o["layout"]["process_local_slice"].items():
            want = jdist.process_local_slice(int(n))
            assert got == [want.start, want.stop], (o["rank"], n)


def test_mesh_errors(runs):
    """An uncovered mesh raises with JAX's message; an axis that does not
    split evenly is refused, as a JAX NamedSharding refuses it."""
    for o in runs["cases"]:
        assert o["layout"]["errors"] == [
            "mesh 3x1 does not cover 4 devices",
            "a leading axis of 6 does not split over 4 ranks of 'data'; "
            "pad it to 8"]


@pytest.mark.parametrize("name", MESHES)
def test_all_to_all_rows_routes_in_block_order(runs, name):
    """Rows of mixed dtypes and shapes (one rank sends none) reach the
    rank of their destination coordinate bit for bit, in source order."""
    for o in runs["cases"]:
        assert o["route"][name]["equal"], (o["rank"], o["route"][name])
    # ranks 0, 2, 3 send 5, 11 and 14 rows, each to a rank of its group
    assert sum(o["route"][name]["received"] for o in runs["cases"]) == 30


@pytest.mark.parametrize("name", MESHES)
def test_sharded_training_matches_single(runs, name):
    """Float64, the plain version: each rank trains its rows; gathered,
    equal to the whole bank's training (tests/test_parallel.py holds JAX
    to atol 1e-12), and to JAX's 8-device run."""
    for o in runs["cases"]:
        r = o["train"][name]
        assert r["local_rows"] == (8 if name == "2x2" else 4)
        assert r["equal"] and r["max_diff"] <= 1e-12
    arr, js = runs["arrays"], runs["jax"]["train"]
    for f in js._fields:
        np.testing.assert_allclose(arr[f"train.{name}.{f}"],
                                   np.asarray(getattr(js, f)), atol=1e-9)


@pytest.mark.parametrize("name", MESHES)
def test_global_rmse_reduction(runs, name):
    """[sum err^2, sum mask] all-reduced once: the single value to rtol
    1e-12 on every rank, and JAX's psum'd value to rtol 1e-9."""
    jv = float(runs["jax"]["rmse"])
    for o in runs["cases"]:
        r = o["rmse"]
        np.testing.assert_allclose(r[name], r["single"], rtol=1e-12)
        np.testing.assert_allclose(r[name], jv, rtol=1e-9)


@pytest.mark.parametrize("case", ["quadratic", "patch_logpost", "map"])
def test_chain_sharded_hmc_and_map_exact(runs, case):
    """HMC chains (and MAP starts) cut over `chain` with the whole draws
    cut the same way: exactly the single run's samples, accepts and step
    sizes (the best theta and every start's log posterior)."""
    for o in runs["cases"]:
        for name in MESHES:
            r = o["chains"][case][name]
            assert r["equal"] and r["max_diff"] == 0.0, (o["rank"], name, r)


FRONT_END_VARIANTS = ("center_out", "shuffle", "native_exact")


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("variant", FRONT_END_VARIANTS)
def test_sharded_front_end_matches_single(runs, variant, name):
    """project on each rank's block of a 4,999-point cloud (center_out and
    the default shuffle order at PIPE_CFG, and native with the exact
    27-offset moments), gathered: the grid (bounds, leaf table, dense
    lookup), n_leaves, every claim, counts, W mask, bank mask and the
    banked cloud rows equal to the single process's; means, rotations and
    banks bit-equal too on this cloud (atol 0: the reordered float64 sums
    round to the same float32 values). Each rank holds 128 / n_data patch
    rows and 5,000 / n_data point rows."""
    n_data = 2 if name == "2x2" else 4
    for o in runs["cases"]:
        r = o["front_end"][variant][name]
        assert r["local_rows"] == 128 // n_data
        assert r["claim_rows"] == 5000 // n_data
        assert r["grid_equal"] and r["n_leaves"] > 64, (o["rank"], r)
        assert r["claims_differ"] == 0, (o["rank"], r)
        for k in ("W_equal", "mask_equal", "counts_equal", "ids_equal"):
            assert r[k], (o["rank"], k)
        assert r["banked"] > 4000
        assert r["rows_differ"] == 0, (o["rank"], r)
        assert all(v == 0.0 for v in r["max_diff"].values()), r["max_diff"]


def test_front_end_padding_rows_are_inert(runs):
    """4,999 points over 2 or 4 blocks: the last data block holds one
    padding row (zero, invalid; the cloud is moved away from the origin,
    so a padding row that counted would move the bounds). Its claim is -1
    and the grid is the single process's on every mesh."""
    for o in runs["cases"]:
        for variant in FRONT_END_VARIANTS:
            for name, chain in (("2x2", 2), ("4x1", 1)):
                r = o["front_end"][variant][name]
                last = o["rank"] // chain == 4 // chain - 1
                assert r["pad_rows"] == (1 if last else 0)
                assert r["pad_claims_unclaimed"] and r["grid_equal"]


@pytest.mark.parametrize("name", MESHES)
def test_round_trip64_matches_single_and_jax_mesh(runs, name):
    """The round trip at PIPE_CFG with a float64 cloud and float64 GPs,
    from point blocks: the RMSE equals the single process's to rtol 1e-12
    (the global sums' order) and JAX's 8-device run's to rtol 1e-9 (float64
    training agrees across the packages)."""
    jv = float(runs["jax"]["round_trip64"])
    for o in runs["cases"]:
        r = o["round_trip64"]
        np.testing.assert_allclose(r[name], r["single"], rtol=1e-12)
        np.testing.assert_allclose(r[name], jv, rtol=1e-9)


@pytest.mark.parametrize("name", MESHES)
def test_round_trip_sharded_matches_single(runs, name):
    """compress_decompress at PIPE_CFG from each rank's block of the cloud:
    claims, mask and valid exact; the banks and both GP states bit-equal
    (per-patch work); RMSE to rtol 1e-6 (only the global sum's order
    changes)."""
    for o in runs["cases"]:
        r = o["round_trip"][name]
        assert r["local_rows"] == (64 if name == "2x2" else 32)
        assert r["claim_rows"] == (2500 if name == "2x2" else 1250)
        for k in ("claims_equal", "n_leaves_equal", "mask_equal",
                  "valid_equal", "banks_equal"):
            assert r[k], (o["rank"], k)
        assert r["states_max_diff"] == 0.0 and r["out_max_diff"] == 0.0
        np.testing.assert_allclose(r["rmse"], o["round_trip"]["single_rmse"],
                                   rtol=1e-6)


def test_round_trip_matches_jax_mesh(runs):
    """Against JAX's 8-device run (tests/test_parallel.py's tolerances):
    claims, mask and valid exact; JAX's states through the port's sharded
    decompress: points within 1e-4, colours within 0.2, RMSE rtol 1e-4."""
    arr, j = runs["arrays"], runs["jax"]["round_trip"]
    for name in MESHES:
        np.testing.assert_array_equal(arr[f"round_trip.{name}.claims"],
                                      np.asarray(j["comp"].patch.claims))
        np.testing.assert_array_equal(arr[f"round_trip.{name}.mask"],
                                      np.asarray(j["comp"].patch.mask))
        np.testing.assert_array_equal(arr[f"round_trip.{name}.valid"],
                                      np.asarray(j["valid"]))
    v = np.asarray(j["valid"])
    np.testing.assert_array_equal(arr["round_trip.jax_state.valid"], v)
    np.testing.assert_allclose(arr["round_trip.jax_state.world"][v],
                               np.asarray(j["world"])[v], atol=1e-4)
    np.testing.assert_allclose(arr["round_trip.jax_state.colors"][v],
                               np.asarray(j["colors"])[v], atol=0.2)
    for o in runs["cases"]:
        np.testing.assert_allclose(o["round_trip"]["jax_state_rmse"],
                                   float(j["rmse"]), rtol=1e-4, atol=1e-6)


def _hold_register(got, want, pose_atol=2e-6):
    assert got["steps"] == int(want["steps"])
    np.testing.assert_allclose(got["t"], np.asarray(want["t"]),
                               atol=pose_atol)
    np.testing.assert_allclose(got["R"], np.asarray(want["R"]),
                               atol=pose_atol)


def _jax_state(st):
    return {"steps": st.step_nbr, "t": st.t_cloud, "R": st.R_cloud,
            "delta": st.delta}


@pytest.mark.parametrize("name", MESHES)
def test_register_sharded_matches_single(runs, name):
    """register on the sharded map, one all-reduce per step: equal steps,
    pose within 2e-6, delta rtol 2e-4 (tests/test_parallel.py)."""
    for o in runs["cases"]:
        r, s = o["register"][name], o["register"]["single"]
        assert r["steps"] > 2
        _hold_register(r, s)
        np.testing.assert_allclose(r["delta"], s["delta"], rtol=2e-4,
                                   atol=1e-8)


def test_register_matches_jax_mesh(runs):
    """The port's sharded register on JAX's map and scan against JAX's
    register on its 8-device mesh: equal steps, pose within 2e-6. The last
    gradient is held to the single-process port above, not to JAX: in
    float32 the twist mean cancels, and the two packages' single runs on
    this map already differ by up to ~2% in it with identical claims
    (tests/test_torch_registration.py holds the float32 case by its error
    only, the float64 cases to 1e-9)."""
    want = _jax_state(runs["jax"]["register"]["state"])
    for o in runs["cases"]:
        _hold_register(o["register"]["jax_map"], want)


def test_calibrated_round_trip_sharded(runs):
    """dryrun_multichip's configuration on the 2 x 2 mesh (16 patches per
    data rank, MAP starts over chain): theta equal to the single run's,
    RMSE rtol 1e-3, register t within 5e-6 and equal steps."""
    for o in runs["cases"]:
        r, s = o["calibrated"]["2x2"], o["calibrated"]["single"]
        assert r["theta"] == s["theta"]
        np.testing.assert_allclose(r["rmse"], s["rmse"], rtol=1e-3)
        assert 0.0 < r["rmse"] < 0.1
        _hold_register(r, s, pose_atol=5e-6)


def test_calibrated_round_trip_matches_jax_mesh(runs):
    """Against JAX's 4 x 2 mesh run: the calibrated values within 1e-6 in
    log space (tests/test_torch_calibration.py), and on JAX's calibrated
    states the port's sharded RMSE (rtol 1e-3) and register (equal steps,
    t within 5e-6)."""
    j = runs["jax"]["calibrated"]
    jt = np.log(np.r_[np.asarray(j["kp"]), float(j["s20"])])
    want = _jax_state(j["state"])
    for o in runs["cases"]:
        np.testing.assert_allclose(np.log(o["calibrated"]["2x2"]["theta"]),
                                   jt, atol=1e-6)
        got = o["calibrated"]["jax_state"]
        np.testing.assert_allclose(got["rmse"], float(j["rmse"]), rtol=1e-3)
        _hold_register(got, want, pose_atol=5e-6)


def test_cluster_joined_from_environment(runs):
    """Two ranks joined by initialize() from torchrun's variables: the
    train-and-predict RMSE reduced across processes equals the single
    run (tests/test_distributed.py's tolerances) and is the same on both
    ranks."""
    outs = runs["cluster"]
    assert sorted(o["rank"] for o in outs) == [0, 1]
    assert [o["rows"] for o in sorted(outs, key=lambda o: o["rank"])] == \
        [[0, 16], [16, 32]]
    for o in outs:
        assert o["nproc"] == 2 and o["is_distributed"]
        assert o["backend"] == "gloo"
        np.testing.assert_allclose(o["rmse_dist"], o["rmse_single"],
                                   rtol=3e-5, atol=3e-6)
        np.testing.assert_allclose(o["sum_mean_dist"], o["sum_mean_single"],
                                   rtol=3e-5, atol=1e-4)
        np.testing.assert_allclose(o["sum_var_dist"], o["sum_var_single"],
                                   rtol=3e-5, atol=1e-4)
    np.testing.assert_allclose(outs[0]["rmse_dist"], outs[1]["rmse_dist"],
                               rtol=1e-6)


def test_shard_report_partitions_banks(runs):
    """Every point, bank, GP-state and decompress leaf is this rank's half
    on the 2 x 2 mesh, the claims included (no rank holds the whole point
    axis or the whole banks); the point rows are the data coordinate's
    block; no device peak on the CPU, for any stage."""
    for o in runs["cases"]:
        rep = o["shard_report"]
        assert rep["n_ranks"] == 4 and rep["device"] == "cpu"
        d = rep["coordinate"]["data"]
        assert rep["point_rows"] == [2500 * d, 2500 * (d + 1)]
        leaves = rep["calibrated_pipeline"]["leaves"]
        assert "points" in leaves and "patch.claims" in leaves
        for k, v in leaves.items():
            assert v["layout"] == "partitioned", (k, v)
            assert 2 * v["rows"] == v["of"], (k, v)
        assert rep["calibrated_pipeline"]["peak_bytes"] is None
        for k in ("stage_peak_bytes", "stage_start_bytes"):
            assert rep[k] == {"front_end": None, "training": None,
                              "decompress": None}
        assert rep["register"]["steps"] >= 2


def test_single_process_defaults(monkeypatch):
    """Without a rendezvous initialize() is a no-op (as JAX's is without a
    coordinator): one process owns every row; the CPU only when asked for,
    and no silent CPU when CUDA is asked for without a card."""
    import torch

    from gp_compressor_tpu_torch.parallel import distributed, mesh

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize(device_type="cpu")
    assert not torch.distributed.is_initialized()
    assert not distributed.is_distributed()
    assert distributed.process_local_slice(10) == slice(0, 10)
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        distributed.local_device("cuda")
    for n, m in ((0, 4), (5, 4), (8, 4), (9, 1)):
        assert mesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
