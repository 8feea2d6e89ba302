"""The port's mapping stream against the JAX package, float64 on the CPU.

The small case of gp_compressor_tpu_torch/testing/mapping_case.py: map_init,
map_insert on the first scan, on a scan that leaves pending evidence and
on a growth scan that creates patches from it and fills the spill bank
(from JAX's state, and chained from the port's own), the carve with a
marking block smaller than the walk, the stream (add_cloud_fused and
add_clouds with rprop registration at calibrated-style values), map_cloud,
the occupancy channel fed JAX's permutations, and the state converter.

Tolerances: integer and bool fields exact; GP states, frames, means and
poses within 1e-9 (float64 rounding through ~100 sequential updates);
claim tables compared by the claims they make (duplicate writers leave
either of two equal rows), with `nm` left out (the port stores it
refreshed from the final means).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.ops.kernels import RBFParams as JRBF
from gp_compressor_tpu.workloads import mapping as jmap
from gp_compressor_tpu.workloads import registration as jreg
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.geometry import patches as tpatches
from gp_compressor_tpu_torch.geometry import transforms as ttf
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.models import sparse_gp as tsg
from gp_compressor_tpu_torch.ops.kernels import RBFParams as TRBF
from gp_compressor_tpu_torch.testing import mapping_case as case
from gp_compressor_tpu_torch.workloads import mapping as tmap
from gp_compressor_tpu_torch.workloads import registration as treg

torch.set_num_threads(1)

T = torch.from_numpy
JCFG = case.compressor_config(jcfg, jnp.float64)
TCFG = case.compressor_config(tcfg, torch.float64)
JMCFG = case.mapping_config(jcfg)
TMCFG = case.mapping_config(tcfg)
MIN_NBR = (1, 30, 30)
ATOL = 1e-9


def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


def _port_state(js):
    return convert.map_state_from_numpy(_asdict(js), device="cpu")


def _jscan(s):
    return tuple(jnp.asarray(a) for a in s)


def _tscan(s):
    return tuple(T(a) for a in s)


@functools.lru_cache(maxsize=None)
def _jax_inserts():
    """JAX's map_init and three inserts: ([states 0..3], [infos 1..3])."""
    st = jmap.map_init(JCFG, JMCFG, *case.BOX, dtype=jnp.float64,
                       pending_capacity=case.PENDING)
    states, infos = [st], []
    for scan, nbr in zip(case.scans(), MIN_NBR):
        st, info = jmap.map_insert(st, *_jscan(scan), JCFG, JMCFG,
                                   jax.random.key(0),
                                   jnp.asarray(nbr, jnp.int32))
        states.append(st)
        infos.append({k: int(v) for k, v in info.items()})
    return states, infos


def _calib(RBF, asarray):
    sf, l2, s20 = case.CAL
    eps = JCFG.depth_gp.eps_tol * sf / JCFG.depth_gp.sigmaf_sq
    return dict(depth_kp=RBF(asarray(sf), asarray(l2)),
                depth_s20=asarray(s20), depth_eps=asarray(eps))


@functools.lru_cache(maxsize=None)
def _jax_stream():
    """JAX's add_clouds over the three moved scans from an empty map."""
    st = jmap.map_init(JCFG, JMCFG, *case.BOX, dtype=jnp.float64,
                       pending_capacity=case.PENDING)
    sc = case.moved_scans()
    P, C, V = (jnp.stack([jnp.asarray(s[j]) for s in sc]) for j in range(3))
    out = jmap.add_clouds(st, P, C, V, JCFG, JMCFG, jax.random.key(1),
                          rcfg=case.registration_config(jcfg),
                          **_calib(JRBF,
                                   lambda v: jnp.asarray(v, jnp.float64)))
    return out


def _claims(tables, state_np, probe):
    """The claims the port's tables make on probe points (with nm from the
    stored frames and means)."""
    st = convert.map_state_from_numpy(state_np, device="cpu")
    nm = torch.cat([st.rotations[:, :, 0], st.means], 1)
    grid = st.grid(TCFG.patch.res)
    return treg.claim_with_tables(tables._replace(nm=nm), grid, T(probe),
                                  torch.ones(len(probe), dtype=torch.bool),
                                  TCFG.patch.res,
                                  out_fill=TCFG.patch.max_patches)


def _probe():
    pts = np.concatenate([s[0] for s in case.scans()])
    return pts + 0.3 * TCFG.patch.res * np.array([0.31, -0.17, 0.23])


def _assert_state(t, j, atol=ATOL, tables=True):
    """Port MapState t against JAX MapState j (numpy dicts or states)."""
    jd = j if isinstance(j, dict) else _asdict(j)
    for f in tmap.MapState._fields:
        if f == "tables":
            continue
        a, b = getattr(t, f), jd[f]
        if isinstance(b, dict):
            for g, bb in b.items():
                aa = getattr(a, g).numpy()
                if aa.dtype.kind in "biu":
                    np.testing.assert_array_equal(aa, bb, err_msg=f"{f}.{g}")
                else:
                    np.testing.assert_allclose(aa, bb, atol=atol,
                                               err_msg=f"{f}.{g}")
            continue
        a = a.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=f)
    if tables:
        probe = _probe()
        want = _claims(convert.claim_tables_from_numpy(jd["tables"],
                                                       device="cpu"),
                       jd, probe)
        got = _claims(t.tables, jd, probe)
        assert want[2].float().mean() > 0.3
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol)
        # the stored nm is refreshed from the final frames and means
        np.testing.assert_allclose(
            t.tables.nm.numpy(),
            np.concatenate([jd["rotations"][:, :, 0], jd["means"]], 1),
            atol=atol)


def test_map_init_matches_jax():
    states, _ = _jax_inserts()
    t = tmap.map_init(TCFG, TMCFG, *case.BOX, dtype=torch.float64,
                      pending_capacity=case.PENDING, device="cpu")
    _assert_state(t, states[0], atol=0, tables=False)
    for f in treg.ClaimTables._fields:
        np.testing.assert_array_equal(getattr(t.tables, f).numpy(),
                                      np.asarray(getattr(states[0].tables, f)))
    assert tmap.required_ray_steps(*case.BOX, 0.3) \
        == jmap.required_ray_steps(*case.BOX, 0.3) == TMCFG.max_ray_steps


@pytest.mark.parametrize("k", [0, 1, 2], ids=["first", "pending", "growth"])
def test_map_insert_matches_jax(k):
    """One insert from JAX's state before it: states, counters, tables."""
    states, infos = _jax_inserts()
    t, info = tmap.map_insert(_port_state(states[k]),
                              *_tscan(case.scans()[k]), TCFG, TMCFG,
                              MIN_NBR[k])
    _assert_state(t, states[k + 1])
    assert {f: int(v) for f, v in info.items()} == infos[k]
    def plane(st):
        # (created patches, pending points) of the plane's voxels
        on = np.abs(np.asarray(st.means)[:, 2] - 3.05) < 0.1
        keys = np.asarray(st.leaf_keys)[:int(st.n_patches)]
        k3 = np.stack([keys // 289, keys // 17 % 17, keys % 17], -1)
        gids = np.asarray(st.leaf_ids)[:int(st.n_patches)][k3[:, 2] == 13]
        return int((on & np.asarray(st.created)).sum()), \
            int(np.asarray(st.pend_count)[gids].sum())

    (c0, p0), (c1, p1) = plane(states[k]), plane(states[k + 1])
    if k == 1:   # the plane's voxels keep their points as evidence
        assert c1 <= 8 and p1 > 150, (c1, p1)
    if k == 2:   # patches created from pending evidence; the spill bank
        assert c1 - c0 >= 10 and p1 < p0, (c0, c1, p0, p1)
        assert infos[k]["bank_dropped"] > 0 and infos[k]["patch_overflow"] == 0


def test_map_insert_chain_matches_jax():
    """The port from its own map_init through the three inserts."""
    states, _ = _jax_inserts()
    t = tmap.map_init(TCFG, TMCFG, *case.BOX, dtype=torch.float64,
                      pending_capacity=case.PENDING, device="cpu")
    for k, scan in enumerate(case.scans()):
        t, _ = tmap.map_insert(t, *_tscan(scan), TCFG, TMCFG, MIN_NBR[k])
        _assert_state(t, states[k + 1])


def test_carve_matches_jax_in_blocks():
    """_carve_free_space on fresh rays against the map after scan 1, with
    marking blocks of 3 steps: the free masks are equal."""
    states, _ = _jax_inserts()
    js = states[2]
    r = np.random.default_rng(5)
    rays = case.scans()[0][0][r.permutation(case.N_SCAN)[:800]]
    rays = rays + 0.01 * r.standard_normal(rays.shape)
    jt = jreg.claim_with_tables(
        js.tables, js.grid(0.3), jnp.asarray(rays), jnp.ones(800, bool), 0.3,
        out_fill=256)
    claim, claimed = np.array(jt[0]), np.array(jt[2])
    assert claimed.mean() > 0.5
    carve = jax.jit(jmap._carve_free_space, static_argnames=("cfg", "mcfg"))
    want = carve(js, js.key_to_leaf, js.created, js.rotations, js.means,
                 js.free, jnp.asarray(rays), jnp.asarray(claimed),
                 jnp.asarray(claim), cfg=JCFG, mcfg=JMCFG)
    ts = _port_state(js)
    got = tmap._carve_free_space(ts, ts.key_to_leaf, ts.created,
                                 ts.rotations, ts.means, ts.free, T(rays),
                                 T(claimed), T(claim), TCFG, TMCFG, chunk=3)
    want = np.asarray(want)
    assert (want & ~np.asarray(js.free)).sum() > 20     # new free cells
    np.testing.assert_array_equal(got.numpy(), want)


def test_add_clouds_matches_jax():
    """The stream with rprop registration on every 2nd point at the
    calibrated-style values: by add_clouds and by add_cloud_fused scan by
    scan, poses, reg_steps, diverged, counters and states as JAX's."""
    jst, jdvg, jsteps, jinfo = _jax_stream()
    calib = _calib(TRBF,
                   lambda v: torch.tensor(v, dtype=torch.float64))
    rcfg = case.registration_config(tcfg)
    t0 = tmap.map_init(TCFG, TMCFG, *case.BOX, dtype=torch.float64,
                       pending_capacity=case.PENDING, device="cpu")
    sc = [_tscan(s) for s in case.moved_scans()]
    t, dvg, steps, info = tmap.add_clouds(
        t0, [s[0] for s in sc], [s[1] for s in sc], [s[2] for s in sc],
        TCFG, TMCFG, rcfg=rcfg, **calib)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    assert steps[0] == 0 and (steps[1:] > 2).all()
    np.testing.assert_array_equal(dvg.numpy(), np.asarray(jdvg))
    for k, v in info.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jinfo[k]))
    _assert_state(t, jst)
    # the registered pose undoes the known motion of scans 1 and 2
    assert np.linalg.norm(t.t_cloud.numpy() + np.asarray(case.T_MOVE)) < 0.01

    s = t0
    for p, c, v in sc:
        s, d, n, _ = tmap.add_cloud_fused(s, p, c, v, TCFG, TMCFG, rcfg=rcfg,
                                          **calib)
    _assert_state(s, jst)


def test_add_cloud_reports_python_numbers():
    t = tmap.map_init(TCFG, TMCFG, *case.BOX, dtype=torch.float64,
                      pending_capacity=case.PENDING, device="cpu")
    scan = _tscan(case.scans()[0])
    t, info = tmap.add_cloud(t, *scan, TCFG, TMCFG)
    assert info == {"diverged": False, "reg_steps": 0, "bank_dropped": 0,
                    "pend_dropped": 0, "patch_overflow": 0,
                    "n_patches": int(t.n_patches)}
    # a scan whose registration reaches max_steps is dropped by default
    mc = dataclasses.replace(TMCFG, drop_on_reg_cap=True)
    t2, info = tmap.add_cloud(t, *scan, TCFG, mc,
                              rcfg=tcfg.RegistrationConfig(max_steps=3,
                                                           min_steps=2))
    assert info["diverged"] and info["reg_steps"] == 3
    assert "n_patches" not in info and torch.equal(t2.W, t.W)


def test_map_cloud_matches_jax():
    states, _ = _jax_inserts()
    js = states[3]
    kw_j = _calib(JRBF, lambda v: jnp.asarray(v, jnp.float64))
    kw_t = _calib(TRBF, lambda v: torch.tensor(v, dtype=torch.float64))
    for jkw, tkw in (({}, {}),
                     ({k: kw_j[k] for k in ("depth_kp", "depth_s20")},
                      {k: kw_t[k] for k in ("depth_kp", "depth_s20")})):
        want = jmap.map_cloud(js, JCFG, **jkw)
        got = tmap.map_cloud(_port_state(js), TCFG, **tkw)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[2].sum() > 100
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_occupancy_matches_jax():
    """train_occupancy fed the permutations JAX draws, and
    predict_occupancy on the grid: states to 1e-9; hit cells score above
    carved ones (the criterion of tests/test_mapping.py)."""
    states, _ = _jax_inserts()
    js = states[3]
    key = jax.random.key(7)
    B, G = js.W.shape
    occ_j = jmap.train_occupancy(js, JCFG, key)
    perm = jax.vmap(lambda k: jax.random.permutation(k, G))(
        jax.random.split(key, B))
    ts = _port_state(js)
    occ_t = tmap.train_occupancy(ts, TCFG, perm=T(np.asarray(perm)))
    for f in tsg.SOGPState._fields:
        a, b = getattr(occ_t, f).numpy(), np.asarray(getattr(occ_j, f))
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f)
    assert int(tsg.size(occ_t).sum()) > 100
    grid = tpatches.prediction_grid(TCFG.patch, torch.float64, device="cpu")
    Xs = grid.expand(B, G, 2)
    p_t = tmap.predict_occupancy(occ_t, TCFG, Xs)
    p_j = jmap.predict_occupancy(occ_j, JCFG, jnp.asarray(Xs.numpy()))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=ATOL)
    W, free = np.asarray(js.W), np.asarray(js.free)
    created = np.asarray(js.created)[:, None]
    hit, carved = W & ~free & created, free & ~W & created
    assert hit.sum() > 50 and carved.sum() > 50
    p = p_t.numpy()
    assert p[hit].mean() > p[carved].mean() + 0.1
    # drawn from a generator: a valid permutation per patch, same labels
    occ_g = tmap.train_occupancy(ts, TCFG,
                                 generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(tsg.size(occ_g).numpy() > 0,
                                  tsg.size(occ_t).numpy() > 0)


def test_map_state_round_trip():
    """A JAX state carried across keeps every value and dtype."""
    states, _ = _jax_inserts()
    d = _asdict(states[2])
    t = convert.map_state_from_numpy(d, device="cpu")
    assert isinstance(t, tmap.MapState)
    for f, v in d.items():
        pairs = ([(getattr(getattr(t, f), g), a) for g, a in v.items()]
                 if isinstance(v, dict) else [(getattr(t, f), v)])
        for a, b in pairs:
            assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, f
            np.testing.assert_array_equal(a.numpy(), b)
    got = convert.mapping_config_from_dict(dataclasses.asdict(JMCFG))
    assert got == TMCFG


# ---- against the plain reference of the source's insert
# (portbench/reference/workloads/mapping_source.py), and the stream at the
# source's motion


def _source_settings():
    from portbench.reference import config as rconf
    from portbench.reference.workloads import mapping_source as ms

    def gp(c):
        return rconf.GPConfig(**{f.name: getattr(c, f.name)
                                 for f in dataclasses.fields(rconf.GPConfig)})
    return ms.Settings(res=0.3, sz=10, min_nbr=30, min_points_for_rotation=4,
                       bank=64, spill=32, depth_gp=gp(TCFG.depth_gp),
                       rgb_gp=gp(TCFG.rgb_gp))


@pytest.mark.parametrize("k", [1, 2], ids=["pending", "growth"])
def test_map_insert_matches_source_reference(k):
    """The port's insert of scan k into its own map of the scans before,
    at the calibrated-style values, against the reference's insert of the
    same scan into the same map, float64: which leaves exist and are
    patches, the W masks and the pending counts equal; frames, means and
    pending points to 1e-9; the GPs' predicted depth on each patch's grid
    to 1e-9 m (scan 2 makes patches from pending evidence and fills the
    spill bank)."""
    from portbench.harness import map_compare
    from portbench.reference.ops.kernels import RBFParams as RRBF
    from portbench.reference.workloads import mapping_source as ms
    kw = _calib(TRBF, lambda v: torch.tensor(v, dtype=torch.float64))
    st = tmap.map_init(TCFG, TMCFG, *case.BOX, dtype=torch.float64,
                       pending_capacity=case.PENDING, device="cpu")
    for j, scan in enumerate(case.scans()[:k + 1]):
        before = st
        st, _ = tmap.map_insert(st, *_tscan(scan), TCFG, TMCFG, MIN_NBR[j],
                                **kw)
    m = map_compare.as_map(before)
    kp = kw["depth_kp"]
    want = ms.insert(m, *_tscan(case.scans()[k]), _source_settings(),
                     RRBF(kp.sigmaf_sq, kp.l_sq), kw["depth_s20"],
                     kw["depth_eps"])
    got = map_compare.as_map(st)
    assert got.n_patches == want.n_patches
    for f in ("key_to_leaf", "created", "W", "pend_count"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("rotations", "means", "rgb_means", "pend_pts", "pend_cols"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), atol=ATOL,
                                   err_msg=f)
    nums = map_compare.insert(got, want, m, 0.3, kp, kw["depth_s20"], 10)
    assert nums["insert_differ"] == 0.0
    assert nums["insert_gap"] <= 1e3 * ATOL            # mm
    if k == 2:
        assert bool((want.created & ~m.created).any())


def test_exact_pose_is_the_pose_the_scan_was_inserted_at():
    """With exact_pose the stored pose composes the registration's exactly
    (R_reg (R x + t) + t_reg), and the scan lands where that pose puts it;
    without it, the reference's plain sum of the steps' translations."""
    kw = _calib(TRBF, lambda v: torch.tensor(v, dtype=torch.float64))
    rcfg = case.registration_config(tcfg)
    sc = [_tscan(s) for s in case.moved_scans()]
    st = tmap.map_init(TCFG, TMCFG, *case.BOX, dtype=torch.float64,
                       pending_capacity=case.PENDING, device="cpu")
    st, _, _, _ = tmap.add_cloud_fused(st, *sc[0], TCFG, TMCFG, rcfg=rcfg,
                                       **kw)
    # a start pose off the identity, so that R_reg t differs from t
    st = st._replace(t_cloud=torch.tensor([0.02, -0.01, 0.015],
                                          dtype=torch.float64))
    view, tables = tmap.registration_view(st, TCFG)
    p, c, v = sc[1]
    k = TMCFG.reg_stride
    pts = ttf.apply(p, st.R_cloud, st.t_cloud)
    reg, _ = treg.register(view, pts[::k], c[::k], v[::k], TCFG, rcfg,
                           depth_kp=kw["depth_kp"],
                           depth_s20=kw["depth_s20"], tables=tables)
    exact = dataclasses.replace(TMCFG, exact_pose=True)
    a, _, _, _ = tmap.add_cloud_fused(st, p, c, v, TCFG, exact, rcfg=rcfg,
                                      **kw)
    b, _, _, _ = tmap.add_cloud_fused(st, p, c, v, TCFG, TMCFG, rcfg=rcfg,
                                      **kw)
    assert torch.equal(a.R_cloud, b.R_cloud)
    np.testing.assert_allclose(
        a.t_cloud.numpy(), (reg.R_cloud @ st.t_cloud + reg.t_exact).numpy(),
        atol=1e-15)
    np.testing.assert_allclose(b.t_cloud.numpy(),
                               (st.t_cloud + reg.t_cloud).numpy(),
                               atol=1e-15)
    assert float(torch.linalg.norm(a.t_cloud - b.t_cloud)) > 1e-5
    # the inserted scan is the scan at the stored pose
    want, _ = tmap.map_insert(st._replace(R_cloud=a.R_cloud,
                                          t_cloud=a.t_cloud),
                              ttf.apply(p, a.R_cloud, a.t_cloud), c, v,
                              TCFG, exact, TMCFG.min_points_new_patch, **kw)
    _assert_state(a, _asdict(want), atol=0.0, tables=False)
