"""The port's mapping building blocks against the JAX package on the CPU:
the probit noise model, the Amanatides-Woo ray walk (against jitted JAX
and the independent NumPy oracle of tests/test_ray_walk.py), the fixed-size
unique of the insert's allocator, the dense claim tables (full build,
empty, incremental update; the port's incremental against its own full
build inside map_insert), and one float32 run of the mapping stream.

Tolerances: ray walks, table rows and claims exact (the same float64
arithmetic); the probit moments to 1e-12 relative; the float32 stream by
the `realistic` rule's statistics, since float32 deletion and claim
choices are chaotic (see the test).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.geometry import voxel as jvoxel
from gp_compressor_tpu.ops import noise as jnoise
from gp_compressor_tpu.ops.kernels import RBFParams as JRBF
from gp_compressor_tpu.workloads import mapping as jmap
from gp_compressor_tpu.workloads import registration as jreg
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.geometry import voxel as tvoxel
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.ops import noise as tnoise
from gp_compressor_tpu_torch.ops.kernels import RBFParams as TRBF
from gp_compressor_tpu_torch.testing import mapping_case as case
from gp_compressor_tpu_torch.workloads import mapping as tmap
from gp_compressor_tpu_torch.workloads import registration as treg
from tests.test_ray_walk import oracle_ray_voxels

torch.set_num_threads(1)

T = torch.from_numpy


def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


# ---------------------------------------------------------------------------
# probit noise
# ---------------------------------------------------------------------------

def test_probit_noise_matches_jax():
    """Both branches of phi/Phi (z < -8 takes the -z asymptote), dx_ln
    elementwise and dx2_ln summed over the output axis, batched as the
    trainer calls them."""
    r = np.random.default_rng(0)
    B = 64
    y = np.where(r.uniform(size=(B, 1)) > 0.5, 1.0, -1.0)
    m = r.normal(scale=4.0, size=(B, 1))
    m[:8] = -y[:8] * r.uniform(12.0, 40.0, size=(8, 1))     # z < -8
    s2 = r.uniform(0.01, 2.0, size=B)
    jn = jnoise.ProbitNoise(s20=jnp.asarray(0.7))
    tn = tnoise.ProbitNoise(s20=torch.tensor(0.7, dtype=torch.float64))
    jd = jax.vmap(jn.dx_ln)(jnp.asarray(y), jnp.asarray(m),
                            jnp.asarray(s2))
    jd2 = jax.vmap(jn.dx2_ln)(jnp.asarray(y), jnp.asarray(m),
                              jnp.asarray(s2))
    td = tn.dx_ln(T(y), T(m), T(s2)[:, None])
    td2 = tn.dx2_ln(T(y), T(m), T(s2))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-12)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-12)
    z = (y * m)[:, 0] / np.sqrt(0.7 + s2)
    assert (z < -8).sum() == 8 and np.isfinite(td2.numpy()).all()


# ---------------------------------------------------------------------------
# the ray walk
# ---------------------------------------------------------------------------

def _walks(origin, dims, res, cam, deltas, t_stop=None):
    """(port keys lists, jitted JAX keys lists) of every ray."""
    steps = tvoxel.max_walk_steps(dims)
    jf = jax.jit(lambda o, c, d: jvoxel.ray_voxel_list(
        o, jnp.asarray(dims, jnp.int32), res, c, d, max_steps=steps,
        t_stop=t_stop))
    jk, jc = (np.asarray(a) for a in jf(jnp.asarray(origin), jnp.asarray(cam),
                                        jnp.asarray(deltas)))
    tk, tc = tvoxel.ray_voxel_list(
        T(np.asarray(origin, np.float64)), torch.tensor(dims, dtype=torch.int32),
        res, T(np.asarray(cam, np.float64)), T(np.asarray(deltas, np.float64)),
        max_steps=steps, t_stop=t_stop)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(tc.numpy(), jc)
    return [list(tk[i, :tc[i]].numpy()) for i in range(len(deltas))]


def _case(name):
    """(origin, dims, res, cam, deltas, t_stop) of the cases of
    tests/test_ray_walk.py."""
    r = np.random.default_rng(0 if name == "random" else 3)
    if name == "random":
        origin, dims, res = np.array([-1.3, 0.2, -0.7]), [17, 11, 23], 0.31
        cams = [origin + np.array([2.0, 1.1, 3.3]),
                origin - np.array([1.0, 2.0, 0.5]),
                origin + np.asarray(dims) * res + 0.7]
        return [(origin, dims, res, cam,
                 origin + r.uniform(-0.2, 1.2, size=(40, 3))
                 * (np.asarray(dims) * res) - cam, None) for cam in cams]
    if name == "t_stop":
        cam = np.array([1.87, 1.91, 1.83])
        return [(np.zeros(3), [25, 25, 25], 0.15, cam,
                 r.uniform(0.05, 3.7, size=(60, 3)) - cam, 1.0)]
    if name == "diagonal":
        cam = np.array([0.011, 0.017, 0.013])
        ends = np.array([[8.99, 8.93, 8.97], [8.99, 0.02, 8.97],
                         [0.02, 8.93, 0.01]])
        return [(np.zeros(3), [60, 60, 60], 0.15, cam, ends - cam, 1.0)]
    # axis-aligned and degenerate (a near-zero direction, a ray leaving
    # backwards near the origin corner)
    return [(np.zeros(3), [10, 10, 10], 0.5, np.array([1.26, 1.31, 1.22]),
             np.array([[3.0, 0.0, 0.0], [0.0, -3.0, 0.0], [0.0, 0.0, 1e-8],
                       [-5.0, -5.0, -5.0]]), None)]


@pytest.mark.parametrize("name", ["random", "t_stop", "diagonal",
                                  "axis_degenerate"])
def test_ray_voxel_list_matches_jax_and_oracle(name):
    for origin, dims, res, cam, deltas, t_stop in _case(name):
        got = _walks(origin, dims, res, cam, deltas, t_stop=t_stop)
        for i, d in enumerate(deltas):
            assert got[i] == oracle_ray_voxels(origin, dims, res, cam, d,
                                               t_stop=t_stop), i
        if name == "diagonal":
            assert min(len(g) for g in got) > 50


def test_ray_walk_step_ties_go_to_the_lower_axis():
    """Equal boundary parameters on two or three axes step the lower axis,
    as jnp.argmin breaks ties; the 3.4e38 sentinel of a zero direction
    never steps."""
    tmax = np.array([[1.0, 1.0, 2.0], [2.0, 1.0, 1.0], [1.0, 2.0, 1.0],
                     [1.0, 1.0, 1.0], [3.4e38, 0.5, 3.4e38]])
    n = len(tmax)
    st = dict(X=np.full((n, 3), 4, np.int32), tmax=tmax,
              tdelta=np.full((n, 3), 0.25), stepv=np.ones((n, 3), np.int32),
              t=np.zeros(n), t_end=np.full(n, 9.0), active=np.ones(n, bool))
    dims = np.array([10, 10, 10], np.int32)
    js = jvoxel.ray_walk_step(
        jvoxel.RayWalkState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(dims))
    ts = tvoxel.ray_walk_step(
        tvoxel.RayWalkState(**{k: T(v) for k, v in st.items()}), T(dims))
    for f in tvoxel.RayWalkState._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.X.numpy()[:, 0] - 4, [1, 0, 1, 1, 0])


@pytest.mark.parametrize("size", [8, 40])
def test_unique_sorted_matches_jnp_unique(size):
    r = np.random.default_rng(size)
    x = r.integers(0, 30, size=50).astype(np.int32)
    x[r.uniform(size=50) < 0.3] = tvoxel.FILL
    want = np.asarray(jnp.unique(jnp.asarray(x), size=size,
                                 fill_value=jvoxel._FILL))
    np.testing.assert_array_equal(tmap._unique_sorted(T(x), size).numpy(),
                                  want)


# ---------------------------------------------------------------------------
# the dense claim tables
# ---------------------------------------------------------------------------

DIMS = np.array([9, 8, 7], np.int32)
ORIGIN = np.array([-0.5, -0.3, 0.1])
RES = 0.3
B = 40


@functools.lru_cache(maxsize=None)
def _leaves():
    """A synthetic map: 30 leaves at random cells of a 9 x 8 x 7 grid,
    random frames, 70% trained, and up to 6 untrained leaves that train
    next."""
    r = np.random.default_rng(4)
    nc = int(np.prod(DIMS))
    n = 30
    cells = r.choice(nc, size=n, replace=False).astype(np.int32)
    key_to_leaf = np.full(nc, -1, np.int32)
    key_to_leaf[cells] = np.arange(n)
    key_by_gid = np.full(B, tvoxel.FILL, np.int32)
    key_by_gid[:n] = cells
    rot = np.linalg.qr(r.normal(size=(B, 3, 3)))[0]
    k3 = np.stack([cells // (8 * 7), cells // 7 % 8, cells % 7], -1)
    centers = ORIGIN + (k3 + 0.5) * RES
    means = np.zeros((B, 3))
    means[:n] = centers + 0.02 * r.normal(size=(n, 3))
    trained = (r.uniform(size=B) < 0.7) & (np.arange(B) < n)
    untrained = np.flatnonzero(~trained[:n])
    changed = np.full(8, B, np.int32)
    changed[:min(6, len(untrained))] = untrained[:6]
    trained2 = trained.copy()
    trained2[changed[changed < B]] = True
    # probes around the leaves, up to 1.5 cells from their centres
    probe = (np.repeat(centers, 100, axis=0)
             + r.uniform(-0.45, 0.45, size=(n * 100, 3)))
    return dict(key_to_leaf=key_to_leaf, key_by_gid=key_by_gid, n=n,
                rot=rot, means=means, trained=trained, trained2=trained2,
                changed=changed, probe=probe)


def _full(pkg, L, trained):
    args = (L["key_to_leaf"], L["key_by_gid"], np.int32(L["n"]), trained,
            L["rot"], L["means"], DIMS)
    if pkg == "jax":
        out = jax.jit(jreg.build_claim_tables_dense)(
            *(jnp.asarray(a) for a in args))
        return convert.claim_tables_from_numpy(_asdict(out), device="cpu")
    return treg.build_claim_tables_dense(*(torch.as_tensor(a) for a in args))


def _claims(tables, L):
    grid = tvoxel.VoxelGrid(keys=T(L["key_by_gid"]), n_leaves=None,
                            origin=T(ORIGIN), dims=T(DIMS),
                            res=torch.tensor(RES, dtype=torch.float64))
    return treg.claim_with_tables(tables, grid, T(L["probe"]),
                                  torch.ones(len(L["probe"]), dtype=torch.bool),
                                  RES, out_fill=B)


def _same_claims(a, b, L):
    ca, cb = _claims(a, L), _claims(b, L)
    for u, v in zip(ca, cb):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    return float(ca[2].double().mean())


def test_dense_tables_full_build_matches_jax():
    L = _leaves()
    jt = _full("jax", L, L["trained"])
    tt = _full("port", L, L["trained"])
    for f in ("prio", "gid", "R12", "nm"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      getattr(jt, f).numpy())
    # cell_row: duplicate writers may differ, the claims may not
    assert _same_claims(tt, jt, L) > 0.05


def test_empty_dense_tables_match_jax():
    jt = jreg.empty_claim_tables_dense(504, B, dtype=jnp.float64)
    tt = treg.empty_claim_tables_dense(504, B, dtype=torch.float64,
                                       device="cpu")
    for f in treg.ClaimTables._fields:
        a, b = getattr(tt, f).numpy(), np.asarray(getattr(jt, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_dense_tables_update_matches_jax_and_full_build():
    """Fold newly trained leaves (and padding entries) into the full
    tables: JAX's update, the port's update and the port's full build of
    the new trained set claim the same."""
    L = _leaves()
    start = _full("port", L, L["trained"])
    jstart = _full("jax", L, L["trained"])
    ch = L["changed"]
    args = (ch, ch < B, L["key_to_leaf"], L["key_by_gid"], L["trained2"],
            L["rot"], DIMS)
    ju = jax.jit(jreg.update_claim_tables)(
        jreg.ClaimTables(*(jnp.asarray(getattr(jstart, f).numpy())
                           for f in treg.ClaimTables._fields)),
        *(jnp.asarray(a) for a in args))
    ju = convert.claim_tables_from_numpy(_asdict(ju), device="cpu")
    tu = treg.update_claim_tables(start, *(torch.as_tensor(a) for a in args))
    full2 = _full("port", L, L["trained2"])
    assert (ch < B).sum() >= 4
    before = _same_claims(start, jstart, L)
    after = _same_claims(tu, ju, L)
    assert _same_claims(tu, full2, L) == after > before


def _non_table_arrays(st):
    out = []
    for f in tmap.MapState._fields:
        v = getattr(st, f)
        if f != "tables":
            out += [a.numpy() for a in v] if isinstance(v, tuple) \
                else [v.numpy()]
    return out


def test_incremental_tables_match_full_rebuild_in_map_insert():
    """map_insert's incremental table update against a forced full
    rebuild (table_update_max 0) on the growth scan and one insert after
    it: equal states, equal claims."""
    cfg = case.compressor_config(tcfg, torch.float64)
    mc = case.mapping_config(tcfg)
    mc_full = dataclasses.replace(mc, table_update_max=0)
    sc = [tuple(T(a) for a in s) for s in case.scans()]
    st = tmap.map_init(cfg, mc, *case.BOX, dtype=torch.float64,
                       pending_capacity=case.PENDING, device="cpu")
    for k in (0, 1):
        st, _ = tmap.map_insert(st, *sc[k], cfg, mc, 1 if k == 0 else 30)
    inc, full = st, st
    for k in (2, 0):
        inc, i_inc = tmap.map_insert(inc, *sc[k], cfg, mc, 30)
        full, i_full = tmap.map_insert(full, *sc[k], cfg, mc_full, 30)
        assert {f: int(v) for f, v in i_inc.items()} \
            == {f: int(v) for f, v in i_full.items()}
        for a, b in zip(_non_table_arrays(inc), _non_table_arrays(full)):
            np.testing.assert_array_equal(a, b)
        probe = np.concatenate([s[0] for s in case.scans()]) + 0.05
        grid = inc.grid(0.3)
        ones = torch.ones(len(probe), dtype=torch.bool)
        ci = treg.claim_with_tables(inc.tables, grid, T(probe), ones, 0.3,
                                    out_fill=256)
        cf = treg.claim_with_tables(full.tables, grid, T(probe), ones, 0.3,
                                    out_fill=256)
        assert ci[2].double().mean() > 0.3
        for a, b in zip(ci, cf):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(inc.created.sum()) > int(st.created.sum())


# ---------------------------------------------------------------------------
# the stream in float32
# ---------------------------------------------------------------------------

def test_add_clouds_float32_matches_jax_statistically():
    """The moved scans' stream in float32 with registration. Float32
    claims near a clip boundary and deletion choices can differ, so the
    `realistic` rule's statistics: the same patch count within 1%, BV
    counts equal on > 90% of the patches both created, a median gap of
    the map's predicted points below 1 mm, registration steps within 2
    and the final translation within 1 mm of JAX's."""
    cfg_j = case.compressor_config(jcfg, jnp.float32)
    cfg_t = case.compressor_config(tcfg, torch.float32)
    mj, mt = case.mapping_config(jcfg), case.mapping_config(tcfg)
    sf, l2, s20 = case.CAL
    eps = cfg_j.depth_gp.eps_tol * sf / cfg_j.depth_gp.sigmaf_sq
    sc = case.moved_scans(np.float32)
    P, C, V = (np.stack([s[j] for s in sc]) for j in range(3))
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    jst, _, jsteps, jinfo = jmap.add_clouds(
        jmap.map_init(cfg_j, mj, *case.BOX, dtype=jnp.float32,
                      pending_capacity=case.PENDING),
        jnp.asarray(P), jnp.asarray(C), jnp.asarray(V), cfg_j, mj,
        jax.random.key(1), rcfg=case.registration_config(jcfg),
        depth_kp=JRBF(f32(sf), f32(l2)), depth_s20=f32(s20),
        depth_eps=f32(eps))
    t32 = lambda v: torch.tensor(v, dtype=torch.float32)
    tkp = TRBF(t32(sf), t32(l2))
    tst, _, tsteps, tinfo = tmap.add_clouds(
        tmap.map_init(cfg_t, mt, *case.BOX, dtype=torch.float32,
                      pending_capacity=case.PENDING, device="cpu"),
        T(P), T(C), T(V), cfg_t, mt, rcfg=case.registration_config(tcfg),
        depth_kp=tkp, depth_s20=t32(s20), depth_eps=t32(eps))
    nj, nt = int(jst.n_patches), int(tst.n_patches)
    assert abs(nj - nt) <= 0.01 * nj, (nj, nt)
    assert np.abs(tsteps.numpy() - np.asarray(jsteps)).max() <= 2
    assert np.abs(tst.t_cloud.numpy() - np.asarray(jst.t_cloud)).max() < 1e-3
    # patches by voxel: gp indices follow the order in which voxels were
    # first seen, which a registered pose a hair apart can change
    def by_key(st):
        n = int(st.n_patches)
        keys, ids = (np.asarray(st.leaf_keys)[:n],
                     np.asarray(st.leaf_ids)[:n])
        sizes = np.asarray(st.depth_gp.active).sum(1)
        created = np.asarray(st.created)
        return {int(k): sizes[g] for k, g in zip(keys, ids) if created[g]}

    kj, kt = by_key(jst), by_key(tst)
    both = kj.keys() & kt.keys()
    assert len(both) > 0.95 * len(kj), (len(both), len(kj), len(kt))
    same = np.mean([kj[k] == kt[k] for k in both])
    assert same > 0.9, same
    wj, _, okj = jmap.map_cloud(jst, cfg_j, depth_kp=JRBF(f32(sf), f32(l2)),
                                depth_s20=f32(s20))
    wt, _, okt = tmap.map_cloud(tst, cfg_t, depth_kp=tkp, depth_s20=t32(s20))
    ok = np.asarray(okj) & okt.numpy()
    gap = np.linalg.norm(wt.numpy()[ok] - np.asarray(wj)[ok], axis=1)
    assert np.median(gap) < 1e-3, np.median(gap)
    for k in tinfo:
        assert abs(int(tinfo[k].sum()) - int(jinfo[k].sum())) \
            <= max(2, 0.05 * int(jinfo[k].sum()))
