"""The port's registration against the JAX package, float64 on the CPU:
the rigid transforms, the kernel's input derivative, claims against a map
the JAX package built (carried across by io/convert), the closed-form
density gradients (against JAX and against a torch.func autodiff oracle),
one gradient evaluation, and the whole register loop in both step modes
and both re-claim cadences; then one float32 register case."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.geometry import transforms as jtf
from gp_compressor_tpu.geometry import voxel as jvoxel
from gp_compressor_tpu.ops import kernels as jkern
from gp_compressor_tpu.ops.kernels import RBFParams as JRBF
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu.workloads import registration as jreg
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.geometry import transforms as ttf
from gp_compressor_tpu_torch.geometry import voxel as tvoxel
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.models import sparse_gp as tsg
from gp_compressor_tpu_torch.ops import kernels as tkern
from gp_compressor_tpu_torch.ops.kernels import RBFParams as TRBF
from gp_compressor_tpu_torch.workloads import compressor as tcomp
from gp_compressor_tpu_torch.workloads import registration as treg

torch.set_num_threads(1)

T = torch.from_numpy


def test_transforms_match_jax():
    r = np.random.default_rng(0)
    a = r.uniform(-0.3, 0.3, 3)
    x = r.standard_normal(3)
    P = r.standard_normal((50, 3))
    for f, arg in (("rot_x", a[0]), ("rot_y", a[1]), ("rot_z", a[2]),
                   ("euler_xyz", a), ("transform_jacobian", x)):
        j = np.asarray(getattr(jtf, f)(jnp.asarray(arg)))
        t = getattr(ttf, f)(torch.tensor(arg)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-12)
    R = np.array(jtf.euler_xyz(jnp.asarray(a)))
    R2 = np.array(jtf.euler_xyz(jnp.asarray(-2 * a)))
    np.testing.assert_allclose(ttf.matmul3(T(R), T(R2)).numpy(),
                               np.asarray(jtf.matmul3(R, R2)), atol=1e-12)
    np.testing.assert_allclose(ttf.apply(T(P), T(R), T(x)).numpy(),
                               np.asarray(jtf.apply(jnp.asarray(P), R, x)),
                               atol=1e-12)
    np.testing.assert_allclose(float(ttf.rotation_angle(T(R))),
                               float(jtf.rotation_angle(R)), atol=1e-12)
    # registration_error on a known perturbation
    t_true = np.array([0.01, -0.02, 0.005])
    R_est = R.T + 1e-4
    je = jreg.registration_error(R_est, -t_true + 1e-3, R, t_true)
    te = treg.registration_error(T(R_est), T(-t_true + 1e-3), T(R), T(t_true))
    for u, v in zip(te, je):
        np.testing.assert_allclose(float(u), float(v), atol=1e-12)


def test_gram_dx_matches_jax_batched():
    r = np.random.default_rng(1)
    X, Z = r.uniform(-0.1, 0.1, (3, 7, 2)), r.uniform(-0.1, 0.1, (3, 5, 2))
    jp = JRBF(jnp.asarray(1e-2), jnp.asarray(4e-3))
    tp = TRBF(torch.tensor(1e-2, dtype=torch.float64),
              torch.tensor(4e-3, dtype=torch.float64))
    j = np.stack([np.asarray(jkern.gram_dx(jp, jnp.asarray(x), jnp.asarray(z)))
                  for x, z in zip(X, Z)])
    np.testing.assert_allclose(tkern.gram_dx(tp, T(X), T(Z)).numpy(), j,
                               atol=1e-12 * np.abs(j).max())


def _cfg(m, dtype):
    """A small map: res 0.3 patches of 64 points and 16 slots; the depth
    GP at well-conditioned centimetre-scale constants, so that the
    predictive variance does not cancel (at the reference constants it
    carries ~1e-6 relative float64 noise, tests/test_registration.py)."""
    return m.CompressorConfig(
        patch=m.PatchConfig(res=0.3, sz=10, max_patches=256,
                            max_points_per_patch=64,
                            approx_sphere_moments=True,
                            bank_order="center_out"),
        depth_gp=m.GPConfig(capacity=14, slots=16, sigmaf_sq=1e-2, l_sq=1e-2,
                            s20=1e-3, eps_tol=2e-4, dtype=dtype),
        rgb_gp=dataclasses.replace(m.rgb_gp_config(slots=16, capacity=14),
                                   eps_tol=2.0, dtype=dtype))


JCFG = _cfg(jcfg, jnp.float64)
TCFG = _cfg(tcfg, torch.float64)
T_TRUE = np.array([0.02, -0.015, 0.01])
ROTVEC = [0.0, 0.01, -0.008]


def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


@functools.lru_cache(maxsize=None)
def _setup(f64=True):
    """A JAX-built map of half a room cloud and the other half as a scan,
    perturbed by a known small motion: (JAX map, port map, scan arrays)."""
    npdt = np.float64 if f64 else np.float32
    pts, cols = synthetic.room_cloud(n=6000, seed=4)
    mpts, mcols = pts[:3000].astype(npdt), cols[:3000].astype(npdt)
    spts, _ = synthetic.rigid_transform(pts[3000:].astype(np.float64),
                                        ROTVEC, T_TRUE)
    scan = (spts.astype(npdt), cols[3000:].astype(npdt),
            np.ones(3000, bool), pts[3000:].astype(np.float64))
    cfg = JCFG if f64 else _cfg(jcfg, jnp.float32)
    jc = jcomp.compress(jnp.asarray(mpts), jnp.asarray(mcols),
                        jnp.ones(3000, bool), cfg, jax.random.key(0))
    return jc, convert.compressed_from_numpy(_asdict(jc), device="cpu"), scan


@pytest.mark.parametrize("table", [True, False], ids=["tables", "27-pass"])
def test_claims_match_jax_exactly(table):
    jc, tc, (spts, _, valid, _) = _setup()
    if not table:
        jc = jc._replace(patch=jc.patch._replace(
            grid=jc.patch.grid._replace(table=None)))
        tc = tc._replace(patch=tc.patch._replace(
            grid=tc.patch.grid._replace(table=None)))
    jout = jax.jit(jreg._claim_to_map, static_argnums=(3,))(
        jc, jnp.asarray(spts), jnp.asarray(valid), JCFG,
        jreg._map_claim_tables(jc))
    tout = treg._claim_to_map(tc, T(spts), T(valid), TCFG,
                              treg._map_claim_tables(tc))
    claimed = np.asarray(jout[2])
    assert claimed.mean() > 0.5
    np.testing.assert_array_equal(tout[2].numpy(), claimed)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               atol=1e-12)
    if not table:
        # the 27-pass fallback claims what the tables claim
        full = _setup()[1]
        via = treg._claim_to_map(full, T(spts), T(valid), TCFG,
                                 treg._map_claim_tables(full))
        for a, b in zip(via, tout):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    if table:
        # the JAX tables carried across claim the same (cell_row is not
        # compared: duplicate writers leave any of several equal rows)
        jt = jreg._map_claim_tables(jc)
        tt = convert.claim_tables_from_numpy(_asdict(jt), device="cpu")
        got = treg.claim_with_tables(tt, tc.patch.grid, T(spts), T(valid),
                                     0.3, out_fill=256)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jout[0]))
        ours = treg._map_claim_tables(tc)
        for f in ("prio", "gid", "R12", "nm"):
            np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                          np.asarray(getattr(jt, f)))


def test_claim_table_rows_match_jax_exactly():
    """The dense tables' row content, for the map's dilated leaf cells
    (some switched off, some out of the grid), looked up through the dense
    cell table."""
    jc, tc, _ = _setup()
    g = tc.patch.grid
    n = int(g.n_leaves)
    leaf3 = tvoxel.delinearize(g.keys[:n], g.dims)
    offs = torch.tensor([(1, 0, 0), (0, -1, 0), (-1, -1, 1)],
                        dtype=torch.int32)
    cells3 = (leaf3[:, None, :] + offs[None]).reshape(-1, 3)
    ok = torch.from_numpy(np.random.default_rng(3).uniform(
        size=cells3.shape[0]) > 0.1)
    trained = tsg.size(tc.depth_gp) > 0
    args_t = (cells3, ok, g.table, trained, tc.patch.rotations, g.dims)
    jt = jax.jit(jreg._claim_table_rows)(
        *(jnp.asarray(a.numpy()) for a in args_t))
    tt = treg._claim_table_rows(*args_t)
    assert (np.asarray(jt[0]) != jvoxel._FILL).mean() > 0.05
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _banks(tc, spts, scols, valid):
    """The scan's registration banks, built by the port (the gradient tests
    feed the same arrays to JAX)."""
    B, P = 256, 64
    claim, loc, claimed = treg._claim_to_map(tc, T(spts), T(valid), TCFG)
    Xb, Cb, Mb = treg._bank_points(claim, loc, T(scols), claimed, B, P)
    Cb = torch.where(Mb[..., None], Cb - tc.patch.rgb_means[:, None, :], 0.0)
    return Xb, Cb, Mb


def _oracle(kp, s20, states, Xb, vals, mask, color):
    """Autodiff gradient and value of the predictive density per point
    (the JAX package's _depth/_color_density_grads), by torch.func."""
    def density(uv, v, st):
        mean, var = tsg.predict(kp, s20, st, uv[None])
        if color:
            lp = torch.sum(-0.5 * torch.log(2 * math.pi * var)
                           - 0.5 * (v - mean[0]) ** 2 / var)
        else:
            lp = -0.5 * torch.log(2 * math.pi * var[0]) \
                - 0.5 * (v[0] - mean[0, 0]) ** 2 / var[0]
        return torch.exp(lp)

    per_point = torch.func.vmap(torch.func.grad_and_value(
        density, argnums=(0, 1)), in_dims=(0, 0, None))
    (duv, dv), val = torch.func.vmap(per_point)(Xb[..., 1:], vals, states)
    dy = torch.zeros_like(dv[..., :1]) if color else dv
    out = torch.cat([dy, duv], dim=-1)
    return (torch.where(mask[..., None], out, 0.0),
            torch.where(mask, val, 0.0))


def test_density_grads_match_jax_and_autodiff():
    jc, tc, (spts, scols, valid, _) = _setup()
    Xb, Cb, Mb = _banks(tc, spts, scols, valid)
    assert int(Mb.sum()) > 1000
    for gp, vals, color in (("depth_gp", Xb[..., :1], False),
                            ("rgb_gp", Cb, True)):
        g = getattr(JCFG, gp)
        jkp = JRBF(jnp.asarray(g.sigmaf_sq), jnp.asarray(g.l_sq))
        tkp = TRBF(torch.tensor(g.sigmaf_sq, dtype=torch.float64),
                   torch.tensor(g.l_sq, dtype=torch.float64))
        j = jreg._density_grads_closed(
            jkp, g.s20, getattr(jc, gp), jnp.asarray(Xb.numpy()),
            jnp.asarray(vals.numpy()), jnp.asarray(Mb.numpy()), zero_y=color)
        t = treg._density_grads_closed(tkp, g.s20, getattr(tc, gp), Xb, vals,
                                       Mb, zero_y=color)
        o = _oracle(tkp, g.s20, getattr(tc, gp), Xb, vals, Mb, color)
        for a, b, c in zip(t, j, o):
            scale = np.abs(np.asarray(b)).max()
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=1e-10 * scale)
            np.testing.assert_allclose(a.numpy(), c.numpy(),
                                       atol=1e-8 * scale)


@pytest.mark.parametrize("blend", ["alpha", "likelihood"])
def test_gradient_step_matches_jax(blend):
    """compute_transformation from scratch, and _bank_step on the banked
    world points, against JAX."""
    jc, tc, (spts, scols, valid, _) = _setup()
    rj = jcfg.RegistrationConfig(blend_mode=blend, color_blend=0.7)
    rt = tcfg.RegistrationConfig(blend_mode=blend, color_blend=0.7)
    args = (jnp.asarray(spts), jnp.asarray(scols), jnp.asarray(valid))
    jd = jax.jit(jreg.compute_transformation, static_argnums=(4, 5))(
        jc, *args, JCFG, rj)
    td = treg.compute_transformation(tc, T(spts), T(scols), T(valid), TCFG, rt)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)

    B, P = 256, 64
    claim, _, claimed = treg._claim_to_map(tc, T(spts), T(valid), TCFG)
    Wb, Cb, Mb = treg._bank_points(claim, T(spts), T(scols), claimed, B, P)
    Cb = torch.where(Mb[..., None], Cb - tc.patch.rgb_means[:, None, :], 0.0)
    centers = tvoxel.voxel_centers(tc.patch.grid)[:B]
    dkp, ckp = tcomp.default_params(TCFG, device="cpu")
    tb = treg._bank_step(tc, TCFG, rt, dkp, ckp, Wb, Cb, Mb, centers)
    jkp = jcomp.default_params(JCFG)
    jb = jax.jit(jreg._bank_step, static_argnums=(1, 2))(
        jc, JCFG, rj, *jkp, *(jnp.asarray(a.numpy()) for a in (Wb, Cb, Mb)),
        jvoxel.voxel_centers(jc.patch.grid)[:B])
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)


def _register_pair(rkw, jc, tc, spts, scols, valid, jinit=None, tinit=None):
    rj = jcfg.RegistrationConfig(**rkw)
    rt = tcfg.RegistrationConfig(**rkw)
    jst, jpts = jax.jit(jreg.register, static_argnames=("cfg", "rcfg"))(
        jc, jnp.asarray(spts), jnp.asarray(scols), jnp.asarray(valid),
        cfg=JCFG if spts.dtype == np.float64 else _cfg(jcfg, jnp.float32),
        rcfg=rj, init=jinit)
    tst, tpts = treg.register(
        tc, T(spts), T(scols), T(valid),
        TCFG if spts.dtype == np.float64 else _cfg(tcfg, torch.float32),
        rt, init=tinit)
    return jst, jpts, tst, tpts


REGISTER_CASES = {
    "fixed_every1": dict(step=0.01, max_steps=16, reclaim_every=1,
                         max_motion=0.004),
    "fixed_every4": dict(step=2e-4, max_steps=16, reclaim_every=4,
                         grad_tol_step_ref=0.1),
    "rprop_every1": dict(step_mode="rprop", max_steps=30, reclaim_every=1,
                         bank_points=48),
    "rprop_every4": dict(step_mode="rprop", max_steps=30, reclaim_every=4),
}


@pytest.mark.parametrize("case", list(REGISTER_CASES))
def test_register_matches_jax(case):
    jc, tc, (spts, scols, valid, truth) = _setup()
    jst, jpts, tst, tpts = _register_pair(REGISTER_CASES[case], jc, tc, spts,
                                          scols, valid)
    assert int(tst.step_nbr) == int(jst.step_nbr) > 10
    for f in ("R_cloud", "t_cloud", "t_exact", "delta"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), atol=1e-9)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-9)
    err0 = np.linalg.norm(spts - truth, axis=1).mean()
    err1 = np.linalg.norm(tpts.numpy() - truth, axis=1).mean()
    assert err1 < err0
    if case == "fixed_every4":
        # resume from the JAX state carried across: same as JAX resuming
        rkw = dict(REGISTER_CASES[case], max_steps=24)
        jst2, jpts2, tst2, tpts2 = _register_pair(
            rkw, jc, tc, spts, scols, valid, jinit=jst,
            tinit=convert.registration_state_from_numpy(_asdict(jst),
                                                        device="cpu"))
        assert int(tst2.step_nbr) == int(jst2.step_nbr) > int(jst.step_nbr)
        np.testing.assert_allclose(tst2.R_cloud.numpy(),
                                   np.asarray(jst2.R_cloud), atol=1e-9)
        np.testing.assert_allclose(tpts2.numpy(), np.asarray(jpts2),
                                   atol=1e-9)
        # a resumed state past min_steps whose last gradient already meets
        # the stop test ends at entry, as the JAX loop's first test does
        still = jst._replace(delta=jnp.zeros_like(jst.delta))
        jst3, _, tst3, _ = _register_pair(
            rkw, jc, tc, spts, scols, valid, jinit=still,
            tinit=convert.registration_state_from_numpy(_asdict(still),
                                                        device="cpu"))
        assert int(tst3.step_nbr) == int(jst3.step_nbr) == int(jst.step_nbr)


def test_register_float32_matches_jax():
    jc, tc, (spts, scols, valid, truth) = _setup(f64=False)
    rkw = dict(step_mode="rprop", max_steps=30)
    jst, jpts, tst, tpts = _register_pair(rkw, jc, tc, spts, scols, valid)
    assert abs(int(tst.step_nbr) - int(jst.step_nbr)) <= 2
    ej = np.linalg.norm(np.asarray(jpts) - truth, axis=1).mean()
    et = np.linalg.norm(tpts.numpy() - truth, axis=1).mean()
    assert abs(et - ej) <= 0.1 * ej, (et, ej)


def test_register_reads_once_per_step(monkeypatch):
    """The loop reads the step counter once at entry and one stop flag per
    step; nothing else converts a tensor to a Python value."""
    import importlib
    counter = importlib.import_module("test_torch_calibration")._count_reads
    _, tc, (spts, scols, valid, _) = _setup()
    rt = tcfg.RegistrationConfig(step_mode="rprop", max_steps=14)
    reads = counter(monkeypatch)
    st, _ = treg.register(tc, T(spts), T(scols), T(valid), TCFG, rt)
    monkeypatch.undo()
    assert len(reads) == 1 + int(st.step_nbr), reads


# ---- against the plain reference of the source's loop
# (portbench/reference/workloads/registration_source.py): a map built by
# the port's mapping insert from the small mapping case's first scan at its
# calibrated-style values, and its moved second scan on every 2nd point


@functools.lru_cache(maxsize=None)
def _source_case(dtype=torch.float64):
    from gp_compressor_tpu_torch.testing import mapping_case as case
    from gp_compressor_tpu_torch.workloads import mapping as tmap
    from portbench.harness import map_compare
    cfg = case.compressor_config(tcfg, dtype)
    mcfg = case.mapping_config(tcfg)
    kp = TRBF(*(torch.tensor(v, dtype=dtype) for v in case.CAL[:2]))
    s20 = torch.tensor(case.CAL[2], dtype=dtype)
    st = tmap.map_init(cfg, mcfg, *case.BOX, dtype=dtype,
                       pending_capacity=case.PENDING, device="cpu")
    scans = [tuple(T(a) for a in s) for s in case.moved_scans()]
    st, _ = tmap.map_insert(st, *[a.to(dtype) if a.is_floating_point()
                                  else a for a in scans[0]], cfg, mcfg, 1,
                            depth_kp=kp, depth_s20=s20)
    p, c, v = (a[::2] for a in scans[1])
    ref = map_compare.registration_map(map_compare.as_map(st),
                                       cfg.patch.res, kp, s20)
    return st, cfg, kp, s20, (p.to(dtype), c.to(dtype), v), ref


def _register_map(st, cfg, kp, s20, scan, rcfg):
    from gp_compressor_tpu_torch.workloads import mapping as tmap
    view, tables = tmap.registration_view(st, cfg)
    return treg.register(view, *scan, cfg, rcfg, depth_kp=kp,
                         depth_s20=s20, tables=tables)


# float64: rounding alone (1.2e-15 measured); float32: the sums over
# ~1,300 points' contributions in float32, which the two codes add in other
# orders (7.8e-7 measured)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_gradient_matches_source_reference(dtype, tol):
    """The first step's twist gradient: claims, banks, the closed-form
    density gradient and the twist mean against the reference's claims,
    banks and autograd of the density."""
    from portbench.reference.workloads import registration_source as rs
    st, cfg, kp, s20, scan, ref = _source_case(dtype)
    one = tcfg.RegistrationConfig(step_mode="rprop", min_steps=0,
                                  max_steps=1, bank_points=32)
    got, _ = _register_map(st, cfg, kp, s20, scan, one)
    want, n = rs.twist_gradient(scan[0], scan[2], ref, 32)
    assert n > 1000
    gap = torch.linalg.norm(got.delta.double() - want.double()) \
        / torch.linalg.norm(want.double())
    assert float(gap) <= tol, float(gap)


def test_register_loop_matches_source_reference():
    """The whole loop under the source's stop rule (more than 10 steps,
    then convergence or the cap of 300) and the iRprop- step, float64: the
    same steps and the same pose to 1e-9."""
    from portbench.reference.workloads import registration_source as rs
    st, cfg, kp, s20, scan, ref = _source_case()
    rcfg = tcfg.RegistrationConfig(step_mode="rprop", min_steps=10,
                                   max_steps=300, bank_points=32)
    got, _ = _register_map(st, cfg, kp, s20, scan, rcfg)
    R, t, steps = rs.register(scan[0], scan[2], ref, rs.Rule(
        min_steps=10, max_steps=300, eta0=rcfg.rprop_eta0,
        eta_min=rcfg.rprop_eta_min, eta_max=rcfg.rprop_eta_max,
        tol=rcfg.rprop_tol, reclaim_every=rcfg.reclaim_every,
        bank_points=32))
    assert 10 < int(got.step_nbr) == steps < 300
    np.testing.assert_allclose(got.R_cloud.numpy(), R.numpy(), atol=1e-9)
    np.testing.assert_allclose(got.t_exact.numpy(), t.numpy(), atol=1e-9)
