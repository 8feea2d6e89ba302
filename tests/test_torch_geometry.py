"""Port front end (voxel grid, plane fits, claiming, banks) against the
JAX package on a small room cloud, float32 inputs on both sides.

The JAX functions run under jit, as the main path runs them: XLA folds a
division by a constant voxel edge into a multiplication by its reciprocal
and contracts a*b+c into FMAs, so eager JAX is not the reference. The
voxel grid must agree exactly; quantities that pass through FMA-contracted
or differently ordered float sums agree to the stated tolerances."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu.config import PatchConfig as JPatchConfig
from gp_compressor_tpu.geometry import patches as jpatches
from gp_compressor_tpu.geometry import rotation as jrot
from gp_compressor_tpu.geometry import voxel as jvoxel
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu_torch.config import PatchConfig as TPatchConfig
from gp_compressor_tpu_torch.geometry import patches as tpatches
from gp_compressor_tpu_torch.geometry import rotation as trot
from gp_compressor_tpu_torch.geometry import voxel as tvoxel

torch.set_num_threads(1)

N = 4000
KW = dict(res=0.3, sz=10, max_patches=512, max_points_per_patch=64,
          bank_order="center_out")


@functools.lru_cache(maxsize=None)
def _cloud():
    pts, cols = synthetic.room_cloud(n=N, seed=0)
    valid = np.random.default_rng(1).uniform(size=N) > 0.02
    return pts, cols, valid


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid_pair(max_cells):
    pts, _, valid = _cloud()
    jg = jax.jit(jvoxel.build_grid, static_argnums=(2, 3, 4))(
        _j(pts), _j(valid), 0.3, 512, max_cells)
    tg = tvoxel.build_grid(_t(pts), _t(valid), 0.3, 512, max_cells)
    return jg, tg


@pytest.mark.parametrize("max_cells", [1 << 20, 64, 0],
                         ids=["dense", "sorted+table", "sorted"])
def test_build_grid_matches_jax_exactly(max_cells):
    jg, tg = _grid_pair(max_cells)
    np.testing.assert_array_equal(tg.keys.numpy(), np.asarray(jg.keys))
    assert int(tg.n_leaves) == int(jg.n_leaves) > 100
    np.testing.assert_array_equal(tg.dims.numpy(), np.asarray(jg.dims))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    if max_cells:
        np.testing.assert_array_equal(tg.table.numpy(), np.asarray(jg.table))
    else:
        assert tg.table is None and jg.table is None
    # every point's home voxel and its neighbours resolve to the same leaf
    pts, _, _ = _cloud()
    lk = jax.jit(lambda g, p, off: jvoxel.lookup(g, jvoxel.linearize(
        jvoxel.point_keys(p, g.origin, g.res) + off, g.dims)))
    for off in [(0, 0, 0), (1, -1, 0), (-1, 1, 1)]:
        ji, je = lk(jg, _j(pts), jnp.asarray(off, jnp.int32))
        keys3 = tvoxel.point_keys(_t(pts), tg.origin, tg.res) \
            + torch.tensor(off, dtype=torch.int32)
        ti, te = tvoxel.lookup(tg, tvoxel.linearize(keys3, tg.dims))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(ti.numpy()[te.numpy()],
                                      np.asarray(ji)[np.asarray(je)])


def test_jacobi_eigh_matches_jax_f64():
    r = np.random.default_rng(5)
    A = r.standard_normal((64, 4, 4))
    M = A @ A.transpose(0, 2, 1) * np.logspace(-6, 4, 64)[:, None, None]
    M[:, :, 3] *= 1e2
    M[:, 3, :] *= 1e2
    jw, jV = jax.jit(jrot.jacobi_eigh_batch)(_j(M))
    tw, tV = trot.jacobi_eigh_batch(_t(M))
    assert tw.dtype == torch.float64
    scale = np.abs(M).max(axis=(1, 2))
    np.testing.assert_allclose(tw.numpy() / scale[:, None],
                               np.asarray(jw) / scale[:, None], atol=1e-10)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), atol=1e-10)


def test_frame_from_normal_matches_jax():
    r = np.random.default_rng(2)
    n = r.standard_normal((200, 3))
    n[:10] = [[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [-1, -1, 0],
              [0, 0, -1], [0, -1, 0], [-1, 0, 0], [2, -2, 1], [1, -1, -1]]
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    jR = jax.jit(jax.vmap(jrot.frame_from_normal))(_j(n))
    tR = trot.frame_from_normal(_t(n))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6)


@pytest.mark.parametrize("approx", [True, False], ids=["octant", "exact"])
def test_sphere_moments_and_rotations_match_jax(approx):
    pts, _, valid = _cloud()
    jcfg = JPatchConfig(**KW, approx_sphere_moments=approx)
    tcfg = TPatchConfig(**KW, approx_sphere_moments=approx)

    @jax.jit
    def jfn(p, v):
        g = jvoxel.build_grid(p, v, jcfg.res, jcfg.max_patches, jcfg.max_cells)
        M, c = jpatches.sphere_moments(g, p, v, jcfg)
        return M, c, jrot.rotation_from_moment_batch(M, c).astype(p.dtype)

    jM, jc, jR = jfn(_j(pts), _j(valid))
    tg = tvoxel.build_grid(_t(pts), _t(valid), tcfg.res, tcfg.max_patches,
                           tcfg.max_cells)
    tM, tc = tpatches.sphere_moments(tg, _t(pts), _t(valid), tcfg)
    assert tM.dtype == torch.float64 and jM.dtype == np.float64
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=1e-9,
                               atol=1e-9)
    tR = trot.rotation_from_moment_batch(tM, tc).float()
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)


@functools.lru_cache(maxsize=None)
def _patch_pair(approx):
    pts, cols, valid = _cloud()
    jcfg = JPatchConfig(**KW, approx_sphere_moments=approx)
    tcfg = TPatchConfig(**KW, approx_sphere_moments=approx)
    jb = jax.jit(jpatches.build_patches, static_argnums=(3,))(
        _j(pts), _j(cols), _j(valid), jcfg)
    tb = tpatches.build_patches(_t(pts), _t(cols), _t(valid), tcfg)
    return jb, tb


@pytest.mark.parametrize("approx", [True, False], ids=["octant", "exact"])
def test_claims_match_jax(approx):
    jb, tb = _patch_pair(approx)
    jc, tc = np.asarray(jb.claims), tb.claims.numpy()
    assert (jc == tc).mean() >= 0.999, (jc != tc).sum()
    assert (tc >= 0).mean() > 0.9
    assert int(tb.n_leaves) == int(jb.n_leaves)
    np.testing.assert_allclose(tb.rotations.numpy(), np.asarray(jb.rotations),
                               atol=1e-5)


@pytest.mark.parametrize("approx", [True, False], ids=["octant", "exact"])
def test_build_patches_banks_match_jax(approx):
    """Banks agree at atol 1e-5 on every patch whose claimed point set is
    the same. The per-patch depth and colour means are compared apart:
    JAX takes them from float32 prefix sums over the whole sorted cloud
    (rounding ~ log2(N) eps32 |sum| / count), the port from float64 ones."""
    jb, tb = _patch_pair(approx)
    # the training kernel takes contiguous banks
    assert all(t.is_contiguous() for t in (tb.X, tb.y, tb.rgb, tb.mask))
    jc, tc = np.asarray(jb.claims), tb.claims.numpy()
    B = jb.mask.shape[0]
    differ = np.zeros(B + 1, bool)
    differ[np.where(jc != tc, jc, B)] = True
    differ[np.where(jc != tc, tc, B)] = True
    same = ~differ[:B] & (np.asarray(jb.counts) > 0)
    assert same.sum() > 100
    np.testing.assert_array_equal(tb.counts.numpy()[same],
                                  np.asarray(jb.counts)[same])
    np.testing.assert_array_equal(tb.mask.numpy()[same],
                                  np.asarray(jb.mask)[same])
    mask = tb.mask.numpy()[same]
    np.testing.assert_allclose(tb.X.numpy()[same][mask],
                               np.asarray(jb.X)[same][mask], atol=1e-5)

    # per-patch colour means: within the JAX prefix sums' f32 rounding
    _, cols, _ = _cloud()
    cnt = np.maximum(np.asarray(jb.counts), 1)[same]
    bound = 2 * np.log2(N) * np.finfo(np.float32).eps \
        * np.abs(cols).sum(0).max() / cnt
    dmean = np.abs(tb.rgb_means.numpy() - np.asarray(jb.rgb_means))[same]
    assert (dmean.max(axis=1) <= bound).all(), (dmean.max(), bound.min())
    # banks with the patch means added back: the raw payload
    for tname, mname in (("rgb", "rgb_means"), ("y", None)):
        tv = getattr(tb, tname).numpy()[same]
        jv = np.asarray(getattr(jb, tname))[same]
        if mname is None:      # depth mean = offset of `means` along normal
            centers = np.asarray(jax.jit(jvoxel.voxel_centers)(jb.grid))
            nrm = np.asarray(jb.rotations)[:, :, 0]
            tm = np.sum((tb.means.numpy() - centers) * nrm, -1)[same]
            jm = np.sum((np.asarray(jb.means) - centers) * nrm, -1)[same]
            tv, jv = tv + tm[:, None, None], jv + jm[:, None, None]
            atol = 1e-5
        else:
            tv = tv + getattr(tb, mname).numpy()[same][:, None, :]
            jv = jv + np.asarray(getattr(jb, mname))[same][:, None, :]
            atol = 1e-5 + 255 * np.finfo(np.float32).eps
        np.testing.assert_allclose(tv[mask], jv[mask], atol=atol)
    W_agree = (tb.W.numpy() == np.asarray(jb.W))[same].mean()
    assert W_agree >= 0.999, W_agree


def test_prediction_grid_and_reproject_match_jax():
    jb, tb = _patch_pair(True)
    jcfg, tcfg = JPatchConfig(**KW), TPatchConfig(**KW)
    jg = jax.jit(jpatches.prediction_grid, static_argnums=(0, 1))(
        jcfg, jnp.float32)
    tg = tpatches.prediction_grid(tcfg, torch.float32, device="cpu")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    depth = np.random.default_rng(3).uniform(
        -0.1, 0.1, size=(jb.mask.shape[0], jg.shape[0])).astype(np.float32)
    jw = jax.jit(jpatches.reproject)(jb, _j(depth), jg)
    # the JAX batch's frames and means, so that only reproject is compared
    tb = tb._replace(rotations=_t(jb.rotations), means=_t(jb.means))
    tw = tpatches.reproject(tb, _t(depth), tg)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


def test_unported_front_end_paths_raise():
    """No front-end path is left unported: every bank order builds
    (tests/test_torch_bank_order.py holds them to JAX); a bank order that
    neither package has raises."""
    pts, cols, valid = _cloud()
    for order in ("shuffle", "edge_in", "far_center"):
        cfg = TPatchConfig(**dict(KW, bank_order=order))
        tpatches.build_patches(_t(pts), _t(cols), _t(valid), cfg)
    with pytest.raises(ValueError):
        tpatches.build_patches(_t(pts), _t(cols), _t(valid),
                               TPatchConfig(**dict(KW, bank_order="spiral")))


def test_raster_patches_claim_like_build_patches():
    """The raster (K-SVD) patches build on the same leaves and claims as
    the GP patches (tests/test_torch_ksvd_compressor.py holds them to
    JAX)."""
    pts, cols, valid = _cloud()
    cfg = TPatchConfig(**KW)
    tb = tpatches.build_patches(_t(pts), _t(cols), _t(valid), cfg)
    rb = tpatches.build_raster_patches(_t(pts), _t(cols), _t(valid), cfg)
    assert int(rb.n_leaves) == int(tb.n_leaves)
    np.testing.assert_array_equal(rb.claims.numpy(), tb.claims.numpy())
