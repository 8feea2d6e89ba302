"""The port's K-SVD compression workload against the JAX package on the
CPU, float64 (x64 on).

A 6k-point room cloud at res 0.3, sz 10 (tests/test_dictionary.py's
pipeline case): the raster patches of jitted JAX `build_raster_patches`
and the port's (claims and cells equal, images and means within 1e-9),
`raster_reproject` on the same raster, the quaternion pair (random
rotations, each of the four pivot cases, a rotation by nearly pi), then
the whole compress -> decompress pipeline and the in-sample RMS with the
random data rows JAX's keys draw fed to the port (sweep counts equal,
dictionaries, codes and points within 1e-9). The artifact: the port's
copy of the NumPy artifact module writes byte-identical files, and the
port's to_artifact of a JAX-built KSVDCompressed carried across
(io/convert) writes the same bytes as JAX's; a file read back decompresses
to the in-memory points within 1e-4 m.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.geometry import patches as jpatches
from gp_compressor_tpu.geometry import rotation as jrot
from gp_compressor_tpu.io import artifact as jart
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu.workloads import ksvd_compressor as jksvd
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.geometry import patches as tpatches
from gp_compressor_tpu_torch.geometry import rotation as trot
from gp_compressor_tpu_torch.io import artifact as tart
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.workloads import ksvd_compressor as tksvd

from test_torch_dictionary import jax_draws

torch.set_num_threads(1)

T = torch.from_numpy
ATOL = 1e-9
N = 6000


def _cfg(m, max_iters=8):
    return m.CompressorConfig(
        patch=m.PatchConfig(res=0.3, sz=10, max_patches=512,
                            max_points_per_patch=256),
        ksvd=m.KSVDConfig(dict_size=40, words_max=6, proj_error=1e-4,
                          stop_diff=1e-4, max_iters=max_iters, atom_block=16),
        rgb_ksvd=m.KSVDConfig(dict_size=60, words_max=8, proj_error=1e-1,
                              stop_diff=1e-1, max_iters=max_iters,
                              atom_block=16))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)


def _asdict(nt):
    if dataclasses.is_dataclass(nt):
        return dataclasses.asdict(nt)
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


@functools.lru_cache(maxsize=None)
def _cloud():
    pts, cols = synthetic.room_cloud(n=N, seed=5)
    valid = np.random.default_rng(1).uniform(size=N) > 0.02
    return pts.astype(np.float64), cols.astype(np.float64), valid


@functools.lru_cache(maxsize=None)
def _rasters():
    pts, cols, valid = _cloud()
    jr = jax.jit(jpatches.build_raster_patches, static_argnums=3)(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), JCFG.patch)
    tr = tpatches.build_raster_patches(T(pts), T(cols), T(valid), TCFG.patch)
    return jr, tr


def test_raster_patches_match_jax():
    jr, tr = _rasters()
    assert int(tr.n_leaves) == int(jr.n_leaves) > 100
    for f in ("claims", "cells"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    assert (tr.claims.numpy() >= 0).mean() > 0.9
    np.testing.assert_array_equal(tr.W.numpy(), np.asarray(jr.W))
    assert 0.1 < tr.W.numpy()[:int(tr.n_leaves)].mean() < 0.9
    for f in ("S", "RGB", "means", "rgb_means", "rotations",
              "depth_demeaned"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=ATOL,
                                   err_msg=f)
    # the reference's quirk: each patch is demeaned over all sz^2 cells,
    # the empty ones included (so occupied cells need not average 0)
    S = tr.S.numpy()[:int(tr.n_leaves)]
    np.testing.assert_allclose(S.mean(1), 0.0, atol=1e-12)


def test_raster_reproject_matches_jax():
    """Random depth and colour images on JAX's raster carried across, with
    non-finite and out-of-range colours (255, then clamped)."""
    jr, _ = _rasters()
    fields = {f: T(np.array(getattr(jr, f))) for f in
              tpatches.RasterBatch._fields if f != "grid"}
    tr = tpatches.RasterBatch(grid=None, **fields)
    B, G = jr.S.shape
    r = np.random.default_rng(2)
    S_rec = 0.05 * r.standard_normal((B, G))
    RGB_rec = 200.0 * r.standard_normal((B, G, 3))
    RGB_rec[0, :3, 0] = [np.nan, np.inf, -np.inf]
    jout = jpatches.raster_reproject(jr, jnp.asarray(S_rec),
                                     jnp.asarray(RGB_rec), 10, 0.3)
    tout = tpatches.raster_reproject(tr, T(S_rec), T(RGB_rec), 10, 0.3)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    cols = tout[1].numpy()
    assert cols.min() == 0.0 and cols.max() == 255.0
    assert (cols.reshape(B, G, 3)[0, :2, 0] == 255.0).all()


def _rotations():
    """Random rotations, one rotation for each pivot case of the Shepperd
    construction (trace large; m00, m11, m22 dominant: rotations by ~pi
    about x, y, z), and a rotation by pi - 1e-6 about a skew axis."""
    r = np.random.default_rng(3)
    q = r.standard_normal((40, 4))
    Rs = list(np.asarray(jax.vmap(jrot.quaternion_to_matrix)(jnp.asarray(q))))
    for axis in (None, 0, 1, 2):
        ang = 0.3 if axis is None else np.pi - 0.2
        k = np.array([0.2, 0.3, 0.9]) if axis is None else np.eye(3)[axis]
        k = k / np.linalg.norm(k)
        Rs.append(synthetic.rigid_transform(np.eye(3), k * ang, 0)[1])
    k = np.array([0.6, -0.48, 0.64])
    Rs.append(synthetic.rigid_transform(np.eye(3), k * (np.pi - 1e-6), 0)[1])
    return np.stack(Rs)


def test_quaternion_pair_matches_jax():
    Rs = _rotations()
    jq = np.asarray(jax.vmap(jrot.matrix_to_quaternion)(jnp.asarray(Rs)))
    tq = trot.matrix_to_quaternion(T(Rs)).numpy()
    np.testing.assert_allclose(tq, jq, atol=1e-12)
    # the four pivot cases are all taken
    qw = np.stack([1 + np.trace(Rs, axis1=1, axis2=2),
                   1 + Rs[:, 0, 0] - Rs[:, 1, 1] - Rs[:, 2, 2],
                   1 - Rs[:, 0, 0] + Rs[:, 1, 1] - Rs[:, 2, 2],
                   1 - Rs[:, 0, 0] - Rs[:, 1, 1] + Rs[:, 2, 2]], -1)
    assert set(np.argmax(qw, -1)[-5:-1]) == {0, 1, 2, 3}
    jm = np.asarray(jax.vmap(jrot.quaternion_to_matrix)(jnp.asarray(jq)))
    tm = trot.quaternion_to_matrix(T(tq)).numpy()
    np.testing.assert_allclose(tm, jm, atol=1e-12)
    np.testing.assert_allclose(tm, Rs, atol=1e-9)
    # float32, as the artifact stores them
    q32 = trot.matrix_to_quaternion(T(Rs.astype(np.float32)))
    assert q32.dtype == torch.float32
    np.testing.assert_allclose(q32.numpy(), jq, atol=1e-5)


def _draws(key, raster):
    """JAX compress's key tree: (kd, kc) = split(key) for depth and RGB."""
    B = raster.S.shape[0]
    pvalid = np.arange(B) < int(raster.n_leaves)
    kd, kc = jax.random.split(key)
    return (jax_draws(kd, pvalid, JCFG.ksvd),
            jax_draws(kc, np.concatenate([pvalid] * 3), JCFG.rgb_ksvd))


@functools.lru_cache(maxsize=None)
def _compressed():
    pts, cols, valid = _cloud()
    key = jax.random.key(0)
    jc = jksvd.compress(jnp.asarray(pts), jnp.asarray(cols),
                        jnp.asarray(valid), JCFG, key)
    tc = tksvd.compress(T(pts), T(cols), T(valid), TCFG,
                        draws=_draws(key, jc.raster))
    return jc, tc


def test_compress_decompress_matches_jax():
    jc, tc = _compressed()
    for j, t in ((jc.depth, tc.depth), (jc.rgb, tc.rgb)):
        assert t.iters == int(j.iters)
        np.testing.assert_allclose(t.D.numpy(), np.asarray(j.D), atol=ATOL)
        np.testing.assert_array_equal(t.code.I.numpy(), np.asarray(j.code.I))
        np.testing.assert_array_equal(t.code.nw.numpy(),
                                      np.asarray(j.code.nw))
        jX = np.asarray(j.code.X)
        np.testing.assert_allclose(t.code.X.numpy(), jX,
                                   atol=ATOL * max(1.0, np.abs(jX).max()))
        np.testing.assert_allclose(float(t.error), float(j.error), rtol=1e-9)
    assert 1 < tc.depth.iters <= 8
    for a, b in zip(tksvd.decompress(tc), jksvd.decompress(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-8)
    rms = tksvd.rms_error(tc)
    assert rms < 0.08
    np.testing.assert_allclose(rms, jksvd.rms_error(jc), rtol=1e-9)


def test_compressed_converts_from_jax():
    jc, _ = _compressed()
    tc = convert.ksvd_compressed_from_numpy(
        {**{f: _asdict(getattr(jc, f)) for f in ("raster", "depth", "rgb")},
         "cfg": dataclasses.asdict(JCFG)}, device="cpu")
    assert tc.cfg == TCFG and tc.depth.iters == int(jc.depth.iters)
    assert tc.raster.grid.keys.shape == jc.raster.grid.keys.shape
    np.testing.assert_array_equal(tc.rgb.code.I.numpy(),
                                  np.asarray(jc.rgb.code.I))
    for a, b in zip(tksvd.decompress(tc), jksvd.decompress(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


def _files(write, art, tmp_path, name):
    base = os.path.join(tmp_path, name)
    write(base, art)
    return [open(base + s, "rb").read()
            for s in ("rgb.pcdict", "depth.pcdict", ".pccode")]


def test_artifact_files_byte_identical_to_jax(tmp_path):
    jc, tc = _compressed()
    j_art = jksvd.to_artifact(jc)
    # the port's copy of the artifact module, on JAX's record
    jfiles = _files(jart.write, j_art, tmp_path, "jax")
    assert _files(tart.write, tart.Artifact(*j_art), tmp_path, "copy") \
        == jfiles
    # the port's to_artifact of the same codes carried across
    carried = convert.ksvd_compressed_from_numpy(
        {**{f: _asdict(getattr(jc, f)) for f in ("raster", "depth", "rgb")},
         "cfg": dataclasses.asdict(JCFG)}, device="cpu")
    t_art = tksvd.to_artifact(carried)
    assert _files(tart.write, t_art, tmp_path, "port") == jfiles
    # and the read back equals the JAX reader's
    back_t = tart.read(os.path.join(tmp_path, "port"))
    back_j = jart.read(os.path.join(tmp_path, "jax"))
    for a, b in zip(back_t, back_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_artifact_read_decompresses_to_in_memory_points(tmp_path):
    """The port's own compress through its artifact file and host
    decompressor: the same points, in the same order (patch by patch,
    occupied cells in cell order), as the in-memory decompress, within
    1e-4 m; colours clamped to [0, 255]."""
    _, tc = _compressed()
    w, c, ok = tksvd.decompress(tc)
    w = w.numpy()[ok.numpy()]
    name = os.path.join(tmp_path, "scene")
    tart.write(name, tksvd.to_artifact(tc))
    pts2, cols2 = tksvd.decompress_artifact(tart.read(name))
    assert pts2.shape == w.shape and w.shape[0] > 500

    np.testing.assert_allclose(pts2, w, atol=1e-4)
    assert cols2.min() >= 0.0 and cols2.max() <= 255.0
    # JAX's host decompressor on the same file gives the same arrays
    jp, jcols = jksvd.decompress_artifact(jart.read(name))
    np.testing.assert_allclose(pts2, jp, atol=1e-6)
    np.testing.assert_allclose(cols2, jcols, atol=1e-3)


def test_port_default_generator_round_trip():
    """The port's own generator (seed 0 by default), no draws fed: finite
    output in the JAX pipeline's RMS regime, deterministic for a seed."""
    pts, cols, valid = _cloud()
    cfg = _cfg(tcfg, max_iters=3)
    a = tksvd.compress(T(pts), T(cols), T(valid), cfg)
    b = tksvd.compress(T(pts), T(cols), T(valid), cfg,
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.depth.D, b.depth.D) and a.rgb.iters == b.rgb.iters
    assert tksvd.rms_error(a) < 0.08
    w, c, ok = tksvd.decompress(a)
    assert torch.isfinite(w[ok]).all() and torch.isfinite(c).all()
