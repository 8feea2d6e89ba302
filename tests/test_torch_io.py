"""The port's IO, checkpoints, profiling, visualisation and leftover API
against the JAX package on the CPU.

  * pcd and native: both readers give JAX's arrays for binary and ascii
    files with and without colour; both writers give JAX's bytes; the
    native artifact writer gives the port's `artifact.write` bytes; the
    library builds from native/gpio.cpp into its own build directory and
    leaves a stale-looking native/libgpio.so beside the source untouched;
    without a compiler the NumPy path stands in, and a failing build
    raises.
  * tum: every function on `make_fixture` output (scans byte-identical,
    the ground truth within 1e-12).
  * checkpoint: JAX save -> port load and port save -> JAX load, both
    strict, for SOGPState banks, a CompressedCloud and a MapState; JAX's
    (HMC state, key) tuple into the port; the mismatch errors; strict=False;
    load_meta; the template's device and dtype.
  * sparse_gp's single-patch API, gaussian_log_pdf and
    rotation_from_moment against JAX in float64 (x64 on) to 1e-10
    relative;
    add_points_batch(keys=perm) against JAX fed the same keys; the port's
    SerialSOGP copy equal to JAX's.
  * profiling: spans, counts and the Chrome trace that carries the
    spans; viz: PNG and SVG files byte-identical.
"""

import functools
import hashlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.geometry import rotation as jrot
from gp_compressor_tpu.inference.hmc import HMCChainState as JHMCState
from gp_compressor_tpu.io import checkpoint as jckpt
from gp_compressor_tpu.io import native as jnative
from gp_compressor_tpu.io import pcd as jpcd
from gp_compressor_tpu.io import tum as jtum
from gp_compressor_tpu.models import oracle as joracle
from gp_compressor_tpu.models import sparse_gp as jsg
from gp_compressor_tpu.ops import noise as jnoise
from gp_compressor_tpu.ops.kernels import RBFParams as JRBF
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu.utils import viz as jviz
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu.workloads import mapping as jmap
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.geometry import rotation as trot
from gp_compressor_tpu_torch.inference.hmc import HMCChainState as THMCState
from gp_compressor_tpu_torch.io import artifact as tart
from gp_compressor_tpu_torch.io import checkpoint as tckpt
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.io import native as tnative
from gp_compressor_tpu_torch.io import pcd as tpcd
from gp_compressor_tpu_torch.io import tum as ttum
from gp_compressor_tpu_torch.models import oracle as toracle
from gp_compressor_tpu_torch.models import sparse_gp as tsg
from gp_compressor_tpu_torch.ops import noise as tnoise
from gp_compressor_tpu_torch.ops.kernels import RBFParams as TRBF
from gp_compressor_tpu_torch.testing import mapping_case as case
from gp_compressor_tpu_torch.utils import profiling as tprof
from gp_compressor_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)

T = torch.from_numpy
ATOL = 1e-10


def _cloud(n=400, seed=0):
    r = np.random.default_rng(seed)
    pts = r.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    cols = r.integers(0, 256, size=(n, 3)).astype(np.float32)
    return pts, cols


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---- pcd and native ------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "xyz"])
def test_pcd_and_native_match_jax(tmp_path, binary, rgb):
    pts, cols = _cloud(seed=1)
    cols = cols if rgb else None
    paths = {}
    for tag, write in (("jax_pcd", jpcd.write), ("port_pcd", tpcd.write),
                       ("jax_native", jnative.write_pcd),
                       ("port_native", tnative.write_pcd)):
        paths[tag] = os.path.join(tmp_path, f"{tag}.pcd")
        write(paths[tag], pts, cols, binary=binary)
    assert _bytes(paths["port_pcd"]) == _bytes(paths["jax_pcd"])
    assert _bytes(paths["port_native"]) == _bytes(paths["jax_native"])
    if binary:
        assert _bytes(paths["port_native"]) == _bytes(paths["jax_pcd"])
    for path in paths.values():
        jp, jc = jpcd.read(path)
        for tp, tc in (tpcd.read(path), tnative.read_pcd(path)):
            np.testing.assert_array_equal(tp, jp)
            if rgb:
                np.testing.assert_array_equal(tc, jc)
            else:
                assert tc is None and jc is None


def _artifact(seed=7):
    r = np.random.default_rng(seed)
    n, sz, l = 9, 8, 64
    return tart.Artifact(
        res=0.2, sz=sz,
        D=r.standard_normal((l, 16)).astype(np.float32),
        RGB_D=r.standard_normal((l, 12)).astype(np.float32),
        words_max=5, RGB_words_max=4,
        means=r.standard_normal((n, 3)).astype(np.float32),
        quats=r.standard_normal((n, 4)).astype(np.float32),
        rgb_means=r.standard_normal((n, 3)).astype(np.float32),
        X=r.standard_normal((n, 5)).astype(np.float32),
        I=r.integers(0, 16, size=(n, 5)).astype(np.int32),
        nw=r.integers(0, 6, size=n).astype(np.int32),
        RGB_X=r.standard_normal((3 * n, 4)).astype(np.float32),
        RGB_I=r.integers(0, 12, size=(3 * n, 4)).astype(np.int32),
        RGB_nw=r.integers(0, 5, size=3 * n).astype(np.int32),
        W=r.uniform(size=(n, sz * sz)) > 0.4)


def test_native_artifact_equals_artifact_write(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(tnative.SOURCE) == os.path.join(repo, "native", "gpio.cpp")
    assert str(tnative.BUILD_DIR) == os.path.join(repo, "build",
                                                  "torch_native")
    art = _artifact()
    py, nat = os.path.join(tmp_path, "py"), os.path.join(tmp_path, "nat")
    tart.write(py, art)
    assert tnative.write_artifact(nat, art)
    for suffix in (".pccode", "depth.pcdict", "rgb.pcdict"):
        assert _bytes(nat + suffix) == _bytes(py + suffix), suffix


@pytest.fixture
def isolated_native(tmp_path, monkeypatch):
    """The native module pointed at a copy of native/: gpio.cpp with a
    libgpio.so beside it that is older than the source (the state in
    which native/build.sh rebuilds the tracked library), and a build
    directory of its own."""
    src_dir = tmp_path / "native"
    src_dir.mkdir()
    shutil.copy(tnative.SOURCE, src_dir / "gpio.cpp")
    shutil.copy(tnative.SOURCE.parent / "libgpio.so", src_dir / "libgpio.so")
    t = os.path.getmtime(src_dir / "gpio.cpp")
    os.utime(src_dir / "libgpio.so", (t - 100, t - 100))
    monkeypatch.setattr(tnative, "SOURCE", src_dir / "gpio.cpp")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    return src_dir


def test_native_builds_into_its_own_dir(isolated_native, tmp_path):
    so = isolated_native / "libgpio.so"
    before = (hashlib.sha256(_bytes(so)).hexdigest(), os.stat(so).st_mtime_ns)
    assert tnative.available()
    built = list((tmp_path / "build").glob("libgpio_*.so"))
    assert len(built) == 1
    after = (hashlib.sha256(_bytes(so)).hexdigest(), os.stat(so).st_mtime_ns)
    assert after == before
    assert sorted(os.listdir(isolated_native)) == ["gpio.cpp", "libgpio.so"]
    pts, cols = _cloud(seed=2)
    path = str(tmp_path / "a.pcd")
    tnative.write_pcd(path, pts, cols)
    np.testing.assert_array_equal(tnative.read_pcd(path)[0], pts)


def test_native_falls_back_without_compiler_and_raises_on_bad_build(
        isolated_native, tmp_path, monkeypatch):
    pts, cols = _cloud(seed=3)
    path = str(tmp_path / "a.pcd")
    tpcd.write(path, pts, cols)
    with monkeypatch.context() as m:
        m.setattr(shutil, "which", lambda name: None)
        assert not tnative.available()
        out = str(tmp_path / "b.pcd")
        tnative.write_pcd(out, pts, cols)
        assert _bytes(out) == _bytes(path)
        assert not tnative.write_artifact(str(tmp_path / "x"), _artifact())
    (isolated_native / "gpio.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.read_pcd(path)
    assert not list((tmp_path / "build").glob("libgpio_*.so"))


# ---- tum -------------------------------------------------------------------

def test_tum_matches_jax(tmp_path):
    jd, jposes = jtum.make_fixture(str(tmp_path / "jax"), n_frames=4,
                                   n_points=1500, seed=3)
    td, tposes = ttum.make_fixture(str(tmp_path / "port"), n_frames=4,
                                   n_points=1500, seed=3)
    for (jR, jt), (tR, tt) in zip(jposes, tposes):
        np.testing.assert_array_equal(tR, jR)
        np.testing.assert_array_equal(tt, jt)
    jf = jtum.list_scan_files(os.path.join(jd, "pointclouds"))
    tf = ttum.list_scan_files(os.path.join(td, "pointclouds"))
    assert [os.path.basename(f) for f in tf] == \
        [os.path.basename(f) for f in jf] and len(tf) == 4
    for a, b in zip(jf, tf):
        assert _bytes(a) == _bytes(b)
        assert ttum.timestamp_from_filename(b) == \
            jtum.timestamp_from_filename(a)
    jg = jtum.read_ground_truth(os.path.join(jd, "groundtruth.txt"))
    tg = ttum.read_ground_truth(os.path.join(td, "groundtruth.txt"))
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    times, pos, quat = tg
    for t in (times[0] - 1.0, times[1], times[2] + 0.1, times[-1] + 5.0):
        assert ttum.find_closest_timestamp(times, t) == \
            jtum.find_closest_timestamp(times, t)
    r = np.random.default_rng(4)
    qa, qb = r.standard_normal(4), r.standard_normal(4)
    for f in ("q_conj", "q_normalize"):
        np.testing.assert_array_equal(getattr(ttum, f)(qa),
                                      getattr(jtum, f)(qa))
    np.testing.assert_array_equal(ttum.q_mul(qa, qb), jtum.q_mul(qa, qb))
    for i, j in ((0, 1), (1, 3), (0, 3)):
        jq, jt = jtum.ground_truth_delta(times, pos, quat, times[i], times[j])
        tq, tt = ttum.ground_truth_delta(times, pos, quat, times[i], times[j])
        np.testing.assert_allclose(tq, jq, atol=1e-12)
        np.testing.assert_allclose(tt, jt, atol=1e-12)
        R_est = jposes[j][0] @ jposes[i][0].T
        t_est = jt + 1e-3 * r.standard_normal(3)
        np.testing.assert_allclose(ttum.pair_errors(R_est, t_est, jq, jt),
                                   jtum.pair_errors(R_est, t_est, jq, jt),
                                   atol=1e-12)
    pts, cols = tpcd.read(tf[1])
    for leaf in (0.01, 0.05):
        jp, jc = jtum.voxel_filter(pts, cols, leaf=leaf)
        tp, tc = ttum.voxel_filter(pts, cols, leaf=leaf)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
    assert ttum.voxel_filter(pts, None, leaf=0.05)[1] is None


# ---- checkpoint -----------------------------------------------------------

def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


def _sogp_bank(seed=0):
    cfg = jcfg.GPConfig(slots=8, capacity=7)
    st = jsg.init_batch(cfg, 5)
    r = np.random.default_rng(seed)
    return st._replace(C=jnp.asarray(r.standard_normal(st.C.shape),
                                     jnp.float32),
                       active=jnp.asarray(r.uniform(size=(5, 8)) > 0.5))


@functools.lru_cache(maxsize=None)
def _jax_compressed():
    pts, cols = synthetic.room_cloud(n=2000, seed=4)
    cfg = jcfg.CompressorConfig(
        patch=jcfg.PatchConfig(res=0.4, sz=6, max_patches=128,
                               max_points_per_patch=32),
        depth_gp=jcfg.GPConfig(capacity=7, slots=8, eps_tol=1.0),
        rgb_gp=jcfg.rgb_gp_config(slots=8, capacity=7))
    return jcomp.compress(jnp.asarray(pts), jnp.asarray(cols),
                          jnp.ones(len(pts), bool), cfg, jax.random.key(1))


def _jax_map():
    cfg = case.compressor_config(jcfg, jnp.float64)
    return jmap.map_init(cfg, case.mapping_config(jcfg), *case.BOX)


CASES = {
    "sogp_bank": (_sogp_bank,
                  lambda j: convert.state_from_numpy(_asdict(j), "cpu")),
    "compressed": (_jax_compressed,
                   lambda j: convert.compressed_from_numpy(_asdict(j),
                                                           "cpu")),
    "map_state": (_jax_map,
                  lambda j: convert.map_state_from_numpy(_asdict(j), "cpu")),
    "nested": (lambda: (_sogp_bank(1), None,
                        {"b": [jnp.arange(3), jnp.ones(2)], "a": 1.5}),
               lambda j: (convert.state_from_numpy(_asdict(j[0]), "cpu"),
                          None, {"a": torch.tensor(1.5, dtype=torch.float64),
                                 "b": [torch.arange(3), torch.ones(2)]})),
}


def _same_leaves(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = []
    tckpt._flatten(ttree, tl)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("name", list(CASES))
def test_checkpoint_crosses_both_ways(tmp_path, name):
    make_jax, to_port = CASES[name]
    jtree = make_jax()
    ttree = to_port(jtree)
    stored = []
    assert f"PyTreeDef({tckpt._flatten(ttree, stored)})" == \
        str(jax.tree_util.tree_structure(jtree))
    # JAX -> port, strict, into a zeroed template
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, jtree, meta={"from": "jax"})
    zeros = jax.tree_util.tree_map(
        lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t,
        ttree)
    back = tckpt.load(jpath, zeros, strict=True)
    _same_leaves(jtree, back)
    assert tckpt.load_meta(jpath) == {"from": "jax"}
    # port -> JAX, strict
    tpath = str(tmp_path / "port.npz")
    tckpt.save(tpath, ttree, meta={"from": "port", "n": 3})
    jback = jckpt.load(tpath, jax.tree_util.tree_map(jnp.zeros_like, jtree),
                       strict=True)
    _same_leaves(jback, ttree)
    assert jckpt.load_meta(tpath) == {"from": "port", "n": 3}


def test_checkpoint_hmc_state_and_key_from_jax(tmp_path):
    """JAX's (HMC chain state, typed key) checkpoint
    (tests/test_misc_coverage.py) loads into the port's HMCChainState and
    a tensor of the key data's shape."""
    st = JHMCState(theta=jnp.asarray([4.6, 0.0, -2.3]),
                   logp=jnp.asarray(-12.5),
                   grad=jnp.asarray([0.1, -0.2, 0.3]),
                   step_size=jnp.asarray(0.05), h_bar=jnp.asarray(0.01),
                   log_eps_bar=jnp.asarray(-3.0), mu=jnp.asarray(-1.6),
                   inv_mass=jnp.ones(3), accept_prob=jnp.asarray(0.83))
    key = jax.random.key(42)
    path = str(tmp_path / "sampler.npz")
    jckpt.save(path, (st, key), meta={"kind": "hmc"})
    like = (THMCState(*[torch.zeros(np.shape(v), dtype=torch.float64)
                        for v in st]),
            torch.zeros(2, dtype=torch.int64))
    tst, tkey = tckpt.load(path, like)
    for a, b in zip(st, tst):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tkey.numpy(),
                                  np.asarray(jax.random.key_data(key)))
    assert tkey.dtype == torch.int64


def test_checkpoint_checks(tmp_path):
    tree = {"a": torch.arange(4.0), "b": (torch.zeros((2, 2)),
                                          torch.ones(3, dtype=torch.int32))}
    path = str(tmp_path / "c.npz")
    tckpt.save(path, tree, meta={"step": 7})
    assert tckpt.load_meta(path) == {"step": 7}
    back = tckpt.load(path, tree)
    assert torch.equal(back["a"], tree["a"])
    assert back["b"][1].dtype == torch.int32
    # leaves take the template's dtype
    like64 = {"a": torch.zeros(4, dtype=torch.float64),
              "b": (torch.zeros((2, 2)), torch.zeros(3, dtype=torch.int64))}
    back = tckpt.load(path, like64)
    assert back["a"].dtype == torch.float64 and back["b"][1].dtype == \
        torch.int64
    assert torch.equal(back["b"][1], torch.ones(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(path, {"a": torch.zeros(5), "b": (torch.zeros((2, 2)),
                                                     torch.zeros(3))})
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.load(path, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load(path, {"a": torch.zeros(4)}, strict=False)
    # strict=False: a renamed container with the same leaf layout
    renamed = {"a": torch.zeros(4), "c": [torch.zeros((2, 2)),
                                          torch.zeros(3)]}
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.load(path, renamed)
    loose = tckpt.load(path, renamed, strict=False)
    assert torch.equal(loose["c"][1], torch.ones(3))
    plain = str(tmp_path / "plain.npz")
    tckpt.save(plain, [torch.zeros(1)])
    assert tckpt.load_meta(plain) == {}


# ---- sparse_gp's single-patch API ------------------------------------------

def _gp_case(dout=1, n=40, seed=0, slots=12):
    r = np.random.default_rng(seed)
    X = r.uniform(-0.3, 0.3, size=(n, 2))
    Y = 0.05 * np.sin(4 * X[:, :1] + X[:, 1:]) + 0.01 * r.standard_normal(
        (n, dout))
    kw = dict(capacity=slots - 2, slots=slots, dout=dout, sigmaf_sq=2e-3,
              l_sq=0.02, s20=1e-4, eps_tol=1e-5)
    return (jcfg.GPConfig(**kw, dtype=jnp.float64),
            tcfg.GPConfig(**kw, dtype=torch.float64), X, Y)


def _params(cfg):
    return (JRBF(sigmaf_sq=jnp.asarray(cfg.sigmaf_sq), l_sq=jnp.asarray(
        cfg.l_sq)), TRBF(sigmaf_sq=torch.tensor(cfg.sigmaf_sq,
                                                dtype=torch.float64),
                         l_sq=torch.tensor(cfg.l_sq, dtype=torch.float64)))


def _close(t, j, atol=ATOL, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dout", [1, 3])
def test_single_patch_api_matches_jax(dout):
    jc, tc, X, Y = _gp_case(dout=dout)
    jkp, tkp = _params(jc)
    s20 = jc.s20
    jn = jnoise.GaussianNoise(s20=jnp.asarray(s20))
    tn = tnoise.GaussianNoise(s20=torch.tensor(s20, dtype=torch.float64))
    j0, t0 = jsg.init(jc), tsg.init(tc, device="cpu")
    for a, b in zip(j0, t0):
        assert b.shape == a.shape and b.numpy().dtype == np.asarray(a).dtype
        _close(b, a, 0, 0)
    key = jax.random.key(5)
    mask = np.arange(len(X)) % 7 != 3
    js = jsg.add_points(jkp, jn, jc, j0, jnp.asarray(X), jnp.asarray(Y),
                        jnp.asarray(mask), key=key)
    perm = T(np.asarray(jax.random.permutation(key, len(X))))
    ts = tsg.add_points(tkp, tn, tc, t0, T(X), T(Y), T(mask), perm=perm)
    assert int(tsg.size(ts)) == int(jsg.size(js)) > 4
    for a, b in zip(js, ts):
        _close(b, a)
    # per-point thresholds follow their rows
    eps = np.where(np.arange(len(X)) % 5 == 0, -np.inf, jc.eps_tol)
    js2 = jsg.add_points(jkp, jn, jc, j0, jnp.asarray(X), jnp.asarray(Y),
                         key=key, eps_tol=jnp.asarray(eps))
    ts2 = tsg.add_points(tkp, tn, tc, t0, T(X), T(Y), perm=perm,
                         eps_tol=T(eps))
    for a, b in zip(js2, ts2):
        _close(b, a)
    Xs = np.random.default_rng(1).uniform(-0.35, 0.35, size=(25, 2))
    Ys = 0.05 * np.sin(4 * Xs[:, :1] + Xs[:, 1:]) * np.ones((1, dout))
    for f in ("predict", "predict_confidence"):
        for a, b in zip(getattr(jsg, f)(jkp, s20, js, jnp.asarray(Xs)),
                        getattr(tsg, f)(tkp, s20, ts, T(Xs))):
            _close(b, a, 1e-9)
    for f in ("log_likelihood", "likelihood"):
        _close(getattr(tsg, f)(tkp, s20, ts, T(Xs), T(Ys)),
               getattr(jsg, f)(jkp, s20, js, jnp.asarray(Xs),
                               jnp.asarray(Ys)), 1e-7)
    jdx = np.asarray(jsg.likelihood_dx(jkp, s20, js, jnp.asarray(Xs),
                                       jnp.asarray(Ys)))
    tdx = tsg.likelihood_dx(tkp, s20, ts, T(Xs), T(Ys))
    assert tdx.shape == (25, 3)
    np.testing.assert_allclose(tdx.numpy(), jdx, rtol=1e-8,
                               atol=1e-9 * np.abs(jdx).max())
    for a, b in zip(jsg.reset(js), tsg.reset(ts)):
        _close(b, a, 0, 0)


def test_add_points_batch_keys_match_jax():
    jc, tc, X, Y = _gp_case(n=24, slots=8)
    jkp, tkp = _params(jc)
    B = 6
    r = np.random.default_rng(3)
    Xb = np.stack([X + 0.01 * r.standard_normal(X.shape) for _ in range(B)])
    Yb = np.stack([Y + 0.01 * r.standard_normal(Y.shape) for _ in range(B)])
    mask = r.uniform(size=(B, len(X))) > 0.1
    eps = np.where(r.uniform(size=mask.shape) < 0.1, -np.inf, jc.eps_tol)
    keys = jax.random.split(jax.random.key(9), B)
    perm = T(np.stack([np.asarray(jax.random.permutation(k, len(X)))
                       for k in keys]))
    jn = jnoise.GaussianNoise(s20=jnp.asarray(jc.s20))
    tn = tnoise.GaussianNoise(s20=torch.tensor(jc.s20, dtype=torch.float64))
    for e in (None, eps):
        js = jsg.add_points_batch(
            jkp, jn, jc, jsg.init_batch(jc, B), jnp.asarray(Xb),
            jnp.asarray(Yb), jnp.asarray(mask), keys,
            eps_tol=None if e is None else jnp.asarray(e))
        ts = tsg.add_points_batch(
            tkp, tn, tc, tsg.init_batch(tc, B, device="cpu"), T(Xb), T(Yb),
            T(mask), keys=perm, eps_tol=None if e is None else T(e))
        for a, b in zip(js, ts):
            _close(b, a)


def test_gaussian_log_pdf_and_rotation_from_moment_match_jax():
    r = np.random.default_rng(6)
    y, mu = r.standard_normal(10), r.standard_normal(10)
    var = r.uniform(0.1, 2.0, size=10)
    _close(tnoise.gaussian_log_pdf(T(y), T(mu), T(var)),
           jnoise.gaussian_log_pdf(jnp.asarray(y), jnp.asarray(mu),
                                   jnp.asarray(var)), 1e-14)
    for seed, npts in ((0, 50), (1, 50), (2, 3)):
        rr = np.random.default_rng(seed)
        P = rr.uniform(-1, 1, size=(50, 3)) * [1.0, 0.6, 0.02]
        R0 = np.linalg.qr(rr.standard_normal((3, 3)))[0]
        Ph = np.concatenate([P @ R0.T + rr.standard_normal(3),
                             np.ones((50, 1))], 1)
        M = Ph.T @ Ph
        j = np.asarray(jrot.rotation_from_moment(jnp.asarray(M), npts))
        t = trot.rotation_from_moment(T(M), npts)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-9)
        if npts < 4:
            np.testing.assert_array_equal(t.numpy(), np.eye(3))


def test_serial_oracle_copy_matches_jax():
    jc, _, X, Y = _gp_case(dout=3, n=60, slots=10)
    kw = dict(capacity=8, s20=jc.s20, sigmaf_sq=jc.sigmaf_sq, l_sq=jc.l_sq,
              eps_tol=jc.eps_tol, dout=3)
    a, b = joracle.SerialSOGP(**kw), toracle.SerialSOGP(**kw)
    order = np.random.default_rng(2).permutation(len(X))
    a.add_measurements(X, Y, order)
    b.add_measurements(X, Y, order)
    assert a.size == b.size == 8
    for f in ("bv", "alpha", "C", "Q"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for u, v in zip(a.predict(X[:9]), b.predict(X[:9])):
        np.testing.assert_array_equal(v, u)


# ---- profiling and viz -----------------------------------------------------

def test_profiling_matches_jax_format(tmp_path):
    """The port's tracer (it replaced the phase timer and the JSONL logger
    ported from the JAX package): spans record nothing with tracing off,
    nest with tracing on (context manager and decorator, one request per
    outermost span), counts are totals and attach to the innermost span,
    and `trace` writes a Chrome trace that holds the spans as host ranges
    in the function scope."""
    @tprof.span("outer")
    def outer(x):
        with tprof.span("inner"):
            tprof.count("t.items", 2)
        tprof.count("t.items")
        return x + 1

    tprof.take()
    tprof.reset_counters()
    assert outer(1) == 2 and tprof.take() == []
    assert tprof.counters() == {"t.items": 3}
    tprof.tracing(True)
    try:
        outer(1)
        outer(2)
    finally:
        tprof.tracing(False)
    recs = tprof.take()
    assert [(r.name, r.request) for r in recs] == [
        ("inner", 0), ("outer", 0), ("inner", 1), ("outer", 1)]
    by_id = {r.id: r for r in recs}
    assert [by_id[r.parent].name if r.parent is not None else None
            for r in recs] == ["outer", None, "outer", None]
    assert all(r.start <= r.end for r in recs)
    assert by_id[recs[0].parent].start <= recs[0].start
    assert recs[0].end <= by_id[recs[0].parent].end
    assert [r.counts for r in recs] == [{"t.items": 2}, {"t.items": 1}] * 2
    assert tprof.counters() == {"t.items": 9}
    tprof.reset_counters()
    assert tprof.counters() == {}

    with tprof.trace(str(tmp_path / "trace")) as prof:
        with tprof.span("traced.block"):
            torch.ones(64).sum()
    assert prof is not None
    assert [r.name for r in tprof.take()] == ["traced.block"]
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "traced.block"]
    assert [e.get("cat") for e in ranges] == ["cpu_op"]
    with tprof.trace(None) as prof:
        assert prof is None
    with tprof.span("off"):
        pass
    assert tprof.take() == []


def test_viz_files_byte_identical(tmp_path):
    pts, cols = synthetic.room_cloud(n=3000, seed=1)
    for axis in ("x", "z"):
        a, b = str(tmp_path / f"j{axis}.png"), str(tmp_path / f"t{axis}.png")
        jviz.render_cloud(a, pts, cols, axis=axis, size=120)
        tviz.render_cloud(b, pts, cols, axis=axis, size=120)
        assert _bytes(a) == _bytes(b)
    # height colouring: JAX's form calls ndarray.ptp, which NumPy 2 lacks,
    # so it is held against JAX given the same colours explicitly
    d = pts[:, 2].astype(np.float64)
    t = (d - d.min()) / max(np.ptp(d), 1e-9)
    heights = np.stack([60 + 180 * t, 80 + 120 * (1 - t), 220 - 160 * t], -1)
    a, b = str(tmp_path / "jh.png"), str(tmp_path / "th.png")
    jviz.render_cloud(a, pts, heights, size=100)
    tviz.render_cloud(b, pts, None, size=100)
    assert _bytes(a) == _bytes(b)
    series = {"gp": [0.3, 0.1, np.nan, 0.05], "icp": [0.2, 0.15, 0.12, 0.1]}
    a, b = str(tmp_path / "j.svg"), str(tmp_path / "t.svg")
    jviz.plot_series(a, series, title="err")
    tviz.plot_series(b, series, title="err")
    assert _bytes(a) == _bytes(b)
