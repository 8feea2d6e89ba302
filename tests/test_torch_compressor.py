"""The port's compress -> decompress round trip against the JAX package.

A ~6k-point room cloud at a cut-down bench configuration (res 0.3, sz 10,
512 patches of 128 points, 16 state slots, capacity 14, eps_tol 2.0,
center-out banks, octant sphere moments) goes through JAX's
compress_decompress (XLA training path) and through the port (the plain
version of the training kernel, since the tensors lie on the CPU)."""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.models import sparse_gp as jsg
from gp_compressor_tpu.utils import synthetic
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.models import sparse_gp as tsg
from gp_compressor_tpu_torch.workloads import compressor as tcomp

torch.set_num_threads(1)

N = 6000
REPO = Path(__file__).resolve().parents[1]


def _cfg(m):
    return m.CompressorConfig(
        patch=m.PatchConfig(res=0.3, sz=10, max_patches=512,
                            max_points_per_patch=128,
                            approx_sphere_moments=True,
                            bank_order="center_out"),
        depth_gp=m.GPConfig(capacity=14, slots=16, eps_tol=2.0),
        rgb_gp=dataclasses.replace(m.rgb_gp_config(slots=16, capacity=14),
                                   eps_tol=2.0))


def _asdict(nt):
    if hasattr(nt, "_asdict"):
        return {k: _asdict(v) for k, v in nt._asdict().items()}
    return None if nt is None else np.asarray(nt)


@functools.lru_cache(maxsize=None)
def _runs():
    pts, cols = synthetic.room_cloud(n=N, seed=0)
    jout = jcomp.compress_decompress(
        jnp.asarray(pts, jnp.float32), jnp.asarray(cols, jnp.float32),
        jnp.ones(N, bool), _cfg(jcfg), jax.random.key(0))
    tout = tcomp.compress_decompress(
        torch.from_numpy(pts), torch.from_numpy(cols),
        torch.ones(N, dtype=torch.bool), _cfg(tcfg))
    return jout, tout


def test_round_trip_matches_jax():
    (jc, jo), (tc, to) = _runs()
    assert int(tc.patch.n_leaves) == int(jc.patch.n_leaves) > 300
    for gp in ("depth_gp", "rgb_gp"):
        sj = np.asarray(jsg.size(getattr(jc, gp)))
        st = tsg.size(getattr(tc, gp)).numpy()
        assert (sj == st).mean() >= 0.9, (gp, (sj == st).mean())
    rj = float(jcomp.reconstruction_rmse(jc, _cfg(jcfg)))
    rt = float(tcomp.reconstruction_rmse(tc, _cfg(tcfg)))
    assert abs(rt - rj) <= 0.02 * rj, (rt, rj)
    world, colors, valid, centers, normals, patch_ok = to
    B, G = 512, 100
    assert world.shape == (B * G, 3) and colors.shape == (B * G, 3)
    assert torch.isfinite(world).all() and torch.isfinite(colors).all()
    assert float(colors.min()) >= 0.0 and float(colors.max()) <= 255.0
    assert valid.sum() == patch_ok.sum() * G > 0
    np.testing.assert_array_equal(patch_ok.numpy(), np.asarray(jo[5]))


def test_decompress_of_jax_state_matches_jax():
    """Both packages decompress exactly the same trained state."""
    (jc, jo), _ = _runs()
    comp = convert.compressed_from_numpy(_asdict(jc), device="cpu")
    to = tcomp.decompress(comp, _cfg(tcfg))
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), atol=1e-5)
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=1e-3)
    for k in (2, 5):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]), atol=1e-6)
    np.testing.assert_allclose(to[4].numpy(), np.asarray(jo[4]), atol=1e-6)
    rj = float(jcomp.reconstruction_rmse(jc, _cfg(jcfg)))
    rt = float(tcomp.reconstruction_rmse(comp, _cfg(tcfg)))
    assert abs(rt - rj) <= 1e-5 * rj


def test_train_routes_by_device():
    """CPU banks take the plain version; asking for the kernel raises."""
    (_, _), (tc, _) = _runs()
    batch, cfg = tc.patch, _cfg(tcfg)
    with pytest.raises(ValueError):
        tcomp.train(batch, cfg, use_kernel=True)
    plain = tcomp.train(batch, cfg, use_kernel=False)
    for a, b in zip(plain.depth_gp + plain.rgb_gp, tc.depth_gp + tc.rgb_gp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sanitize_counts_diverged_patches():
    (_, _), (tc, _) = _runs()
    cfg = _cfg(tcfg)
    dkp, ckp = tcomp.default_params(cfg, device="cpu")
    d = tc.depth_gp._replace(alpha=tc.depth_gp.alpha.clone())
    d.alpha[3] = float("nan")
    d.alpha[7] *= 1e6
    ds, cs, nd, nc = tcomp.sanitize(tc.patch, cfg, d, tc.rgb_gp, dkp, ckp,
                                    cfg.depth_gp.s20)
    assert int(nd) == 2 and int(nc) == 0
    assert not ds.active[3].any() and not ds.active[7].any()


def test_port_imports_no_jax():
    """Every module of the port (parallel/ included) imports, and one
    small CLI run goes through (the commands import their modules lazily),
    with neither jax nor the JAX package in sys.modules afterwards."""
    code = ("import pkgutil, sys\n"
            "import gp_compressor_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]\n"
            "assert 'gp_compressor_tpu_torch.cli' in mods, mods\n"
            "assert {'gp_compressor_tpu_torch.parallel.' + m for m in "
            "('mesh', 'distributed', 'shard_report')} <= set(mods), mods\n"
            "for m in mods:\n"
            "    __import__(m)\n"
            "from gp_compressor_tpu_torch import cli\n"
            "cli.main(['gp-compress', '--n-points', '600', '--res', '0.4', "
            "'--sz', '4', '--max-patches', '64', '--max-ppp', '16', "
            "'--capacity', '7', '--device', 'cpu'])\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'gp_compressor_tpu.')) or m == "
            "'gp_compressor_tpu']\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "assert torch.get_float32_matmul_precision() == 'highest'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
