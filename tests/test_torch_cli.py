"""The port's command line against the JAX package's, on the CPU.

Each of the six subcommands runs through
`gp_compressor_tpu_torch.cli.main([..., "--device", "cpu"])` and
`gp_compressor_tpu.cli.main` at the same small arguments (3,000 points,
res 0.4, sz 8, 256 patches of 32 points, capacity 15), and the printed
lines are compared. JAX runs with x64 off, as its command line does
(float32), except where a case feeds both packages a float64 cloud
(`room_cloud` replaced in both), which the K-SVD codec and the
calibration then compute in float64. JAX's draws are fed to the port by
replacing the port's draw functions inside the test: the shuffle bits of
the bank order (`patches.draw_shuffle_bits`), the K-SVD rows
(`dictionary.draw_ksvd`) and the HMC momenta and uniforms
(`hmc.hmc_sample_chains`'s draws).

Tolerances:
  * float64 cases: compress and calibrate --map print the same lines,
    numbers to 1e-9 relative; HMC (40 transitions of 16 leapfrogs per
    chain carry the rounding along) to 1e-5 relative.
  * float32 GP paths at eps_tol 1.0 (the novelty test decided far from
    rounding): counts and the ground-truth columns exact; mean BVs within
    2%, max BVs within 1, RMS within 5%, emitted points within 2 patches;
    registration steps within 3 (synthetic) / 8 (TUM pairs), final errors
    within 1 mm (synthetic) / 5 mm (TUM), mean likelihood within 2%; map
    patches within 1% per scan and map points written within 2%.
  * float32 K-SVD: the in-sample RMS within 3% (OMP's greedy choices
    follow float32 rounding, so sweep counts differ).
  * float32 MAP calibration: JAX's command line raises TypeError (it
    hands json.dumps numpy float32 values); the port's printed values
    equal JAX's `map_estimate` on the same subsample within 1e-4
    relative.
"""

import argparse
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_compressor_tpu import cli as jcli
from gp_compressor_tpu.inference import hmc as jhmc
from gp_compressor_tpu.io import checkpoint as jckpt
from gp_compressor_tpu.io import tum as jtum
from gp_compressor_tpu.utils import synthetic as jsyn
from gp_compressor_tpu.workloads import compressor as jcomp
from gp_compressor_tpu_torch import cli as tcli
from gp_compressor_tpu_torch.geometry import patches as tpatches
from gp_compressor_tpu_torch.inference import hmc as thmc
from gp_compressor_tpu_torch.io import native as tnative
from gp_compressor_tpu_torch.models import dictionary as tdict
from gp_compressor_tpu_torch.utils import synthetic as tsyn

from test_torch_bayes import hmc_run_draws
from test_torch_dictionary import jax_draws

torch.set_num_threads(1)

SMALL = ["--n-points", "3000", "--res", "0.4", "--sz", "8",
         "--max-patches", "256", "--max-ppp", "32", "--capacity", "15"]
KSVD = ["--dict-size", "20", "--words-max", "4", "--rgb-dict-size", "30",
        "--rgb-words-max", "5"]
CALIB = ["--steps", "20", "--n-calib-patches", "8", "--n-calib-points", "16"]
G = 64                       # sz^2: the points one patch emits
COMMANDS = ("gp-compress", "compress", "decompress", "gp-accuracy",
            "calibrate", "gp-mapping")


@contextlib.contextmanager
def _x64(on: bool):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _lines(main, argv, capsys, x64=False):
    capsys.readouterr()
    with _x64(x64):
        main(argv)
    return capsys.readouterr().out.splitlines()


def _both(argv, capsys, x64=False):
    return (_lines(jcli.main, argv, capsys, x64),
            _lines(tcli.main, argv + ["--device", "cpu"], capsys, x64))


@pytest.fixture
def shuffle_bits(monkeypatch):
    """The port's `shuffle` bank order draws the bits JAX's compress draws
    from key(seed) (its project takes the first split)."""
    def draw(B, P, device="cuda", generator=None):
        ks = jax.random.split(jax.random.key(0))[0]
        bits = np.asarray(jax.random.bits(ks, (B, P), jnp.uint32))
        return torch.from_numpy(bits.astype(np.int64)).to(device)

    monkeypatch.setattr(tpatches, "draw_shuffle_bits", draw)


@pytest.fixture
def f64_cloud(monkeypatch):
    """room_cloud in both packages returns float64 arrays."""
    for mod in (jsyn, tsyn):
        orig = mod.room_cloud
        monkeypatch.setattr(
            mod, "room_cloud", lambda n=100_000, seed=0, _o=orig: tuple(
                a.astype(np.float64) for a in _o(n=n, seed=seed)))


def _jax_config(eps_tol):
    """JAX's CompressorConfig for SMALL's arguments."""
    return jcli._gp_config(argparse.Namespace(
        res=0.4, sz=8, max_patches=256, max_ppp=32, capacity=15,
        eps_tol=eps_tol, dict_size=200, words_max=10, rgb_dict_size=600,
        rgb_words_max=20))


def _num(line):
    return float(line.split(":")[1].strip().rstrip("s"))


def _parsers(main):
    """{subcommand: {option: (default, type, choices, action)}} of a CLI's
    parser, caught as main() parses."""
    caught = {}

    class Caught(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        caught["p"] = self
        raise Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(Caught):
            main(["gp-compress"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in caught["p"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {o: (a.default, a.type, a.choices, type(a).__name__)
                   for a in sp._actions for o in a.option_strings}
            for name, sp in sub.choices.items()}


def test_arguments_match_jax():
    """The six subcommands with JAX's options, defaults, types and
    choices, plus --device (default cuda) on each."""
    j, t = _parsers(jcli.main), _parsers(tcli.main)
    assert list(t) == list(j) == list(COMMANDS)
    for cmd in COMMANDS:
        extra = {o: v for o, v in t[cmd].items() if o not in j[cmd]}
        assert list(extra) == ["--device"], cmd
        assert extra["--device"][0] == "cuda"
        assert {o: v for o, v in t[cmd].items() if o in j[cmd]} == j[cmd]


@pytest.mark.parametrize("cmd", COMMANDS)
def test_default_device_needs_a_card(cmd):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main([cmd])


def test_gp_compress_matches_jax(tmp_path, capsys, shuffle_bits):
    args = ["gp-compress"] + SMALL + ["--eps-tol", "1.0"]
    j = _lines(jcli.main, args, capsys)
    out, ckpt = str(tmp_path / "t.pcd"), str(tmp_path / "t.npz")
    t = _lines(tcli.main, args + ["--device", "cpu", "--out", out,
                                  "--checkpoint", ckpt], capsys)
    assert t[:2] == j[:2] == ["Size of original point cloud: 3000",
                              "Number of patches: 177"]
    assert abs(_num(t[2]) - _num(j[2])) <= 0.02 * _num(j[2])     # mean BVs
    assert abs(_num(t[3]) - _num(j[3])) <= 1                     # max BVs
    assert abs(_num(t[4]) - _num(j[4])) <= 0.05 * _num(j[4])     # RMS
    assert abs(_num(t[5]) - _num(j[5])) <= 2 * G                 # emitted
    assert t[7:] == [f"wrote {out}", f"wrote {ckpt}"]
    pts, cols = tnative.read_pcd(out)
    assert pts.shape == (_num(t[5]), 3) and cols.shape == pts.shape
    # the port's checkpoint loads into JAX's compress output, strictly
    with _x64(False):
        cfg = _jax_config(eps_tol=1.0)
        p, c = jsyn.room_cloud(n=3000, seed=0)
        like = jcomp.compress(jnp.asarray(p), jnp.asarray(c),
                              jnp.ones(len(p), bool), cfg, jax.random.key(0))
        back = jckpt.load(ckpt, like, strict=True)
    assert jckpt.load_meta(ckpt) == {"kind": "gp_compressed"}
    np.testing.assert_array_equal(np.asarray(back.patch.claims),
                                  np.asarray(like.patch.claims))


@pytest.mark.parametrize("f64", [True, False], ids=["float64", "float32"])
def test_compress_decompress_match_jax(tmp_path, capsys, monkeypatch, f64,
                                       request):
    if f64:
        request.getfixturevalue("f64_cloud")
    kd, kc = jax.random.split(jax.random.key(0))
    keys = [kd, kc]
    dt = jnp.float64 if f64 else jnp.float32
    monkeypatch.setattr(tdict, "draw_ksvd", lambda valid, cfg, generator=None:
                        jax_draws(keys.pop(0), valid.numpy(), cfg, dt))
    jname, tname = str(tmp_path / "j"), str(tmp_path / "t")
    j = _lines(jcli.main, ["compress"] + SMALL + KSVD + ["--name", jname],
               capsys, x64=f64)
    t = _lines(tcli.main, ["compress"] + SMALL + KSVD
               + ["--name", tname, "--device", "cpu"], capsys, x64=f64)
    assert t[0] == j[0] and t[-1] == j[-1].replace(jname, tname)
    if f64:
        assert t == [s.replace(jname, tname) for s in j]
    else:
        assert abs(_num(t[-2]) - _num(j[-2])) <= 0.03 * _num(j[-2])
    jd = _lines(jcli.main, ["decompress", "--name", jname, "--out",
                            jname + ".pcd"], capsys)
    td = _lines(tcli.main, ["decompress", "--name", tname, "--out",
                            tname + ".pcd", "--device", "cpu"], capsys)
    assert td[1] == f"wrote {tname}.pcd"
    if f64:
        assert td[0] == jd[0]
        a, b = tnative.read_pcd(jname + ".pcd"), tnative.read_pcd(
            tname + ".pcd")
        np.testing.assert_allclose(b[0], a[0], atol=1e-5)
        np.testing.assert_allclose(b[1], a[1], atol=1.0)
    n = int(td[0].split(":")[1])
    assert tnative.read_pcd(tname + ".pcd")[0].shape == (n, 3)


def _close_json(t, j, rel):
    assert t.keys() == j.keys()
    for k in j:
        if isinstance(j[k], dict):
            _close_json(t[k], j[k], rel)
        elif isinstance(j[k], list):
            np.testing.assert_allclose(t[k], j[k], rtol=rel)
        else:
            assert t[k] == pytest.approx(j[k], rel=rel), k


def test_gp_accuracy_matches_jax(capsys, shuffle_bits):
    args = ["gp-accuracy"] + SMALL + ["--eps-tol", "1.0", "--max-steps",
                                      "20", "--baseline", "icp"]
    j, t = (json.loads(s[-1]) for s in _both(args, capsys))
    assert t["initial_mean_err_m"] == j["initial_mean_err_m"]
    assert abs(t["steps"] - j["steps"]) <= 3
    assert abs(t["final_mean_err_m"] - j["final_mean_err_m"]) <= 1e-3
    assert t["mean_likelihood"] == pytest.approx(j["mean_likelihood"],
                                                 rel=0.02)
    ji, ti = j["icp"], t["icp"]
    assert ti["iters"] == ji["iters"]
    assert abs(ti["final_mean_err_m"] - ji["final_mean_err_m"]) <= 1e-3
    assert ti["n_matched"] == pytest.approx(ji["n_matched"], rel=0.02)


@pytest.fixture
def tum_dir(tmp_path):
    d, _ = jtum.make_fixture(str(tmp_path / "tum"), n_frames=4,
                             n_points=3000)
    return d


def test_gp_accuracy_tum_matches_jax(capsys, shuffle_bits, tum_dir):
    args = ["gp-accuracy"] + SMALL + ["--eps-tol", "1.0", "--max-steps",
                                      "20", "--dataset", tum_dir,
                                      "--frame-stride", "1", "--n-pairs", "3"]
    j, t = (list(map(json.loads, s)) for s in _both(args, capsys))
    assert len(t) == len(j) == 4
    for a, b in zip(j[:3], t[:3]):
        assert b["pair"] == a["pair"] and b["gt_trans_m"] == a["gt_trans_m"]
        assert abs(b["steps"] - a["steps"]) <= 8
        assert abs(b["trans_err_m"] - a["trans_err_m"]) <= 5e-3
        assert abs(b["rot_err"] - a["rot_err"]) <= 2e-3
    assert t[3]["n_pairs"] == j[3]["n_pairs"] == 3


@pytest.mark.parametrize("hmc", [False, True], ids=["map", "hmc"])
def test_calibrate_matches_jax_in_float64(capsys, monkeypatch, f64_cloud,
                                          hmc):
    if hmc:
        orig = thmc.hmc_sample_chains

        def fed(logpost, theta0, cfg, n_leapfrog=16, generator=None,
                draws=None):
            d = hmc_run_draws(jax.random.key(0), theta0.shape[0], 3, cfg)
            return orig(logpost, theta0, cfg, n_leapfrog, draws=d)

        monkeypatch.setattr(thmc, "hmc_sample_chains", fed)
    args = ["calibrate"] + SMALL + CALIB + ([] if hmc else ["--map"])
    j, t = (json.loads(s[-1]) for s in _both(args, capsys, x64=True))
    _close_json(t, j, 1e-5 if hmc else 1e-9)


def test_calibrate_map_float32(capsys):
    """JAX's command line fails here (float32 values to json.dumps); the
    port prints, and its values are JAX's MAP ascent on the subsample."""
    args = ["calibrate"] + SMALL + CALIB + ["--map"]
    with pytest.raises(TypeError, match="float32"):
        _lines(jcli.main, args, capsys)
    t = json.loads(_lines(tcli.main, args + ["--device", "cpu"], capsys)[-1])
    with _x64(False):
        cfg = _jax_config(eps_tol=1e-6)
        p, c = jsyn.room_cloud(n=3000, seed=0)
        batch = jcomp.project(jnp.asarray(p), jnp.asarray(c),
                              jnp.ones(len(p), bool), cfg)
        X, y, mask = jcomp.calib_subsample(batch, 8, 16)
        logpost = jhmc.make_patch_logpost(X, y, mask.astype(X.dtype))
        theta, trace = jhmc.map_estimate(
            logpost, jnp.asarray([np.log(100.0), 0.0, np.log(0.1)]),
            steps=20)
        est = np.exp(np.asarray(theta, np.float64))
    for k, v in zip(("sigmaf_sq", "l_sq", "s20"), est):
        assert t[k] == pytest.approx(float(v), rel=1e-4), k
    assert t["logpost"] == pytest.approx(float(trace[-1]), rel=1e-4)


def _scan_info(line):
    head, _, body = line.partition(": ")
    return head, eval(body)          # the printed dict of ints and bools


@pytest.mark.parametrize("dataset", [False, True], ids=["synthetic", "tum"])
def test_gp_mapping_matches_jax(tmp_path, capsys, dataset, request):
    args = ["gp-mapping"] + SMALL + ["--eps-tol", "1.0"]
    if dataset:
        args += ["--dataset", request.getfixturevalue("tum_dir"),
                 "--world-margin", "1.0"]
    else:
        args += ["--n-scans", "3"]
    j = _lines(jcli.main, args + ["--out", str(tmp_path / "j.pcd")], capsys)
    out = str(tmp_path / "t.pcd")
    t = _lines(tcli.main, args + ["--out", out, "--device", "cpu"], capsys)
    assert len(t) == len(j) >= 4
    for a, b in zip(j, t):
        if a.startswith("wrote"):
            na, nb = (int(s.split("(")[1].split()[0]) for s in (a, b))
            assert abs(na - nb) <= 0.02 * na
            assert b == f"wrote {out} ({nb} points)"
            continue
        (ha, ia), (hb, ib) = _scan_info(a), _scan_info(b)
        assert hb == ha and list(ib) == list(ia)
        assert ib["diverged"] == ia["diverged"]
        assert abs(ib["reg_steps"] - ia["reg_steps"]) <= 3
        for k in ("bank_dropped", "patch_overflow", "pend_dropped"):
            assert ib[k] == ia[k]
        if "n_patches" in ia:
            assert abs(ib["n_patches"] - ia["n_patches"]) \
                <= 0.01 * ia["n_patches"]
    assert os.path.exists(out)
