"""Port config and synthetic cloud against the JAX package: exact."""

import dataclasses

import numpy as np
import pytest
import torch

from gp_compressor_tpu import config as jcfg
from gp_compressor_tpu.utils import synthetic as jsyn
from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.io import convert
from gp_compressor_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)


def _assert_same_fields(j, t):
    """The JAX config's fields, in order, and the port's documented own
    fields (tcfg.PORT_ONLY) after them, at their defaults."""
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    own = tcfg.PORT_ONLY.get(type(t).__name__, ())
    assert [f.name for f in jf] + list(own) == [f.name for f in tf]
    for name in own:
        f = {f.name: f for f in tf}[name]
        assert getattr(t, name) == f.default, name
    for f in jf:
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "dtype":
            assert isinstance(b, torch.dtype)
            assert "torch." + np.dtype(a).name == str(b)
        elif dataclasses.is_dataclass(a):
            _assert_same_fields(a, b)
        else:
            assert type(a) is type(b) and a == b, f.name


@pytest.mark.parametrize("make", ["GPConfig", "PatchConfig", "KSVDConfig",
                                  "CompressorConfig", "rgb_gp_config",
                                  "rgb_ksvd_config", "RegistrationConfig",
                                  "HMCConfig", "MappingConfig", "SMCConfig",
                                  "MeshConfig"])
def test_config_defaults_match_jax(make):
    _assert_same_fields(getattr(jcfg, make)(), getattr(tcfg, make)())


def test_config_converts_from_jax_fields():
    """A non-default (bench-shaped) JAX config carried across field by
    field equals the same config built in the port."""
    def mk(m):
        return m.CompressorConfig(
            patch=m.PatchConfig(res=0.15, sz=20, max_patches=2048,
                                max_points_per_patch=256,
                                approx_sphere_moments=True,
                                bank_order="center_out"),
            depth_gp=m.GPConfig(capacity=30, slots=32, eps_tol=2.0),
            rgb_gp=dataclasses.replace(m.rgb_gp_config(slots=32, capacity=30),
                                       eps_tol=2.0),
            ksvd=m.KSVDConfig(atom_block=16))
    got = convert.compressor_config_from_dict(dataclasses.asdict(mk(jcfg)))
    assert got == mk(tcfg)
    _assert_same_fields(mk(jcfg), got)
    # the registration, HMC and SMC configs, with options off their
    # defaults
    kw = dict(step_mode="rprop", max_steps=80, max_motion=0.004,
              grad_tol_step_ref=0.1, bank_points=48)
    got = convert.registration_config_from_dict(
        dataclasses.asdict(jcfg.RegistrationConfig(**kw)))
    assert got == tcfg.RegistrationConfig(**kw)
    got = convert.hmc_config_from_dict(
        dataclasses.asdict(jcfg.HMCConfig(num_chains=2, num_warmup=40)))
    assert got == tcfg.HMCConfig(num_chains=2, num_warmup=40)
    kw = dict(num_particles=256, pose_proposal_std_t=0.012,
              pose_proposal_std_r=0.004)
    got = convert.smc_config_from_dict(dataclasses.asdict(
        jcfg.SMCConfig(**kw)))
    assert got == tcfg.SMCConfig(**kw)
    _assert_same_fields(jcfg.SMCConfig(**kw), got)


def test_gp_config_rejects_too_few_slots():
    with pytest.raises(ValueError):
        tcfg.GPConfig(capacity=16, slots=16)


@pytest.mark.parametrize("n,seed", [(1000, 0), (4321, 7), (300, 3)])
def test_room_cloud_is_byte_identical(n, seed):
    pj, cj = jsyn.room_cloud(n=n, seed=seed)
    pt, ct = tsyn.room_cloud(n=n, seed=seed)
    for a, b in ((pj, pt), (cj, ct)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rotvec,t,dtype", [
    ([0.0, 0.008, -0.006], [0.02, -0.015, 0.01], np.float32),
    ([0.3, -1.2, 2.5], [1.0, 2.0, -3.0], np.float64),
    ([0.0, 0.0, 0.0], [0.5, 0.0, 0.0], np.float32)])
def test_rigid_transform_is_byte_identical(rotvec, t, dtype):
    pts = np.random.default_rng(3).standard_normal((500, 3)).astype(dtype)
    pj, Rj = jsyn.rigid_transform(pts, rotvec, t)
    pt, Rt = tsyn.rigid_transform(pts, rotvec, t)
    assert pj.dtype == pt.dtype == dtype
    assert pj.tobytes() == pt.tobytes() and Rj.tobytes() == Rt.tobytes()
