"""The K-SVD atom block kernel's wrapper on the CPU: its launch geometry,
and the argument checks that raise before any build (the kernel itself
runs only on a card: tests/test_torch_gpu.py)."""

import pytest
import torch

from gp_compressor_tpu_torch.cuda_kernels import ksvd_power
from gp_compressor_tpu_torch.models import dictionary
from gp_compressor_tpu_torch.utils import profiling


@pytest.mark.parametrize("n, l, itemsize, rows_cap", [
    (2048, 400, 4, 66),       # depth, float32
    (6144, 400, 4, 63),       # colour, float32
    (2048, 400, 8, 30),       # depth, float64
    (300, 49, 8, 38),         # a small problem: every user staged
])
def test_power_geometry(n, l, itemsize, rows_cap):
    geo = ksvd_power.power_geometry(n, l, itemsize)
    assert geo.idx_cap == -(-n // ksvd_power.CLUSTER)
    assert geo.rows_cap == rows_cap <= geo.idx_cap
    assert geo.smem_bytes <= ksvd_power.SMEM_MAX
    fixed = itemsize * (4 * l + 2 + geo.idx_cap + ksvd_power.WARPS) \
        + 4 * (geo.idx_cap + ksvd_power.WARPS)
    assert geo.smem_bytes == fixed + rows_cap * l * itemsize
    if rows_cap < geo.idx_cap:        # one more row would not fit
        assert geo.smem_bytes + l * itemsize > ksvd_power.SMEM_MAX


def test_power_geometry_rejects_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        ksvd_power.power_geometry(2048, 20_000, 4)
    with pytest.raises(ValueError, match="shared memory"):
        ksvd_power.power_geometry(2048, 0, 4)


def _args(n=64, l=8, b=4, dtype=torch.float32):
    return dict(R=torch.zeros((n, l), dtype=dtype),
                W=torch.ones((n, l), dtype=dtype),
                dj=torch.zeros((l, b + 2), dtype=dtype)[:, 1:b + 1].T,
                xj=torch.zeros((b, n), dtype=dtype),
                using=torch.zeros((b, n), dtype=torch.bool), iters=20)


def _bad(name):
    a = _args()
    if name == "half":
        a = _args(dtype=torch.float16)
    elif name == "mixed_dtype":
        a["W"] = a["W"].double()
    elif name == "using_not_bool":
        a["using"] = a["using"].to(torch.uint8)
    elif name == "W_shape":
        a["W"] = a["W"][:-1]
    elif name == "xj_shape":
        a["xj"] = a["xj"][:, :-1]
    elif name == "using_shape":
        a["using"] = a["using"][:-1]
    elif name == "dj_shape":
        a["dj"] = a["dj"][:, :-1]
    elif name == "R_3d":
        a["R"] = a["R"][None]
    elif name == "R_strided":
        a["R"] = torch.zeros((64, 16))[:, ::2]
    elif name == "xj_strided":
        a["xj"] = a["xj"].T.contiguous().T
    elif name == "using_strided":
        a["using"] = a["using"].T.contiguous().T
    elif name == "negative_iters":
        a["iters"] = -1
    return a


@pytest.mark.parametrize("name, exc, match", [
    ("half", TypeError, "float32 or float64"),
    ("mixed_dtype", TypeError, "W has dtype"),
    ("using_not_bool", TypeError, "using has dtype"),
    ("W_shape", ValueError, "W has shape"),
    ("xj_shape", ValueError, "xj has shape"),
    ("using_shape", ValueError, "using has shape"),
    ("dj_shape", ValueError, "dj has shape"),
    ("R_3d", ValueError, "matrices"),
    ("R_strided", ValueError, "R must be contiguous"),
    ("xj_strided", ValueError, "xj must be contiguous"),
    ("using_strided", ValueError, "using must be contiguous"),
    ("negative_iters", ValueError, "iters"),
    ("cpu", ValueError, "one CUDA device"),
])
def test_block_wrapper_checks_before_any_build(monkeypatch, name, exc, match):
    """Each check raises before the wrapper builds anything; a strided
    view of the dictionary's columns is taken as dj (`cpu`: everything
    right but the device)."""
    def no_build():
        raise AssertionError("the wrapper tried to build")

    monkeypatch.setattr(ksvd_power, "build", no_build)
    with pytest.raises(exc, match=match):
        ksvd_power.block_power(**_bad(name))


def test_block_update_on_cpu_takes_the_plain_version():
    """On CPU tensors _block_update is _block_update_plain: no launch
    counted, the same values bit for bit (atoms with and without users)."""
    from gp_compressor_tpu_torch.testing import ksvd_case

    R, W, D, xj, using = (torch.from_numpy(a) for a in
                          ksvd_case.block_problem(200, 30, 6, 180))
    dj = D[:, 2:8].T
    k0 = profiling.counters().get("ksvd.block_kernels", 0)
    got = dictionary._block_update(R, W, dj, xj, using, 20)
    want = dictionary._block_update_plain(R, W, dj, xj, using, 20)
    assert profiling.counters().get("ksvd.block_kernels", 0) == k0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0][0], dj[0]) and torch.equal(got[1][0], xj[0])
    assert torch.equal(got[1][1:] != 0, using[1:])
