"""K-SVD atom block update: CUDA C++ for Hopper, bound with ctypes.

For each atom j of a block, the largest singular pair of the masked
residual with the atom's own part restored, A_j = R + W o (x_j d_j^T),
restricted to the atom's users, by the fixed-count NIPALS iteration of
`models/dictionary._power_iteration`: u (the new atom, [b, l]) and
x_new = sigma v on the users, 0 elsewhere ([b, n]). An atom without users
keeps d_j and x_j. `models/dictionary._block_update_plain` is the plain
PyTorch version (the dense [b, n, l] stack), which CPU tensors take.

The kernel (`csrc/ksvd_power.cu`) replaces no TPU kernel: it runs an
atom's whole loop in one cluster of CTAs over the user rows only, so a
block of atoms is one launch instead of ~120, and reads no dense stack.
It is bound by its chain of iters + 1 cluster-wide exchanges, not by
bytes. `power_geometry` gives the launch shape from n, l and the dtype.

The library is built at first use with nvcc into `build/torch_kernels/`
(`nvcc.load_library`, in the span `ksvd_power.build`). Each launch counts
one `ksvd.block_kernels` (profiling.count).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from gp_compressor_tpu_torch.cuda_kernels.nvcc import load_library
from gp_compressor_tpu_torch.utils.profiling import count, span

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ksvd_power.cu"
CLUSTER = 8                 # CTAs per atom (kCluster in the source)
THREADS = 256               # threads per CTA (kThreads)
WARPS = THREADS // 32
# dynamic shared memory a CTA may take: half of an H100 SM's 228 KB less
# a block's 1 KB reserve, so that two CTAs share an SM and the card runs
# a block's 16 clusters at once (at the 227 KB a block can have it runs 15)
SMEM_MAX = 112 * 1024
DTYPES = (torch.float32, torch.float64)

# set by build(): library path, build seconds (0.0 when reused) and the
# ptxas report
BUILD_INFO: dict = {}
_LIB = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, in the
    span `ksvd_power.build`. Raises if nvcc is missing or the build
    fails."""
    global _LIB
    if _LIB is None:
        with span("ksvd_power.build"):
            lib, info = load_library(SOURCE, "ksvd_power")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ksvd_power_launch.argtypes = [p] * 3 + [ll, ll] + [p] * 5 \
                + [i] * 8 + [p]
            lib.ksvd_power_launch.restype = i
            lib.ksvd_power_max_clusters.argtypes = [i, i,
                                                    ctypes.POINTER(i)]
            lib.ksvd_power_max_clusters.restype = i
            lib.ksvd_power_error_string.argtypes = [i]
            lib.ksvd_power_error_string.restype = ctypes.c_char_p
            BUILD_INFO.update(info)
            _LIB = lib
    return _LIB


class PowerGeometry(NamedTuple):
    idx_cap: int      # most users one CTA holds: ceil(n / CLUSTER)
    rows_cap: int     # user rows a CTA stages in shared memory
    smem_bytes: int   # dynamic shared memory per CTA


def power_geometry(n: int, l: int, itemsize: int) -> PowerGeometry:
    """The launch shape for n rows of length l in itemsize-byte floats.
    A CTA keeps u, d_j, two partials of l + 1, v' and the row indices of
    its users, and stages as many user rows as the rest of SMEM_MAX
    holds, never more than it can have; the rest it re-forms from R and
    W on each pass."""
    idx_cap = -(-n // CLUSTER)
    fixed = itemsize * (4 * l + 2 + idx_cap + WARPS) + 4 * (idx_cap + WARPS)
    if l < 1 or fixed > SMEM_MAX:
        raise ValueError(f"n={n}, l={l} does not fit a CTA's shared memory")
    rows_cap = min(idx_cap, (SMEM_MAX - fixed) // (l * itemsize))
    return PowerGeometry(idx_cap, rows_cap, fixed + rows_cap * l * itemsize)


def _check(name, t, shape, dtype, contiguous=True):
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def block_power(R: torch.Tensor, W: torch.Tensor, dj: torch.Tensor,
                xj: torch.Tensor, using: torch.Tensor, iters: int):
    """One launch on the current stream, no synchronise: (u [b, l], x_new
    [b, n]) for the b atoms of a block. R, W [n, l] and xj [b, n]
    contiguous, float32 or float64 alike; dj [b, l] at any strides (a
    view of the dictionary's columns); using [b, n] bool, contiguous; all
    on one CUDA device. Checks every tensor, before any build, and raises
    on what the kernel does not take."""
    if R.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or float64, got {R.dtype}")
    if R.ndim != 2 or dj.ndim != 2:
        raise ValueError(f"R and dj must be matrices, got {tuple(R.shape)} "
                         f"and {tuple(dj.shape)}")
    (n, l), b = R.shape, dj.shape[0]
    _check("R", R, (n, l), R.dtype)
    _check("W", W, (n, l), R.dtype)
    _check("dj", dj, (b, l), R.dtype, contiguous=False)
    _check("xj", xj, (b, n), R.dtype)
    _check("using", using, (b, n), torch.bool)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = R.device
    if dev.type != "cuda" or any(t.device != dev for t in (W, dj, xj, using)):
        raise ValueError(f"the kernel needs all tensors on one CUDA device, "
                         f"got {[str(t.device) for t in (R, W, dj, xj, using)]}")
    geo = power_geometry(n, l, R.element_size())
    u = torch.empty((b, l), dtype=R.dtype, device=dev)
    x_new = torch.empty((b, n), dtype=R.dtype, device=dev)
    # max |R|: non-finite exactly when R holds a non-finite value
    rmax = torch.linalg.vector_norm(R, math.inf)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.ksvd_power_launch(
            R.data_ptr(), W.data_ptr(), dj.data_ptr(), dj.stride(0),
            dj.stride(1), xj.data_ptr(), using.data_ptr(), rmax.data_ptr(),
            u.data_ptr(), x_new.data_ptr(), b, n, l, int(iters), *geo,
            R.element_size(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("ksvd_power launch failed: "
                           + lib.ksvd_power_error_string(err).decode())
    count("ksvd.block_kernels")
    return u, x_new


def max_active_clusters(n: int, l: int, dtype=torch.float32) -> int:
    """How many atoms' clusters the card runs at once at this geometry
    (cudaOccupancyMaxActiveClusters)."""
    size = torch.empty((), dtype=dtype).element_size()
    lib, out = build(), ctypes.c_int(0)
    err = lib.ksvd_power_max_clusters(power_geometry(n, l, size).smem_bytes,
                                      size, ctypes.byref(out))
    if err != 0:
        raise RuntimeError("cudaOccupancyMaxActiveClusters failed: "
                           + lib.ksvd_power_error_string(err).decode())
    return out.value
