"""Fused SOGP training kernel: CUDA C++ for Hopper, bound with ctypes.

Replaces the Pallas TPU kernel `gp_compressor_tpu/pallas_kernels/
sogp_train.py::_kernel` (`pl.pallas_call` at :327), reached there through
`add_points_batch_pallas`. The kernel (`csrc/sogp_train.cu`) runs the whole
Csató–Opper online training loop of a bank of patch GPs with each patch's
state held on chip, reading the input state and writing a new one.

On the card it is bound by the serial per-row chain, not by bytes: every
point depends on the state the previous point left, so the patches with
the most valid rows set the launch's end, while the state is read once
and written once. The design shortens that chain (see the source): one
warp per patch with no block barriers and scalars from warp butterflies;
loops over the active slots only, switching to the dense loop inside the
kernel once a value turns non-finite; geometric deletions searched only
when a ballot says one can fire; inputs staged a chunk ahead and each
row's kernel vector computed during the previous row; and IEEE divisions
without per-division branches. `launch_geometry` computes the launch
shape (patches per block, rows per lane, shared bytes) from S and D.

The library is built at first use with nvcc into `build/torch_kernels/`
under the repository root, named by a hash of the source so that a
changed source rebuilds, and loaded through its plain C interface
(`nvcc.load_library`).

`add_points_batch_plain` is the plain PyTorch version of the same
function (it delegates to `models.sparse_gp.add_points_batch`); the
wrapper takes it only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from gp_compressor_tpu_torch.config import GPConfig
from gp_compressor_tpu_torch.cuda_kernels.nvcc import load_library
from gp_compressor_tpu_torch.models import sparse_gp
from gp_compressor_tpu_torch.models.sparse_gp import SOGPState
from gp_compressor_tpu_torch.ops.kernels import RBFParams
from gp_compressor_tpu_torch.ops.noise import GaussianNoise
from gp_compressor_tpu_torch.utils.profiling import count, span

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "sogp_train.cu"
MAX_SLOTS = 128
SMEM_DEFAULT = 48 * 1024        # a block's shared memory without the opt-in

# set by build(): library path, build seconds (0.0 when reused) and the
# ptxas register / shared-memory / spill report
BUILD_INFO: dict = {}
_LIB = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, in the
    span `sogp_train.build`. Raises if nvcc is missing or the build
    fails."""
    global _LIB
    if _LIB is None:
        with span("sogp_train.build"):
            _LIB = _build_and_load()
    return _LIB


def _build_and_load() -> ctypes.CDLL:
    lib, info = load_library(SOURCE, "sogp_train")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sogp_train_launch.argtypes = [p] * 14 + [i] * 6 + [f, f, i, i, i, i,
                                                         p]
    lib.sogp_train_launch.restype = i
    lib.sogp_div_test.argtypes = [p, p, p, p, i, p]
    lib.sogp_div_test.restype = i
    lib.sogp_train_error_string.argtypes = [i]
    lib.sogp_train_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    return lib


class LaunchGeometry(NamedTuple):
    warps_per_block: int    # patches per block, one warp each
    rows_per_lane: int      # ceil(S / 32): slots l, l + 32, ... of lane l
    smem_bytes: int         # dynamic shared memory per block


def launch_geometry(S: int, D: int) -> LaunchGeometry:
    """The kernel's launch shape for S slots and D outputs. Each warp keeps
    C and Q as [S][S | 1] float32 in shared memory; a block packs 4, 2 or
    1 patches, the most that fit without the shared-memory opt-in, and 1
    above it (S >= 78)."""
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"the kernel takes 1 to {MAX_SLOTS} slots, got {S}")
    if D not in (1, 3):
        raise ValueError(f"the kernel takes dout 1 or 3, got {D}")
    per_warp = 2 * S * (S | 1) * 4
    warps = next(w for w in (4, 2, 1)
                 if w * per_warp <= SMEM_DEFAULT or w == 1)
    return LaunchGeometry(warps, (S + 31) // 32, warps * per_warp)


def hyper_row(kp: RBFParams, cfg: GPConfig, device, s20=None, eps_tol=None,
              geom=None, dtype=torch.float32) -> torch.Tensor:
    """The kernel's float32[7] hyperparameter row
    [sigmaf^2, l^2, s20, eps_tol, kappa, geom_max_bv, gamma_min * sigmaf^2],
    computed in float32 exactly as the TPU kernel's wrapper does, so that
    overrides (calibrated s20 / eps_tol, geometric sweeps) reach the kernel
    as data. geom: optional (dmin, max_bv, gamma_min_rel) override. dtype:
    the row's dtype (the plain version computes it in its states' dtype,
    so a float64 state trains at float64 hyperparameters)."""
    dt = dtype

    def t(v):
        # a Python number is filled on the device (no host-to-device copy)
        if isinstance(v, torch.Tensor):
            return v.to(dtype=dt, device=device)
        return torch.full((), v, dtype=dt, device=device)
    sf, l2 = t(kp.sigmaf_sq), t(kp.l_sq)
    g_dmin, g_maxbv, g_gmin = (cfg.geom_dmin, cfg.geom_max_bv,
                               cfg.geom_gamma_min_rel) if geom is None else geom
    kappa = sf * torch.exp(t(-0.5) * t(g_dmin) ** 2 / l2)
    return torch.stack([sf, l2, t(cfg.s20 if s20 is None else s20),
                        t(cfg.eps_tol if eps_tol is None else eps_tol),
                        kappa, t(g_maxbv), t(g_gmin) * sf])


def add_points_batch_plain(kp: RBFParams, cfg: GPConfig, states: SOGPState,
                           X: torch.Tensor, Y: torch.Tensor,
                           mask: torch.Tensor, s20=None, eps_tol=None,
                           geom=None, tally=None) -> SOGPState:
    """The plain PyTorch version of the kernel: the same function through
    the unfused per-point loop, fed the same hyperparameter row. tally:
    optional [B, 5] int64 per-patch counts of the training's work (see
    sparse_gp.add_point)."""
    row = hyper_row(kp, cfg, X.device, s20=s20, eps_tol=eps_tol, geom=geom,
                    dtype=states.C.dtype)
    return sparse_gp.add_points_batch(
        RBFParams(row[0], row[1]), GaussianNoise(row[2]), cfg, states, X, Y,
        mask, eps_tol=row[3], geom=(row[4], row[5], row[6]), tally=tally)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(cfg: GPConfig, states: SOGPState, out: SOGPState,
           X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
           row: torch.Tensor) -> None:
    """One kernel launch on the current stream, no synchronise: trains
    `states` on the banks and writes the result into `out` (same shapes,
    separate storage); `states` is left unchanged. row: the
    `hyper_row` on the banks' device. Checks every tensor and raises on
    what the kernel does not take. Each launch counts one
    `sogp_train.launches` (profiling.count)."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    B, P, _ = X.shape
    D, S = cfg.dout, cfg.slots
    if cfg.dim != 2:
        raise ValueError("the kernel takes dim 2")
    geo = launch_geometry(S, D)
    f32 = torch.float32
    _check("X", X, (B, P, 2), f32, dev)
    _check("Y", Y, (B, P, D), f32, dev)
    _check("mask", mask, (B, P), torch.bool, dev)
    _check("row", row, (7,), f32, dev)
    for name, st in (("", states), ("out.", out)):
        _check(name + "bv", st.bv, (B, S, 2), f32, dev)
        _check(name + "alpha", st.alpha, (B, S, D), f32, dev)
        _check(name + "C", st.C, (B, S, S), f32, dev)
        _check(name + "Q", st.Q, (B, S, S), f32, dev)
        _check(name + "active", st.active, (B, S), torch.bool, dev)

    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sogp_train_launch(
            X.data_ptr(), Y.data_ptr(), mask.data_ptr(),
            *[a.data_ptr() for a in states], *[a.data_ptr() for a in out],
            row.data_ptr(), B, P, S, D, cfg.capacity,
            cfg.max_geometric_deletes, cfg.gamma_tiny, cfg.geom_tol,
            int(cfg.novelty_mode == "geometric"), *geo, stream)
    if err != 0:
        raise RuntimeError("sogp_train launch failed: "
                           + lib.sogp_train_error_string(err).decode())
    count("sogp_train.launches")


def inline_division(a: torch.Tensor, b: torch.Tensor):
    """The kernel's division of a by b (CUDA float32, same shape) in its
    two forms: per element, and the row's fast paths with their fix-up.
    For the check that holds both to IEEE division."""
    _check("b", b, tuple(a.shape), torch.float32, a.device)
    if a.device.type != "cuda" or not a.is_contiguous():
        raise ValueError("inline_division takes contiguous CUDA tensors")
    lib = build()
    q, q_fix = torch.empty_like(a), torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.sogp_div_test(a.data_ptr(), b.data_ptr(), q.data_ptr(),
                                q_fix.data_ptr(), a.numel(),
                                torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError("sogp_div_test launch failed: "
                           + lib.sogp_train_error_string(err).decode())
    return q, q_fix


def add_points_batch_cuda(kp: RBFParams, cfg: GPConfig, states: SOGPState,
                          X: torch.Tensor, Y: torch.Tensor,
                          mask: torch.Tensor, s20=None, eps_tol=None,
                          geom=None) -> SOGPState:
    """Train a bank of patch GPs: X [B, P, 2], Y [B, P, D], mask [B, P];
    D in {1, 3}, S = cfg.slots <= 128. Gaussian noise, banks in insertion
    order. s20 / eps_tol: optional scalar overrides of the config
    constants; geom: optional (dmin, max_bv, gamma_min_rel) override.

    CUDA tensors launch the kernel on the current stream (no synchronise)
    and return new state tensors, leaving `states` unchanged; CPU tensors
    take the plain version. This is the only place that chooses by device:
    `compressor.train_gp` calls here unless the plain version is asked
    for."""
    if X.device.type == "cpu":
        return add_points_batch_plain(kp, cfg, states, X, Y, mask, s20=s20,
                                      eps_tol=eps_tol, geom=geom)
    if eps_tol is not None and torch.as_tensor(eps_tol).ndim != 0:
        raise ValueError("the kernel takes one scalar eps_tol")
    out = SOGPState(*[torch.empty_like(a) for a in states])
    row = hyper_row(kp, cfg, X.device, s20=s20, eps_tol=eps_tol, geom=geom)
    launch(cfg, states, out, X, Y, mask, row)
    return out
