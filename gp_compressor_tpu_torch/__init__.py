"""gp_compressor_tpu_torch — the GP point-cloud compressor in PyTorch/CUDA.

A port of the JAX package `gp_compressor_tpu` (which stays the reference)
to PyTorch on NVIDIA Hopper. Module paths and function names follow the
JAX package, so each function's counterpart sits at the same place:

  * `geometry/`   voxel binning, plane fits, patch banks (torch ops)
  * `models/`     the batched Csató–Opper sparse online GP (plain torch)
  * `cuda_kernels/` + `csrc/`  the fused SOGP training kernel in CUDA C++
  * `ops/linalg_f32.py`, `models/exact_gp.py`, `inference/hmc.py`
                  the exact-GP marginal posterior, its MAP ascent, HMC
                  and the chain diagnostics
  * `inference/nuts.py`, `vi.py`, `smc.py`  NUTS, ADVI and SMC over
                  poses (chains and particles as batch dims)
  * `workloads/compressor.py`  compress -> decompress round trip, plain
                  and calibrated (MAP or HMC)
  * `workloads/registration.py`  scan-to-map registration
  * `workloads/mapping.py`  the mapping stream and SMC pose refinement
  * `cli.py`      the command line (`python -m gp_compressor_tpu_torch.cli`)
  * `io/`         PCD (NumPy and the native C++ library), TUM datasets,
                  the K-SVD artifact, checkpoints, the JAX state converter
  * `utils/`      synthetic clouds, spans and counters, headless renders

The package imports torch and numpy only — never jax, and nothing from
`gp_compressor_tpu` (whose `config` imports `jax.numpy`).

TF32 is switched off for matrix products and cuDNN: the JAX code asks for
`Precision.HIGHEST` on every state contraction, and the novelty term
gamma = k** - k^T Q k cancels far below TF32's three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from gp_compressor_tpu_torch import config  # noqa: E402,F401
