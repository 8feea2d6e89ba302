"""The plain reference that decides `correct`.

A frozen copy of the plain PyTorch versions of the parts of
gp_compressor_tpu_torch's modules that the cells' checks call (configs,
front end, sparse online GP, sanitize, decompress, the calibration's MAP
ascent), taken so that a later change to the program cannot move the
yardstick. It imports nothing of the program and
never launches the program's CUDA kernel: training runs the per-point
loop (`cuda_kernels/sogp_train.py` here holds only that loop).

TF32 is off, as in the program: a float32 product must not run at TF32's
precision, which is below the configuration's.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
