"""Multi-process execution: joining the process group, one rank per device.

The counterpart of `gp_compressor_tpu.parallel.distributed`. Every process
calls `initialize()` once (a no-op when no rendezvous is configured, as
JAX's is without a coordinator), builds one mesh over all ranks with
`global_mesh`, and runs the same program on its own rows. The arguments
default to torchrun's environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
RANK, LOCAL_RANK), so

    torchrun --nproc-per-node N script.py

configures every rank by environment alone. The backend is NCCL for
CUDA ranks and gloo for CPU ranks unless one is named; rank r uses
cuda:{LOCAL_RANK % device_count}, and the CPU only when it is asked for.

Mesh layout: one process holds one device, so the ranks in order are
process-contiguous on `data`; per-patch work stays on its rank and only
the global sums and the gathered chains cross processes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from gp_compressor_tpu_torch.config import MeshConfig
from gp_compressor_tpu_torch.parallel import mesh as mesh_lib


def local_device(device_type: str = "cuda",
                 local_rank: Optional[int] = None) -> torch.device:
    """The device this rank runs on: cuda:{local_rank % device_count}
    (local_rank defaults to LOCAL_RANK, else 0), or the CPU when asked
    for. Raises when CUDA is asked for and there is no card."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device_type='cpu' to run "
                           "on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device_type: str = "cuda") -> None:
    """Join the process group (idempotent).

    init_method defaults to tcp://MASTER_ADDR:MASTER_PORT, world_size to
    WORLD_SIZE and rank to RANK; with no init_method and no MASTER_ADDR /
    MASTER_PORT this is a no-op (a single process). backend defaults to
    nccl for device_type "cuda" (whose ranks first select their device)
    and gloo for "cpu"."""
    if dist.is_initialized():
        return
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            return
        init_method = f"tcp://{addr}:{port}"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """One mesh over all ranks, process-contiguous on the `data` axis (one
    device per process: the ranks in order)."""
    return mesh_lib.make_mesh(cfg, device_type)


def process_local_slice(n_rows: int) -> slice:
    """The rows of a [n_rows, ...] data-sharded array this process owns
    under global_mesh's process-contiguous layout; the remainder goes to
    the last process."""
    pc = dist.get_world_size() if dist.is_initialized() else 1
    pi = dist.get_rank() if dist.is_initialized() else 0
    per = n_rows // pc
    return slice(pi * per, (pi + 1) * per if pi < pc - 1 else n_rows)
