"""The port's CUDA libraries: built with nvcc, loaded with ctypes.

A source under `csrc/` compiles into a shared library with a plain C
interface, once per hash of the source and the flags, into
`build/torch_kernels/` under the repository root (`<stem>_<hash>.so`,
beside it the ptxas report as `.log`); a changed source rebuilds. Only the
machine with the card builds: nvcc is not needed to import the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def load_library(source: Path, stem: str) -> tuple:
    """(the loaded library, {path, seconds, ptxas}) for `source`: built
    into BUILD_DIR unless a library of the same hash is there (seconds
    0.0 then). Raises if nvcc is missing or the build fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{stem}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
               "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    return lib, {"path": str(lib_path), "seconds": seconds,
                 "ptxas": log_path.read_text() if log_path.exists() else ""}
