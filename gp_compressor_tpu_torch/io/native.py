"""ctypes bindings for the native IO library (`native/gpio.cpp` at the
repository root): a binary PCD reader and writer and the `.pccode` /
`.pcdict` artifact writer, byte-identical to `io/pcd.py` and
`io/artifact.py`.

The library is compiled at first use with `g++ -O3 -std=c++17 -shared
-fPIC` into `build/torch_native/` under the repository root, named by a
hash of the source and flags, so that a changed source rebuilds. The
prebuilt `native/libgpio.so` and `native/build.sh` are left alone: the
build script rewrites that tracked file whenever it looks older than the
source, which a fresh checkout can make it.

Only when no C++ compiler is on PATH do the functions fall back to the
NumPy implementations (the same bytes and arrays, slower). A build or load
that fails with a compiler present raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gpio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lib = None


def build() -> Optional[ctypes.CDLL]:
    """Compile (once per source hash) and load the library; None when no
    C++ compiler is on PATH. Raises when the build or the load fails."""
    global _lib
    if _lib is not None:
        return _lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    digest = digest[:16]
    lib_path = BUILD_DIR / f"libgpio_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i, lng = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.gpio_pcd_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(lng),
                                  ctypes.POINTER(i)]
    lib.gpio_pcd_read.argtypes = [ctypes.c_char_p, p, p]
    lib.gpio_pcd_write.argtypes = [ctypes.c_char_p, p, p, lng, i]
    lib.gpio_dict_write.argtypes = [ctypes.c_char_p, p, lng, lng]
    lib.gpio_dict_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(lng),
                                   ctypes.POINTER(lng)]
    lib.gpio_dict_read.argtypes = [ctypes.c_char_p, p]
    lib.gpio_pccode_write.argtypes = [ctypes.c_char_p] + [ctypes.c_int32] * 6 \
        + [ctypes.c_float] + [p] * 9
    for fn in (lib.gpio_pcd_info, lib.gpio_pcd_read, lib.gpio_pcd_write,
               lib.gpio_dict_write, lib.gpio_dict_info, lib.gpio_dict_read,
               lib.gpio_pccode_write):
        fn.restype = i
    _lib = lib
    return lib


def available() -> bool:
    return build() is not None


def read_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(points [n, 3] float32, colors [n, 3] float32 0..255 or None)."""
    lib = build()
    if lib is None:
        from gp_compressor_tpu_torch.io import pcd
        return pcd.read(path)
    n = ctypes.c_long()
    has_rgb = ctypes.c_int()
    rc = lib.gpio_pcd_info(path.encode(), ctypes.byref(n),
                           ctypes.byref(has_rgb))
    if rc != 0:
        raise IOError(f"gpio_pcd_info({path}) failed rc={rc}")
    xyz = np.empty((n.value, 3), np.float32)
    rgb = np.empty((n.value, 3), np.float32) if has_rgb.value else None
    rc = lib.gpio_pcd_read(
        path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p) if rgb is not None else None)
    if rc != 0:
        raise IOError(f"gpio_pcd_read({path}) failed rc={rc}")
    return xyz, rgb


def write_pcd(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None, binary: bool = True):
    """Write an XYZ or XYZRGB PCD (points [n, 3], colors [n, 3] 0..255)."""
    lib = build()
    if lib is None:
        from gp_compressor_tpu_torch.io import pcd
        return pcd.write(path, points, colors, binary)
    xyz = np.ascontiguousarray(points, np.float32)
    rgb = None if colors is None else np.ascontiguousarray(colors, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or (
            rgb is not None and rgb.shape != xyz.shape):
        shape = None if rgb is None else rgb.shape
        raise ValueError(f"points {xyz.shape} and colors {shape} must be "
                         "[n, 3]")
    rc = lib.gpio_pcd_write(
        path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p) if rgb is not None else None,
        xyz.shape[0], 1 if binary else 0)
    if rc != 0:
        raise IOError(f"gpio_pcd_write({path}) failed rc={rc}")


def write_artifact(name: str, art) -> bool:
    """Native .pccode/.pcdict writer (byte-identical to io/artifact.py).
    Returns False when no compiler is there to build the library (the
    caller then takes io/artifact.write)."""
    lib = build()
    if lib is None:
        return False
    keep = []

    def cp(a, dt):
        a = np.ascontiguousarray(a, dt)
        keep.append(a)
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.gpio_dict_write(
        (name + "rgb.pcdict").encode(), cp(art.RGB_D, np.float32),
        art.RGB_D.shape[0], art.RGB_D.shape[1])
    rc |= lib.gpio_dict_write(
        (name + "depth.pcdict").encode(), cp(art.D, np.float32),
        art.D.shape[0], art.D.shape[1])
    n = art.means.shape[0]
    rc |= lib.gpio_pccode_write(
        (name + ".pccode").encode(),
        ctypes.c_int32(n), ctypes.c_int32(art.sz),
        ctypes.c_int32(art.words_max), ctypes.c_int32(art.RGB_words_max),
        ctypes.c_int32(art.D.shape[1]), ctypes.c_int32(art.RGB_D.shape[1]),
        ctypes.c_float(art.res),
        cp(art.means, np.float32), cp(art.quats, np.float32),
        cp(art.rgb_means, np.float32),
        cp(art.X, np.float32), cp(art.I, np.int32), cp(art.nw, np.int32),
        cp(art.RGB_X, np.float32), cp(art.RGB_I, np.int32),
        cp(art.RGB_nw, np.int32), cp(art.W, np.uint8))
    if rc != 0:
        raise IOError(f"native artifact write failed rc={rc}")
    return True
