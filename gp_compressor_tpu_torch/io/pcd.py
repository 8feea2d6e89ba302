"""PCD (Point Cloud Data) file IO.

The reference leans on PCL's readers (pcl::io::loadPCDFile,
src/test_compress.cpp:13, src/test_gp_mapping_no_vis.cpp:55); this
environment has no PCL, so the framework carries its own reader/writer for
the subset the workloads need: XYZ / XYZRGB, ascii and binary encodings.
A C++ fast path for large binary files is `io/native.py`; this NumPy
implementation is its reference and its fallback.

A copy of `gp_compressor_tpu.io.pcd` (NumPy only), which the port may not
import; tests/test_torch_io.py holds the two readers' arrays equal and the
two writers' files byte-identical.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _parse_header(lines):
    hdr = {}
    for ln in lines:
        if ln.startswith("#") or not ln.strip():
            continue
        k, _, v = ln.partition(" ")
        hdr[k.upper()] = v.strip()
        if k.upper() == "DATA":
            break
    return hdr


def read(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (points [n, 3] float32, colors [n, 3] float32 0..255 or None)."""
    with open(path, "rb") as f:
        raw = f.read()
    # header is ascii text up to and including the DATA line
    end = 0
    lines = []
    while True:
        nl = raw.index(b"\n", end)
        line = raw[end:nl].decode("ascii", "replace")
        lines.append(line)
        end = nl + 1
        if line.startswith("DATA"):
            break
    hdr = _parse_header(lines)
    fields = hdr["FIELDS"].split()
    sizes = list(map(int, hdr["SIZE"].split()))
    types = hdr["TYPE"].split()
    counts = list(map(int, hdr.get("COUNT", " ".join(["1"] * len(fields))).split()))
    n = int(hdr["POINTS"])
    data_kind = hdr["DATA"].split()[0]

    np_map = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "<u1", ("U", 2): "<u2",
              ("U", 4): "<u4", ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4"}
    dtype = np.dtype([
        (fields[i] if counts[i] == 1 else fields[i], np_map[(types[i], sizes[i])],
         (counts[i],) if counts[i] > 1 else ())
        for i in range(len(fields))])

    if data_kind == "ascii":
        txt = raw[end:].decode("ascii", "replace").split()
        ncols = sum(counts)
        arr = np.array(txt[:n * ncols], np.float64).reshape(n, ncols)
        cols = {}
        off = 0
        for i, fld in enumerate(fields):
            cols[fld] = arr[:, off:off + counts[i]]
            off += counts[i]
        pts = np.stack([cols["x"][:, 0], cols["y"][:, 0], cols["z"][:, 0]],
                       -1).astype(np.float32)
        rgb = _extract_rgb_ascii(cols)
        return pts, rgb
    elif data_kind == "binary":
        arr = np.frombuffer(raw[end:end + n * dtype.itemsize], dtype)
        pts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
        rgb = _extract_rgb_binary(arr)
        return pts, rgb
    raise ValueError(f"unsupported PCD DATA kind: {data_kind}")


def _unpack_rgb_float(packed_f32: np.ndarray) -> np.ndarray:
    u = packed_f32.astype(np.float32).view(np.uint32)
    r = (u >> 16) & 0xFF
    g = (u >> 8) & 0xFF
    b = u & 0xFF
    return np.stack([r, g, b], -1).astype(np.float32)


def _extract_rgb_ascii(cols) -> Optional[np.ndarray]:
    if "rgb" in cols:
        return _unpack_rgb_float(cols["rgb"][:, 0].astype(np.float32))
    if "rgba" in cols:
        u = cols["rgba"][:, 0].astype(np.uint32)
        return np.stack([(u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF],
                        -1).astype(np.float32)
    return None


def _extract_rgb_binary(arr) -> Optional[np.ndarray]:
    names = arr.dtype.names
    if "rgb" in names:
        return _unpack_rgb_float(arr["rgb"])
    if "rgba" in names:
        u = arr["rgba"].astype(np.uint32)
        return np.stack([(u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF],
                        -1).astype(np.float32)
    return None


def write(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
          binary: bool = True) -> None:
    """Write XYZ or XYZRGB pcd."""
    n = points.shape[0]
    has_rgb = colors is not None
    fields = "x y z rgb" if has_rgb else "x y z"
    sizes = "4 4 4 4" if has_rgb else "4 4 4"
    types = "F F F F" if has_rgb else "F F F"
    counts = "1 1 1 1" if has_rgb else "1 1 1"
    hdr = (f"# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
           f"FIELDS {fields}\nSIZE {sizes}\nTYPE {types}\nCOUNT {counts}\n"
           f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
           f"DATA {'binary' if binary else 'ascii'}\n")
    pts = np.asarray(points, np.float32)
    if has_rgb:
        c = np.asarray(colors).astype(np.uint32)
        packed = ((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]).astype(np.uint32)
        rgbf = packed.view(np.float32)
        rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                 ("rgb", "<f4")])
        rec["x"], rec["y"], rec["z"], rec["rgb"] = pts[:, 0], pts[:, 1], pts[:, 2], rgbf
    else:
        rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    with open(path, "wb") as f:
        f.write(hdr.encode())
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(repr(float(v)) for v in row) + "\n").encode())
