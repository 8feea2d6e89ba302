"""Binary artifact (de)serialization — the `.pccode` / `.pcdict` format.

Byte-compatible with the reference's dictionary_representation
(src/dictionary_representation.cpp:48-138 read, :173-248 write):

  <name>depth.pcdict : int32 cols, int32 rows, float32 column-major data
  <name>rgb.pcdict   : same
  <name>.pccode      :
     int32 nbr, sz, words_max, RGB_words_max, dict_size, RGB_dict_size
     float32 res
     nbr * float32[3]            patch means
     nbr * float32[4]            rotations (quaternion x,y,z,w — Eigen coeffs)
     per patch: u8 nw, nw*float32 codes
     per patch: nw * uint16      atom indices
     nbr * float32[3]            RGB means
     per 3*nbr:  u8 nw, nw*float32 RGB codes
     per 3*nbr:  nw * uint16     RGB atom indices
     bit-packed masks, LSB-first within each byte (:37-46,157-171)

A copy of `gp_compressor_tpu.io.artifact` (NumPy only), which the port
may not import; tests/test_torch_ksvd_compressor.py holds the files both
write byte-identical.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class Artifact(NamedTuple):
    """Host-side contents of a compressed artifact (padding stripped)."""

    res: float
    sz: int
    D: np.ndarray            # [l, dict_size] float32
    RGB_D: np.ndarray        # [l, RGB_dict_size] float32
    words_max: int
    RGB_words_max: int
    means: np.ndarray        # [n, 3] float32
    quats: np.ndarray        # [n, 4] float32 (x, y, z, w)
    rgb_means: np.ndarray    # [n, 3] float32
    X: np.ndarray            # [n, words_max] float32
    I: np.ndarray            # [n, words_max] int32
    nw: np.ndarray           # [n] int32
    RGB_X: np.ndarray        # [3n, RGB_words_max] float32
    RGB_I: np.ndarray        # [3n, RGB_words_max] int32
    RGB_nw: np.ndarray       # [3n] int32
    W: np.ndarray            # [n, sz*sz] bool


def _write_dict(path: str, D: np.ndarray) -> None:
    rows, cols = D.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", cols, rows))
        f.write(np.asarray(D, "<f4").T.tobytes())   # column-major like Eigen


def _read_dict(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        cols, rows = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(4 * rows * cols), "<f4")
    return data.reshape(cols, rows).T.copy()


def _pack_bits(bits: np.ndarray) -> bytes:
    """LSB-first bit packing (dictionary_representation::write_bool,
    :157-171; always flushes a final byte via close_write_bools)."""
    bits = np.asarray(bits, np.uint8).reshape(-1)
    nbytes = max(1, -(-len(bits) // 8))  # ceil; close_write_bools flushes the
    padded = np.zeros(nbytes * 8, np.uint8)   # partially-filled last byte
    padded[:len(bits)] = bits
    return np.packbits(padded, bitorder="little").tobytes()


def _unpack_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8),
                         bitorder="little")[:n].astype(bool)


def write(name: str, art: Artifact) -> None:
    _write_dict(name + "rgb.pcdict", art.RGB_D)
    _write_dict(name + "depth.pcdict", art.D)

    n = art.means.shape[0]
    out = bytearray()
    out += struct.pack("<iiii", n, art.sz, art.words_max, art.RGB_words_max)
    out += struct.pack("<ii", art.D.shape[1], art.RGB_D.shape[1])
    out += struct.pack("<f", art.res)
    out += np.asarray(art.means, "<f4").tobytes()
    out += np.asarray(art.quats, "<f4").tobytes()
    for i in range(n):
        w = int(art.nw[i])
        out += struct.pack("<B", w)
        out += np.asarray(art.X[i, :w], "<f4").tobytes()
    for i in range(n):
        w = int(art.nw[i])
        out += np.asarray(art.I[i, :w], "<u2").tobytes()
    out += np.asarray(art.rgb_means, "<f4").tobytes()
    for i in range(3 * n):
        w = int(art.RGB_nw[i])
        out += struct.pack("<B", w)
        out += np.asarray(art.RGB_X[i, :w], "<f4").tobytes()
    for i in range(3 * n):
        w = int(art.RGB_nw[i])
        out += np.asarray(art.RGB_I[i, :w], "<u2").tobytes()
    out += _pack_bits(np.asarray(art.W, np.uint8))
    with open(name + ".pccode", "wb") as f:
        f.write(bytes(out))


def read(name: str) -> Artifact:
    RGB_D = _read_dict(name + "rgb.pcdict")
    D = _read_dict(name + "depth.pcdict")
    with open(name + ".pccode", "rb") as f:
        data = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        sz = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, data, off)
        off += sz
        return vals

    def take_np(dtype, count):
        nonlocal off
        a = np.frombuffer(data, dtype, count=count, offset=off)
        off += a.nbytes
        return a

    n, sz, words_max, rgb_words_max = take("<iiii")
    dict_size, rgb_dict_size = take("<ii")
    (res,) = take("<f")
    means = take_np("<f4", 3 * n).reshape(n, 3).copy()
    quats = take_np("<f4", 4 * n).reshape(n, 4).copy()

    X = np.zeros((n, words_max), np.float32)
    nw = np.zeros(n, np.int32)
    for i in range(n):
        (w,) = take("<B")
        nw[i] = w
        X[i, :w] = take_np("<f4", w)
    I = np.zeros((n, words_max), np.int32)
    for i in range(n):
        I[i, :nw[i]] = take_np("<u2", int(nw[i]))
    rgb_means = take_np("<f4", 3 * n).reshape(n, 3).copy()
    RGB_X = np.zeros((3 * n, rgb_words_max), np.float32)
    RGB_nw = np.zeros(3 * n, np.int32)
    for i in range(3 * n):
        (w,) = take("<B")
        RGB_nw[i] = w
        RGB_X[i, :w] = take_np("<f4", w)
    RGB_I = np.zeros((3 * n, rgb_words_max), np.int32)
    for i in range(3 * n):
        RGB_I[i, :RGB_nw[i]] = take_np("<u2", int(RGB_nw[i]))
    W = _unpack_bits(data[off:], n * sz * sz).reshape(n, sz * sz)

    return Artifact(res=res, sz=sz, D=D, RGB_D=RGB_D, words_max=words_max,
                    RGB_words_max=rgb_words_max, means=means, quats=quats,
                    rgb_means=rgb_means, X=X, I=I, nw=nw, RGB_X=RGB_X,
                    RGB_I=RGB_I, RGB_nw=RGB_nw, W=W)
