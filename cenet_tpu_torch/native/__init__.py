"""The port's native helpers, C++ built at first use and loaded with ctypes.

* ``native/edt.cpp`` (at the repository root; the JAX package builds the same
  source, ``cenet_tpu/native/__init__.py``): the exact Euclidean distance
  transform of the HD95 metric, :func:`edt`.
* ``cenet_tpu_torch/native/zstd_decode.cpp``: a Zstandard frame decoder
  (RFC 8878) and CRC-32C, which read the JAX package's Orbax checkpoints
  (:mod:`cenet_tpu_torch.core.orbax`), :func:`zstd_decompress` and
  :func:`crc32c`.

At first use ``g++ -O3 -shared -fPIC`` compiles a source into
``cenet_tpu_torch/_build/<name>-<hash>/lib<...>.so``, keyed on a hash of the
source and the flags, so a changed source rebuilds and later uses load; a lock
makes threads build it once. Nothing runs at import time. A missing compiler or
a failed build raises: the metrics do not quietly fall back to scipy, nor the
checkpoint reader to another decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)

# name → (source, shared object, {symbol: (restype, argtypes)})
LIBRARIES = {
    "edt": (Path(__file__).resolve().parents[2] / "native" / "edt.cpp", "libcenet_edt.so", {
        "cenet_edt": (ctypes.c_int, [_u8p, _f64p, ctypes.c_int, _i64p, _f64p]),
    }),
    "zstd": (Path(__file__).resolve().with_name("zstd_decode.cpp"), "libcenet_zstd.so", {
        "cenet_zstd_content_size": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                                     ctypes.c_size_t]),
        "cenet_zstd_decompress": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                                   ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]),
        "cenet_crc32c": (ctypes.c_uint32, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]),
    }),
}

_lock = threading.Lock()
_libs: dict = {}


def build_dir(name: str) -> Path:
    src = LIBRARIES[name][0]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` of :data:`LIBRARIES`, built on first use."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src, so_name, symbols = LIBRARIES[name]
        out = build_dir(name)
        so = out / so_name
        if not so.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"g++ not found: {src.name} needs a C++ compiler to build")
            out.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: a reader never sees a partial file
        lib = ctypes.CDLL(str(so))
        for sym, (restype, argtypes) in symbols.items():
            fn = getattr(lib, sym)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[name] = lib
        return lib


def edt(mask: np.ndarray, sampling=None) -> np.ndarray:
    """``scipy.ndimage.distance_transform_edt(mask, sampling)`` for 1- to 3-D
    masks: for each non-zero element, the distance to the nearest zero element,
    in float64."""
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if not 1 <= m.ndim <= 3:
        raise ValueError(f"edt takes 1- to 3-D masks, got {m.ndim}-D")
    lib = load("edt")
    out = np.empty(m.shape, np.float64)
    shape = (ctypes.c_int64 * m.ndim)(*m.shape)
    samp = None
    if sampling is not None:
        s = np.asarray(sampling, np.float64)
        s = np.full((m.ndim,), float(s)) if s.ndim == 0 else s
        if s.shape != (m.ndim,):
            raise ValueError(f"sampling {tuple(s.shape)} does not fit a {m.ndim}-D mask")
        samp = (ctypes.c_double * m.ndim)(*s)
    rc = lib.cenet_edt(m.ctypes.data_as(_u8p), out.ctypes.data_as(_f64p), m.ndim, shape, samp)
    if rc != 0:
        raise RuntimeError(f"cenet_edt failed with code {rc}")
    return out


MAX_DECODED_BYTES = 1 << 34  # where a frame that does not state its size stops growing the output


def zstd_decompress(data, size: int | None = None) -> np.ndarray:
    """The content of the zstd frames in ``data`` (bytes-like), as a uint8
    array. ``size``, when given, is the exact number of bytes expected. Raises
    ``ValueError`` on a malformed, truncated or corrupt input (a content
    checksum that disagrees included), or when the content is not ``size``
    bytes."""
    src = np.frombuffer(data, np.uint8)
    lib = load("zstd")
    err = ctypes.create_string_buffer(256)
    if size is None:
        stated = lib.cenet_zstd_content_size(src.ctypes.data, src.size, err, len(err))
        if stated == -1:
            raise ValueError(f"zstd: {err.value.decode()}")
        cap = int(stated) if stated >= 0 else max(4 * src.size, 1 << 16)
    else:
        cap = int(size)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = lib.cenet_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, cap, err, len(err))
        if n == -2 and size is None and cap < MAX_DECODED_BYTES:
            cap = min(2 * cap, MAX_DECODED_BYTES)  # the frames did not state their size
            continue
        if n == -2:
            raise ValueError(f"zstd: content larger than {cap} bytes")
        if n < 0:
            raise ValueError(f"zstd: {err.value.decode()}")
        if size is not None and n != size:
            raise ValueError(f"zstd: content of {n} bytes where {size} were expected")
        return out[:n]


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    src = np.frombuffer(data, np.uint8)
    return int(load("zstd").cenet_crc32c(src.ctypes.data, src.size, crc))
