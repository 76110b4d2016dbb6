"""The repository's C++ exact Euclidean distance transform (``native/edt.cpp``), loaded with ctypes.

The port's own loader of the source the JAX package also builds
(``cenet_tpu/native/__init__.py``); nothing of that package is imported. At
first use ``g++ -O3 -shared -fPIC`` compiles ``native/edt.cpp`` into
``cenet_tpu_torch/_build/edt-<hash>/libcenet_edt.so``, keyed on a hash of the
source and the flags, so a changed source rebuilds and later uses load. Nothing
runs at import time. A missing compiler or a failed build raises: the metrics
do not quietly fall back to scipy.
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

SRC = Path(__file__).resolve().parents[2] / "native" / "edt.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"edt-{h.hexdigest()[:16]}"


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _build_dir()
        so = out / "libcenet_edt.so"
        if not so.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the native EDT needs a C++ compiler to build")
            out.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)], capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: a reader never sees a partial file
        lib = ctypes.CDLL(str(so))
        lib.cenet_edt.restype = ctypes.c_int
        lib.cenet_edt.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return lib


def edt(mask: np.ndarray, sampling=None) -> np.ndarray:
    """``scipy.ndimage.distance_transform_edt(mask, sampling)`` for 1- to 3-D
    masks: for each non-zero element, the distance to the nearest zero element,
    in float64."""
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if not 1 <= m.ndim <= 3:
        raise ValueError(f"edt takes 1- to 3-D masks, got {m.ndim}-D")
    lib = _load()
    out = np.empty(m.shape, np.float64)
    shape = (ctypes.c_int64 * m.ndim)(*m.shape)
    samp = None
    if sampling is not None:
        s = np.asarray(sampling, np.float64)
        s = np.full((m.ndim,), float(s)) if s.ndim == 0 else s
        if s.shape != (m.ndim,):
            raise ValueError(f"sampling {tuple(s.shape)} does not fit a {m.ndim}-D mask")
        samp = (ctypes.c_double * m.ndim)(*s)
    rc = lib.cenet_edt(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m.ndim, shape, samp)
    if rc != 0:
        raise RuntimeError(f"cenet_edt failed with code {rc}")
    return out
