"""Build the CUDA sources under ``cenet_tpu_torch/csrc`` and load them with ctypes.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). Libraries go
to ``cenet_tpu_torch/_build/<hash>/``, keyed on a hash of every source and the
flags, so the first use after a change rebuilds and later uses load. ``ptxas``
reports each kernel's registers, spills and shared memory into
``lib<name>.log`` beside the library (:func:`ptxas_usage`). Nothing here runs
at import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(names: Iterable[str]) -> Path:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one ``nvcc`` per
    source, all started together. Returns the build directory."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{n}.cu:\n{log}")
        else:
            (out / f"lib{n}.log").write_text(log)
            os.replace(tmp, out / f"lib{n}.so")  # atomic: a reader never sees a partial file
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name]) / f"lib{name}.so"))
            _libs[name] = lib
        return lib


_USAGE = re.compile(r"Compiling entry function '(\S+)'|(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads|Used (\d+) registers")


def ptxas_usage(name: str, pattern: str = "") -> Dict[str, Dict[str, int]]:
    """``ptxas -v``'s report for the kernels of ``csrc/<name>.cu`` whose mangled
    names contain ``pattern``: registers a thread and spill stores and loads in
    bytes, by kernel (built first if needed)."""
    with _lock:
        log = (build([name]) / f"lib{name}.log").read_text()
    out: Dict[str, Dict[str, int]] = {}
    kernel = None
    for m in _USAGE.finditer(log):
        if m.group(1):
            kernel = m.group(1) if pattern in m.group(1) else None
            if kernel:
                out[kernel] = {}
        elif kernel and m.group(2):
            out[kernel].update(spill_stores=int(m.group(3)), spill_loads=int(m.group(4)))
        elif kernel and m.group(5):
            out[kernel]["registers"] = int(m.group(5))
    return out
