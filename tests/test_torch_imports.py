"""Guards of the port: no JAX, no build for CPU tensors, no silent CPU fallback."""

import os
import subprocess
import sys

import pytest
import torch

from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.core.device import resolve_device
from cenet_tpu_torch.data.loader import device_put_fn
from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import build
from cenet_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import cenet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cenet_tpu_torch.__path__, "cenet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "cenet_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 30  # every module of the package, training and data included, was imported
    assert out[1].strip() == "[]"


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    K.reset_launches()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 40, 8, generator=g)
    v = torch.randn(1, 2, 40, 16, generator=g)
    o, lse1, lse2 = K.diff_attention_interleaved_fwd(q, q, v, torch.tensor(0.2))
    assert o.shape == (1, 2, 40, 16) and lse1.shape == lse2.shape == (1, 2, 40)
    o, lse = K.attention_fwd(q, q, q)
    assert o.shape == (1, 4, 40, 8) and lse.shape == (1, 4, 40)
    dq, dk, dv, dlam = K.diff_attention_interleaved_bwd(q, q, v, torch.tensor(0.2), lse1, lse2, v)
    assert dq.shape == dk.shape == q.shape and dv.shape == v.shape and dlam.shape == ()
    grads = K.attention_bwd(q, q, q, o, lse, o)
    assert all(g.shape == q.shape for g in grads)
    assert not any(K.LAUNCHES.values()), K.LAUNCHES


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_preset("synapse"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VolumeInferencer(lambda x: x, VolumeInferenceConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_preset("synapse"), max_iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_put_fn()
    assert resolve_device("cpu") == torch.device("cpu")
