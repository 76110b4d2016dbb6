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


@pytest.mark.parametrize("module", ["binding", "rms_norm", "rotary", "depthwise", "smallc_conv"])
def test_op_modules_import_no_jax(module):
    code = (f"import sys; import cenet_tpu_torch.ops.{module}; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cenet_tpu', 'tools')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_cpu_tensors_never_touch_the_build_in_the_new_ops(monkeypatch):
    """K9–K12's wrappers and Functions take their twins for CPU tensors."""
    from cenet_tpu_torch.ops import depthwise, rms_norm, rotary, smallc_conv

    def no_build(*a, **kw):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    K.reset_launches()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 16, generator=g, requires_grad=True)
    rms_norm.RMSNormFn.apply(x, None, 1e-5).sum().backward()
    cos, sin = rotary.make_rotary_tables(5, 16)
    assert rotary.apply_rotary_emb_kernel(x.detach()[None], cos, sin).shape == (1, 2, 5, 16)
    xd = torch.randn(1, 6, 7, 4, generator=g, requires_grad=True)
    depthwise.depthwise_conv3x3(xd, torch.randn(3, 3, 1, 4, generator=g), 1).sum().backward()
    xs = torch.randn(1, 112, 112, 8, generator=g, requires_grad=True)
    smallc_conv.conv_small_c(xs, torch.randn(3, 3, 8, 8, generator=g), 1).sum().backward()
    assert xd.grad.shape == xd.shape and xs.grad.shape == xs.shape
    assert not any(K.LAUNCHES.values()), K.LAUNCHES


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
    grads = K.attention_bwd_fused(q, q, q, o, lse, o)
    assert all(g.shape == q.shape for g in grads)
    q1, q2 = q[:, 0::2], q[:, 1::2]
    o, lse1, lse2 = K.diff_attention_fwd(q1, q1, q2, q2, v, torch.tensor(0.2))
    assert o.shape == (1, 2, 40, 16) and lse1.shape == lse2.shape == (1, 2, 40)
    for bwd in (K.diff_attention_bwd, K.diff_attention_bwd_split):
        *grads, dlam = bwd(q1, q1, q2, q2, v, torch.tensor(0.2), lse1, lse2, o)
        assert [g.shape for g in grads] == [q1.shape] * 4 + [v.shape] and dlam.shape == ()
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
