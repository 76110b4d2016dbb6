"""The port's ``attn_impl`` names and unported options, on the CPU.

``get_attention_core`` maps the JAX package's names as
``cenet_tpu/nn/attention.py::get_attention_core`` does, and raises where the
port has no counterpart yet; ``MultiheadDiffAttn`` takes its naive path for
every impl whose core is ``'xla'``; ``build_model`` raises on ``train.remat``.
Small modules only, and no JAX compile: the JAX side is asked only which
names it accepts.
"""

import dataclasses

import pytest
import torch

from cenet_tpu.nn import attention as jatt
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.nn import attention as tatt
from cenet_tpu_torch.ops import router
from cenet_tpu_torch.train.trainer import Trainer


@pytest.mark.parametrize("impl,core", [
    ("xla", router.plain_attention), ("chunked", router.plain_attention), ("pallas", router.flash_attention_core),
])
def test_attention_core_names_map_as_in_jax(impl, core):
    assert tatt.get_attention_core(impl) is core
    assert callable(jatt.get_attention_core(impl))


@pytest.mark.parametrize("impl", ["bogus", "", "XLA", "flash", "bogus@model"])
def test_unknown_attention_impl_raises_as_in_jax(impl):
    with pytest.raises(ValueError):
        jatt.get_attention_core(impl)
    with pytest.raises(ValueError):
        tatt.get_attention_core(impl)


@pytest.mark.parametrize("impl", ["ring", "ring@seq", "pallas@model", "xla@model", "chunked@model"])
def test_ring_and_axis_impls_are_not_ported(impl):
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tatt.get_attention_core(impl)


@pytest.mark.parametrize("impl,core,axis", [("pallas@model", "pallas", "model"), ("xla", "xla", None),
                                            ("ring@seq@x", "ring", "seq@x")])
def test_parse_impl_splits_at_the_first_at(impl, core, axis):
    assert router.parse_impl(impl) == (core, axis)


def _diff_attn(impl, seed=0):
    torch.manual_seed(seed)
    return tatt.MultiheadDiffAttn(32, depth=2, num_heads=2, attn_impl=impl)


def _no_route(*args, **kwargs):
    raise AssertionError("reached a routed diff-attention core")


def test_xla_at_axis_takes_the_naive_diff_path(monkeypatch):
    """As in JAX, the naive path is taken where the parsed core is 'xla',
    whatever the axis: no router call, the same output as 'xla'."""
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = _diff_attn("xla")(x)
        monkeypatch.setattr(router, "diff_attention_interleaved", _no_route)
        monkeypatch.setattr(router, "diff_attention_plain", _no_route)
        got = _diff_attn("xla@model")(x)
    assert torch.equal(got, want)


def test_chunked_diff_attention_is_plain_math(monkeypatch):
    """'chunked' computes the two groups in plain math (the JAX chunked scan's
    numerics) and never reaches the routed core, which takes kernels on the card."""
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = _diff_attn("xla")(x)
        monkeypatch.setattr(router, "diff_attention_interleaved", _no_route)
        got = _diff_attn("chunked")(x)
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.parametrize("impl,error", [("bogus", ValueError), ("pallas@model", NotImplementedError),
                                        ("ring", NotImplementedError)])
def test_diff_attention_rejects_unported_impls(impl, error):
    x = torch.randn(1, 16, 32)
    with torch.no_grad(), pytest.raises(error):
        _diff_attn(impl)(x)


@pytest.mark.parametrize("preset", ["synapse", "acdc", "ham10000", "ph2"])
def test_presets_do_not_ask_for_remat(preset):
    assert get_preset(preset).train.remat is False


def test_build_model_raises_on_remat():
    cfg = get_preset("synapse")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, remat=True))
    with pytest.raises(NotImplementedError, match="remat"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        Trainer(cfg, 1, device="cpu")
