"""The port's ``attn_impl`` names and unported options, on the CPU.

``get_attention_core`` maps the JAX package's names as
``cenet_tpu/nn/attention.py::get_attention_core`` does ('chunked' to the
query-block scan, 'ring' included),
and raises on a name it does not know; ``MultiheadDiffAttn`` takes its naive path for
every impl whose core is ``'xla'``; ``build_model`` honours ``train.remat``
for CENet's PVT encoder, and CENetOrg ignores it.
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

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it:
# in the parallel test run torch's default pool spins against the other workers.
torch.set_num_threads(1)


@pytest.mark.parametrize("impl,core", [
    ("xla", router.plain_attention), ("chunked", router.chunked_attention_core),
    ("pallas", router.flash_attention_core),
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
    """Ring attention (the 'seq' axis) raised naming its ROADMAP item before
    its port, and an '@model' impl was ported first. Now both run, and
    without a registered mesh the core of each is the bare core's function
    (``router.shard_heads`` falls through, the ring core takes plain math)."""
    core = tatt.get_attention_core(impl)
    bare = tatt.get_attention_core("pallas" if impl.startswith("ring") else router.parse_impl(impl)[0])
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 9, 8, generator=g) for _ in range(3))
    assert torch.equal(core(q, k, v), bare(q, k, v))


@pytest.mark.parametrize("impl", ["ring@model", "ring@data"])
def test_ring_over_another_axis_raises(impl):
    """The port's ring carries tokens over 'seq' only: its data and model ranks
    hold other rows and heads."""
    with pytest.raises(ValueError, match="'seq' axis only"):
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
    """'chunked' computes the two groups in plain math below the size limit
    (the JAX router's rule; above it each group is scanned, held in
    ``tests/test_torch_chunked.py``) and never reaches the routed core, which
    takes kernels on the card."""
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = _diff_attn("xla")(x)
        monkeypatch.setattr(router, "diff_attention_interleaved", _no_route)
        got = _diff_attn("chunked")(x)
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.parametrize("impl,error", [("bogus", ValueError), ("ring@seq", None), ("ring", None)])
def test_diff_attention_rejects_unported_impls(impl, error):
    """An unknown name raises. Ring attention raised before its port; now
    ``'ring'`` and ``'ring@seq'`` run, and without a registered mesh they are
    the plain split groups, as ``'pallas'`` is on the CPU."""
    x = torch.randn(1, 16, 32)
    with torch.no_grad():
        if error is not None:
            with pytest.raises(error):
                _diff_attn(impl)(x)
            return
        assert torch.equal(_diff_attn(impl)(x), _diff_attn("pallas")(x))


@pytest.mark.parametrize("preset", ["synapse", "acdc", "ham10000", "ph2"])
def test_presets_do_not_ask_for_remat(preset):
    assert get_preset(preset).train.remat is False


def test_build_model_raises_on_remat():
    """It raised before ``remat`` was ported; now ``train.remat`` builds: a
    CENet's PVT encoder checkpoints its blocks (``tests/test_torch_remat.py``
    holds the step), and CENetOrg ignores it, as the JAX package's does."""
    cfg = get_preset("synapse")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, encoder="pvt_v2_b0"),
                      train=dataclasses.replace(cfg.train, remat=True))
    assert build_model(cfg, device="cpu").backbone.remat is True
    assert Trainer(cfg, 1, device="cpu").model.backbone.remat is True
    org = cfg.replace(model=dataclasses.replace(cfg.model, model_version="cenet_org"))
    assert build_model(org, device="cpu").backbone.remat is False
