"""The ACDC and skin presets' model shapes against the JAX package, and the
four presets field by field.

CENet(pvt_v2_b0) at 64 px, fp32, batch 2, with the ACDC preset's model
(1 input channel, 4 classes, scale factors (1.0, 0.5), DSEB heads (4, 4, 4))
and the PH2 preset's (3 input channels, 2 classes, the three scale factors
(1.0, 0.75, 0.5) with their 0.75 resize, heads (2, 2, 2)): the port's logits
within max abs 1e-4 of JAX's ``apply`` on the same weights (the port's
seeded initial weights carried to JAX by the JAX package's
``convert_state_dict`` on a ``jax.eval_shape`` template, so no JAX ``init``
is compiled, BatchNorm statistics randomised, and back by
``state_dict_from_jax``), as
``tests/test_torch_model.py`` holds the Synapse preset's. HAM10000's model is
PH2's (the presets differ in their data and loss weights only). Every ported
preset equals the JAX preset of its name in every field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.convert.torch2jax import convert_state_dict
from cenet_tpu.core import config as jconfig
from cenet_tpu.models.cenet import CENet as JCENet
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.core import config as tconfig
from cenet_tpu_torch.models.cenet import build_model
from torch_parity import FAST_COMPILE, nchw, nhwc, randomize_stats

PRESETS = ["synapse", "acdc", "ham10000", "ph2"]


@pytest.mark.parametrize("name", PRESETS)
def test_ported_preset_equals_jax_field_by_field(name):
    got, want = tconfig.get_preset(name), jconfig.get_preset(name)
    for part in ("model", "train", "data"):
        g, w = getattr(got, part), getattr(want, part)
        assert [f.name for f in dataclasses.fields(g)] == [f.name for f in dataclasses.fields(w)], part
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), f"{name}.{part}.{f.name}"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.get_preset(name.upper()) == got
    with pytest.raises(KeyError):
        tconfig.get_preset("nonesuch")


@pytest.mark.parametrize("name", ["acdc", "ph2"])
def test_preset_model_logits_match_jax(name):
    cfg = tconfig.get_preset(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, encoder="pvt_v2_b0"))
    m = cfg.model
    assert (m.input_channels, m.num_classes, m.diffatt_num_heads) == \
        {"acdc": (1, 4, (4, 4, 4)), "ph2": (3, 2, (2, 2, 2))}[name]
    jm = JCENet(input_channels=m.input_channels, num_classes=m.num_classes, scale_factors=m.scale_factors,
                diffatt_num_heads=m.diffatt_num_heads, encoder=m.encoder, skip_mode=m.skip_mode,
                dec_up_block=m.dec_up_block, out_merge_mode=m.out_merge_mode, out_up_block=m.out_up_block,
                out_up_ks=m.out_up_ks, skip_use_command=m.skip_use_command)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, m.input_channels)).astype(np.float32)
    model = build_model(cfg, device="cpu", seed=2)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x), jax.random.PRNGKey(0), jnp.asarray(x))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables, report = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, template,
                                           strict=True)
    assert not report["missing"]
    variables = randomize_stats(variables)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    fn = jax.jit(lambda v, x: jm.apply(v, x)).lower(variables, jnp.asarray(x)).compile(compiler_options=FAST_COMPILE)
    want = np.asarray(fn(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(nchw(x))
    assert got.shape == (2, m.num_classes, 64, 64)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=0)
