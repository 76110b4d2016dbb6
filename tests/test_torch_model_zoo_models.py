"""The model zoo's whole models against the JAX package, and the port's initial weights.

Logits: CENetOrg(pvt_v2_b0) and CENet(resnet18) at 64 px, fp32, batch 2, the
Synapse preset's model otherwise (1 input channel, 9 classes; CENetOrg with
``scale_factors[:2]`` and the DSEB heads, as the JAX ``build_model`` builds
it): the port's logits within max abs 1e-4 of the JAX model's on the same
weights, the port model built on the CPU when asked. CENetOrg's weights are
those of the JAX ``init`` (its ``init_with_output`` gives the logits too);
CENet(resnet18)'s are the port's seeded initial weights put into a
``jax.eval_shape`` template (``torch_parity.variables_from_port``) with
BatchNorm statistics randomised, and back through ``state_dict_from_jax``.

Initial weights: a fresh ``build_model`` draws every parameter from the
distribution that the JAX module's ``init`` names (``weight_init``/
``bias_init``: N(0, 2/fan_out), truncated and plain normals of std 0.02,
zeros, and torch's U(±1/√fan_in) where the JAX module names none). Held on
CENetOrg(pvt_v2_b0) (PVT, DecoderOrg with its CFAMs, EUCBs and
SkipEnhancers, the org head) and the ResNet-18 backbone, each JAX ``init``
compiled under ``FAST_COMPILE``: each tensor of 1024 elements or more has its
standard deviation within 10% of the JAX tensor's and its mean within 0.1 of
that standard deviation (a sample mean of 1024 draws lies within 0.03
standard deviations of the distribution's); each tensor that JAX fills with
one value (zeros, ones, the 0.5 gates, the layer scales) holds that value
exactly; the global RNG is left alone.

Under ``slow``: CENet(resnet50) logits as CENet(resnet18)'s; the initial
weights of the whole CENet(resnet18) (Decoder with DSEBs, OutHead); and one
fp32 train step of CENetOrg(pvt_v2_b0) against the JAX ``Trainer``'s (loss
and parameter changes within 1e-6, statistics within 1e-5, as
``tests/test_torch_trajectory.py`` holds CENet's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.core.config import get_preset as jget_preset
from cenet_tpu.models.resnet import make_resnet as jmake_resnet
from cenet_tpu.train.trainer import Trainer as JTrainer, TrainState, build_model as jbuild_model
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.models.cenet import CENet, CENetOrg, build_model, init_weights_
from cenet_tpu_torch.models.resnet import make_resnet
from cenet_tpu_torch.train.trainer import Trainer
from torch_parity import FAST_COMPILE, jax_init, nchw, nhwc, randomize_stats, variables_from_port


def _cfg(get, version, encoder, **train):
    cfg = get("synapse")
    return cfg.replace(model=dataclasses.replace(cfg.model, model_version=version, encoder=encoder,
                                                 drop_path_rate=0.0),
                       train=dataclasses.replace(cfg.train, **train))


def _x():
    return np.random.default_rng(1).standard_normal((2, 64, 64, 1)).astype(np.float32)


def _port(version, encoder, seed):
    torch.manual_seed(0)
    before = torch.random.get_rng_state()
    model = build_model(_cfg(get_preset, version, encoder), device="cpu", seed=seed)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert isinstance(model, CENetOrg if version == "cenet_org" else CENet)
    assert next(model.parameters()).device.type == "cpu" and not model.training
    return model


def _assert_drawn_alike(got, want, min_checked):
    assert set(got) == set(want)
    checked = 0
    for k, w in want.items():
        g = got[k]
        if w.dtype != torch.float32:
            continue
        if torch.all(w == w.flatten()[0]):  # one value: zeros, ones, 0.5 gates, layer scales
            assert torch.equal(g, w), k
        elif w.numel() >= 1024:
            ws, gs = float(w.std()), float(g.std())
            assert abs(gs - ws) <= 0.1 * ws, (k, gs, ws)
            assert abs(float(g.mean()) - float(w.mean())) <= 0.1 * ws, (k, float(g.mean()), float(w.mean()))
            checked += 1
    assert checked >= min_checked


def _logits(model, variables, want, version):
    model.load_state_dict(state_dict_from_jax(variables, version), strict=True)
    with torch.no_grad():
        got = model(nchw(_x()))
    assert got.shape == (2, 9, 64, 64)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4, rtol=0)


def test_cenet_org_init_and_logits_match_jax():
    jm = jbuild_model(_cfg(jget_preset, "cenet_org", "pvt_v2_b0"))
    key, x = jax.random.PRNGKey(0), jnp.asarray(_x())
    fn = jax.jit(lambda k, x: jm.init_with_output(k, x)).lower(key, x).compile(compiler_options=FAST_COMPILE)
    want, variables = fn(key, x)
    variables = jax.tree.map(np.asarray, dict(variables))
    model = _port("cenet_org", "pvt_v2_b0", seed=5)
    _assert_drawn_alike(model.state_dict(), state_dict_from_jax(variables, "cenet_org"), 40)
    _logits(model, variables, want, "cenet_org")


def _resnet_logits(encoder):
    jm = jbuild_model(_cfg(jget_preset, "cenet", encoder))
    x = jnp.asarray(_x())
    model = _port("cenet", encoder, seed=2)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x), jax.random.PRNGKey(0), x)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables = randomize_stats(variables_from_port(model, template))
    fn = jax.jit(lambda v, x: jm.apply(v, x)).lower(variables, x).compile(compiler_options=FAST_COMPILE)
    _logits(model, variables, fn(variables, x), "cenet")


def test_cenet_resnet18_logits_match_jax():
    _resnet_logits("resnet18")


@pytest.mark.slow
def test_cenet_resnet50_logits_match_jax():
    _resnet_logits("resnet50")


def test_resnet_backbone_init_matches_jax():
    want = state_dict_from_jax({c: {"backbone": t} for c, t in
                                jax_init(jmake_resnet("resnet18"), jnp.zeros((1, 64, 64, 3))).items()})
    got = {f"backbone.{k}": v for k, v in
           init_weights_(make_resnet("resnet18"), torch.Generator().manual_seed(5)).state_dict().items()}
    _assert_drawn_alike(got, want, 20)


@pytest.mark.slow
def test_cenet_resnet18_init_matches_jax():
    want = state_dict_from_jax(jax_init(jbuild_model(_cfg(jget_preset, "cenet", "resnet18")),
                                        jnp.zeros((1, 64, 64, 1))))
    _assert_drawn_alike(_port("cenet", "resnet18", seed=5).state_dict(), want, 40)


@pytest.mark.slow
def test_org_train_step_matches_jax():
    cfg_j, cfg_t = (_cfg(g, "cenet_org", "pvt_v2_b0", amp=False) for g in (jget_preset, get_preset))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    labels = rng.integers(0, 9, (2, 64, 64)).astype(np.int32)
    jt = JTrainer(cfg_j, max_iterations=10)
    tr = Trainer(cfg_t, max_iterations=10, device="cpu")
    shapes = jax.eval_shape(lambda x: jt.model.init(jax.random.PRNGKey(0), x), jnp.asarray(images))
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), dict(shapes))
    variables = randomize_stats(variables_from_port(tr.model, template, "cenet_org"))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]), jt.tx.init(params),
                       jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(0)
    step = jt.make_train_step().lower(state, images, labels, key).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})
    state, jloss = step(state, jnp.asarray(images), jnp.asarray(labels), key)
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.as_variables()), "cenet_org")
    init = state_dict_from_jax(variables, "cenet_org")
    tr.model.load_state_dict(init, strict=True)
    loss = tr.train_step(nchw(images), torch.from_numpy(labels))
    assert np.isfinite(float(jloss))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-6, rtol=0)
    got = tr.model.state_dict()
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        atol = 1e-5 if k.endswith(("running_mean", "running_var")) else 1e-6
        np.testing.assert_allclose((got[k] - init[k]).numpy(), (want[k] - init[k]).numpy(), atol=atol, rtol=0,
                                   err_msg=k)
