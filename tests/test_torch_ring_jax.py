"""The port's ring model against the JAX package's, under ``slow`` (a JAX compile of a whole CENet).

CENet-b0 at 64 px (``tests/test_torch_dp.py``'s configuration, drop-path 0)
with ``attn_impl='ring'``: the port's eval forward on two gloo ranks of the
(1, 1, 2) mesh (``torch_mesh_ranks.rank_ring_forward``), the JAX package's
on the 8-device CPU mesh with ``MeshConfig(data=4, seq=2)`` (its ring inside
``shard_map``), the same weights and BatchNorm statistics
(``torch_parity.variables_from_port`` over a ``jax.eval_shape`` template).
The logits agree within 2e-4, ``tests/test_ring_attention.py``'s limit for
its whole ring model. The JAX compile of the model is about half a minute,
so the test is not in Tier-1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from cenet_tpu.core import mesh as jmesh
from cenet_tpu.core.config import get_preset as jget_preset
from cenet_tpu.train.trainer import build_model as jbuild_model
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.models.cenet import build_model
from torch_parity import FAST_COMPILE, nchw, nhwc, randomize_stats, variables_from_port

pytestmark = pytest.mark.slow


def test_ring_model_forward_matches_jax_ring_model():
    cfg = R.dp_config(attn_impl="ring", drop_path_rate=0.0)
    model = build_model(cfg, device="cpu", seed=3)
    jcfg = jget_preset("acdc")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **{f.name: getattr(cfg.model, f.name)
                                                                for f in dataclasses.fields(jcfg.model)}))
    jm = jbuild_model(jcfg)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 1)).astype(np.float32)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x), jax.random.PRNGKey(0), jnp.asarray(x))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables = randomize_stats(variables_from_port(model, template))
    ranks = R.start_ranks("rank_ring_forward", 2, {"cfg": cfg, "state": state_dict_from_jax(variables),
                                                   "x": nchw(x)})
    try:
        jmesh.set_attention_mesh(jmesh.make_mesh(jmesh.MeshConfig(data=4, seq=2)))
        try:
            fn = jax.jit(lambda v, x: jm.apply(v, x)).lower(variables, jnp.asarray(x))
            want = np.asarray(fn.compile(compiler_options=FAST_COMPILE)(variables, jnp.asarray(x)))
        finally:
            jmesh.set_attention_mesh(None)
    finally:
        got = ranks.results()
    assert jcfg.model.attn_impl == "ring" and want.shape == (2, 64, 64, 4)
    for logits in got:
        np.testing.assert_allclose(nhwc(logits), want, atol=2e-4, rtol=2e-4)
