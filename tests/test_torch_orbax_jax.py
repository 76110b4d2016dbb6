"""Slow gate (``@pytest.mark.slow``: it compiles a JAX train step, which Tier-1
cannot afford) of the Orbax bridge: the JAX ``Trainer`` and the port's, each
resumed from one Orbax TrainState that the JAX package wrote, take one step on
the same batch and agree.

CENet-b0 at 64 px, batch 2, fp32, drop-path 0, the Synapse preset otherwise
(SGD with momentum and weight decay, the poly schedule), as
``tests/test_torch_trajectory.py`` runs it: the port's seeded weights carried
into the JAX tree, BatchNorm statistics randomised, and here a seeded non-zero
momentum and the step count 5, saved by ``cenet_tpu.core.checkpoint``'s
``CheckpointManager``. The JAX side restores it with Orbax
(``restore_state``), the port with its own reader
(``CheckpointManager.restore``). The trajectory gate's limits: the loss
within 1e-6, the parameters' change within 1e-6, BatchNorm statistics within
1e-5; the count is 6 on both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.convert.torch2jax import convert_state_dict
from cenet_tpu.core import checkpoint as jckpt
from cenet_tpu.core.config import get_preset as jget_preset
from cenet_tpu.train.trainer import Trainer as JTrainer, TrainState
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.core.checkpoint import CheckpointManager
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.train.trainer import Trainer
from torch_parity import nchw, randomize_stats

pytestmark = pytest.mark.slow

MAX_IT, STEP, B, S = 10, 5, 2, 64
JAX_STEP_OPTIONS = {"xla_llvm_disable_expensive_passes": True}


def _cfg(get):
    cfg = get("synapse")
    return cfg.replace(model=dataclasses.replace(cfg.model, encoder="pvt_v2_b0", drop_path_rate=0.0),
                       train=dataclasses.replace(cfg.train, amp=False))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, S, S, 1)).astype(np.float32)
    labels = np.zeros((B, S, S), np.int32)
    for i in range(B):
        for c in range(1, 9):
            y, x = rng.integers(0, S - 16, size=2)
            labels[i, y:y + rng.integers(6, 16), x:x + rng.integers(6, 16)] = c
    return images, labels


def test_one_step_from_one_orbax_state_matches_the_jax_trainer(tmp_path):
    images, labels = _batch()
    jt = JTrainer(_cfg(jget_preset), max_iterations=MAX_IT)
    tr = Trainer(_cfg(get_preset), max_iterations=MAX_IT, device="cpu")
    shapes = jax.eval_shape(lambda x: jt.model.init(jax.random.PRNGKey(0), x), jnp.asarray(images))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), dict(shapes))
    sd = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    variables = randomize_stats(convert_state_dict(sd, zeros, "cenet", strict=True)[0])
    rng = np.random.default_rng(1)
    opt_state = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(a.dtype)
                             if jnp.issubdtype(a.dtype, jnp.floating) else np.full(a.shape, STEP, a.dtype),
                             jt.tx.init(variables["params"]))
    state = TrainState(variables["params"], variables["batch_stats"], opt_state, np.asarray(STEP, np.int32))
    jckpt.CheckpointManager(str(tmp_path)).save(STEP, state)

    template = jax.tree.map(jnp.zeros_like, state)
    restored = jckpt.CheckpointManager(str(tmp_path)).restore_state(template)
    step = jt.make_train_step().lower(restored, images, labels, jax.random.PRNGKey(0)).compile(
        compiler_options=JAX_STEP_OPTIONS)
    after, jax_loss = step(restored, jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(0))
    assert np.isfinite(float(jax_loss))
    want = state_dict_from_jax(jax.tree.map(np.asarray, after.as_variables()))

    CheckpointManager(str(tmp_path)).restore(tr)
    assert tr.step == STEP
    initial = {k: v.clone() for k, v in tr.model.state_dict().items()}
    loss = float(tr.train_step(nchw(images), torch.from_numpy(labels)))
    assert tr.step == int(after.step) == STEP + 1
    np.testing.assert_allclose(loss, float(jax_loss), atol=1e-6, rtol=0)
    got = tr.model.state_dict()
    params = [k for k in want if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(params) > 100 and len(stats) > 20
    for k in params:
        np.testing.assert_allclose((got[k] - initial[k]).numpy(), (want[k] - initial[k]).numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
