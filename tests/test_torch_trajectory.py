"""Trajectory gate: three optimizer steps of the port's ``Trainer`` against the
JAX package's ``Trainer.make_train_step`` from the same weights on the same batches.

CENet(pvt_v2_b0) at 64 px, batch 2, fp32, drop-path 0, the Synapse preset
otherwise (BoundaryDoU loss, SGD momentum 0.9 with weight decay 1e-4 and the poly
schedule). The initial weights are the port's seeded initialisation carried
into the JAX tree (``convert_state_dict`` on the tree's shapes from
``jax.eval_shape``, which costs no compile), BatchNorm statistics randomised;
they go back into the port's trainer through ``state_dict_from_jax``. Both run
on the CPU with plain attention math.

The JAX step is compiled once, with ``xla_llvm_disable_expensive_passes`` only:
at ``xla_backend_optimization_level`` 0 (``FAST_COMPILE``) this train step
turns NaN by its third step. The gate checks that the JAX losses are finite
before it compares anything. Limits (fp32 on the CPU, sums in other orders,
compounded over three steps, where the differences run at about 1.2e-7, 3e-8
and 1e-6): losses within 1e-6; the parameters' three-step change (at most
about 1.4e-3) within 1e-6, so an update wrong by 0.1% of the largest one
fails; BatchNorm running statistics within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.convert.torch2jax import convert_state_dict
from cenet_tpu.core.config import get_preset as jget_preset
from cenet_tpu.train.trainer import Trainer as JTrainer, TrainState
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.train.trainer import Trainer
from torch_parity import nchw, randomize_stats

STEPS, MAX_IT = 3, 10
JAX_STEP_OPTIONS = {"xla_llvm_disable_expensive_passes": True}


def _cfg(get):
    cfg = get("synapse")
    return cfg.replace(model=dataclasses.replace(cfg.model, encoder="pvt_v2_b0", drop_path_rate=0.0),
                       train=dataclasses.replace(cfg.train, amp=False))


def _batches(seed=0, b=2, s=64):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((STEPS, b, s, s, 1)).astype(np.float32)
    labels = np.zeros((STEPS, b, s, s), np.int32)
    for t in range(STEPS):
        for i in range(b):
            for c in range(1, 9):
                y, x = rng.integers(0, s - 16, size=2)
                labels[t, i, y:y + rng.integers(6, 16), x:x + rng.integers(6, 16)] = c
    return images, labels


@pytest.fixture(scope="module")
def runs():
    """Both trainers over the same batches from the same variables: the
    per-step losses and the final state of each (computed once)."""
    images, labels = _batches()
    jt = JTrainer(_cfg(jget_preset), max_iterations=MAX_IT)
    tr = Trainer(_cfg(get_preset), max_iterations=MAX_IT, device="cpu")
    shapes = jax.eval_shape(lambda x: jt.model.init(jax.random.PRNGKey(0), x), jnp.asarray(images[0]))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), dict(shapes))
    sd = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    variables = randomize_stats(convert_state_dict(sd, zeros, "cenet", strict=True)[0])
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]), jt.tx.init(params),
                       jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(0)
    step = jt.make_train_step().lower(state, images[0], labels[0], rng).compile(compiler_options=JAX_STEP_OPTIONS)
    jax_losses = []
    for t in range(STEPS):
        state, loss = step(state, jnp.asarray(images[t]), jnp.asarray(labels[t]), rng)
        jax_losses.append(float(loss))
    jax_final = state_dict_from_jax(jax.tree.map(np.asarray, state.as_variables()))

    initial = state_dict_from_jax(variables)
    tr.model.load_state_dict(initial, strict=True)
    losses = [float(tr.train_step(nchw(images[t]), torch.from_numpy(labels[t]))) for t in range(STEPS)]
    return dict(jax_losses=jax_losses, jax_final=jax_final, losses=losses, trainer=tr, initial=initial)


def test_jax_reference_losses_are_finite(runs):
    assert np.all(np.isfinite(runs["jax_losses"])), runs["jax_losses"]


def test_losses_match_jax_step_by_step(runs):
    assert np.all(np.isfinite(runs["jax_losses"]))
    np.testing.assert_allclose(runs["losses"], runs["jax_losses"], atol=1e-6, rtol=0)
    assert runs["trainer"].step == STEPS


def test_parameter_updates_match_jax(runs):
    assert np.all(np.isfinite(runs["jax_losses"]))
    got, want, init = runs["trainer"].model.state_dict(), runs["jax_final"], runs["initial"]
    names = [k for k in want if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert len(names) > 100
    assert max(float((want[k] - init[k]).abs().max()) for k in names) > 1e-4  # the steps moved the weights
    for k in names:
        np.testing.assert_allclose((got[k] - init[k]).numpy(), (want[k] - init[k]).numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_batchnorm_statistics_match_jax(runs):
    assert np.all(np.isfinite(runs["jax_losses"]))
    got, want, init = runs["trainer"].model.state_dict(), runs["jax_final"], runs["initial"]
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) > 20 and any(not torch.equal(want[k], init[k]) for k in names)
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
