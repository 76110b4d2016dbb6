"""Port parity of the training pieces against the JAX package.

* Losses: every loss and ``Criterion`` combination of ``cenet_tpu/train/losses.py``
  on the same logits (NHWC for JAX, NCHW for the port) and labels, value and
  gradient with respect to the logits, fp32 within 1e-6 absolute plus 1e-5
  relative (sums in another order).
* Schedules (including past ``max_iterations``) and optimizers (SGD, Adam,
  AdamW, global-norm clipping, freezing) against ``make_schedule`` /
  ``make_optimizer`` / ``freeze_subtree`` over five steps on a small parameter
  tree: parameters within 1e-6 relative (fp32 rounding of the same updates).
* ``DropPath`` / ``Dropout`` semantics: mask shape, the 1/keep scale, the
  identity in eval and at rate 0, the same draws from the same generator seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cenet_tpu.train import losses as jlosses
from cenet_tpu.train import optim as joptim
from cenet_tpu_torch.nn.layers import DropPath, Dropout, set_generator
from cenet_tpu_torch.train import losses as tlosses
from cenet_tpu_torch.train import optim as toptim

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it:
# in the parallel test run torch's default pool spins against the other workers.
torch.set_num_threads(1)

K_CLASSES = 9


def _batch(seed=0, b=2, h=24, w=20):
    """Logits and labels with blob structure, so every class has interior and boundary pixels."""
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, h, w, K_CLASSES))).astype(np.float32)
    labels = np.zeros((b, h, w), np.int32)
    for i in range(b):
        for c in range(1, K_CLASSES):
            y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
            labels[i, y:y + rng.integers(2, 7), x:x + rng.integers(2, 7)] = c
    return logits, labels


LOSSES = [
    ("ce", lambda l, y: jlosses.cross_entropy_loss(l, y), lambda l, y: tlosses.cross_entropy_loss(l, y)),
    ("dice", lambda l, y: jlosses.dice_loss(l, y, K_CLASSES), lambda l, y: tlosses.dice_loss(l, y, K_CLASSES)),
    ("dice_weighted", lambda l, y: jlosses.dice_loss(l, y, K_CLASSES, weight=list(range(1, 10)), softmax=False),
     lambda l, y: tlosses.dice_loss(l, y, K_CLASSES, weight=list(range(1, 10)), softmax=False)),
    ("boundary", lambda l, y: jlosses.boundary_dou_loss(l, y, K_CLASSES),
     lambda l, y: tlosses.boundary_dou_loss(l, y, K_CLASSES)),
    ("jaccard", lambda l, y: jlosses.jaccard_loss(l, y), lambda l, y: tlosses.jaccard_loss(l, y)),
] + [
    (f"criterion_{t}", (lambda t, w: lambda l, y: jlosses.Criterion(K_CLASSES, t, w)(l, y))(t, w),
     (lambda t, w: lambda l, y: tlosses.Criterion(K_CLASSES, t, w)(l, y))(t, w))
    for t, w in [("dice,ce", "0.5,0.5"), ("dice,ce", "0.7,0.3"), ("boundary", "1.0"),
                 ("ce,dice,boundary,jaccard", "0.1,0.2,0.3,0.4")]
]


@pytest.mark.parametrize("name,jfn,tfn", LOSSES, ids=[x[0] for x in LOSSES])
def test_loss_and_its_gradient_match_jax(name, jfn, tfn):
    logits, labels = _batch()
    if name == "jaccard":
        labels[0, :3, :3] = 255  # ignore-index pixels
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(labels))
    tl = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()).requires_grad_()
    got = tfn(tl, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy().transpose(0, 2, 3, 1), np.asarray(want_g), atol=1e-6, rtol=1e-5)


def test_boundary_alpha_is_clamped_at_0_8():
    """A class that is all boundary (single pixels) has α = 1 − 2·(tiny) → clamped at 0.8."""
    logits, _ = _batch(1)
    labels = np.zeros(logits.shape[:3], np.int32)
    labels[:, ::4, ::4] = 3  # isolated pixels: no interior
    want = jlosses.boundary_dou_loss(jnp.asarray(logits), jnp.asarray(labels), K_CLASSES)
    got = tlosses.boundary_dou_loss(torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()),
                                    torch.from_numpy(labels), K_CLASSES)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["poly", "cosine", "exp", "step", "custom"])
def test_schedules_match_jax(name):
    max_it, max_epochs, ipe = 300, 12, 25
    j = joptim.make_schedule(name, 0.015, max_it, max_epochs, ipe)
    t = toptim.make_schedule(name, 0.015, max_it, max_epochs, ipe)
    for step in [0, 1, 7, 124, 125, 199, 200, 299, 300, 301, 450]:  # past max_iterations too
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6, atol=1e-9, err_msg=str(step))
    if name == "poly":
        assert t(450) == 0.0


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"backbone": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "head": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                     "b": rng.standard_normal((5,)).astype(np.float32)}}


def _flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


OPTIMIZERS = [("sgd", 1e-4, 0.0, False), ("sgd", 0.0, 0.0, False), ("adam", 1e-4, 0.0, False),
              ("adamw", 1e-2, 0.0, False), ("sgd", 1e-4, 0.5, False), ("sgd", 1e-4, 0.0, True),
              ("adamw", 1e-2, 0.5, True)]


@pytest.mark.parametrize("name,wd,clip,freeze", OPTIMIZERS)
def test_optimizer_steps_match_optax(name, wd, clip, freeze):
    jsched = joptim.make_schedule("poly", 0.05, 8)
    tx = joptim.make_optimizer(name, jsched, wd, clip)
    opt = toptim.make_optimizer(name, toptim.make_schedule("poly", 0.05, 8), wd, clip)
    if freeze:
        tx = joptim.freeze_subtree(tx, "backbone")
        toptim.freeze_subtree(opt, "backbone")
    params = jax.tree.map(jnp.asarray, _tree(0))
    state = tx.init(params)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in _flat(_tree(0)).items()}
    for step in range(5):
        grads = _tree(step + 10)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        opt.step(tparams, {k: torch.from_numpy(v) for k, v in _flat(grads).items()})
        for k, v in _flat(jax.tree.map(np.asarray, params)).items():
            np.testing.assert_allclose(tparams[k].numpy(), v, rtol=1e-6, atol=1e-7, err_msg=f"{k} step {step}")
    if freeze:
        np.testing.assert_array_equal(tparams["backbone.w"].numpy(), _tree(0)["backbone"]["w"])
    assert opt.count == 5


@pytest.mark.parametrize("cls", [DropPath, Dropout])
def test_drop_layers_identity_in_eval_and_at_rate_0(cls):
    x = torch.randn(4, 3, 5, 6)
    assert cls(0.3).eval()(x) is x
    assert cls(0.0).train()(x) is x
    with pytest.raises(RuntimeError, match="generator"):
        cls(0.3).train()(x)


def test_drop_path_masks_whole_samples_and_dropout_elements():
    keep = 0.75
    x = torch.rand(64, 4, 6, 6) + 0.5  # no zeros of its own
    gen = torch.Generator().manual_seed(0)
    dp = DropPath(1 - keep).train()
    dp.generator = gen
    y = dp(x)
    kept = (y != 0).flatten(1)
    assert torch.all(kept.all(1) | ~kept.any(1))  # each sample all kept or all dropped
    torch.testing.assert_close(y[kept.all(1)], x[kept.all(1)] / keep)
    do = Dropout(1 - keep).train()
    do.generator = gen
    x = torch.rand(200, 500) + 0.5
    y = do(x)
    k = y != 0
    torch.testing.assert_close(y[k], x[k] / keep)
    assert abs(float(k.float().mean()) - keep) < 0.01  # 1e5 draws: 5 standard deviations is 0.007
    assert 0 < int(k.sum(1).min()) and int(k.sum(1).max()) < 500  # mixed within every row
    yb = do(x.bfloat16())
    assert yb.dtype == torch.bfloat16


def test_same_generator_seed_gives_the_same_draws():
    model = torch.nn.Sequential(DropPath(0.4), Dropout(0.3), DropPath(0.2)).train()
    gen = torch.Generator()
    set_generator(model, gen)
    assert all(m.generator is gen for m in model)
    x = torch.rand(16, 8, 5) + 0.5
    outs = []
    for seed in (11, 11, 12):
        gen.manual_seed(seed)
        outs.append(model(x))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert not torch.equal(outs[0], outs[2])


def _b0_cfg(drop_path_rate=0.0):
    """The Synapse preset with CENet-b0, fp32."""
    import dataclasses

    from cenet_tpu_torch.core.config import get_preset

    base = get_preset("synapse")
    return base.replace(model=dataclasses.replace(base.model, encoder="pvt_v2_b0", drop_path_rate=drop_path_rate),
                        train=dataclasses.replace(base.train, amp=False))


def test_grad_accumulation_averages_microbatches_and_threads_batchnorm():
    """``grad_accum_steps=2`` equals two forward/backward passes in train mode
    (BatchNorm statistics carried from the first to the second), their gradients
    and losses averaged, then one optimizer step (CENet-b0, 64 px, fp32)."""
    import dataclasses

    from cenet_tpu_torch.train.trainer import Trainer

    cfg = _b0_cfg()
    accum = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, grad_accum_steps=2)), 10, device="cpu",
                    model_seed=0)
    plain = Trainer(cfg, 10, device="cpu", model_seed=0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((2, 2, 1, 64, 64)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, K_CLASSES, (2, 2, 64, 64)).astype(np.int32))
    loss = accum.train_step(images, labels)

    plain.model.train()
    (l1, g1), (l2, g2) = [plain.loss_and_grads(images[i], labels[i]) for i in range(2)]
    names = [n for n, _ in plain.model.named_parameters()]
    grads = {n: None if a is None else (a + b) / 2 for n, a, b in zip(names, g1, g2)}
    plain.optimizer.step(dict(plain.model.named_parameters()), grads)
    torch.testing.assert_close(loss, (l1 + l2) / 2, atol=1e-7, rtol=0)
    want = plain.model.state_dict()
    for k, v in accum.model.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=1e-7, rtol=0, msg=k)
    assert int(want["decoder.dec1.norm1.num_batches_tracked"]) == 2


def test_resampling_matrices_first_made_under_inference_mode_still_train():
    """The cached resampling matrices are normal tensors even when an eval under
    ``inference_mode`` makes them first, so training after evaluating works."""
    from cenet_tpu_torch.nn import functional as tF

    x = torch.randn(1, 2, 37, 29)  # sizes no other test uses: the cache is cold
    with torch.inference_mode():
        tF.adaptive_avg_pool2d(x, (7, 7))
        tF.resize_bilinear(x, (41, 23))
    xg = x.clone().requires_grad_()
    (tF.adaptive_avg_pool2d(xg, (7, 7)).sum() + tF.resize_bilinear(xg, (41, 23)).sum()).backward()
    assert xg.grad.shape == x.shape


def test_multi_step_equals_successive_train_steps():
    """``multi_step`` over two stacked batches is two ``train_step`` calls, with
    drop-path on: the generator is reseeded from the seed and the step count,
    so both trainers draw the same masks (CENet-b0, 64 px, batch 1, fp32)."""
    from cenet_tpu_torch.train.trainer import Trainer

    cfg = _b0_cfg(drop_path_rate=0.3)
    a, b = [Trainer(cfg, 10, device="cpu", model_seed=1) for _ in range(2)]
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.standard_normal((2, 1, 1, 64, 64)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, K_CLASSES, (2, 1, 64, 64)).astype(np.int32))
    last = a.multi_step(images, labels)
    losses = [b.train_step(images[i], labels[i]) for i in range(2)]
    torch.testing.assert_close(last, losses[-1], atol=0, rtol=0)
    assert a.step == b.step == 2
    want = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)
