"""``train.remat``: each PVT block recomputed in the backward, with the same
drop-path masks (``models/pvtv2.py::checkpointed_block``).

A CENet-b0 train step (64 px, fp32, CPU) with ``remat`` equals the step
without it to the bit, at ``drop_path_rate`` 0.1, with one batch and with two
accumulated microbatches. A wrap that leaves the trainer's generator alone, or
that winds it back for the recompute without putting it forward again, does
not. ``remat`` reaches a named PVT encoder only, and only while autograd
records in train mode.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.models import pvtv2
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.nn.layers import _RandomMask
from cenet_tpu_torch.train.trainer import Trainer


def _cfg(remat, accum=1, encoder="pvt_v2_b0", version="cenet", drop_path_rate=0.1):
    base = get_preset("synapse")
    return base.replace(
        model=dataclasses.replace(base.model, encoder=encoder, model_version=version, drop_path_rate=drop_path_rate),
        train=dataclasses.replace(base.train, amp=False, remat=remat, grad_accum_steps=accum))


def _batch(accum, b=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    lead = (accum,) if accum > 1 else ()
    images = torch.from_numpy(rng.standard_normal((*lead, b, 1, size, size)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 9, (*lead, b, size, size)).astype(np.int64))
    return images, labels


def _step(cfg, images, labels):
    trainer = Trainer(cfg, 10, device="cpu", model_seed=0)
    loss = trainer.train_step(images, labels)
    return [loss], {**trainer.model.state_dict(),
                    **{f"{n}.{k}": v for n, slots in trainer.optimizer.state.items() for k, v in slots.items()}}


def _unequal(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


def _never_restored(blk, tokens, H, W):
    """A naive wrap: the recompute draws on from wherever the generator stands."""
    return checkpoint(lambda t: blk(t, H, W), tokens, use_reentrant=False)


def _wound_back(blk, tokens, H, W):
    """Sets the forward's state for the recompute but leaves the generator there."""
    gens = list({id(m.generator): m.generator for m in blk.modules()
                 if isinstance(m, _RandomMask) and m.generator is not None}.values())
    entry, calls = [g.get_state() for g in gens], [0]

    def run(t):
        calls[0] += 1
        if calls[0] > 1:
            for g, s in zip(gens, entry):
                g.set_state(s)
        return blk(t, H, W)

    return checkpoint(run, tokens, use_reentrant=False)


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_step_equals_the_plain_step_to_the_bit(accum):
    """The loss and every parameter, BatchNorm buffer and momentum slot equal."""
    images, labels = _batch(accum)
    losses, want = _step(_cfg(False, accum), images, labels)
    got_losses, got = _step(_cfg(True, accum), images, labels)
    assert all(torch.equal(a, b) for a, b in zip(losses, got_losses)), (losses, got_losses)
    assert _unequal(want, got) == []


@pytest.mark.parametrize("wrap, accum", [(_never_restored, 1), (_never_restored, 2), (_wound_back, 2)])
def test_a_wrap_that_does_not_restore_the_generator_changes_the_step(monkeypatch, wrap, accum):
    """The same check fails for a wrap that does not restore the generator: the
    gradients of the dropped blocks move (one batch), and with two microbatches
    a wrap that winds the generator back and leaves it there changes the second
    microbatch's masks too."""
    images, labels = _batch(accum)
    _, want = _step(_cfg(False, accum), images, labels)
    monkeypatch.setattr(pvtv2, "checkpointed_block", wrap)
    _, got = _step(_cfg(True, accum), images, labels)
    assert len(_unequal(want, got)) > 10


@pytest.mark.parametrize("version, encoder", [("cenet", "resnet18"), ("cenet_org", "pvt_v2_b0")])
def test_resnet_encoders_and_cenet_org_ignore_remat(version, encoder):
    """``remat`` builds and steps for CENet-resnet18 and CENetOrg, and changes
    nothing there, as in the JAX package (neither checkpoints a block)."""
    images, labels = _batch(1, b=2, size=64, seed=1)
    losses, want = _step(_cfg(False, version=version, encoder=encoder), images, labels)
    got_losses, got = _step(_cfg(True, version=version, encoder=encoder), images, labels)
    assert torch.isfinite(got_losses[0]) and torch.equal(losses[0], got_losses[0])
    assert _unequal(want, got) == []
    model = build_model(_cfg(True, version=version, encoder=encoder), device="cpu", seed=0)
    assert not any(getattr(m, "remat", False) for m in model.modules())


def test_unknown_encoder_falls_back_without_remat():
    model = build_model(_cfg(True, encoder="no_such_encoder"), device="cpu", seed=0)
    assert isinstance(model.backbone, pvtv2.PVTv2) and model.backbone.remat is False


def test_only_train_mode_with_autograd_checkpoints(monkeypatch):
    """Eval mode, and train mode under ``no_grad``, run the blocks as they are;
    train mode with autograd wraps each of b0's eight blocks once a forward."""
    calls = []
    wrapped = pvtv2.checkpointed_block

    def counting(*args):
        calls.append(1)
        return wrapped(*args)

    monkeypatch.setattr(pvtv2, "checkpointed_block", counting)
    model = build_model(_cfg(True, drop_path_rate=0.0), device="cpu", seed=0)
    x = torch.zeros(1, 1, 64, 64)
    model(x)  # eval mode, autograd on
    model.train()
    with torch.no_grad():
        model(x)
    assert calls == []
    model(x).sum().backward()
    assert len(calls) == 8
    model.eval()
    model(x)
    assert len(calls) == 8
