"""``cenet_tpu_torch/data/device_augment.py`` against the JAX package's helpers.

The draws differ by design (a ``torch.Generator`` against JAX keys), so the
transform is held against ``cenet_tpu/data/device_augment.py``'s own helpers
(``_rot90_stack``, ``_select_per_sample``, ``_rotate_nearest``) and
``cenet_tpu.nn.functional``'s ``zoom_resize`` and ``zoom_nearest``, composed as
``random_generator_batch`` composes them, for the same per-sample choices on the
same numpy inputs (NHWC for JAX, NCHW for the port). Eager JAX, no jit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu.data import device_augment as JDA
from cenet_tpu.nn import functional as JF
from cenet_tpu_torch.data import device_augment as DA
from cenet_tpu_torch.nn import functional as TF


def _jax_branches(images, labels, ch):
    """The JAX function's per-sample branches and selection for given choices
    (``device_augment.py:83-101``), before the zoom: NHWC image, (B, H, W, 1) label."""
    img = jnp.asarray(images.transpose(0, 2, 3, 1))
    lab4 = jnp.asarray(labels)[..., None].astype(img.dtype)
    kidx, axis = jnp.asarray(ch["k"]), jnp.asarray(ch["axis"])
    flip0 = (axis == 0)[:, None, None, None]

    def rotflip(x):
        r = JDA._select_per_sample(JDA._rot90_stack(x), kidx)
        return jnp.where(flip0, r[:, ::-1], r[:, :, ::-1])

    ang = jnp.asarray(ch["angle"]).astype(jnp.float32)
    take_a = (jnp.asarray(ch["u1"]) > 0.5)[:, None, None, None]
    take_b = (~(jnp.asarray(ch["u1"]) > 0.5) & (jnp.asarray(ch["u2"]) > 0.5))[:, None, None, None]
    out_img = jnp.where(take_a, rotflip(img), jnp.where(take_b, JDA._rotate_nearest(img, ang), img))
    out_lab = jnp.where(take_a, rotflip(lab4), jnp.where(take_b, JDA._rotate_nearest(lab4, ang), lab4))
    return out_img, out_lab


def _choices(u1, u2, k, axis, angle):
    return {"u1": np.asarray(u1, np.float32), "u2": np.asarray(u2, np.float32), "k": np.asarray(k, np.int64),
            "axis": np.asarray(axis, np.int64), "angle": np.asarray(angle, np.int64)}


def _port(images, labels, ch, out_size):
    img, lab = DA.apply_choices(torch.from_numpy(images), torch.from_numpy(labels),
                                {k: torch.from_numpy(v) for k, v in ch.items()}, out_size)
    return img.numpy(), lab.numpy()


def _inputs(b, n, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 1, n, n)).astype(np.float32)
    labels = rng.integers(0, 9, (b, n, n)).astype(np.int64)
    return images, labels


def test_rot90_flip_and_identity_equal_the_jax_helpers():
    """Every k and flip axis (u1 > 0.5), and the identity (u1, u2 ≤ 0.5): equal."""
    images, labels = _inputs(10, 12)
    ch = _choices(u1=[0.9] * 8 + [0.2, 0.5], u2=[0.0] * 8 + [0.3, 0.5], k=[0, 1, 2, 3] * 2 + [1, 2],
                  axis=[0] * 4 + [1] * 4 + [0, 1], angle=[5] * 10)
    img, lab = _port(images, labels, ch, 12)
    want_img, want_lab = _jax_branches(images, labels, ch)
    np.testing.assert_array_equal(img, np.asarray(want_img).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(lab, np.asarray(want_lab)[..., 0].astype(np.int64))
    np.testing.assert_array_equal(img[8:], images[8:])


def test_order0_rotation_equals_the_jax_helper():
    """Every angle in [−20, 20) (u1 ≤ 0.5 < u2) on a 33² slice (odd, so the
    centre is a pixel) and a 48² one. XLA's and torch's fp32 cos and sin may
    differ by an ulp, which moves a source coordinate that lands within an ulp
    of .5 to the next pixel: the share of such pixels is held under 1e-4 (it
    reads 0 here), every other pixel equal."""
    for n in (33, 48):
        angles = np.arange(-20, 20)
        images, labels = _inputs(len(angles), n, seed=n)
        ch = _choices(u1=[0.1] * 40, u2=[0.9] * 40, k=[0] * 40, axis=[0] * 40, angle=angles)
        img, lab = _port(images, labels, ch, n)
        want_img, want_lab = _jax_branches(images, labels, ch)
        want_img = np.asarray(want_img).transpose(0, 3, 1, 2)
        want_lab = np.asarray(want_lab)[..., 0].astype(np.int64)
        share = float(np.mean(img != want_img))
        assert share < 1e-4, (n, share)
        assert float(np.mean(lab != want_lab)) < 1e-4
        assert (img[1:] != images[1:]).any()  # the rotation moved pixels (angle 0 is sample 20)


def test_cubic_and_nearest_zoom_match_the_jax_helpers():
    """The zoom after the branches: cubic on the image within 1e-5 of max|x|,
    nearest on the label equal (down 40 → 24 and up 40 → 56)."""
    images, labels = _inputs(3, 40, seed=3)
    ch = _choices(u1=[0.9, 0.1, 0.1], u2=[0.0, 0.9, 0.1], k=[3, 0, 0], axis=[1, 0, 0], angle=[0, -13, 0])
    want_img, want_lab = _jax_branches(images, labels, ch)
    for out in (24, 56):
        img, lab = _port(images, labels, ch, out)
        z_img = np.asarray(JF.zoom_resize(want_img, (out, out), order=3)).transpose(0, 3, 1, 2)
        z_lab = np.asarray(JF.zoom_nearest(want_lab, (out, out)))[..., 0].astype(np.int64)
        assert img.shape == (3, 1, out, out) and lab.shape == (3, out, out) and lab.dtype == np.int64
        assert np.max(np.abs(img - z_img)) <= 1e-5 * np.max(np.abs(z_img))
        np.testing.assert_array_equal(lab, z_lab)


def test_zoom_nearest_matches_the_jax_function():
    x = np.random.default_rng(4).integers(0, 9, (2, 1, 37, 29)).astype(np.int32)
    got = TF.zoom_nearest(torch.from_numpy(x), (51, 16)).numpy()
    want = np.asarray(JF.zoom_nearest(jnp.asarray(x.transpose(0, 2, 3, 1)), (51, 16))).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, want)


def test_branch_shares_and_draws():
    """Over 4096 draws the branches' shares lie within 3σ of 0.5, 0.25, 0.25;
    k, axis and angle take every value of their ranges and no other."""
    g = torch.Generator().manual_seed(0)
    ch = DA.draw_choices(g, 4096)
    a = ch["u1"] > 0.5
    b = ~a & (ch["u2"] > 0.5)
    n = 4096
    for share, p in ((a, 0.5), (b, 0.25), (~a & ~b, 0.25)):
        assert abs(float(share.float().mean()) - p) <= 3 * np.sqrt(p * (1 - p) / n), (float(share.float().mean()), p)
    assert set(ch["k"].tolist()) == {0, 1, 2, 3} and set(ch["axis"].tolist()) == {0, 1}
    assert set(ch["angle"].tolist()) == set(range(-20, 20))


def test_random_generator_batch_draws_from_its_generator_and_checks_shapes():
    images, labels = _inputs(6, 32, seed=5)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    outs = [DA.random_generator_batch(torch.Generator().manual_seed(s), x, y, 24) for s in (1, 1, 2)]
    assert outs[0][0].shape == (6, 1, 24, 24) and outs[0][1].shape == (6, 24, 24)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[2][0])
    ch = DA.draw_choices(torch.Generator().manual_seed(1), 6)
    img, lab = DA.apply_choices(x, y, ch, 24)
    assert torch.equal(img, outs[0][0]) and torch.equal(lab, outs[0][1])
    with pytest.raises(ValueError, match="square"):
        DA.random_generator_batch(torch.Generator(), x[..., :30], y[..., :30], 24)
