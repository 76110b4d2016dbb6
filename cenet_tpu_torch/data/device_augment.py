"""On-device batched augmentation: the RandomGenerator as tensor ops on the card.

Counterpart of ``cenet_tpu/data/device_augment.py``. The ACDC/Synapse
``RandomGenerator`` (50% rot90×k and a flip, else 50% a rotation in [−20, 20)
at order 0, then a zoom to ``out_size``, cubic on the image and nearest on the
label; reference ``dataset_acdc.py:32-48``) runs as one batched transform on raw
batches that already lie on the device, with every draw from an explicit
``torch.Generator`` on that device. The host pipeline (``data/augment.py``) is
the production default; this is a library API for runs whose host would
otherwise hold the card back (call :func:`random_generator_batch` on raw batches
before the train step). As in the JAX package, no CLI path uses it.

The draws (:func:`draw_choices`) are apart from the transform
(:func:`apply_choices`), which takes given per-sample choices. Every branch is
a gather of source pixels: rot90×k and the flip, the rotation, and the
identity each give each output pixel a source pixel, picked per sample, so the
whole batch takes one gather for the images and one for the labels.
"""

from __future__ import annotations

from typing import Dict

import torch

from cenet_tpu_torch.nn import functional as F


def draw_choices(generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    """Per-sample draws on ``generator``'s device, as the JAX function draws
    them: ``u1``, ``u2`` uniform in [0, 1), ``k`` in 0..3 (rot90 turns),
    ``axis`` in 0..1 (the flip's), ``angle`` an integer in [−20, 20) (degrees)."""
    kw = dict(generator=generator, device=generator.device)
    return {
        "u1": torch.rand(batch, **kw),
        "u2": torch.rand(batch, **kw),
        "k": torch.randint(0, 4, (batch,), **kw),
        "axis": torch.randint(0, 2, (batch,), **kw),
        "angle": torch.randint(-20, 20, (batch,), **kw),
    }


def _rot_flip_source(n: int, k: torch.Tensor, axis: torch.Tensor, device):
    """Source (row, col) of each output pixel of rot90(x, k) (``jnp.rot90`` over
    axes (H, W)) then flipped along H (axis 0) or W (axis 1): (B, n, n) each."""
    i = torch.arange(n, device=device).view(1, n, 1)
    j = torch.arange(n, device=device).view(1, 1, n)
    a0 = (axis == 0).view(-1, 1, 1)
    fi = torch.where(a0, n - 1 - i, i)  # the flip, undone first
    fj = torch.where(a0, j, n - 1 - j)
    k = k.view(-1, 1, 1)
    rows = torch.where(k == 0, fi, torch.where(k == 1, fj, torch.where(k == 2, n - 1 - fi, n - 1 - fj)))
    cols = torch.where(k == 0, fj, torch.where(k == 1, n - 1 - fi, torch.where(k == 2, n - 1 - fj, fi)))
    return rows, cols


def _rotate_source(h: int, w: int, angle: torch.Tensor, device):
    """Source (row, col) and validity of an order-0 rotation by ``angle``
    degrees about the centre, with scipy's ``rotate(..., order=0,
    reshape=False)`` conventions as the JAX function writes them: θ = −angle in
    radians, centre ((h−1)/2, (w−1)/2), rounding half up (floor(x + 0.5)),
    zeros outside. (B, h, w) each."""
    theta = -torch.deg2rad(angle.to(torch.float32))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=device).view(1, h, 1) - cy
    xx = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, w) - cx
    cos, sin = torch.cos(theta).view(-1, 1, 1), torch.sin(theta).view(-1, 1, 1)
    ys = cos * yy - sin * xx + cy
    xs = sin * yy + cos * xx + cx
    yi = torch.floor(ys + 0.5).to(torch.int64)
    xi = torch.floor(xs + 0.5).to(torch.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    return yi.clamp(0, h - 1), xi.clamp(0, w - 1), valid


def _gather(x: torch.Tensor, index: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W), index and valid (B, H, W): x at each source pixel, 0 where not valid."""
    b, c, h, w = x.shape
    got = torch.gather(x.reshape(b, c, h * w), 2, index.reshape(b, 1, h * w).expand(b, c, h * w))
    got = got.reshape(b, c, h, w)
    return torch.where(valid.unsqueeze(1), got, torch.zeros((), dtype=x.dtype, device=x.device))


def apply_choices(images: torch.Tensor, labels: torch.Tensor, choices: Dict[str, torch.Tensor],
                  out_size: int = 224):
    """The RandomGenerator's transform for given per-sample ``choices``
    (:func:`draw_choices`' keys): images (B, 1, H, W) float, labels (B, H, W)
    int, square (H = W, as the JAX function's ``rot90`` stack needs), on any
    device. A sample whose ``u1 > 0.5`` takes rot90×k and the flip, else one
    whose ``u2 > 0.5`` the rotation, else stays as it is; then the zoom to
    ``out_size`` (cubic image, ``F.zoom_resize``; nearest label,
    ``F.zoom_nearest``). Returns images (B, 1, out, out) and labels
    (B, out, out) in their dtypes."""
    b, _, h, w = images.shape
    if h != w:
        raise ValueError(f"device augmentation takes square slices, got {h} × {w}")
    if labels.shape != (b, h, w):
        raise ValueError(f"labels {tuple(labels.shape)} do not match images {tuple(images.shape)}")
    dev = images.device
    take_a = (choices["u1"] > 0.5).view(-1, 1, 1)
    take_b = ~take_a & (choices["u2"] > 0.5).view(-1, 1, 1)
    fr, fc = _rot_flip_source(h, choices["k"], choices["axis"], dev)
    rr, rc, rvalid = _rotate_source(h, w, choices["angle"], dev)
    ii = torch.arange(h, device=dev).view(1, h, 1)
    jj = torch.arange(w, device=dev).view(1, 1, w)
    rows = torch.where(take_a, fr, torch.where(take_b, rr, ii))
    cols = torch.where(take_a, fc, torch.where(take_b, rc, jj))
    valid = ~take_b | rvalid
    index = rows * w + cols
    img = _gather(images, index, valid)
    lab = _gather(labels.unsqueeze(1), index, valid)
    if h != out_size:
        img = F.zoom_resize(img, (out_size, out_size), order=3)
        lab = F.zoom_nearest(lab, (out_size, out_size))
    return img, lab[:, 0]


def random_generator_batch(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
                           out_size: int = 224):
    """The batched RandomGenerator (``cenet_tpu/data/device_augment.py:66-106``):
    images (B, 1, H, W) float and labels (B, H, W) int on ``generator``'s
    device, drawn per sample from ``generator``; returns images (B, 1, out,
    out) and labels (B, out, out)."""
    if images.device.type != generator.device.type:
        raise ValueError(f"the generator is on {generator.device}, the images on {images.device}")
    return apply_choices(images, labels, draw_choices(generator, images.shape[0]), out_size)
