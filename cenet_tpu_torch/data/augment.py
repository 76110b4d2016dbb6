"""Host-side augmentation of Synapse training slices.

A copy of ``SynapseAug`` and its helpers from ``cenet_tpu/data/augment.py``
(the port imports nothing of the JAX package): the reference's imgaug
``SomeOf(0-4)`` pipeline (``dataset_synapse.py:86-97``) of flips, additive
Gaussian noise, Gaussian blur, linear contrast, affine scale/rotate/shear/
translate and a piecewise-affine-like distortion, in numpy/scipy (and OpenCV
where it is installed, as in the JAX package). For the same input and the same
``np.random.Generator`` state it returns the same arrays, bit for bit. The
ACDC ``RandomGenerator`` and the skin pipeline are later work.

Every transform takes and returns numpy arrays and an explicit
``np.random.Generator``: deterministic per (seed, epoch, index), never global
RNG state.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage

from cenet_tpu_torch.nn.functional import scipy_zoom_matrix

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@functools.lru_cache(maxsize=8)
def _pixel_grid(h: int, w: int):
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    return yy, xx


def _sample_bilinear(img: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """Bilinear resample with a constant-0 boundary: the semantics of
    ``ndimage.map_coordinates(order=1, mode='constant', cval=0)``."""
    h, w = img.shape
    y0 = np.floor(yy)
    x0 = np.floor(xx)
    wy = yy - y0
    wx = xx - x0
    y0i = y0.astype(np.int64)
    x0i = x0.astype(np.int64)
    out = np.zeros(yy.shape, np.float32)
    for dy, wyv in ((0, 1.0 - wy), (1, wy)):
        for dx, wxv in ((0, 1.0 - wx), (1, wx)):
            yi = y0i + dy
            xi = x0i + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            out += np.where(valid, v, 0.0).astype(np.float32) * (wyv * wxv)
    return out


def _sample_nearest(img: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """``map_coordinates(order=0, mode='constant')`` equivalent (round-half-up)."""
    h, w = img.shape
    yi = np.floor(yy + 0.5).astype(np.int64)
    xi = np.floor(xx + 0.5).astype(np.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
    return np.where(valid, v, 0.0).astype(img.dtype)


def _affine_pair(image, label, matrix, offset):
    """An inverse-mapped affine on image (order 1, imgaug's default) and label
    (order 0): ``cv2.warpAffine`` where OpenCV is installed, numpy otherwise."""
    if cv2 is not None:
        h, w = image.shape
        # the (y, x) inverse map as cv2's (x, y) src = M·dst convention
        mcv = np.array(
            [[matrix[1, 1], matrix[1, 0], offset[1]], [matrix[0, 1], matrix[0, 0], offset[0]]],
            np.float64,
        )
        flags = cv2.WARP_INVERSE_MAP | cv2.INTER_LINEAR
        img = cv2.warpAffine(image, mcv, (w, h), flags=flags, borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
        lab = cv2.warpAffine(label, mcv, (w, h), flags=cv2.WARP_INVERSE_MAP | cv2.INTER_NEAREST,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
        return img, lab
    yy, xx = _pixel_grid(image.shape[0], image.shape[1])
    sy = np.float32(matrix[0, 0]) * yy + np.float32(matrix[0, 1]) * xx + np.float32(offset[0])
    sx = np.float32(matrix[1, 0]) * yy + np.float32(matrix[1, 1]) * xx + np.float32(offset[1])
    return _sample_bilinear(image, sy, sx), _sample_nearest(label, sy, sx)


def _center_affine(image, label, a, b, c, d):
    """Affine around the image center with forward matrix [[a,b],[c,d]]."""
    h, w = image.shape
    fwd = np.array([[a, b], [c, d]], np.float64)
    inv = np.linalg.inv(fwd)
    center = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    offset = center - inv @ center
    return _affine_pair(image, label, inv, offset)


class SynapseAug:
    """SomeOf(0..4, random order) over the reference's 10 augmenters
    (``dataset_synapse.py:86-97``)."""

    N_OPS = 10

    def __call__(self, image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
        image = image.astype(np.float32)
        label = label.astype(np.float32)
        n = int(rng.integers(0, 5))
        ops = rng.permutation(self.N_OPS)[:n]
        for op in ops:
            image, label = self._apply(int(op), image, label, rng)
        return image, label

    def _apply(self, op, image, label, rng):
        if op == 0:  # Flipud(0.5)
            if rng.random() < 0.5:
                image, label = np.flipud(image).copy(), np.flipud(label).copy()
        elif op == 1:  # Fliplr(0.5)
            if rng.random() < 0.5:
                image, label = np.fliplr(image).copy(), np.fliplr(label).copy()
        elif op == 2:  # AdditiveGaussianNoise(0.005*255)
            image = image + rng.normal(0, 0.005 * 255, image.shape).astype(np.float32)
        elif op == 3:  # GaussianBlur(sigma=1.0)
            image = ndimage.gaussian_filter(image, 1.0)
        elif op == 4:  # LinearContrast(0.5..1.5); imgaug centers floats at 0.5,
            # uint8-range data at 127.5
            center = 0.5 if image.max() <= 1.5 else 127.5
            alpha = rng.uniform(0.5, 1.5)
            image = center + alpha * (image - center)
        elif op == 5:  # Affine scale x,y ∈ (0.5, 2)
            sx = rng.uniform(0.5, 2.0)
            sy = rng.uniform(0.5, 2.0)
            image, label = _center_affine(image, label, sy, 0, 0, sx)
        elif op == 6:  # Affine rotate ±40°
            theta = np.deg2rad(rng.uniform(-40, 40))
            image, label = _center_affine(image, label, np.cos(theta), -np.sin(theta), np.sin(theta), np.cos(theta))
        elif op == 7:  # Affine shear ±16°
            sh = np.tan(np.deg2rad(rng.uniform(-16, 16)))
            image, label = _center_affine(image, label, 1, sh, 0, 1)
        elif op == 8:  # PiecewiseAffine(0.008..0.03) ≈ smooth random displacement field
            scale = rng.uniform(0.008, 0.03)
            image, label = self._grid_distort(image, label, scale, rng)
        elif op == 9:  # Affine translate ±20%
            h, w = image.shape
            ty = rng.uniform(-0.2, 0.2) * h
            tx = rng.uniform(-0.2, 0.2) * w
            image, label = _affine_pair(image, label, np.eye(2), np.array([-ty, -tx]))
        return image, label

    @staticmethod
    def _grid_distort(image, label, scale, rng, grid=4):
        """Smooth displacement field from a coarse jittered grid (PiecewiseAffine-like)."""
        h, w = image.shape
        disp = rng.normal(0, scale * min(h, w), (2, grid, grid))
        # separable spline-zoom operators: dy = Zy · D · Zxᵀ (scipy.ndimage.zoom
        # order-3 semantics through the operator matrices)
        zy = np.asarray(scipy_zoom_matrix(grid, h, order=3), np.float32)
        zx = np.asarray(scipy_zoom_matrix(grid, w, order=3), np.float32)
        dy = zy @ disp[0].astype(np.float32) @ zx.T
        dx = zy @ disp[1].astype(np.float32) @ zx.T
        yy, xx = _pixel_grid(h, w)
        if cv2 is not None:
            mapx = (xx + dx).astype(np.float32)
            mapy = (yy + dy).astype(np.float32)
            img = cv2.remap(image, mapx, mapy, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
            lab = cv2.remap(label, mapx, mapy, cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
            return img, lab
        img = _sample_bilinear(image, yy + dy, xx + dx)
        lab = _sample_nearest(label, yy + dy, xx + dx)
        return img, lab
