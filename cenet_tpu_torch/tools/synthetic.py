"""Synthetic, seeded ACDC and skin datasets on disk, in the layouts the port's
datasets read, for the tests (at small sizes) and ``chip_smoke.py`` (at the
datasets' own: ACDC-like 256 × 216 slices, 224² skin images). No dataset is
in the repository; these stand in for them.

* :func:`write_acdc`: per-slice ``.npz`` {img, label} under ``train/`` and
  ``valid/``, test volumes ``.npz`` at the root, and the three list files
  (names with their extension, as ``ACDCDataset`` reads them). Labels 0–3
  drawn as a cardiac-like layout: a right-ventricle disk (1), a myocardium
  ring (2) around a left-ventricle disk (3); the image is the label's
  intensity plus noise, with no normalisation.
* :func:`write_skin_cache`: the ``np/X_tr_{s}x{s}.npy`` / ``Y_tr_{s}x{s}.npy``
  cache that ``SkinDataset`` serves (uint8 HWC images, 0/1 masks: a lesion
  ellipse darker than the skin). ``rows`` above ``n`` leaves the rows between
  unwritten (a sparse file), so a split far into the index range (HAM10000's
  test split starts at 9000) costs only the rows written.
* :func:`write_skin_raw`: the raw layouts ``prepare_skin_cache`` decodes with
  PIL: HAM10000 ``images/ISIC_*.jpg`` + ``masks/*_segmentation.png``, PH2
  ``trainx/IMD*.bmp`` + ``trainy/*_lesion.bmp``.
"""

import os

import numpy as np


def acdc_slice(rng, h, w):
    """(image float32, label uint8) of one cardiac-like slice."""
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.4, 0.6) * h, rng.uniform(0.4, 0.6) * w
    r = rng.uniform(0.12, 0.18) * min(h, w)
    d = np.hypot(yy - cy, xx - cx)
    label = np.zeros((h, w), np.uint8)
    label[np.hypot(yy - cy, xx - cx + 1.6 * r) < 1.1 * r] = 1
    label[d < 1.5 * r] = 2
    label[d < r] = 3
    image = (label * 0.25 + rng.normal(0.1, 0.05, (h, w))).astype(np.float32)
    return image, label


def write_acdc(root, seed=0, n_train=8, n_valid=2, n_test=2, depth=3, h=256, w=216):
    """ACDC-like files under ``root`` (also the list dir)."""
    rng = np.random.default_rng(seed)
    names = {"train": [], "valid": [], "test": []}
    for split, n in (("train", n_train), ("valid", n_valid)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            image, label = acdc_slice(rng, h, w)
            name = f"patient{i:03d}_{split}_slice{i}.npz"
            np.savez(os.path.join(root, split, name), img=image, label=label)
            names[split].append(name)
    for i in range(n_test):
        pairs = [acdc_slice(rng, h, w) for _ in range(depth)]
        name = f"patient{100 + i:03d}_volume.npz"
        np.savez(os.path.join(root, name), img=np.stack([p[0] for p in pairs]), label=np.stack([p[1] for p in pairs]))
        names["test"].append(name)
    for split, ns in names.items():
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(ns) + "\n")
    return names


def skin_pair(rng, size):
    """(image uint8 (s, s, 3), mask uint8 (s, s) of 0/1): a dark lesion ellipse on skin."""
    yy, xx = np.mgrid[:size, :size]
    cy, cx = rng.uniform(0.35, 0.65, 2) * size
    ry, rx = rng.uniform(0.15, 0.3, 2) * size
    mask = ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1).astype(np.uint8)
    skin = np.array([205, 160, 140], np.float32)
    lesion = np.array([110, 70, 60], np.float32)
    image = np.where(mask[..., None] > 0, lesion, skin) + rng.normal(0, 12, (size, size, 3))
    return np.clip(image, 0, 255).astype(np.uint8), mask


def write_skin_cache(root, size=224, n=200, seed=0, rows=None):
    """The ``np/`` cache of ``n`` pairs (in the last ``n`` of ``rows`` rows);
    PH2's 200 images make its 80/20/100 split."""
    rng = np.random.default_rng(seed)
    rows = n if rows is None else rows
    os.makedirs(os.path.join(root, "np"), exist_ok=True)
    x = np.lib.format.open_memmap(os.path.join(root, "np", f"X_tr_{size}x{size}.npy"), "w+", np.uint8,
                                  (rows, size, size, 3))
    y = np.lib.format.open_memmap(os.path.join(root, "np", f"Y_tr_{size}x{size}.npy"), "w+", np.uint8,
                                  (rows, size, size))
    for i in range(rows - n, rows):
        x[i], y[i] = skin_pair(rng, size)
    x.flush()
    y.flush()
    del x, y


def write_skin_raw(root, dataset, n, h=90, w=110, seed=0):
    """``n`` raw images and masks of ``dataset`` (``ham10000`` or ``ph2``) at (h, w)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        image, mask = skin_pair(rng, max(h, w))
        image, mask = image[:h, :w], (mask[:h, :w] * 255).astype(np.uint8)
        if dataset == "ham10000":
            os.makedirs(os.path.join(root, "images"), exist_ok=True)
            os.makedirs(os.path.join(root, "masks"), exist_ok=True)
            Image.fromarray(image).save(os.path.join(root, "images", f"ISIC_{i:07d}.jpg"), quality=90)
            Image.fromarray(mask).save(os.path.join(root, "masks", f"ISIC_{i:07d}_segmentation.png"))
        else:
            os.makedirs(os.path.join(root, "trainx"), exist_ok=True)
            os.makedirs(os.path.join(root, "trainy"), exist_ok=True)
            Image.fromarray(image).save(os.path.join(root, "trainx", f"IMD{i:03d}.bmp"))
            Image.fromarray(mask).save(os.path.join(root, "trainy", f"IMD{i:03d}_lesion.bmp"))
