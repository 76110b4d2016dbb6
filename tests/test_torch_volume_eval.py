"""The port's ``VolumeInferencer`` against the JAX package's, on the CPU.

The cases mirror ``tests/test_eval_pipeline.py``: the same numpy inputs from a
seed go through both engines with the same tiny predict function written in
each package (JAX NHWC, port NCHW). Tolerances:

* every transfer mode's host encode equals the JAX encode bit for bit (array,
  scale and offset);
* float32, uint16 and float16 without a zoom, on integer (HU-like) volumes:
  labels equal to JAX's, and uint16's equal to float32's (the codes are the
  intensities); uint8 there agrees with JAX on ≥ 99.9% of voxels (its decode
  is not exact, and the two decodes may round differently);
* with the device zoom (both sides fp32, their matmuls summing in different
  orders) every mode agrees with JAX on ≥ 99.9% of voxels, and uint16 with
  float32 on ≥ 99% (the JAX host-zoom test's limit);
* ``_host_zoom`` equals JAX's within 1e-6 (both numpy fp32 on the same
  matrices), host-zoomed labels agree with JAX's and with the port's device
  zoom on ≥ 99.9% of voxels, and upscaling inputs do not take the host path;
* the scan path (``predict_many_fn``, groups of ``scan_chunks``, the last one
  smaller) equals the per-chunk path and JAX's scan path, host zoom included;
* ``run_inference`` with ``full_metrics`` and a ``save_hook``: the same
  numbers as JAX's and the same predictions handed to the hook.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu.evaluate import volume as jvol
from cenet_tpu_torch.evaluate import volume as tvol
from cenet_tpu_torch.evaluate.predict import make_predict_fn, make_predict_many_fn

K = 3
MODES = ["float32", "uint16", "float16", "uint8"]


def j_levels(x):  # (B, s, s, 1) → one-hot (B, s, s, K) of |round(x)| mod K
    return jax.nn.one_hot(jnp.clip(jnp.abs(jnp.round(x[..., 0])) % K, 0, K - 1).astype(jnp.int32), K)


def t_levels(x):  # (B, 1, s, s) → one-hot (B, K, s, s), the same function
    lvl = x[:, 0].round().abs().remainder(K).clamp(0, K - 1).long()
    return torch.nn.functional.one_hot(lvl, K).permute(0, 3, 1, 2).float()


def j_bands(x):  # bands of the zoomed intensity: 0, 1 above 0, 2 above 0.5
    return jax.nn.one_hot(jnp.clip((x[..., 0] > 0).astype(jnp.int32) + (x[..., 0] > 0.5), 0, K - 1), K)


def t_bands(x):
    lvl = ((x[:, 0] > 0).long() + (x[:, 0] > 0.5).long()).clamp(0, K - 1)
    return torch.nn.functional.one_hot(lvl, K).permute(0, 3, 1, 2).float()


def j_many(predict):
    return lambda xs: jax.vmap(lambda x: jnp.argmax(predict(x), -1).astype(jnp.uint8))(xs)


def t_many(predict):
    return lambda xs: torch.stack([predict(x).argmax(dim=1).to(torch.uint8) for x in xs])


def engines(jpred, tpred, many=False, **kw):
    """(JAX inferencer, port inferencer) with the same config."""
    jcfg, tcfg = jvol.VolumeInferenceConfig(**kw), tvol.VolumeInferenceConfig(**kw)
    return (jvol.VolumeInferencer(jpred, jcfg, predict_many_fn=j_many(jpred) if many else None),
            tvol.VolumeInferencer(tpred, tcfg, device="cpu", predict_many_fn=t_many(tpred) if many else None))


def hu_volume(seed, d=6, h=40, w=40):
    return np.random.default_rng(seed).integers(-1024, 3072, (d, h, w)).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_transfer_modes_without_zoom_match_jax(mode):
    image = hu_volume(0)
    jinf, tinf = engines(j_levels, t_levels, img_size=40, chunk=4, normalize=False, num_classes=K,
                         transfer_dtype=mode)
    (jenc, jsc, joff), (tenc, tsc, toff) = jinf._encode(image), tinf._encode(image)
    assert tenc.dtype == jenc.dtype and (tsc, toff) == (jsc, joff)
    np.testing.assert_array_equal(tenc, jenc)
    want, got = jinf.predict_volume(image), tinf.predict_volume(image)
    assert got.shape == image.shape and got.dtype == np.uint8
    if mode == "uint8":
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)
    if mode == "uint16":
        f32 = tvol.VolumeInferencer(t_levels, dataclasses.replace(tinf.cfg, transfer_dtype="float32"), device="cpu")
        np.testing.assert_array_equal(got, f32.predict_volume(image))


def test_transfer_modes_with_device_zoom_match_jax():
    image = (np.random.default_rng(1).standard_normal((5, 56, 72)) * 2.0).astype(np.float32)
    labels = {}
    for mode in MODES:
        jinf, tinf = engines(j_bands, t_bands, img_size=32, chunk=4, normalize=True, num_classes=K,
                             transfer_dtype=mode)
        got = labels[mode] = tinf.predict_volume(image)
        assert got.shape == image.shape
        assert (got == jinf.predict_volume(image)).mean() >= 0.999, mode
    assert (labels["uint16"] == labels["float32"]).mean() >= 0.99


def test_host_zoom_matches_jax():
    image = (np.random.default_rng(2).standard_normal((6, 96, 112)) * 2.0).astype(np.float32)
    jinf, tinf = engines(j_bands, t_bands, img_size=48, chunk=4, normalize=False, num_classes=K, host_zoom=True)
    np.testing.assert_allclose(tinf._host_zoom(image), jinf._host_zoom(image), rtol=0, atol=1e-6)
    for hw in ((96, 112), (32, 32), (48, 48), (40, 80)):
        assert tinf._host_zoom_active(*hw) == jinf._host_zoom_active(*hw)
    host = tinf.predict_volume(image)
    assert (host == jinf.predict_volume(image)).mean() >= 0.999
    dev = tvol.VolumeInferencer(t_bands, dataclasses.replace(tinf.cfg, host_zoom=False), device="cpu")
    assert (host == dev.predict_volume(image)).mean() >= 0.999
    small = image[:, :32, :32]  # an upscale keeps the device zoom
    np.testing.assert_array_equal(tinf.predict_volume(small), dev.predict_volume(small))


@pytest.mark.parametrize("host_zoom", [False, True])
def test_scan_path_equals_per_chunk_and_jax(host_zoom):
    image = hu_volume(3, d=10, h=64, w=64) / 1000.0 if host_zoom else hu_volume(3, d=10)
    size = 32 if host_zoom else 40
    pred = (j_bands, t_bands) if host_zoom else (j_levels, t_levels)
    kw = dict(img_size=size, chunk=4, normalize=False, num_classes=K, scan_chunks=2, host_zoom=host_zoom)
    jscan, tscan = engines(*pred, many=True, **kw)
    calls = []
    many = tscan.predict_many_fn
    tscan.predict_many_fn = lambda xs: calls.append(tuple(xs.shape)) or many(xs)
    got = tscan.predict_volume(image)
    assert calls == [(2, 4, 1, size, size), (1, 4, 1, size, size)]  # 3 chunks: a group of 2, then of 1
    per_chunk = tvol.VolumeInferencer(pred[1], tvol.VolumeInferenceConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got, per_chunk.predict_volume(image))
    want = jscan.predict_volume(image)
    if host_zoom:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("full_metrics", [False, True])
def test_run_inference_and_save_hook_match_jax(full_metrics):
    rng = np.random.default_rng(4)
    cases = []
    for i in range(3):
        label = np.zeros((4, 48, 48), np.int32)
        label[:, 8 + i : 30, 10:34] = 1
        label[:, 32:44, 4 + 2 * i : 20] = 2
        image = label.astype(np.float32) + (rng.random(label.shape) < 0.02)  # some voxels off by one level
        cases.append({"image": image, "label": label, "case_name": f"case{i}"})
    jinf, tinf = engines(j_levels, t_levels, img_size=48, chunk=4, normalize=False, num_classes=K)
    jpreds, tpreds = [], []
    want = jvol.run_inference(jinf, cases, full_metrics=full_metrics, save_hook=lambda c, p: jpreds.append(p))
    got = tvol.run_inference(tinf, cases, full_metrics=full_metrics, save_hook=lambda c, p: tpreds.append(p))
    assert got == want and 0.0 < got[0] < 1.0
    for a, b in zip(tpreds, jpreds):
        np.testing.assert_array_equal(a, b)
    for case in cases:
        _, metrics = tinf.evaluate_case(case["image"], case["label"], full_metrics=full_metrics)
        assert metrics == jinf.evaluate_case(case["image"], case["label"], full_metrics=full_metrics)[1]
        assert all(len(m) == (4 if full_metrics else 2) for m in metrics)


def test_predict_many_fn_takes_the_argmax_of_the_logits():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3, padding=1), torch.nn.BatchNorm2d(4)).train()
    x = torch.randn(3, 2, 1, 16, 16)
    labels = make_predict_many_fn(model, torch.float32)(x)
    assert labels.shape == (3, 2, 16, 16) and labels.dtype == torch.uint8 and not model.training
    want = torch.stack([make_predict_fn(model, torch.float32)(c).argmax(dim=1) for c in x]).to(torch.uint8)
    assert torch.equal(labels, want)


def test_unknown_transfer_dtype_raises():
    with pytest.raises(ValueError, match="transfer_dtype"):
        tvol.VolumeInferencer(t_levels, tvol.VolumeInferenceConfig(transfer_dtype="int8"), device="cpu")
