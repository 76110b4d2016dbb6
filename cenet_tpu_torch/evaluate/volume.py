"""Volume inference: per-case 3-D prediction in fixed-size chunks, with metrics.

Mirrors ``cenet_tpu/evaluate/volume.py``. A volume is encoded on the host in
the transfer dtype (``_encode``), split into chunks of ``chunk`` slices (the
last one padded, so every forward has one shape) and each chunk goes to the
device in one upload. There the chunk step decodes it in fp32
(``x.float() * scale + offset``), zooms it to the network size with the exact
scipy order-3 spline operator (a separable matrix product), normalises it,
runs ``predict_fn`` and takes the argmax. Labels come back as uint8 and are
zoomed to the volume's size on the host with scipy's order-0 index map.
Metrics run on host numpy.

On the card the chunks overlap, in CUDA terms of the JAX engine's
double-buffered ``device_put``: each chunk is copied into a
pinned staging buffer (two per shape and dtype, kept across chunks and cases)
and uploaded with a ``non_blocking`` copy on a side stream while the previous
chunk computes; the compute stream waits on the upload's event and the chunk's
memory is recorded on it (``record_stream``). Every chunk is dispatched before
any is pulled; each chunk's labels are copied into a pinned output buffer
behind an event, and the host back-zooms chunk k while later chunks are still
in flight. Elsewhere the chunks run in a serial loop (upload, compute, copy
back, one chunk at a time), which gives the same labels to the bit.

``host_zoom`` runs the spline downscale on the host before the encode, so only
img_size² values a slice cross the link; ``predict_many_fn`` (e.g.
:func:`cenet_tpu_torch.evaluate.predict.make_predict_many_fn`) takes the scan
path: the whole volume uploaded at once and groups of ``scan_chunks`` chunks
per call.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cenet_tpu_torch.core.device import resolve_device
from cenet_tpu_torch.evaluate.metrics import calculate_metric_percase, calculate_metric_percase_full
from cenet_tpu_torch.nn import functional as F

TRANSFER_DTYPES = {"float32": torch.float32, "float16": torch.float16, "uint16": torch.uint16, "uint8": torch.uint8}


@dataclasses.dataclass
class VolumeInferenceConfig:
    img_size: int = 224
    chunk: int = 32  # slices per forward (one shape)
    normalize: bool = True  # Synapse: Normalize(0.5, 0.5); ACDC: none
    num_classes: int = 9
    # Host→device dtype of the raw volume, decoded on the device as x*scale+offset:
    #   "float32" — exact, the reference's fp32 eval (default);
    #   "float16" — half the bytes, clipped to the fp16 range;
    #   "uint16"  — half the bytes, per-volume affine codes; exact for
    #               integer-valued volumes spanning ≤ 65535 (raw HU-style CT);
    #   "uint8"   — a quarter of the bytes, ~0.4% of the range.
    transfer_dtype: str = "float32"
    scan_chunks: int = 4  # chunks per call when a predict_many_fn is given
    # Order-3 downscale to img_size on the host, before the encode (only for
    # inputs larger than img_size², which it shrinks on the wire).
    host_zoom: bool = False


class _Staging:
    """Pinned host buffers of one inferencer, kept across chunks and cases: two
    upload buffers per (shape, dtype), each reused once the upload that last
    read it has finished (its event), and one output buffer per chunk position.
    ``allocations`` counts the buffers made."""

    def __init__(self):
        self._inputs: Dict[tuple, List[list]] = {}
        self._turn: Dict[tuple, int] = {}
        self._outputs: Dict[tuple, List[torch.Tensor]] = {}
        self.allocations = 0

    def _new(self, shape, dtype) -> torch.Tensor:
        self.allocations += 1
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def upload_buffer(self, shape, dtype) -> list:
        """[pinned buffer, event of its last upload or None]; waits on that event."""
        key = (tuple(shape), dtype)
        ring = self._inputs.setdefault(key, [])
        if len(ring) < 2:
            ring.append([self._new(shape, dtype), None])
            return ring[-1]
        slot = ring[self._turn.get(key, 0)]
        self._turn[key] = 1 - self._turn.get(key, 0)
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def output_buffer(self, k: int, shape, dtype) -> torch.Tensor:
        bufs = self._outputs.setdefault((tuple(shape), dtype), [])
        while len(bufs) <= k:
            bufs.append(self._new(shape, dtype))
        return bufs[k]


class VolumeInferencer:
    """Batched per-volume predictor.

    ``predict_fn(images (B, 1, s, s) fp32) -> probs (B, K, s, s)`` runs on
    ``device`` (the card unless the caller names another), e.g.
    :func:`cenet_tpu_torch.evaluate.predict.make_predict_fn`. Optionally
    ``predict_many_fn(images (k, c, 1, s, s)) -> labels (k, c, s, s)`` uint8
    takes the scan path.
    """

    def __init__(self, predict_fn: Callable, cfg: VolumeInferenceConfig,
                 device: Optional[Union[str, torch.device]] = None, predict_many_fn: Optional[Callable] = None):
        if cfg.transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype {cfg.transfer_dtype!r} is not one of {sorted(TRANSFER_DTYPES)}")
        self.predict_fn = predict_fn
        self.predict_many_fn = predict_many_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        self.staging = _Staging()
        self._copy_stream = None

    # -- host side ----------------------------------------------------------

    def _encode(self, image: np.ndarray) -> Tuple[np.ndarray, float, float]:
        """Volume → (transfer array, scale, offset); the device decode is x*scale+offset.

        uint16/uint8 use per-volume affine quantization, exact whenever the
        volume is integer-valued with range ≤ qmax, since then scale is 1 and
        the codes are the intensities themselves.
        """
        tdt = np.dtype(self.cfg.transfer_dtype)
        if tdt == np.float16:
            fmax = float(np.finfo(np.float16).max)
            return np.clip(image, -fmax, fmax).astype(tdt), 1.0, 0.0
        if tdt in (np.dtype(np.uint16), np.dtype(np.uint8)):
            qmax = float(np.iinfo(tdt).max)
            lo = float(image.min()) if image.size else 0.0
            hi = float(image.max()) if image.size else 0.0
            span = hi - lo
            integral = span <= qmax and float(np.abs(image - np.rint(image)).max() if image.size else 0.0) == 0.0
            scale = 1.0 if integral or span == 0.0 else span / qmax
            q = np.rint((image - lo) / scale)
            return np.clip(q, 0.0, qmax).astype(tdt), scale, lo
        return np.asarray(image, tdt), 1.0, 0.0

    def _host_zoom(self, chunk: np.ndarray) -> np.ndarray:
        """(c, H, W) → (c, s, s) fp32 on the host: the device path's separable
        spline operator (``W_h @ x @ W_wᵀ`` per slice), in numpy fp32."""
        s = self.cfg.img_size
        h, w = chunk.shape[1], chunk.shape[2]
        wh = np.asarray(F.scipy_zoom_matrix(h, s, 3), np.float32)
        ww = np.asarray(F.scipy_zoom_matrix(w, s, 3), np.float32)
        x = chunk.astype(np.float32, copy=False)
        return (wh @ x) @ ww.T

    def _host_zoom_active(self, h: int, w: int) -> bool:
        s = self.cfg.img_size
        return self.cfg.host_zoom and (h, w) != (s, s) and h * w > s * s

    def _host_chunks(self, image: np.ndarray) -> Tuple[List[np.ndarray], float, float]:
        """Pad to a whole number of chunks and split on the host, in the transfer dtype."""
        d, h, w = image.shape
        c = self.cfg.chunk
        vol, scale, offset = self._encode(image)
        pad = (-d) % c
        if pad:
            vol = np.concatenate([vol, np.zeros((pad, h, w), vol.dtype)], axis=0)
        return [vol[i : i + c] for i in range(0, d + pad, c)], scale, offset

    def _chunk_preps(self, image: np.ndarray) -> List[Callable[[], Tuple[np.ndarray, float, float]]]:
        """One callable per chunk giving (encoded chunk, scale, offset). With the
        host zoom each chunk is zoomed, then encoded with its own affine, when
        its turn comes (so the host zooms chunk k+1 while chunk k computes)."""
        d, h, w = image.shape
        c = self.cfg.chunk
        if self._host_zoom_active(h, w):
            pad = (-d) % c
            raws = [image[i : i + c] for i in range(0, d, c)]
            if pad:
                raws[-1] = np.concatenate([raws[-1], np.zeros((pad, h, w), image.dtype)], axis=0)
            return [lambda r=r: self._encode(self._host_zoom(r)) for r in raws]
        chunks, scale, offset = self._host_chunks(image)
        return [lambda ch=ch: (ch, scale, offset) for ch in chunks]

    def _back_zoom_fn(self, h: int, w: int) -> Callable[[np.ndarray], np.ndarray]:
        """(n, s, s) labels → (n, h, w): scipy order-0's index map, exactly."""
        s = self.cfg.img_size
        if (h, w) == (s, s):
            return lambda p: p
        idx_h, valid_h = F.zoom_nearest_indices(s, h)
        idx_w, valid_w = F.zoom_nearest_indices(s, w)
        valid = np.logical_and.outer(valid_h, valid_w)
        if valid.all():
            return lambda p: p[:, idx_h][:, :, idx_w]
        return lambda p: np.where(valid[None], p[:, idx_h][:, :, idx_w], np.uint8(0))

    # -- device side --------------------------------------------------------

    def _labels(self, x: torch.Tensor, scale: float, offset: float) -> torch.Tensor:
        """The chunk step: (c, H, W) in the transfer dtype → (c, s, s) uint8 labels."""
        s = self.cfg.img_size
        x = (x.float() * float(np.float32(scale)) + float(np.float32(offset)))[:, None]
        x = F.zoom_resize(x, (s, s), order=3)
        if self.cfg.normalize:
            x = (x - 0.5) / 0.5
        return self.predict_fn(x).argmax(dim=1).to(torch.uint8)

    def _upload(self, enc: np.ndarray) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """``enc`` into a pinned staging buffer, then to the card on the side
        stream; returns the device tensor and the event that ends its upload."""
        buf = self.staging.upload_buffer(enc.shape, TRANSFER_DTYPES[self.cfg.transfer_dtype])
        buf[0].numpy()[...] = enc
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            x = torch.empty(buf[0].shape, dtype=buf[0].dtype, device=self.device)
            x.copy_(buf[0], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        buf[1] = ready
        return x, ready

    def _run_serial(self, preps) -> Iterator[np.ndarray]:
        for prep in preps:
            enc, scale, offset = prep()
            x = torch.from_numpy(np.ascontiguousarray(enc)).to(self.device)
            yield self._labels(x, scale, offset).cpu().numpy()

    def _run_overlapped(self, preps) -> Iterator[np.ndarray]:
        """Dispatch every chunk (uploading chunk k+1 before chunk k's step), then
        yield each chunk's labels as its copy to the host completes."""
        stream = torch.cuda.current_stream(self.device)
        pulls = []
        enc, scale, offset = preps[0]()
        nxt = (*self._upload(enc), scale, offset)
        for k in range(len(preps)):
            x, ready, scale, offset = nxt
            if k + 1 < len(preps):
                enc, sc, off = preps[k + 1]()
                nxt = (*self._upload(enc), sc, off)
            stream.wait_event(ready)
            x.record_stream(stream)
            labels = self._labels(x, scale, offset)
            host = self.staging.output_buffer(k, labels.shape, labels.dtype)
            host.copy_(labels, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            pulls.append((host, done))
            del x, labels
        for host, done in pulls:
            done.synchronize()
            yield host.numpy()

    # -- entry points -------------------------------------------------------

    def predict_volume(self, image: np.ndarray) -> np.ndarray:
        """image (D, H, W) float → label volume (D, H, W) uint8."""
        if self.predict_many_fn is not None:
            return self._back_zoom_fn(*image.shape[1:])(self._predict_volume_scan(image))
        return self._predict_chunked(image, self._run_overlapped if self.device.type == "cuda" else self._run_serial)

    def _predict_chunked(self, image: np.ndarray, run: Callable) -> np.ndarray:
        """The per-chunk path with ``run`` (``_run_overlapped`` or ``_run_serial``)."""
        d, h, w = image.shape
        back_zoom = self._back_zoom_fn(h, w)
        parts, left = [], d
        for labels in run(self._chunk_preps(image)):
            take = min(left, labels.shape[0])
            parts.append(back_zoom(labels[:take]))
            left -= take
        return np.concatenate(parts, axis=0)

    def _predict_volume_scan(self, image: np.ndarray) -> np.ndarray:
        """Scan path: the whole volume in one upload, then ``predict_many_fn`` on
        groups of ``scan_chunks`` chunks (the last group smaller, never padded)."""
        d, h, w = image.shape
        s, c = self.cfg.img_size, self.cfg.chunk
        host_zoom = self._host_zoom_active(h, w)
        vol, scale, offset = self._encode(self._host_zoom(image) if host_zoom else image)
        x = torch.from_numpy(np.ascontiguousarray(vol)).to(self.device)
        x = (x.float() * float(np.float32(scale)) + float(np.float32(offset)))[:, None]
        if not host_zoom:
            x = F.zoom_resize(x, (s, s), order=3)
        if self.cfg.normalize:
            x = (x - 0.5) / 0.5
        pad = (-d) % c
        if pad:
            x = torch.cat([x, x.new_zeros((pad, 1, s, s))])
        xs = x.reshape(-1, c, 1, s, s)
        kg = self.cfg.scan_chunks
        outs = [self.predict_many_fn(xs[i : i + kg]).cpu().numpy() for i in range(0, xs.shape[0], kg)]
        return np.concatenate(outs, axis=0).reshape(-1, s, s)[:d]

    def evaluate_case(self, image: np.ndarray, label: np.ndarray,
                      full_metrics: bool = False) -> Tuple[np.ndarray, List[Tuple[float, ...]]]:
        """Returns (prediction volume, per-class metric tuples for classes 1..K-1):
        (dice, hd95), or with ``full_metrics`` (dice, hd95, jaccard, asd)."""
        pred = self.predict_volume(image)
        metric_fn = calculate_metric_percase_full if full_metrics else calculate_metric_percase
        return pred, [metric_fn(pred == i, label == i) for i in range(1, self.cfg.num_classes)]


def run_inference(
    inferencer: VolumeInferencer,
    cases: Sequence[Dict],
    full_metrics: bool = False,
    log: Optional[logging.Logger] = None,
    save_hook: Optional[Callable] = None,
    metrics: bool = True,
) -> Optional[Tuple[float, float]]:
    """Aggregate per-case metrics like the reference ``inference``
    (``utils_synapse.py:151-168``): per-class means over cases, then overall means.
    ``save_hook(case, pred)`` runs after each case. Returns (mean_dice, mean_hd95).
    Without ``metrics`` only the predictions run (the ranks of a mesh other than
    rank 0, whose predictions take part in every chunk's gather), and it returns None."""
    log = log or logging.getLogger(__name__)
    metric_sum = None
    for i, case in enumerate(cases):
        if not metrics:
            inferencer.predict_volume(case["image"])
            continue
        pred, case_metrics = inferencer.evaluate_case(case["image"], case["label"], full_metrics)
        arr = np.array(case_metrics, dtype=np.float64)
        metric_sum = arr if metric_sum is None else metric_sum + arr
        log.info(" idx %d case %s mean_dice %f mean_hd95 %f",
                 i, case.get("case_name", str(i)), arr[:, 0].mean(), arr[:, 1].mean())
        if save_hook is not None:
            save_hook(case, pred)
    if not metrics:
        return None
    metric_mean = metric_sum / len(cases)
    for c in range(metric_mean.shape[0]):
        log.info("Mean class %d -> mean_dice: %f, mean_hd95: %f", c + 1, metric_mean[c, 0], metric_mean[c, 1])
    performance = float(metric_mean[:, 0].mean())
    mean_hd95 = float(metric_mean[:, 1].mean())
    log.info("Testing performance: mean_dice: %f, mean_hd95: %f", performance, mean_hd95)
    return performance, mean_hd95
