"""Logging and observability: file and stdout logging, scalar curves, throughput.

Copies of ``setup_logging``, ``ScalarWriter`` and ``Throughput`` from
``cenet_tpu/core/logging_utils.py`` (the port imports nothing of the JAX
package). Reference surface: python logging to ``snapshot_path/log_{train,eval}.txt``
(``main_synapse.py:111-120``), tensorboardX scalars per iteration and images
every 100 iterations (``main_synapse.py:279-293``), and a real ``--throughput``
(the reference flag is dead). ``ProfilerHook`` is the JAX package's, on
``torch.profiler``: a library API, which no CLI flag turns on.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional


def setup_logging(snapshot_path: str, name: str = "train", also_stdout: bool = True) -> logging.Logger:
    os.makedirs(snapshot_path, exist_ok=True)
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S")
    fh = logging.FileHandler(os.path.join(snapshot_path, f"log_{name}.txt"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    if also_stdout:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


class ScalarWriter:
    """TensorBoard scalar writer (tensorboardX) with a loud TSV fallback.

    When tensorboardX is unavailable the failure is logged as a WARNING (a
    production run must never silently log nothing) and scalars are appended
    to ``<logdir>/scalars.tsv`` (``tag\\tstep\\tvalue`` per line) so they always
    land somewhere greppable/plottable."""

    def __init__(self, logdir: str):
        self._tsv = None
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception as e:  # noqa: BLE001 — import/init failures alike
            self._w = None
            logging.getLogger(__name__).warning(
                "tensorboardX unavailable (%s: %s) — falling back to TSV scalars at %s/scalars.tsv",
                type(e).__name__, e, logdir,
            )
            os.makedirs(logdir, exist_ok=True)
            self._tsv = open(os.path.join(logdir, "scalars.tsv"), "a", buffering=1)

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)
        elif self._tsv is not None:
            self._tsv.write(f"{tag}\t{step}\t{float(value)}\n")

    def image(self, tag: str, img, step: int):
        if self._w is not None:
            self._w.add_image(tag, img, step)
        # no TSV equivalent for images; scalars are the must-not-drop signal

    def close(self):
        if self._w is not None:
            self._w.close()
        if self._tsv is not None:
            self._tsv.close()
            self._tsv = None


class Throughput:
    """Images/sec meter with warmup exclusion (the real ``--throughput``)."""

    def __init__(self, warmup_iters: int = 3):
        self.warmup = warmup_iters
        self.n_images = 0
        self.n_iters = 0
        self.t0: Optional[float] = None

    def step(self, batch_size: int):
        self.n_iters += 1
        if self.n_iters == self.warmup:
            self.t0 = time.time()
            self.n_images = 0
        elif self.n_iters > self.warmup:
            self.n_images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self.t0 is None or self.n_images == 0:
            return 0.0
        return self.n_images / (time.time() - self.t0)


class ProfilerHook:
    """``torch.profiler`` over a window of steps, as the JAX package's hook
    traces one (``cenet_tpu/core/logging_utils.py:99-116``): call
    ``maybe_start_stop(step)`` before each step. A profile of the host (and of
    the card's kernels when a card is present) starts at ``start_step`` and
    stops at ``start_step + num_steps``, after the card has finished the
    window's kernels; then it writes a Chrome trace to
    ``<logdir>/trace_steps_<start>-<stop>.json``. It starts only when inactive
    and stops only when active, so repeated calls at those steps do nothing."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 5):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.trace_path: Optional[str] = None
        self._prof = None

    def maybe_start_stop(self, step: int):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if step == self.start_step and self._prof is None:
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif step == self.stop_step and self._prof is not None:
            if cuda:
                torch.cuda.synchronize()
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            self.trace_path = os.path.join(self.logdir, f"trace_steps_{self.start_step}-{self.stop_step}.json")
            prof.export_chrome_trace(self.trace_path)
