"""Logging to ``<snapshot>/log_<name>.txt`` and stdout (reference
``main_synapse.py:111-120``).

A copy of ``setup_logging`` from ``cenet_tpu/core/logging_utils.py``; its
scalar writer, throughput meter and profiler hook are not ported yet.
"""

from __future__ import annotations

import logging
import os
import sys


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
