"""Logging with the reference's observable format
(reference MFT/train.py:31-40): '%(asctime)s - %(message)s' to a log file
(mode 'w') plus stdout.  Copy of
`multimodal_transformer_tpu/engine/logging_utils.py`."""

from __future__ import annotations

import logging
import sys


def get_logger(log_file: str = "./train_cnn.log",
               name: str = "mmtx") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(message)s")
    fh = logging.FileHandler(log_file, "w")
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger
