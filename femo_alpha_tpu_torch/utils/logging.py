"""Structured logging to stderr (port of femo_alpha_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("femo_alpha_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[femo-torch %(levelname)s] "
                                      "%(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def log(msg, level=logging.INFO):
    _logger.log(level, msg)


def set_verbosity(level):
    _logger.setLevel(level)
