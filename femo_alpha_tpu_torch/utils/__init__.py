"""Logging and timing helpers (port of femo_alpha_tpu/utils: logging.py and
timing.py)."""

from .logging import log, set_verbosity
from .timing import Timer

__all__ = ["log", "set_verbosity", "Timer"]
