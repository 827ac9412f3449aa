"""Leveled logging — the reference's BL_* macro system as a thin stdlib
wrapper.

The port of ``kmerind_tpu.utils.logging``.  The reference selects a log
engine and verbosity at compile time (NO_LOG/CERR/PRINTF/... x
FATAL...TRACE, src/utils/logging.h:96-160); here the environment variable
``KMERIND_TPU_LOG`` (fatal|error|warning|info|debug|trace|none, default
warning) sets the level of the standard `logging` logger
``kmerind_tpu_torch`` when this module is first imported, and `set_level`
changes it later.
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["log", "set_level", "FATAL", "ERROR", "WARNING", "INFO", "DEBUG",
           "TRACE"]

TRACE = 5
DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
FATAL = logging.CRITICAL

logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "fatal": FATAL, "error": ERROR, "warning": WARNING,
    "info": INFO, "debug": DEBUG, "trace": TRACE, "none": FATAL + 10,
}

log = logging.getLogger("kmerind_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(levelname)s] kmerind_tpu_torch %(message)s"))
    log.addHandler(_h)
log.setLevel(_LEVELS.get(
    os.environ.get("KMERIND_TPU_LOG", "warning").lower(), WARNING))


def set_level(name: str):
    """Set the verbosity by name (the LOGGER_VERBOSITY knob)."""
    log.setLevel(_LEVELS[name.lower()])
