"""Per-process root logger (file + console), rank > 0 silenced on console
(counterpart of `pointcept_tpu/utils/logger.py`; parity target: reference
`pointcept/utils/logger.py:36,143`)."""

from __future__ import annotations

import logging
import sys
from typing import Optional

_initialized_loggers = {}


def get_logger(name: str, log_file: Optional[str] = None, log_level=logging.INFO, file_mode="a"):
    logger = logging.getLogger(name)
    if name in _initialized_loggers and log_file is None:
        return logger
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()

    from . import comm

    rank = comm.get_rank()
    fmt = logging.Formatter("[%(asctime)s %(levelname)s %(filename)s line %(lineno)d %(process)d] %(message)s")

    stream = logging.StreamHandler(stream=sys.stdout)
    stream.setFormatter(fmt)
    stream.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.addHandler(stream)

    if log_file is not None and rank == 0:
        fh = logging.FileHandler(log_file, file_mode)
        fh.setFormatter(fmt)
        fh.setLevel(log_level)
        logger.addHandler(fh)

    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    _initialized_loggers[name] = True
    return logger


def get_root_logger(log_file: Optional[str] = None, log_level=logging.INFO, file_mode="a"):
    """The port's logger. A call with `log_file` (a trainer's) attaches that
    file, in place of any earlier one; a call without returns the logger as
    it stands."""
    return get_logger("pointcept_tpu_torch", log_file=log_file, log_level=log_level, file_mode=file_mode)
