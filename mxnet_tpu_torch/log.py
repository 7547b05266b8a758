"""Logging utilities (parity: reference ``python/mxnet/log.py``).

Colored level labels on TTYs, plain ``level:name:message`` otherwise.
A whole copy of ``mxnet_tpu/log.py`` (the port imports nothing of the
JAX package); ``faults``, ``flight``, ``tuner`` and the serving engine
log through it.
"""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger",
           "CRITICAL", "DEBUG", "ERROR", "FATAL", "INFO", "NOTSET", "WARNING"]

CRITICAL = logging.CRITICAL
DEBUG = logging.DEBUG
ERROR = logging.ERROR
FATAL = logging.FATAL
INFO = logging.INFO
NOTSET = logging.NOTSET
WARNING = logging.WARNING

PY3 = True


class _Formatter(logging.Formatter):
    """Customized log formatter with colored level labels."""

    def __init__(self):
        datefmt = "%m%d %H:%M:%S"
        super().__init__(datefmt=datefmt)

    def _get_color(self, level):
        if logging.WARNING <= level:
            return "\x1b[31m"
        elif logging.INFO <= level:
            return "\x1b[32m"
        return "\x1b[34m"

    def _get_label(self, level):
        if level == logging.CRITICAL:
            return "C"
        elif level == logging.ERROR:
            return "E"
        elif level == logging.WARNING:
            return "W"
        elif level == logging.INFO:
            return "I"
        elif level == logging.DEBUG:
            return "D"
        return "U"

    def format(self, record):
        fmt = ""
        if sys.stderr.isatty():
            fmt += self._get_color(record.levelno)
        fmt += self._get_label(record.levelno)
        fmt += "%(asctime)s %(process)d %(pathname)s:%(funcName)s:%(lineno)d"
        fmt += "]"
        if sys.stderr.isatty():
            fmt += "\x1b[0m"
        fmt += " %(message)s"
        self._style._fmt = fmt
        return super().format(record)


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Deprecated alias of :func:`get_logger`."""
    import warnings
    warnings.warn("getLogger is deprecated, use get_logger instead",
                  DeprecationWarning)
    return get_logger(name, filename, filemode, level)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Get a customized logger; attaches one handler per logger name."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", None):
        logger._init_done = True
        if filename:
            mode = filemode if filemode else "a"
            hdlr = logging.FileHandler(filename, mode)
        else:
            hdlr = logging.StreamHandler()
            # the `_Formatter` contain some escape character to
            # represent color, which is not suitable for FileHandler
            hdlr.setFormatter(_Formatter())
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger
