"""Logging for lightgbm_tpu_torch (a copy of lightgbm_tpu/utils/log.py).

Mirrors the reference's four-level logger with Fatal-raises semantics
(reference: include/LightGBM/utils/log.h:27-108).
"""
import sys

_LEVELS = {"fatal": -1, "warning": 0, "info": 1, "debug": 2}
_current_level = 1


class LightGBMError(Exception):
    """Raised on fatal errors (the reference throws std::runtime_error)."""


def set_verbosity(verbosity: int) -> None:
    global _current_level
    _current_level = int(verbosity)


def get_verbosity() -> int:
    return _current_level


def debug(msg, *args):
    if _current_level >= 2:
        _emit("Debug", msg % args if args else msg)


def info(msg, *args):
    if _current_level >= 1:
        _emit("Info", msg % args if args else msg)


def warning(msg, *args):
    if _current_level >= 0:
        _emit("Warning", msg % args if args else msg)


def fatal(msg, *args):
    text = msg % args if args else msg
    raise LightGBMError(text)


def _emit(level, text):
    sys.stderr.write(f"[LightGBM-Torch] [{level}] {text}\n")
    sys.stderr.flush()


def check(cond, msg="check failed"):
    if not cond:
        fatal(msg)
