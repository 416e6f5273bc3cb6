"""ctypes bridge to the repo's native data parser (``cpp/parser.cpp``).

Port of lightgbm_tpu/io/native.py. The library is built at first use with
``g++ -O2 -shared -fPIC`` into the package's build directory (beside the
CUDA libraries: ``lightgbm_tpu_torch/_build/``, or
``LGBM_TORCH_BUILD_DIR``), named by a hash of the source and flags, so an
edited source is rebuilt and an unchanged one reused. Without g++ or the
source, ``available()`` is False and io/parser.py parses with numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils import log

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cpp", "parser.cpp")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_lock = threading.Lock()


def library_path() -> str:
    from ..ops.kernels.build import build_dir
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(build_dir(),
                        "libdataparser_%s.so" % digest.hexdigest()[:12])


def build() -> str:
    """Compile the parser (once per source and flags); its path."""
    target = library_path()
    if os.path.exists(target):
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found; the native parser is built at "
                           "first use")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = "%s.tmp%d" % (target, os.getpid())
    r = subprocess.run([cxx] + FLAGS + ["-o", tmp, SOURCE],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError("g++ failed for cpp/parser.cpp:\n%s%s"
                           % (r.stdout, r.stderr))
    os.replace(tmp, target)
    return target


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _lock:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            log.debug("native parser unavailable: %s", e)
            return None
        lib.parser_probe.restype = ctypes.c_int
        lib.parser_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_char), ctypes.POINTER(ctypes.c_int)]
        lib.parser_parse_delimited.restype = ctypes.c_int
        lib.parser_parse_delimited.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
        lib.parser_parse_libsvm.restype = ctypes.c_int
        lib.parser_parse_libsvm.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def parse_file(path: str, label_column: int = 0,
               has_header: Optional[bool] = None):
    """Returns (X, y, query_boundaries or None) as io.parser.parse_file;
    has_header None takes the parser's own detection."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    fmt = ctypes.c_int()
    delim = ctypes.c_char()
    header = ctypes.c_int()
    rc = lib.parser_probe(path.encode(), ctypes.byref(rows),
                          ctypes.byref(cols), ctypes.byref(fmt),
                          ctypes.byref(delim), ctypes.byref(header))
    if rc != 0:
        raise RuntimeError(f"parser_probe failed rc={rc}")
    r, c = rows.value, cols.value
    if fmt.value == 1:  # libsvm
        labels = np.empty(r, dtype=np.float64)
        x = np.empty((r, c), dtype=np.float64)
        rc = lib.parser_parse_libsvm(
            path.encode(), r, c,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise RuntimeError(f"parser_parse_libsvm failed rc={rc}")
        return x, labels, None
    skip = header.value
    if has_header is not None and int(bool(has_header)) != skip:
        # the caller's word over the detection: one row more or less
        r += skip - int(bool(has_header))
        skip = int(bool(has_header))
    data = np.empty((r, c), dtype=np.float64)
    rc = lib.parser_parse_delimited(
        path.encode(), delim.value, skip, r, c,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"parser_parse_delimited failed rc={rc}")
    if c == 1:
        return data, None, None
    y = data[:, label_column].copy()
    x = np.delete(data, label_column, axis=1)
    return x, y, None
