"""Virtual file I/O: scheme-dispatched readers and writers.

Port of lightgbm_tpu/io/file_io.py (reference: src/io/file_io.cpp:22-160,
VirtualFileReader / VirtualFileWriter): local paths open as plain files;
``hdfs://`` and any other remote scheme resolve through an opener
registered with :func:`register_scheme`, or else through fsspec when the
environment has it (imported only inside the opener), and otherwise fail
with an error naming both options.

Dataset file input and model save / load go through :func:`open_file`.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

# scheme -> opener(path, mode) -> file object
_OPENERS: Dict[str, Callable] = {}


def register_scheme(scheme: str, opener: Callable) -> None:
    """Register an opener for a URI scheme (e.g. "hdfs"). opener takes
    (path, mode) and returns a file-like object."""
    _OPENERS[scheme.lower()] = opener


def _scheme_of(path: str) -> str:
    # windows drive letters ("C:\\") are not schemes; neither are bare
    # relative or absolute paths
    idx = path.find("://")
    if idx <= 1:
        return ""
    return path[:idx].lower()


def _fsspec_opener(path: str, mode: str):
    import fsspec  # not a dependency of the package
    return fsspec.open(path, mode).open()


def exists(path: str) -> bool:
    scheme = _scheme_of(path)
    if not scheme:
        return os.path.exists(path)
    try:
        import fsspec
        fs, p = fsspec.core.url_to_fs(path)
        return fs.exists(p)
    except Exception:
        return False


def open_file(path: str, mode: str = "r"):
    """Open a local path or URI for reading or writing: a registered
    scheme opener, then fsspec (if the environment has it), then an error
    naming both options."""
    scheme = _scheme_of(path)
    if not scheme or scheme == "file":
        local = path[7:] if scheme == "file" else path
        return open(local, mode)
    if scheme in _OPENERS:
        return _OPENERS[scheme](path, mode)
    try:
        return _fsspec_opener(path, mode)
    except (ImportError, OSError, ValueError) as exc:
        # fsspec missing entirely, or present without a working backend
        # for this scheme (e.g. hdfs:// needs libjvm / pyarrow)
        raise NotImplementedError(
            f"Cannot open '{path}': no opener registered for scheme "
            f"'{scheme}' and the fsspec fallback failed ({exc}). Install "
            f"a working fsspec filesystem for '{scheme}' or call "
            f"lightgbm_tpu_torch.io.file_io.register_scheme('{scheme}', "
            f"opener).") from exc


def read_text(path: str) -> str:
    with open_file(path, "r") as fh:
        return fh.read()


def write_text(path: str, content: str) -> None:
    with open_file(path, "w") as fh:
        fh.write(content)
