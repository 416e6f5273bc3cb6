"""Build the port's CUDA sources and load them with ctypes.

Each source under ``lightgbm_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface. Nothing is built
when a module is imported: the first launch of a kernel builds (or finds)
its library. ``build_all`` starts one ``nvcc`` per source at once and waits
for all of them, so a cold start costs the slowest single build.

Libraries go to ``lightgbm_tpu_torch/_build/`` (``LGBM_TORCH_BUILD_DIR``
overrides it), named by a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("histogram", "partition", "split_key")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> str:
    return os.environ.get("LGBM_TORCH_BUILD_DIR") or os.path.join(
        _PKG, "_build")


def nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(build_dir(), "lib%s_%s.so" % (
        name, digest.hexdigest()[:12]))


def build_all(names: Iterable[str] = SOURCES,
              verbose: bool = False) -> Dict[str, str]:
    """Compile the named sources in parallel; returns name -> compiler
    output ("cached" for a library that already exists). verbose adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel)."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    out: Dict[str, str] = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            out[name] = "cached"
            continue
        tmp = "%s.tmp%d" % (target, os.getpid())
        cmd = [nvcc()] + FLAGS + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed for %s.cu:\n%s" % (name, text))
            continue
        os.replace(tmp, target)
        out[name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = library_path(name)
            if not os.path.exists(target):
                build_all((name,))
            lib = ctypes.CDLL(target)
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError("%s failed: CUDA error %d" % (what, rc))
