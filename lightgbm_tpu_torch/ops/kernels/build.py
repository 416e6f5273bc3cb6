"""Build the port's CUDA sources and load them with ctypes.

Each source under ``lightgbm_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface. Nothing is built
when a module is imported: the first launch of a kernel builds (or finds)
its library. ``build_all`` starts one ``nvcc`` per source at once and waits
for all of them, so a cold start costs the slowest single build.

Libraries go to ``lightgbm_tpu_torch/_build/`` (``LGBM_TORCH_BUILD_DIR``
overrides it), named by a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is reused.

``capi_library`` builds the port's C ABI shim (``csrc/c_api.cpp``, host
code) with ``g++`` into ``_build/lib_lightgbm_tpu_torch.so``, the fixed name
external bindings link, with the source's hash beside it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from typing import Dict, Iterable

from ...telemetry import counters as telem_counters

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
    t0 = time.perf_counter()
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
    if procs:
        telem_counters.note_kernel_build(len(procs),
                                         time.perf_counter() - t0)
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


CAPI_NAME = "lib_lightgbm_tpu_torch.so"
CAPI_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]


def capi_library() -> str:
    """Path of the port's C ABI library, built by g++ when it is missing
    or its source changed. It is compiled against Python.h alone, not
    linked with libpython: loaded into a running interpreter (ctypes, or
    a binding library loaded by one), its Python symbols resolve against
    that interpreter, so no python3-config --embed or libpython is
    needed."""
    src = os.path.join(CSRC, "c_api.cpp")
    with open(src, "rb") as f:
        text = f.read()
    with open(os.path.join(CSRC, "c_api.h"), "rb") as f:
        text += f.read()
    digest = hashlib.sha256(text + " ".join(CAPI_FLAGS).encode()) \
        .hexdigest()[:12]
    target = os.path.join(build_dir(), CAPI_NAME)
    stamp = target + ".sha"
    with _lock:
        if os.path.exists(target) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    return target
        os.makedirs(build_dir(), exist_ok=True)
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        tmp = "%s.tmp%d" % (target, os.getpid())
        cmd = [cxx] + CAPI_FLAGS + [
            "-I" + sysconfig.get_paths()["include"], "-I" + CSRC,
            "-o", tmp, src, "-lpthread"]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed for c_api.cpp:\n%s" % proc.stdout)
        os.replace(tmp, target)
        with open(stamp, "w") as f:
            f.write(digest)
    return target
