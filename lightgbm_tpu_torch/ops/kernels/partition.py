"""K4: stable three-way partition of a packed row window.

Port of lightgbm_tpu/ops/pallas/partition_kernel.py::stable_partition3
(kernel body ``_partition_kernel``). The kernel itself is
``csrc/partition.cu`` (block counts, one scan block, warp-ballot ranks and
a row scatter, see the note there); ``stable_partition3_plain`` is the same
function in plain PyTorch: ``index_select`` by ``argsort(key, stable)``.

``stable_partition3`` takes the plain version for a tensor on the CPU and
launches the kernel for a tensor on the card. It writes into ``out`` (a
second buffer): the growth core ping-pongs two working buffers instead of
copying the window back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

# launch count: +1 right after each kernel launch, read by chip_smoke.py
launches = 0

_tile = None


def stable_partition3_plain(win: torch.Tensor,
                            key3: torch.Tensor) -> torch.Tensor:
    """Rows of `win` (W, D) ordered by key3 in {0, 1, 2}, stable."""
    order = torch.argsort(key3, stable=True)
    return win.index_select(0, order)


def stable_partition3(win: torch.Tensor, key3: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stably reorder `win` (W, D) int32 so that rows sort by key3 in
    {0, 1, 2}; the exact equal of take(win, argsort(key3, stable)). The
    result goes to `out` (W, D) when given (it must not overlap `win`)."""
    global launches, _tile
    if out is None:
        out = torch.empty_like(win)
    if win.device.type == "cpu":
        out.copy_(stable_partition3_plain(win, key3))
        return out
    if win.device.type != "cuda" or key3.device != win.device \
            or out.device != win.device:
        raise ValueError("stable_partition3: win, key3 and out must share "
                         "one CUDA device")
    if (win.dim() != 2 or win.dtype != torch.int32 or not win.is_contiguous()
            or key3.shape != (win.shape[0],) or key3.dtype != torch.int32
            or not key3.is_contiguous() or out.shape != win.shape
            or out.dtype != torch.int32 or not out.is_contiguous()):
        raise ValueError("stable_partition3: want contiguous int32 (W, D) "
                         "win and out and (W,) int32 key3")
    w, d = win.shape
    if w == 0:
        return out
    if w >= 2 ** 31:
        raise ValueError("stable_partition3: window too large")
    lib = build.load("partition")
    if _tile is None:
        lib.lgbt_partition_tile_rows.restype = ctypes.c_int
        _tile = int(lib.lgbt_partition_tile_rows())
    nb = -(-w // _tile)
    scratch = torch.empty(6 * nb, dtype=torch.int32, device=win.device)
    fn = lib.lgbt_partition_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    rc = fn(win.data_ptr(), key3.data_ptr(), w, d, scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(win.device).cuda_stream)
    build.check(rc, "partition kernel launch")
    launches += 1
    return out
