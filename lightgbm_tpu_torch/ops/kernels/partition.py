"""K4: stable three-way partition of a packed row window.

Port of lightgbm_tpu/ops/pallas/partition_kernel.py::stable_partition3
(kernel body ``_partition_kernel``). The kernel itself is
``csrc/partition.cu``: one cooperative launch that counts keys per block,
meets at one grid barrier, and moves T-row tiles through shared memory in
coalesced runs (see the note there); ``stable_partition3_plain`` is the
same function in plain PyTorch: ``index_select`` by ``argsort(key,
stable)``.

``stable_partition3`` takes the plain version for a tensor on the CPU and
launches the kernel for a tensor on the card. It writes into ``out`` (a
second buffer): the growth core ping-pongs two working buffers instead of
copying the window back. ``stable_partition3_window`` is the device-window
entry of the compact core's device loop: the window (which buffer, first
row, row count) comes from the split descriptor in device memory
(ops/kernels/desc.py), on a grid fixed for every split, so the launch
replays from a CUDA graph; ``stable_partition3_window_plain`` is its plain
version.

The sizing below mirrors the constants of ``csrc/partition.cu`` (the tests
read them from the source): rows per tile from the row width D, the
kernel's shared memory, and the scratch a grid needs.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build
from . import desc as dsc

# +1 right after each kernel launch, and the rows (W) of those launches;
# read by chip_smoke.py. The window entry's launches count apart; its rows
# are not known on the host, and the device loop adds each tree's split
# windows to rows_win from the split records it fetches
launches = 0
rows = 0
launches_win = 0
rows_win = 0

MAX_TILE = 256                  # kMaxTile: rows per tile
MIN_TILE = 4                    # kMinTile
STAGE_BYTES = 96 * 1024         # kStageBytes: both staged tiles, aimed at
MAX_STAGE_BYTES = 192 * 1024    # kMaxStageBytes
MAX_D = MAX_STAGE_BYTES // (8 * MIN_TILE)   # kMaxD: widest row, in words

_max_grid: Dict[Tuple[int, int], int] = {}
_max_grid_win: Dict[Tuple[int, int], int] = {}
_fn = None


def tile_rows(d: int) -> int:
    """Rows per tile for rows of d 32-bit words (a multiple of 4); 0 where
    the kernel does not take d."""
    if d < 1 or d > MAX_D:
        return 0
    return max(MIN_TILE, min(MAX_TILE, (STAGE_BYTES // (8 * d)) & ~3))


def smem_bytes(d: int) -> int:
    """The kernel's dynamic shared memory at row width d: two staged tiles
    (each widened to 16-byte chunks) and the slot -> row map."""
    t = tile_rows(d)
    return (2 * ((t * d + 6) & ~3) + t) * 4


def scratch_ints(grid: int) -> int:
    """int32 scratch of a launch on `grid` blocks: (key 0, key 1) counts
    per block."""
    return 2 * grid


def grid_blocks(w: int, d: int, max_grid: int) -> int:
    """Blocks of a launch over w rows: one per tile, at most max_grid (the
    blocks the card holds at once, which a cooperative launch needs)."""
    return min(-(-w // tile_rows(d)), max_grid)


def stable_partition3_plain(win: torch.Tensor,
                            key3: torch.Tensor) -> torch.Tensor:
    """Rows of `win` (W, D) ordered by key3 in {0, 1, 2}, stable."""
    order = torch.argsort(key3, stable=True)
    return win.index_select(0, order)


def _launcher(device: torch.device, d: int, window: bool = False):
    """The library's launch entry (the host-int one, or with `window` the
    device-window one) and the most blocks of d-word rows of that kernel
    the card holds at once (cached per device, width and entry)."""
    global _fn
    lib = build.load("partition")
    if _fn is None or _fn[0] is not lib:
        fn = lib.lgbt_partition_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        _fn = [lib, fn, None]
        _max_grid.clear()
        _max_grid_win.clear()
    if window and _fn[2] is None:
        wfn = lib.lgbt_partition_window_launch
        wfn.restype = ctypes.c_int
        wfn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 2
        _fn[2] = wfn
    cache = _max_grid_win if window else _max_grid
    cap = cache.get((device.index, d))
    if cap is None:
        got = ctypes.c_int(0)
        query = lib.lgbt_partition_window_max_grid if window \
            else lib.lgbt_partition_max_grid
        with torch.cuda.device(device):
            build.check(query(d, ctypes.byref(got)),
                        "partition kernel occupancy query")
        cap = cache[(device.index, d)] = got.value
    return _fn[2 if window else 1], cap


def stable_partition3(win: torch.Tensor, key3: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stably reorder `win` (W, D) int32 so that rows sort by key3 in
    {0, 1, 2}; the exact equal of take(win, argsort(key3, stable)). The
    result goes to `out` (W, D) when given (it must not overlap `win`)."""
    global launches, rows
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
    if not tile_rows(d):
        raise ValueError("stable_partition3: rows of %d words; the kernel "
                         "takes 1 to %d" % (d, MAX_D))
    fn, cap = _launcher(win.device, d)
    grid = grid_blocks(w, d, cap)
    scratch = torch.empty(scratch_ints(grid), dtype=torch.int32,
                          device=win.device)
    rc = fn(win.data_ptr(), key3.data_ptr(), w, d, grid, scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(win.device).cuda_stream)
    build.check(rc, "partition kernel launch")
    launches += 1
    rows += w
    return out


def stable_partition3_window_plain(data: torch.Tensor, spare: torch.Tensor,
                                   key3: torch.Tensor,
                                   desc: torch.Tensor) -> None:
    """The window entry in plain PyTorch: rows [BEGIN, BEGIN + COUNT) of
    buffer SRC (data = 0, spare = 1), stably ordered by key3[:COUNT], into
    the same rows of the other buffer; nothing when GO is 0."""
    f = dsc.fields(desc)
    if not f[dsc.GO]:
        return
    begin, count = f[dsc.BEGIN], f[dsc.COUNT]
    src, dst = (spare, data) if f[dsc.SRC] else (data, spare)
    dst[begin:begin + count] = stable_partition3_plain(
        src[begin:begin + count], key3[:count])


def stable_partition3_window(data: torch.Tensor, spare: torch.Tensor,
                             key3: torch.Tensor, desc: torch.Tensor) -> None:
    """K4 over the window the split descriptor names: rows [BEGIN, BEGIN +
    COUNT) of buffer SRC (data = 0, spare = 1), stably ordered by
    key3[:COUNT] into the same rows of the other buffer; equal to
    stable_partition3_window_plain. data, spare: the two (N, D) int32
    working buffers; key3: (N,) int32. One launch on a grid fixed by D
    (counted in ``launches_win``), which returns at once when GO is 0."""
    global launches_win
    if data.device.type == "cpu":
        stable_partition3_window_plain(data, spare, key3, desc)
        return
    for t in (spare, key3, desc):
        if t.device != data.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("stable_partition3_window: want contiguous "
                             "int32 tensors on the buffers' CUDA device")
    if data.dim() != 2 or data.dtype != torch.int32 \
            or not data.is_contiguous() or spare.shape != data.shape \
            or key3.shape != (data.shape[0],) or not dsc.is_desc(desc):
        raise ValueError("stable_partition3_window: want two (N, D) int32 "
                         "buffers, an (N,) key and a descriptor of >= %d "
                         "fields" % dsc.SIZE)
    d = data.shape[1]
    if not tile_rows(d):
        raise ValueError("stable_partition3_window: rows of %d words; the "
                         "kernel takes 1 to %d" % (d, MAX_D))
    fn, grid = _launcher(data.device, d, window=True)
    scratch = torch.empty(scratch_ints(grid), dtype=torch.int32,
                          device=data.device)
    rc = fn(data.data_ptr(), spare.data_ptr(), desc.data_ptr(),
            key3.data_ptr(), d, grid, scratch.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    build.check(rc, "partition window kernel launch")
    launches_win += 1
