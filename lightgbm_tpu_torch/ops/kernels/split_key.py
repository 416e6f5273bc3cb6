"""Split key: each row's side of a split over one window of packed rows.

The compact core's device loop runs it before K4 at every split. It stands
for the window decode that the JAX compact core does in XLA around its
partition (lightgbm_tpu/models/device_learner.py ``packed_go_left`` with
``logical_bins_for_feature`` and ``decide_left``, and ``_quant_side_maxes``
under leaf re-quantization): per row of the split leaf's window, decode the
split feature's code from its packed word, unmap its EFB logical bin and
decide left or right. It writes key3 (0 = left, 1 = right) for K4, and
into the split descriptor (ops/kernels/desc.py) the exact count of rows
going left and, under re-quantization, each side's max |qg| and |qh|.

``split_key`` launches ``csrc/split_key.cu`` for tensors on the card, and
takes ``split_key_plain``, the same function in plain PyTorch, for tensors
on the CPU. Both read the window and the feature from the descriptor and do
nothing when its GO field is 0.
"""
from __future__ import annotations

import ctypes

import torch

from .. import bundle as bundle_ops
from ..partition import decide_left
from ..quantize import unpack_gh
from . import build
from . import desc as dsc
from .histogram import _BLOCKS_PER_SM, _grid_x

# +1 right after each kernel launch; read by chip_smoke.py
launches = 0


def _go_left(win: torch.Tensor, f, item_bits: int) -> torch.Tensor:
    """(W,) bool split decision of the packed rows `win` under the
    descriptor ints `f`."""
    per = 32 // item_bits
    col = (win[:, f[dsc.COL] // per] >> ((f[dsc.COL] % per) * item_bits)) \
        & ((1 << item_bits) - 1)
    bins = bundle_ops.logical_bins_for_feature(
        col, f[dsc.BASE], f[dsc.DEFAULT], f[dsc.NUMBINS], f[dsc.ELIDE])
    return decide_left(bins, f[dsc.THR], bool(f[dsc.DLEFT]),
                       f[dsc.MISSING], f[dsc.DEFAULT], f[dsc.NUMBINS])


def side_maxes(win: torch.Tensor, go_left: torch.Tensor,
               cw: int) -> torch.Tensor:
    """(4,) int32 [max|qg|, max|qh|] of the left rows, then of the right
    rows, of the (qg << 16 | qh) word at cw (0 for a side without rows)."""
    qg, qh = unpack_gh(win[:, cw])
    a = torch.stack([qg.abs(), qh.abs()], dim=1)
    zero = torch.zeros((), dtype=a.dtype, device=win.device)
    left = torch.where(go_left[:, None], a, zero).amax(dim=0)
    right = torch.where(go_left[:, None], zero, a).amax(dim=0)
    return torch.cat([left, right]).to(torch.int32)


def split_key_plain(data: torch.Tensor, spare: torch.Tensor,
                    desc: torch.Tensor, key: torch.Tensor, *,
                    item_bits: int, cw: int, renew: bool) -> None:
    """The split key in plain PyTorch: writes key[:COUNT] and the
    descriptor's LPHYS (and SIDE_MAX when renew), as the kernel does."""
    f = dsc.fields(desc)
    if not f[dsc.GO]:
        return
    begin, count = f[dsc.BEGIN], f[dsc.COUNT]
    win = (spare if f[dsc.SRC] else data)[begin:begin + count]
    go_left = _go_left(win, f, item_bits)
    key[:count] = (~go_left).to(torch.int32)
    desc[dsc.LPHYS] += int(go_left.sum())
    if renew:
        desc[dsc.SIDE_MAX:] = torch.maximum(desc[dsc.SIDE_MAX:],
                                            side_maxes(win, go_left, cw))


def split_key(data: torch.Tensor, spare: torch.Tensor, desc: torch.Tensor,
              key: torch.Tensor, *, item_bits: int, cw: int,
              renew: bool) -> None:
    """Key3 of the window the descriptor names, into key[:COUNT], and the
    left count (and side maxes) added into the descriptor, whose LPHYS and
    SIDE_MAX fields the caller has zeroed. data, spare: the two (N, D)
    int32 working buffers; key: (N,) int32."""
    global launches
    if data.device.type == "cpu":
        split_key_plain(data, spare, desc, key, item_bits=item_bits, cw=cw,
                        renew=renew)
        return
    for t in (spare, desc, key):
        if t.device != data.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("split_key: want contiguous int32 tensors on "
                             "the buffers' CUDA device")
    n, d = data.shape
    if data.dtype != torch.int32 or not data.is_contiguous() \
            or spare.shape != data.shape or key.shape != (n,) \
            or desc.shape != (dsc.SIZE,):
        raise ValueError("split_key: want two (N, D) int32 buffers, an (N,) "
                         "key and a (%d,) descriptor" % dsc.SIZE)
    if item_bits not in (4, 8, 16):
        raise ValueError("split_key: item_bits must be 4, 8 or 16")
    fn = build.load("split_key").lgbt_split_key_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    rc = fn(data.data_ptr(), spare.data_ptr(), desc.data_ptr(),
            key.data_ptr(), d, cw, item_bits, int(renew),
            _grid_x(data.device, n, _BLOCKS_PER_SM),
            torch.cuda.current_stream(data.device).cuda_stream)
    build.check(rc, "split key kernel launch")
    launches += 1
