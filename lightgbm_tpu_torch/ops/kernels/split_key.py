"""Split key: each row's side of a split, in three entries.

``split_key``, the packed entry: the compact core's device loop runs it
before K4 at every split. It stands for the window decode that the JAX
compact core does in XLA around its partition (lightgbm_tpu/models/
device_learner.py ``packed_go_left`` with ``logical_bins_for_feature`` and
``decide_left``, and ``_quant_side_maxes`` under leaf re-quantization): per
row of the split leaf's window, decode the split feature's code from its
packed word, unmap its EFB logical bin and decide left or right: by the
threshold, or for a categorical split (the descriptor's CAT field) by the
logical bin's bit in the descriptor's bitset words (the JAX ``cat_mask``
lookup, ``partition_step_categorical``'s semantics). It writes
key3 (0 = left, 1 = right) for K4, and into the split descriptor
(ops/kernels/desc.py) the exact count of rows going left and, under
re-quantization, each side's max |qg| and |qh|.

``split_key_column``, the column entry: the masked core's device loop runs
it before K2 / K3t at every split. It stands for the decode and row update
of the JAX masked body (lightgbm_tpu/models/device_learner.py grow_tree,
:402-419): over all N rows, the split leaf's rows read the feature's code
from its column of the (C, N) codes, are decided the same way, and move to
the new leaf id when they go right; the left child's histogram operand
gets the gh of the rows that go left, 0 for every other row.

``route_rows``, the router: the compact core runs it once per bagged
tree, for the rows left out of the bag. It stands for the JAX
``route_rows_by_rec`` (lightgbm_tpu/models/device_learner.py:2174): each
packed row walks the tree's split records in order and takes leaf i + 1
where it sits in record i's leaf and goes right, decoded as the packed
entry decodes it (a record of a categorical feature by its bitset words,
the JAX ``rec_cat``).

Each wrapper launches ``csrc/split_key.cu`` for tensors on the card, and
takes its ``*_plain`` version, the same function in plain PyTorch, for
tensors on the CPU. The first two read the split from the descriptor and
do nothing when its GO field is 0; the router reads the records and their
count k from device memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import bundle as bundle_ops
from ..partition import decide_left, decide_left_categorical
from ..quantize import unpack_gh
from . import build
from . import desc as dsc
from .histogram import _BLOCKS_PER_SM, _OP_KIND, _grid_x

# +1 right after each kernel launch; read by chip_smoke.py
launches = 0          # the packed entry
launches_col = 0      # the column entry
launches_route = 0    # the router

# split-record columns the router reads (models/device_learner.py R_*)
_R_LEAF, _R_FEAT, _R_THR, _R_DLEFT = range(4)

# the column entry's code widths; its operand kinds are the histogram's
_CODE_BYTES = {torch.uint8: 1, torch.int16: 2}


def _decide(col: torch.Tensor, f) -> torch.Tensor:
    """Bool split decision of the raw codes `col` of the split feature's
    column under the descriptor ints `f`: its EFB logical bins, then the
    categorical decision (CAT set: the bin's bit in the WORDS) or the
    numerical one."""
    bins = bundle_ops.logical_bins_for_feature(
        col, f[dsc.BASE], f[dsc.DEFAULT], f[dsc.NUMBINS], f[dsc.ELIDE])
    if len(f) > dsc.WORDS and f[dsc.CAT]:
        return decide_left_categorical(bins, torch.tensor(
            f[dsc.WORDS:], dtype=torch.int32, device=col.device))
    return decide_left(bins, f[dsc.THR], bool(f[dsc.DLEFT]),
                       f[dsc.MISSING], f[dsc.DEFAULT], f[dsc.NUMBINS])


def _go_left(win: torch.Tensor, f, item_bits: int) -> torch.Tensor:
    """(W,) bool split decision of the packed rows `win` under the
    descriptor ints `f`."""
    per = 32 // item_bits
    col = (win[:, f[dsc.COL] // per] >> ((f[dsc.COL] % per) * item_bits)) \
        & ((1 << item_bits) - 1)
    return _decide(col, f)


def side_maxes(win: torch.Tensor, go_left: torch.Tensor,
               cw: int) -> torch.Tensor:
    """(4,) int32 [max|qg|, max|qh|] of the left rows, then of the right
    rows, of the (qg << 16 | qh) word at cw (0 for a side without rows)."""
    qg, qh = unpack_gh(win[:, cw])
    a = torch.stack([qg.abs(), qh.abs()], dim=1)
    # a zero row first: a rank's window may hold no rows
    zero = a.new_zeros((1, 2))
    left = torch.cat([zero, torch.where(go_left[:, None], a, zero)])
    right = torch.cat([zero, torch.where(go_left[:, None], zero, a)])
    left, right = left.amax(dim=0), right.amax(dim=0)
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
        side = desc[dsc.SIDE_MAX:dsc.LEAF]
        side.copy_(torch.maximum(side, side_maxes(win, go_left, cw)))


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
            or not dsc.is_desc(desc):
        raise ValueError("split_key: want two (N, D) int32 buffers, an (N,) "
                         "key and a descriptor of >= %d fields" % dsc.SIZE)
    if item_bits not in (4, 8, 16):
        raise ValueError("split_key: item_bits must be 4, 8 or 16")
    fn = build.load("split_key").lgbt_split_key_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    rc = fn(data.data_ptr(), spare.data_ptr(), desc.data_ptr(),
            key.data_ptr(), d, cw, item_bits, int(renew), dsc.cat_words(desc),
            _grid_x(data.device, n, _BLOCKS_PER_SM),
            torch.cuda.current_stream(data.device).cuda_stream)
    build.check(rc, "split key kernel launch")
    launches += 1


def split_key_column_plain(codes_t: torch.Tensor, desc: torch.Tensor,
                           leaf_id: torch.Tensor, gh: torch.Tensor,
                           ghl: torch.Tensor) -> None:
    """The column entry in plain PyTorch: rewrites leaf_id and writes ghl
    in full, as the kernel does; nothing when GO is 0."""
    f = dsc.fields(desc)
    if not f[dsc.GO]:
        return
    col = codes_t[f[dsc.COL]].long()
    if codes_t.dtype == torch.int16:
        col = col & 0xFFFF
    go_left = _decide(col, f)
    parent = leaf_id == f[dsc.LEAF]
    leaf_id.masked_fill_(parent & ~go_left, f[dsc.NEW_ID])
    ghl.copy_(torch.where((parent & go_left)[:, None], gh, gh.new_zeros(())))


def split_key_column(codes_t: torch.Tensor, desc: torch.Tensor,
                     leaf_id: torch.Tensor, gh: torch.Tensor,
                     ghl: torch.Tensor) -> None:
    """The masked core's split over all N rows: rows of leaf LEAF that go
    right get leaf id NEW_ID in leaf_id, and ghl (the left child's
    histogram operand) gets gh's row where the row is in the leaf and goes
    left, else 0. codes_t: contiguous (C, N) uint8 or int16 codes (16-bit
    codes read as uint16); leaf_id: (N,) int32; gh, ghl: contiguous (N, 3)
    f32, int8 or int32 of one dtype. The grid is fixed by N; counted in
    ``launches_col``."""
    global launches_col
    if codes_t.device.type == "cpu":
        split_key_column_plain(codes_t, desc, leaf_id, gh, ghl)
        return
    for t in (desc, leaf_id, gh, ghl):
        if t.device != codes_t.device or not t.is_contiguous():
            raise ValueError("split_key_column: want contiguous tensors on "
                             "the codes' CUDA device")
    if codes_t.dim() != 2 or codes_t.dtype not in _CODE_BYTES \
            or not codes_t.is_contiguous():
        raise ValueError("split_key_column: want contiguous (C, N) uint8 or "
                         "int16 codes, got %s %s" % (codes_t.dtype,
                                                     tuple(codes_t.shape)))
    n = codes_t.shape[1]
    if desc.dtype != torch.int32 or not dsc.is_desc(desc) \
            or leaf_id.dtype != torch.int32 or leaf_id.shape != (n,) \
            or gh.dtype not in _OP_KIND or ghl.dtype != gh.dtype \
            or gh.shape != (n, 3) or ghl.shape != (n, 3):
        raise ValueError("split_key_column: want an int32 descriptor of "
                         ">= %d fields, "
                         "an (N,) int32 leaf_id and two (N, 3) operands of "
                         "one dtype (f32, int8 or int32)" % dsc.SIZE)
    if n == 0:
        return
    fn = build.load("split_key").lgbt_split_key_column_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rc = fn(codes_t.data_ptr(), _CODE_BYTES[codes_t.dtype], n,
            desc.data_ptr(), leaf_id.data_ptr(), gh.data_ptr(),
            ghl.data_ptr(), _OP_KIND[gh.dtype], dsc.cat_words(desc),
            _grid_x(codes_t.device, n, _BLOCKS_PER_SM),
            torch.cuda.current_stream(codes_t.device).cuda_stream)
    build.check(rc, "split key column kernel launch")
    launches_col += 1


def route_rows_plain(rows: torch.Tensor, rec: torch.Tensor, k: torch.Tensor,
                     table: torch.Tensor, *, item_bits: int,
                     rec_cat: Optional[torch.Tensor] = None,
                     f_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The router in plain PyTorch: the JAX loop over the first k records,
    each row moved to leaf i + 1 where it is in record i's leaf and goes
    right."""
    leaf = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    words = 0 if rec_cat is None else rec_cat.shape[1]
    f = [0] * dsc.size(words)
    for i in range(int(k)):
        r = rec[i].tolist()
        feat = min(max(int(r[_R_FEAT]), 0), table.shape[0] - 1)
        f[dsc.THR], f[dsc.DLEFT] = int(r[_R_THR]), int(r[_R_DLEFT] > 0.5)
        f[dsc.COL:dsc.DEFAULT + 1] = table[feat].tolist()
        if words:
            f[dsc.CAT] = int(f_cat[feat])
            f[dsc.WORDS:] = rec_cat[i].tolist()
        right = (leaf == int(r[_R_LEAF])) & ~_go_left(rows, f, item_bits)
        leaf = torch.where(right, i + 1, leaf)
    return leaf


def route_rows(rows: torch.Tensor, rec: torch.Tensor, k: torch.Tensor,
               table: torch.Tensor, *, item_bits: int,
               rec_cat: Optional[torch.Tensor] = None,
               f_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M,) int32 leaf of each of the (M, CW) int32 packed code rows
    `rows` under a tree's (L-1, 13) f32 split records `rec`, of which the
    first k (a 0-d int32 tensor, read on the device) are real; `table`
    the (F, 6) int32 feature fields (column, EFB base, elide flag, bin
    count, missing type, default bin). With categorical features,
    `rec_cat` holds each record's (L-1, W) int32 bitset words and `f_cat`
    the (F,) int32 categorical flags. One launch on a grid fixed by M,
    counted in ``launches_route``."""
    global launches_route
    if rows.device.type == "cpu":
        return route_rows_plain(rows, rec, k, table, item_bits=item_bits,
                                rec_cat=rec_cat, f_cat=f_cat)
    m = rows.shape[0] if rows.dim() == 2 else -1
    if rows.dtype != torch.int32 or m < 0 or not rows.is_contiguous() \
            or rec.dtype != torch.float32 or rec.dim() != 2 \
            or rec.shape[1] != 13 or not rec.is_contiguous() \
            or k.dtype != torch.int32 or k.numel() != 1 \
            or table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[1] != 6 or not table.is_contiguous():
        raise ValueError("route_rows: want (M, CW) int32 rows, (L-1, 13) f32 "
                         "records, a 0-d int32 k and an (F, 6) int32 table")
    words = 0 if rec_cat is None else rec_cat.shape[1]
    if words and (rec_cat.dtype != torch.int32 or rec_cat.dim() != 2
                  or rec_cat.shape[0] != rec.shape[0]
                  or not rec_cat.is_contiguous() or f_cat is None
                  or f_cat.dtype != torch.int32
                  or f_cat.shape != (table.shape[0],)):
        raise ValueError("route_rows: want (L-1, W) int32 bitset words "
                         "beside the records and (F,) int32 categorical "
                         "flags")
    for t in (rec, k, table) + ((rec_cat, f_cat) if words else ()):
        if t.device != rows.device:
            raise ValueError("route_rows: want every tensor on the rows' "
                             "CUDA device")
    if item_bits not in (4, 8, 16):
        raise ValueError("route_rows: item_bits must be 4, 8 or 16")
    leaf = torch.empty(m, dtype=torch.int32, device=rows.device)
    if m == 0:
        return leaf
    fn = build.load("split_key").lgbt_route_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    rc = fn(rows.data_ptr(), m, rows.shape[1], item_bits, rec.data_ptr(),
            k.data_ptr(), rec.shape[0], table.data_ptr(), table.shape[0],
            rec_cat.data_ptr() if words else None, words,
            f_cat.data_ptr() if words else None, leaf.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(rc, "router kernel launch")
    launches_route += 1
    return leaf
