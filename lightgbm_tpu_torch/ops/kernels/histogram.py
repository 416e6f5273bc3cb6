"""Histogram kernels: K1, K2 (float) and K3, K3t (exact integer).

Ports of lightgbm_tpu/ops/pallas/histogram_kernel.py:

  * K1 ``build_histogram``: (P, F) codes + (P, 3) f32 [grad, hess, valid]
    -> (F, B, 3) f32 (``build_histogram_pallas``, body ``_hist_kernel``);
  * K2 ``build_histogram_t``: the same over column-major (F, P) codes
    (``build_histogram_pallas_t``), the masked strategy's layout;
  * K3 ``build_histogram_quantized``: (P, F) codes + (P, 3) int8/int32
    [qg, qh, valid] -> exact (F, B, 3) int32
    (``build_histogram_pallas_quantized``, body ``_hist_kernel_q``);
  * K3t ``build_histogram_quantized_t``: the same over (F, P) codes
    (``build_histogram_pallas_quantized_t``);
  * counted as K3, ``build_histogram_quantized_rows``: the compact core's
    operand build (``_quant_win_operand``, lightgbm_tpu/models/
    device_learner.py) and K3 in one launch, over the packed quantized
    working rows read in place;
  * the device-window entries of the compact core's device loop,
    ``build_histogram_window`` (K1) and ``build_histogram_quantized_window``
    (K3's packed-row entry): the same kernels over the packed rows of the
    window that the split descriptor (ops/kernels/desc.py) names -- the
    split's smaller child, or all rows at the root -- read from device
    memory on a grid fixed for every split, so their launches replay from
    a CUDA graph. K1 decodes 4-, 8- and 16-bit codes there as K3 does.

All launch through ``csrc/histogram.cu`` (per-block shared-memory
histograms on native int32 atomics; see the notes there): K1 / K2 its
fixed-point float kernel, K3 / K3t its exact integer kernel, the packed-row
entry its row kernel.
The (F, P) forms pass the transposed view's strides (row stride 1, column
stride P), so consecutive threads read consecutive code bytes. Codes come
as any view with element strides, so the compact core hands the kernels
the code bytes of its packed working rows without unpacking them.

Each ``*_plain`` function is the same function in plain PyTorch
(``index_add_`` over flattened feature * B + bin slots; the (F, P) forms
transpose first). A wrapper takes the plain version for a tensor on the
CPU and launches its kernel for a tensor on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import quantize as quant_ops
from . import build
from . import desc as dsc

# launch counts, +1 right after each kernel launch, read by chip_smoke.py:
launches = 0          # K1
launches_t = 0        # K2
launches_q = 0        # K3, and the packed-row entry
launches_qt = 0       # K3t
launches_win = 0      # K1's device-window entry
launches_qwin = 0     # K3's device-window entry

_CODE_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}
# operand kinds of lgbt_hist_launch (the accumulator follows: f32 for
# an f32 operand, int32 for an integer one)
_OP_KIND = {torch.float32: 0, torch.int8: 1, torch.int32: 2}
_THREADS = 256
# blocks per SM of the grid the wrappers ask for, measured (PERF.md; the
# integer kernels' register budget, csrc/histogram.cu kIntBlocksPerSM).
# The launchers cut the float kernel's grid to the blocks the card holds at
# once (its cooperative launch), grow the integer kernels' where a block
# would walk more rows than kMaxPackedRowsPerBlock, cut theirs to one wave
# of the clusters the card holds, and initialise the output.
_BLOCKS_PER_SM = 4
_sm_count = {}


def _slots(codes: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(P * F,) flat feature * B + bin slots; codes outside [0, B) go to
    the dump slot F * B, as the one-hot drops them. int16 codes are read
    as uint16 (the packed-row view of 16-bit bins)."""
    p, f = codes.shape
    c = codes.long()
    if codes.dtype == torch.int16:
        c = c & 0xFFFF
    slot = c + torch.arange(f, device=codes.device) * num_bins
    return torch.where((c >= 0) & (c < num_bins), slot,
                       f * num_bins).reshape(-1)


def build_histogram_plain(codes: torch.Tensor, gh: torch.Tensor,
                          num_bins: int) -> torch.Tensor:
    """(P, F) codes + (P, 3) f32 gh -> (F, B, 3) f32, via one index_add_
    into f64 slots rounded once to f32 (as the kernel rounds its exact
    fixed-point sum once: the two agree bit for bit but on a slot whose
    sum lies within ~2^-50 of its terms' magnitude of an f32 rounding
    boundary)."""
    f = codes.shape[1]
    out = torch.zeros((f * num_bins + 1, 3), dtype=torch.float64,
                      device=codes.device)
    out.index_add_(0, _slots(codes, num_bins),
                   gh.double().repeat_interleave(f, dim=0))
    return out[:-1].view(f, num_bins, 3).float()


def build_histogram_t_plain(codes_t: torch.Tensor, gh: torch.Tensor,
                            num_bins: int) -> torch.Tensor:
    """(F, P) codes + (P, 3) f32 gh -> (F, B, 3) f32."""
    return build_histogram_plain(codes_t.t(), gh, num_bins)


def build_histogram_quantized_plain(codes: torch.Tensor, ghq: torch.Tensor,
                                    num_bins: int) -> torch.Tensor:
    """(P, F) codes + (P, 3) int8/int32 ghq -> exact (F, B, 3) int32, via
    one index_add_ into int64 slots."""
    f = codes.shape[1]
    out = torch.zeros((f * num_bins + 1, 3), dtype=torch.int64,
                      device=codes.device)
    out.index_add_(0, _slots(codes, num_bins),
                   ghq.long().repeat_interleave(f, dim=0))
    return out[:-1].view(f, num_bins, 3).to(torch.int32)


def build_histogram_quantized_t_plain(codes_t: torch.Tensor,
                                      ghq: torch.Tensor,
                                      num_bins: int) -> torch.Tensor:
    """(F, P) codes + (P, 3) int8/int32 ghq -> exact (F, B, 3) int32."""
    return build_histogram_quantized_plain(codes_t.t(), ghq, num_bins)


def packed_codes(rows: torch.Tensor, cw: int, c_cols: int,
                 item_bits: int) -> torch.Tensor:
    """(W, c_cols) codes of packed int32 rows whose words [0, cw) hold
    item_bits-wide fields, low field first: a byte (or 16-bit) view in
    place, 4-bit fields unpacked. int32 >> is arithmetic, so each field is
    masked after its shift."""
    if item_bits == 8:
        return rows.view(torch.uint8)[:, :c_cols]
    if item_bits == 16:
        return rows.view(torch.int16)[:, :c_cols]
    per = 32 // item_bits
    shifts = torch.arange(per, device=rows.device, dtype=torch.int32) \
        * item_bits
    u = (rows[:, :cw, None] >> shifts) & ((1 << item_bits) - 1)
    return u.reshape(rows.shape[0], cw * per)[:, :c_cols]


def build_histogram_quantized_rows_plain(rows: torch.Tensor, cw: int,
                                         c_cols: int, item_bits: int,
                                         r_g: torch.Tensor,
                                         r_h: torch.Tensor, qcap_op: int,
                                         grad_bits: int,
                                         num_bins: int) -> torch.Tensor:
    """The packed-row entry in two steps: the (W, 3) operand re-quantized
    from each row's (qg|qh) word (every row counts), then K3's plain
    version over the rows' codes."""
    ghq = quant_ops.gh_operand_scaled(rows[:, cw], None, grad_bits, qcap_op,
                                      r_g, r_h)
    return build_histogram_quantized_plain(
        packed_codes(rows, cw, c_cols, item_bits), ghq, num_bins)


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def _grid_x(dev: torch.device, p: int, per_sm: int) -> int:
    return max(1, min(-(-p // _THREADS), per_sm * _sms(dev)))


@functools.lru_cache(maxsize=None)
def _fixed_scratch_words(f: int, num_bins: int, grid_x: int) -> int:
    fn = build.load("histogram").lgbt_hist_fixed_scratch_words
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    return fn(f, num_bins, grid_x)


def _fixed_scratch(dev: torch.device, f: int, num_bins: int,
                   grid_x: int) -> torch.Tensor:
    """The float kernel's scratch (its int64 accumulator and the blocks'
    pre-pass sums) for a launch asked for at grid_x blocks, from the
    caching allocator on the launch's stream (in a capture, from the
    graph's pool)."""
    return torch.empty(_fixed_scratch_words(f, num_bins, grid_x),
                       dtype=torch.int64, device=dev)


def _check(name: str, codes: torch.Tensor, gh: torch.Tensor,
           op_dtypes) -> None:
    if codes.device.type != "cuda" or gh.device != codes.device:
        raise ValueError("%s: codes and gh must share one CUDA device"
                         % name)
    if codes.dim() != 2 or gh.dim() != 2 or gh.shape != (codes.shape[0], 3):
        raise ValueError("%s: want (P, F) codes and (P, 3) gh, got %s and %s"
                         % (name, tuple(codes.shape), tuple(gh.shape)))
    if codes.dtype not in _CODE_BYTES:
        raise ValueError("%s: codes dtype %s not supported"
                         % (name, codes.dtype))
    if gh.dtype not in op_dtypes or gh.stride(1) != 1:
        raise ValueError("%s: gh must be %s with unit column stride, got %s"
                         % (name, " or ".join(map(str, op_dtypes)),
                            gh.dtype))


def _launch(name: str, counter: str, codes: torch.Tensor, gh: torch.Tensor,
            num_bins: int, op_dtypes) -> torch.Tensor:
    """Check the inputs and launch the csrc/histogram.cu kernel once over
    (P, F) codes; adds one to the module's launch count `counter` right
    after the launch. An empty window launches nothing and counts
    nothing."""
    _check(name, codes, gh, op_dtypes)
    p, f = codes.shape
    kind = _OP_KIND[gh.dtype]
    dtype = torch.float32 if kind == 0 else torch.int32
    if p == 0 or f == 0:
        return torch.zeros((f, num_bins, 3), dtype=dtype, device=codes.device)
    # the launcher initialises the output
    out = torch.empty((f, num_bins, 3), dtype=dtype, device=codes.device)
    grid_x = _grid_x(codes.device, p, _BLOCKS_PER_SM)
    scratch = _fixed_scratch(codes.device, f, num_bins, grid_x) \
        if kind == 0 else None
    fn = build.load("histogram").lgbt_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    rc = fn(codes.data_ptr(), _CODE_BYTES[codes.dtype], p, f,
            codes.stride(0), codes.stride(1), gh.data_ptr(), kind,
            gh.stride(0), num_bins, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), grid_x,
            torch.cuda.current_stream(codes.device).cuda_stream)
    build.check(rc, name + " kernel launch")
    globals()[counter] += 1
    return out


def build_histogram(codes: torch.Tensor, gh: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """K1: (P, F) codes (uint8 / int16 / int32, any strides) + (P, 3) f32
    gh with unit column stride -> (F, B, 3) f32 histogram. Rows that must
    not count carry gh == 0."""
    if codes.device.type == "cpu":
        return build_histogram_plain(codes, gh, num_bins)
    return _launch("build_histogram", "launches", codes, gh, num_bins,
                   (torch.float32,))


def build_histogram_t(codes_t: torch.Tensor, gh: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """K2: (F, P) codes + (P, 3) f32 gh -> (F, B, 3) f32 histogram."""
    if codes_t.device.type == "cpu":
        return build_histogram_t_plain(codes_t, gh, num_bins)
    return _launch("build_histogram_t", "launches_t", codes_t.t(), gh,
                   num_bins, (torch.float32,))


def build_histogram_quantized(codes: torch.Tensor, ghq: torch.Tensor,
                              num_bins: int) -> torch.Tensor:
    """K3: (P, F) codes + (P, 3) int8/int32 [qg, qh, valid] with unit
    column stride -> exact (F, B, 3) int32 histogram."""
    if codes.device.type == "cpu":
        return build_histogram_quantized_plain(codes, ghq, num_bins)
    return _launch("build_histogram_quantized", "launches_q", codes, ghq,
                   num_bins, (torch.int8, torch.int32))


def build_histogram_quantized_t(codes_t: torch.Tensor, ghq: torch.Tensor,
                                num_bins: int) -> torch.Tensor:
    """K3t: (F, P) codes + (P, 3) int8/int32 ghq -> exact (F, B, 3)
    int32 histogram."""
    if codes_t.device.type == "cpu":
        return build_histogram_quantized_t_plain(codes_t, ghq, num_bins)
    return _launch("build_histogram_quantized_t", "launches_qt",
                   codes_t.t(), ghq, num_bins, (torch.int8, torch.int32))


def build_histogram_quantized_rows(rows: torch.Tensor, cw: int, c_cols: int,
                                   item_bits: int, r_g: torch.Tensor,
                                   r_h: torch.Tensor, qcap_op: int,
                                   grad_bits: int,
                                   num_bins: int) -> torch.Tensor:
    """K3 over the compact core's packed quantized rows, read in place:
    `rows` is a contiguous (W, D) int32 slice of the working buffer (codes
    of item_bits 4 / 8 / 16 in words [0, cw), the (qg << 16 | qh) word at
    cw); each row's qg and qh are re-quantized at the 0-d f32 ratios r_g,
    r_h (read on the device, no host sync) and clamped to +-qcap_op, and
    count once. -> exact (c_cols, B, 3) int32, equal to
    build_histogram_quantized_rows_plain. Counts in ``launches_q``."""
    if rows.device.type == "cpu":
        return build_histogram_quantized_rows_plain(
            rows, cw, c_cols, item_bits, r_g, r_h, qcap_op, grad_bits,
            num_bins)
    name = "build_histogram_quantized_rows"
    if rows.device.type != "cuda" or rows.dtype != torch.int32 \
            or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("%s: want contiguous (W, D) int32 rows on a CUDA "
                         "device, got %s %s on %s" % (
                             name, rows.dtype, tuple(rows.shape),
                             rows.device))
    w, d = rows.shape
    if item_bits not in (4, 8, 16) or not 0 <= cw < d \
            or c_cols > cw * (32 // item_bits):
        raise ValueError("%s: %d codes of %d bits do not fit words [0, %d) "
                         "of %d-word rows" % (name, c_cols, item_bits, cw, d))
    ratios = []
    for r in (r_g, r_h):
        if r.device != rows.device or r.dtype != torch.float32 \
                or r.numel() != 1:
            raise ValueError("%s: ratios must be one-element f32 tensors on "
                             "the rows' device" % name)
        ratios.append(r.reshape(()).contiguous())
    if w == 0 or c_cols == 0:
        return torch.zeros((c_cols, num_bins, 3), dtype=torch.int32,
                           device=rows.device)
    out = torch.empty((c_cols, num_bins, 3), dtype=torch.int32,
                      device=rows.device)      # initialised by the launcher
    fn = build.load("histogram").lgbt_hist_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    rc = fn(rows.data_ptr(), w, d, cw, c_cols, item_bits,
            ratios[0].data_ptr(), ratios[1].data_ptr(), int(qcap_op),
            num_bins, out.data_ptr(), _grid_x(rows.device, w, _BLOCKS_PER_SM),
            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(rc, name + " kernel launch")
    global launches_q
    launches_q += 1
    return out


def window_rows(data: torch.Tensor, spare: torch.Tensor,
                desc: torch.Tensor) -> torch.Tensor:
    """The rows a device-window entry reads, on the host's reading of the
    descriptor: the split's smaller child in buffer 1 - SRC (data = 0,
    spare = 1), from BEGIN (plus LPHYS for a right child); None when GO is
    0."""
    f = dsc.fields(desc)
    if not f[dsc.GO]:
        return None
    rows = data if f[dsc.SRC] else spare
    lphys, count = f[dsc.LPHYS], f[dsc.COUNT]
    off = f[dsc.BEGIN] + (0 if f[dsc.LEFT_SMALL] else lphys)
    return rows[off:off + (lphys if f[dsc.LEFT_SMALL] else count - lphys)]


def build_histogram_window_plain(data: torch.Tensor, spare: torch.Tensor,
                                 desc: torch.Tensor, cw: int, c_cols: int,
                                 item_bits: int,
                                 num_bins: int) -> torch.Tensor:
    """K1's window entry in plain PyTorch: the window's codes unpacked
    and its f32 (grad, hess, weight) words at cw, through
    build_histogram_plain; zeros when GO is 0."""
    rows = window_rows(data, spare, desc)
    if rows is None:
        return torch.zeros((c_cols, num_bins, 3), dtype=torch.float32,
                           device=data.device)
    return build_histogram_plain(packed_codes(rows, cw, c_cols, item_bits),
                                 rows.view(torch.float32)[:, cw:cw + 3],
                                 num_bins)


def build_histogram_quantized_window_plain(
        data: torch.Tensor, spare: torch.Tensor, desc: torch.Tensor,
        cw: int, c_cols: int, item_bits: int, r_g: torch.Tensor,
        r_h: torch.Tensor, qcap_op: int, grad_bits: int,
        num_bins: int) -> torch.Tensor:
    """K3's window entry in plain PyTorch: the packed-row entry's plain
    version over the window; zeros when GO is 0."""
    rows = window_rows(data, spare, desc)
    if rows is None:
        return torch.zeros((c_cols, num_bins, 3), dtype=torch.int32,
                           device=data.device)
    return build_histogram_quantized_rows_plain(
        rows, cw, c_cols, item_bits, r_g, r_h, qcap_op, grad_bits, num_bins)


def _window_launch(name: str, counter: str, data, spare, desc, cw, c_cols,
                   item_bits, quant, r_g, r_h, qcap_op,
                   num_bins) -> torch.Tensor:
    for t in (spare, desc):
        if t.device != data.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("%s: want contiguous int32 tensors on the "
                             "buffers' CUDA device" % name)
    if data.dim() != 2 or data.dtype != torch.int32 \
            or not data.is_contiguous() or spare.shape != data.shape \
            or not dsc.is_desc(desc):
        raise ValueError("%s: want two (N, D) int32 buffers and a "
                         "descriptor of >= %d fields" % (name, dsc.SIZE))
    n, d = data.shape
    lanes = 2 if quant else 4
    if item_bits not in (4, 8, 16) or not 0 <= cw <= d - lanes \
            or c_cols > cw * (32 // item_bits):
        raise ValueError("%s: %d codes of %d bits do not fit words [0, %d) "
                         "of %d-word rows" % (name, c_cols, item_bits, cw, d))
    ratios = [None, None]                # the float kernel has none
    if quant:
        for i, r in enumerate((r_g, r_h)):
            if r.device != data.device or r.dtype != torch.float32 \
                    or r.numel() != 1 or not r.is_contiguous():
                raise ValueError("%s: ratios must be one-element f32 "
                                 "tensors on the buffers' device" % name)
            ratios[i] = r.data_ptr()
    out = torch.empty((c_cols, num_bins, 3),
                      dtype=torch.int32 if quant else torch.float32,
                      device=data.device)      # written whole by the launch
    grid_x = _grid_x(data.device, n, _BLOCKS_PER_SM)
    scratch = None if quant \
        else _fixed_scratch(data.device, c_cols, num_bins, grid_x)
    fn = build.load("histogram").lgbt_hist_window_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    rc = fn(data.data_ptr(), spare.data_ptr(), desc.data_ptr(), n, d, cw,
            c_cols, item_bits, int(quant), ratios[0], ratios[1],
            int(qcap_op), num_bins, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), grid_x,
            torch.cuda.current_stream(data.device).cuda_stream)
    build.check(rc, name + " kernel launch")
    globals()[counter] += 1
    return out


def build_histogram_window(data: torch.Tensor, spare: torch.Tensor,
                           desc: torch.Tensor, cw: int, c_cols: int,
                           item_bits: int, num_bins: int) -> torch.Tensor:
    """K1 over the window the split descriptor names in the compact core's
    two (N, D) int32 working buffers (codes of item_bits 4 / 8 / 16 in
    words [0, cw), bitcast f32 grad, hess, weight at cw .. cw + 2) ->
    (c_cols, B, 3) f32, within K1's tolerance of
    build_histogram_window_plain; zeros when GO is 0. The grid is fixed
    by N; counted in ``launches_win``."""
    if data.device.type == "cpu":
        return build_histogram_window_plain(data, spare, desc, cw, c_cols,
                                            item_bits, num_bins)
    return _window_launch("build_histogram_window", "launches_win", data,
                          spare, desc, cw, c_cols, item_bits, False, None,
                          None, 0, num_bins)


def build_histogram_quantized_window(
        data: torch.Tensor, spare: torch.Tensor, desc: torch.Tensor,
        cw: int, c_cols: int, item_bits: int, r_g: torch.Tensor,
        r_h: torch.Tensor, qcap_op: int, grad_bits: int,
        num_bins: int) -> torch.Tensor:
    """K3's packed-row entry over the window the split descriptor names
    (the (qg << 16 | qh) word at cw, re-quantized at the 0-d f32 ratios
    r_g, r_h read on the device) -> exact (c_cols, B, 3) int32, equal to
    build_histogram_quantized_window_plain; zeros when GO is 0. The grid is
    fixed by N; counted in ``launches_qwin``."""
    if data.device.type == "cpu":
        return build_histogram_quantized_window_plain(
            data, spare, desc, cw, c_cols, item_bits, r_g, r_h, qcap_op,
            grad_bits, num_bins)
    return _window_launch("build_histogram_quantized_window",
                          "launches_qwin", data, spare, desc, cw, c_cols,
                          item_bits, True, r_g.reshape(()), r_h.reshape(()),
                          qcap_op, num_bins)
