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
    (``build_histogram_pallas_quantized_t``).

All four launch through one entry of ``csrc/histogram.cu`` (per-block
shared-memory histograms on native int32 atomics; see the notes there):
K1 / K2 its fixed-point float kernel, K3 / K3t its exact integer kernel.
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

import torch

from . import build

# launch counts, +1 right after each kernel launch, read by chip_smoke.py:
launches = 0          # K1
launches_t = 0        # K2
launches_q = 0        # K3
launches_qt = 0       # K3t

_CODE_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}
# operand kinds of lgbt_hist_launch (the accumulator follows: f32 for
# an f32 operand, int32 for an integer one)
_OP_KIND = {torch.float32: 0, torch.int8: 1, torch.int32: 2}
_THREADS = 256
# blocks per SM of the grid, by operand kind: the float kernel does more
# work per row between its atomics and runs best at four (PERF.md); the
# integer kernel keeps two. The float kernel's launcher grows the grid
# further where a block would walk more rows than its fixed-point words
# allow (csrc/histogram.cu, kMaxRowsPerBlock).
_BLOCKS_PER_SM = {0: 4, 1: 2, 2: 2}
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
    """(P, F) codes + (P, 3) f32 gh -> (F, B, 3) f32, via one index_add_."""
    f = codes.shape[1]
    out = torch.zeros((f * num_bins + 1, 3), dtype=torch.float32,
                      device=codes.device)
    out.index_add_(0, _slots(codes, num_bins),
                   gh.float().repeat_interleave(f, dim=0))
    return out[:-1].view(f, num_bins, 3)


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


def _grid_x(dev: torch.device, p: int, per_sm: int) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return max(1, min(-(-p // _THREADS), per_sm * _sm_count[idx]))


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
    acc = torch.float32 if gh.dtype == torch.float32 else torch.int32
    out = torch.zeros((f, num_bins, 3), dtype=acc, device=codes.device)
    if p == 0 or f == 0:
        return out
    fn = build.load("histogram").lgbt_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    kind = _OP_KIND[gh.dtype]
    rc = fn(codes.data_ptr(), _CODE_BYTES[codes.dtype], p, f,
            codes.stride(0), codes.stride(1), gh.data_ptr(), kind,
            gh.stride(0), num_bins, out.data_ptr(),
            _grid_x(codes.device, p, _BLOCKS_PER_SM[kind]),
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
