"""K1: per-(feature, bin) histogram of [grad, hess, count].

Port of lightgbm_tpu/ops/pallas/histogram_kernel.py::build_histogram_pallas
(kernel body ``_hist_kernel``). The kernel itself is ``csrc/histogram.cu``
(shared-memory atomics, see the note there); ``build_histogram_plain`` is
the same function in plain PyTorch (``index_add_`` over flattened
feature * B + bin slots).

``build_histogram`` takes the plain version for a tensor on the CPU and
launches the kernel for a tensor on the card. Codes come as any (P, F)
view with element strides, so the growth core hands the kernel the code
bytes of its packed working rows without unpacking them.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# wrapper-side launch count: +1 per kernel launch, read by chip_smoke.py
launches = 0

_CODE_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}
_sm_count = {}


def build_histogram_plain(codes: torch.Tensor, gh: torch.Tensor,
                          num_bins: int) -> torch.Tensor:
    """(P, F) codes + (P, 3) f32 gh -> (F, B, 3) f32, via one index_add_.
    Codes outside [0, B) fall into a dump slot, as the one-hot drops them;
    int16 codes are read as uint16 (the packed-row view of 16-bit bins)."""
    p, f = codes.shape
    c = codes.long()
    if codes.dtype == torch.int16:
        c = c & 0xFFFF
    slot = c + torch.arange(f, device=codes.device) * num_bins
    slot = torch.where((c >= 0) & (c < num_bins), slot, f * num_bins)
    out = torch.zeros((f * num_bins + 1, 3), dtype=torch.float32,
                      device=codes.device)
    out.index_add_(0, slot.reshape(-1),
                   gh.float().repeat_interleave(f, dim=0))
    return out[:-1].view(f, num_bins, 3)


def _grid_x(dev: torch.device, p: int) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return max(1, min(-(-p // 256), 2 * _sm_count[idx]))


def build_histogram(codes: torch.Tensor, gh: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """(P, F) codes (uint8 / int16 / int32, any strides) + (P, 3) f32 gh
    with unit column stride -> (F, B, 3) f32 histogram. Rows that must not
    count carry gh == 0."""
    global launches
    if codes.device.type == "cpu":
        return build_histogram_plain(codes, gh, num_bins)
    if codes.device.type != "cuda" or gh.device != codes.device:
        raise ValueError("build_histogram: codes and gh must share one "
                         "CUDA device")
    if codes.dim() != 2 or gh.dim() != 2 or gh.shape != (codes.shape[0], 3):
        raise ValueError("build_histogram: want (P, F) codes and (P, 3) gh, "
                         "got %s and %s" % (tuple(codes.shape),
                                            tuple(gh.shape)))
    if codes.dtype not in _CODE_BYTES:
        raise ValueError("build_histogram: codes dtype %s not supported"
                         % codes.dtype)
    if gh.dtype != torch.float32 or gh.stride(1) != 1:
        raise ValueError("build_histogram: gh must be float32 with unit "
                         "column stride")
    p, f = codes.shape
    out = torch.zeros((f, num_bins, 3), dtype=torch.float32,
                      device=codes.device)
    if p == 0 or f == 0:
        return out
    lib = build.load("histogram")
    fn = lib.lgbt_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    rc = fn(codes.data_ptr(), _CODE_BYTES[codes.dtype], p, f,
            codes.stride(0), codes.stride(1), gh.data_ptr(), gh.stride(0),
            num_bins, out.data_ptr(), _grid_x(codes.device, p),
            torch.cuda.current_stream(codes.device).cuda_stream)
    launches += 1
    build.check(rc, "histogram kernel launch")
    return out
