"""Device histogram construction.

Port of lightgbm_tpu/ops/histogram.py (reference roles: Bin::Construct
Histogram, src/io/dense_bin.hpp:71-195, and the OpenCL histogram256.cl).
On the card every (P, F) histogram is built by kernel K1 (float) or K3
(exact int32, quantized gradients) of ops/kernels/histogram.py; a tensor on
the CPU takes the kernels' plain versions. The JAX package's one-hot
contraction and its chunk ladder exist for the TPU's MXU and have no
counterpart here. ``accumulate_histogram`` adds a chunk's histogram into a
running total (the chunk core). ``gather_and_build`` /
``gather_and_build_quantized`` serve the host-loop learner
(models/serial_learner.py): a leaf's rows gathered from the permutation
buffer, then K1's host-int entry or K3's operand entry over them.
"""
from __future__ import annotations

import torch

from .kernels import histogram as _khist


def build_histogram(binned_rows: torch.Tensor, gh: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """(P, F) bin codes + (P, 3) f32 [grad, hess, valid] -> (F, B, 3) f32
    per-(feature, bin) sums. Rows that must not count carry gh == 0."""
    return _khist.build_histogram(binned_rows, gh, num_bins)


def build_histogram_quantized(binned_rows: torch.Tensor, ghq: torch.Tensor,
                              num_bins: int) -> torch.Tensor:
    """(P, F) bin codes + (P, 3) int8/int32 [qg, qh, valid] (ops/quantize)
    -> (F, B, 3) int32 exact [sum_qg, sum_qh, count]. Rows that must not
    count carry ghq == 0."""
    return _khist.build_histogram_quantized(binned_rows, ghq, num_bins)


def accumulate_histogram(acc: torch.Tensor, binned_rows: torch.Tensor,
                         gh: torch.Tensor, num_bins: int) -> torch.Tensor:
    """One row chunk's histogram added into the running (F, B, 3) total
    `acc` (the JAX package's streamed-accumulation seam, which the chunk
    core's chunk passes and its streamed quantized root use). The
    accumulator's dtype picks the kernel: int32 takes the exact quantized
    one (K3, `gh` the integer [qg, qh, valid] operand), f32 the float one
    (K1). Integer totals do not depend on the chunking; float totals only
    through the order of the f32 additions."""
    if acc.dtype == torch.int32:
        return acc + build_histogram_quantized(binned_rows, gh, num_bins)
    return acc + build_histogram(binned_rows, gh, num_bins)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (reference: feature_histogram.hpp:
    75-81 FeatureHistogram::Subtract). Dtype-preserving, so on int32
    histograms it is exact."""
    return parent - child


def _gather(binned: torch.Tensor, indices_buf: torch.Tensor, begin: int,
            count: int, bucket: int):
    """The leaf's padded window of row ids, its (bucket, F) gathered codes
    and its (bucket,) validity (positions < count)."""
    window = indices_buf[begin:begin + bucket].long()
    valid = torch.arange(bucket, device=window.device) < count
    return window, binned.index_select(0, window), valid


def gather_and_build(binned: torch.Tensor, indices_buf: torch.Tensor,
                     grad: torch.Tensor, hess: torch.Tensor, begin: int,
                     count: int, num_bins: int,
                     bucket: int) -> torch.Tensor:
    """A leaf's histogram: rows [begin, begin + count) of the permutation
    buffer gathered from the (N, F) codes in a padded window of `bucket`
    rows (pad rows carry gh == 0), then K1. Returns (F, B, 3) f32."""
    window, rows, valid = _gather(binned, indices_buf, begin, count, bucket)
    v = valid.float()
    gh = torch.stack([grad.index_select(0, window) * v,
                      hess.index_select(0, window) * v, v], dim=1)
    return build_histogram(rows, gh, num_bins)


def gather_and_build_quantized(binned: torch.Tensor,
                               indices_buf: torch.Tensor,
                               gh_packed: torch.Tensor, begin: int,
                               count: int, num_bins: int, bucket: int,
                               grad_bits: int) -> torch.Tensor:
    """Quantized gather_and_build: the leaf's packed (qg|qh) int32 rows as
    the integer operand, then K3. Returns exact (F, B, 3) int32."""
    from . import quantize as quant_ops
    window, rows, valid = _gather(binned, indices_buf, begin, count, bucket)
    ghq = quant_ops.gh_operand(gh_packed.index_select(0, window), valid,
                               grad_bits)
    return build_histogram_quantized(rows, ghq, num_bins)
