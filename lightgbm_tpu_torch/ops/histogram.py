"""Device histogram construction.

Port of lightgbm_tpu/ops/histogram.py (reference roles: Bin::Construct
Histogram, src/io/dense_bin.hpp:71-195, and the OpenCL histogram256.cl).
On the card every (P, F) histogram is built by kernel K1 (float) or K3
(exact int32, quantized gradients) of ops/kernels/histogram.py; a tensor on
the CPU takes the kernels' plain versions. The JAX package's one-hot
contraction and its chunk ladder exist for the TPU's MXU and have no
counterpart here.
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


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (reference: feature_histogram.hpp:
    75-81 FeatureHistogram::Subtract). Dtype-preserving, so on int32
    histograms it is exact."""
    return parent - child
