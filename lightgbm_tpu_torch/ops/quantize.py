"""Gradient/hessian quantization for integer histogram construction.

Port of lightgbm_tpu/ops/quantize.py. Per iteration the
gradients and hessians are scaled onto [-qmax, qmax] and rounded
stochastically, q = floor(x * s + u) with u ~ U[0, 1) drawn by the
threefry port (utils/random.py), so the integers are the JAX package's
bit for bit. Integer histograms then sum exactly in any order, sibling
subtraction loses nothing, and the split scan dequantizes with the
iteration's (or the leaf's) scales.

Rows carry (qg, qh) packed into one int32 word, qg in the high 16 bits.
Leaf-wise re-quantization (``quant_renew``): rows are stored at 16 bits
and each leaf's histogram operand is re-quantized to ``grad_bits`` at a
leaf-local ratio r = qcap_op / max|q16 over the leaf|; the parent's pool
entry is rescaled to the split's ratio before sibling subtraction, and
the scan dequantizes with s * r. See the JAX module for the reasoning.

Overflow safety: ``quant_max`` caps qmax * N at 2**30, so per-bin int32
sums cannot overflow.

Data-parallel ranks (``quantize_gh_pmax``) quantize against the scales of
the whole group -- the max-abs over every rank, the cap from the global
row count -- with the rounding noise of fold_in(key, rank), as the JAX
package's shard_map program does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import random as trandom

_EPS = 1e-12


def quant_max(grad_bits: int, n: int) -> int:
    """Largest quantized magnitude for `grad_bits` that is also safe to
    accumulate over n rows in int32."""
    qmax = (1 << (grad_bits - 1)) - 1
    cap = (1 << 30) // max(int(n), 1)
    return max(1, min(qmax, cap))


def operand_dtype(grad_bits: int) -> torch.dtype:
    """Histogram operand dtype: int8 up to 8 bits, else int32."""
    return torch.int8 if grad_bits <= 8 else torch.int32


def gh_scales(grad: torch.Tensor, hess: torch.Tensor, grad_bits: int,
              n: int):
    """(s_g, s_h) f32 scalars mapping this iteration's grad/hess onto
    [-qcap, qcap] (max-abs scaling)."""
    # a fill on the device: a host tensor copied there would synchronise
    qcap = torch.full((), float(quant_max(grad_bits, n)),
                      dtype=torch.float32, device=grad.device)
    s_g = qcap / (torch.max(torch.abs(grad)) + _EPS)
    s_h = qcap / (torch.max(torch.abs(hess)) + _EPS)
    return s_g, s_h


def _round(x: torch.Tensor, key: torch.Tensor,
           stochastic: bool) -> torch.Tensor:
    if stochastic:
        u = trandom.uniform(key, x.shape[0], device=x.device)
        return torch.floor(x + u)
    return torch.round(x)                  # half to even, as jnp.rint


def quantize_gh_core(grad: torch.Tensor, hess: torch.Tensor,
                     key: torch.Tensor, *, grad_bits: int,
                     stochastic: bool = True):
    """Discretize one iteration's (N,) f32 grad and hess to signed
    integers packed into one int32 word per row.

    Returns (packed (N,) int32, s_g, s_h)."""
    n = grad.shape[0]
    qcap = quant_max(grad_bits, n)
    s_g, s_h = gh_scales(grad, hess, grad_bits, n)
    kg, kh = trandom.split(key)
    qg = torch.clamp(_round(grad * s_g, kg, stochastic), -qcap, qcap) \
        .to(torch.int32)
    qh = torch.clamp(_round(hess * s_h, kh, stochastic), -qcap, qcap) \
        .to(torch.int32)
    return pack_gh(qg, qh), s_g, s_h


def quantize_gh(grad: torch.Tensor, hess: torch.Tensor, key: torch.Tensor,
                *, grad_bits: int, stochastic: bool = True):
    """The top-level entry of quantize_gh_core (the JAX package's jitted
    wrapper; torch runs the core as it is)."""
    return quantize_gh_core(grad, hess, key, grad_bits=grad_bits,
                            stochastic=stochastic)


def quantize_gh_pmax(grad: torch.Tensor, hess: torch.Tensor,
                     key: torch.Tensor, *, grad_bits: int, n_total: int,
                     rank: Optional[int] = None, reduce_max=None,
                     stochastic: bool = True):
    """One data-parallel rank's discretization (the JAX quantize_gh_pmax
    under shard_map): the max-abs of grad and hess taken over every rank
    by `reduce_max` (in place on a (2,) f32 tensor: the group's pmax;
    None: this rank's alone), the cap quant_max(grad_bits, n_total) from
    the global row count, and with `rank` the rounding key fold_in(key,
    rank), so each rank draws its own noise. Returns (packed (N,) int32,
    s_g, s_h)."""
    qcap = quant_max(grad_bits, max(int(n_total), grad.shape[0]))
    m = torch.stack([torch.max(torch.abs(grad)), torch.max(torch.abs(hess))])
    if reduce_max is not None:
        m = reduce_max(m)
    if rank is not None:
        key = trandom.fold_in(key, rank)
    q = torch.full((), float(qcap), dtype=torch.float32, device=grad.device)
    s_g = q / (m[0] + _EPS)
    s_h = q / (m[1] + _EPS)
    kg, kh = trandom.split(key)
    qg = torch.clamp(_round_fused(grad, s_g, kg, stochastic), -qcap, qcap) \
        .to(torch.int32)
    qh = torch.clamp(_round_fused(hess, s_h, kh, stochastic), -qcap, qcap) \
        .to(torch.int32)
    return pack_gh(qg, qh), s_g, s_h


def _round_fused(x: torch.Tensor, s: torch.Tensor, key: torch.Tensor,
                 stochastic: bool) -> torch.Tensor:
    """floor(x * s + u) with x * s + u rounded to f32 once, as a fused
    multiply-add rounds it: the JAX package's shard_map program contracts
    the product and the noise into one FMA (XLA), which near an integer
    floors otherwise than two roundings. The product of two f32 is exact
    in f64."""
    if not stochastic:
        return torch.round(x * s)
    u = trandom.uniform(key, x.shape[0], device=x.device)
    return torch.floor((x.double() * s.double() + u.double()).float())


def pack_gh(qg: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """(qg << 16) | (qh & 0xffff) as int32. The shift runs in int64 and
    the word is narrowed with its sign, so a negative qg is defined."""
    w = ((qg.to(torch.int64) << 16) | (qh.to(torch.int64) & 0xFFFF)) \
        & 0xFFFFFFFF
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def unpack_gh(packed: torch.Tensor):
    """Inverse of pack_gh: qg from the arithmetic high half, qh from the
    sign-extended low half."""
    qg = packed >> 16
    lo = packed & 0xFFFF
    qh = torch.where(lo >= 0x8000, lo - 0x10000, lo)
    return qg, qh


def gh_operand(packed: torch.Tensor, valid: torch.Tensor,
               grad_bits: int) -> torch.Tensor:
    """(N, 3) integer [qg, qh, valid] histogram operand from packed rows;
    rows with valid == 0 contribute nothing."""
    qg, qh = unpack_gh(packed)
    v = valid.to(torch.int32)
    return torch.stack([qg * v, qh * v, v], dim=1) \
        .to(operand_dtype(grad_bits))


def dequant_scale3(s_g: torch.Tensor, s_h: torch.Tensor) -> torch.Tensor:
    """(3,) f32 [1/s_g, 1/s_h, 1]: multiply an integer histogram by this
    to recover f32 (sum_grad, sum_hess, count)."""
    return torch.stack([1.0 / s_g, 1.0 / s_h, torch.ones_like(s_g)])


def dequantize_histogram(hist_q: torch.Tensor, s_g: torch.Tensor,
                         s_h: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 histogram -> f32 with the scales; counts pass
    through unscaled."""
    return hist_q.float() * dequant_scale3(s_g, s_h)


def storage_bits(grad_bits: int, renew: bool) -> int:
    """Row-storage resolution: 16 bits under leaf re-quantization (the
    packed word's field width), grad_bits without it (then the compact
    core quantizes bit-identically to the masked strategy)."""
    return 16 if renew else grad_bits


def requant_ratio(leaf_max_q: torch.Tensor, qcap_op: int) -> torch.Tensor:
    """Leaf-local operand ratio from the leaf's max |stored int| (f32);
    an all-zero leaf gets 1. The numerator is a tensor: torch divides a
    Python number by a tensor as the number times the tensor's
    reciprocal, which rounds twice and can miss the quotient by an ulp."""
    qcap = torch.full_like(leaf_max_q, float(qcap_op))
    return torch.where(leaf_max_q > 0.0,
                       qcap / torch.clamp(leaf_max_q, min=1.0),
                       torch.ones_like(leaf_max_q))


def gh_operand_scaled(packed: torch.Tensor, valid: torch.Tensor,
                      grad_bits: int, qcap_op: int, r_g: torch.Tensor,
                      r_h: torch.Tensor) -> torch.Tensor:
    """(N, 3) [qg, qh, valid] operand re-quantized to the leaf's ratio:
    q_op = clip(rint(q16 * r), -qcap_op, qcap_op). With r == 1 it equals
    gh_operand (f32 holds |q| <= 32767 exactly). valid=None means every
    row counts."""
    qg, qh = unpack_gh(packed)
    qg2 = torch.clamp(torch.round(qg.float() * r_g), -qcap_op, qcap_op) \
        .to(torch.int32)
    qh2 = torch.clamp(torch.round(qh.float() * r_h), -qcap_op, qcap_op) \
        .to(torch.int32)
    if valid is None:
        v = torch.ones_like(qg2)
    else:
        v = valid.to(torch.int32)
        qg2, qh2 = qg2 * v, qh2 * v
    return torch.stack([qg2, qh2, v], dim=1).to(operand_dtype(grad_bits))


def rescale_histogram(hist_q: torch.Tensor, r_g: torch.Tensor,
                      r_h: torch.Tensor) -> torch.Tensor:
    """Re-express an int32 (..., 3) histogram built at ratio r_old in
    ratio r_new units (pass r = r_new / r_old per lane). The count lane is
    untouched; the (g, h) lanes round-trip through f32."""
    gh2 = torch.round(hist_q[..., :2].float() * torch.stack([r_g, r_h])) \
        .to(torch.int32)
    return torch.cat([gh2, hist_q[..., 2:]], dim=-1)
