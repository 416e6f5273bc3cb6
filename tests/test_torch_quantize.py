"""Quantized gradients and the integer / column-major histograms: the
port vs the JAX package.

Bars, and why:
  * quantize_gh_core, gh_operand_scaled and rescale_histogram: bit-exact.
    The threefry port draws the same uniforms as jax.random
    (test_torch_random.py) and every step is one f32 operation in the
    same order, so the integers and the f32 scales must be equal.
  * K3 / K3t plain vs build_histogram_pallas_quantized(_t) in interpret
    mode: bit-exact. Integer sums do not depend on their order.
  * K2 plain vs build_histogram_pallas_t: rtol = atol = 1e-4, the K1 bound
    of test_torch_histogram.py (the JAX kernel sums a bf16 hi/lo split);
    the count lane sums exact integers and must be equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu.ops.pallas.histogram_kernel import (
    build_histogram_pallas_quantized, build_histogram_pallas_quantized_t,
    build_histogram_pallas_t)
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops.kernels import histogram as khist
from lightgbm_tpu_torch.utils import random as trandom

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _gh(n=3001, seed=0):
    r = np.random.RandomState(seed)
    g = (r.randn(n) * 0.7).astype(np.float32)
    h = (0.05 + r.rand(n) * 0.2).astype(np.float32)
    return g, h


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_gh_core_bit_exact(bits):
    g, h = _gh(seed=bits)
    jp, jsg, jsh = jq.quantize_gh_core(jnp.asarray(g), jnp.asarray(h),
                                       jax.random.PRNGKey(11),
                                       grad_bits=bits)
    tp, tsg, tsh = tq.quantize_gh_core(torch.from_numpy(g),
                                       torch.from_numpy(h),
                                       trandom.prng_key(11), grad_bits=bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tsg.item() == float(jsg) and tsh.item() == float(jsh)
    qg, qh = tq.unpack_gh(tp)
    assert qg.abs().max().item() == tq.quant_max(bits, len(g))
    assert torch.equal(tq.pack_gh(qg, qh), tp)


def test_gh_operand_scaled_and_rescale_bit_exact():
    g, h = _gh(seed=3)
    key = jax.random.PRNGKey(5)
    jp, _, _ = jq.quantize_gh_core(jnp.asarray(g), jnp.asarray(h), key,
                                   grad_bits=16)
    tp = torch.from_numpy(np.array(jp))
    r = np.random.RandomState(1)
    valid = r.rand(len(g)) < 0.8
    for r_g, r_h, bits in [(0.0123, 0.37, 8), (1.0, 1.0, 8),
                           (0.51, 0.0049, 16)]:
        qcap = tq.quant_max(bits, len(g))
        want = jq.gh_operand_scaled(jp, jnp.asarray(valid), bits, qcap,
                                    jnp.float32(r_g), jnp.float32(r_h))
        got = tq.gh_operand_scaled(tp, torch.from_numpy(valid), bits, qcap,
                                   torch.tensor(r_g), torch.tensor(r_h))
        assert got.dtype == tq.operand_dtype(bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hist = r.randint(-2**29, 2**29, size=(10, 64, 3)).astype(np.int32)
    want = jq.rescale_histogram(jnp.asarray(hist), jnp.float32(0.731),
                                jnp.float32(1.9))
    got = tq.rescale_histogram(torch.from_numpy(hist), torch.tensor(0.731),
                               torch.tensor(1.9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qcase(bits, num_bins, p=3000, f=10, valid=2701):
    """The JAX package's own kernel case (tests/test_quantized.py): P rows
    with a tail of zero-operand pad rows, F features."""
    r = np.random.RandomState(num_bins + bits)
    codes = r.randint(0, num_bins, size=(p, f)).astype(np.uint8)
    g, h = _gh(p, seed=bits)
    packed, _, _ = jq.quantize_gh_core(jnp.asarray(g), jnp.asarray(h),
                                       jax.random.PRNGKey(bits),
                                       grad_bits=bits)
    ghq = np.array(jq.gh_operand(packed, jnp.arange(p) < valid, bits))
    return codes, ghq


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("num_bins", [16, 64, 256])
def test_plain_k3_and_k3t_bit_exact_vs_jax_kernel(bits, num_bins):
    codes, ghq = _qcase(bits, num_bins)
    assert ghq.dtype == (np.int8 if bits <= 8 else np.int32)
    want = np.asarray(build_histogram_pallas_quantized(
        jnp.asarray(codes), jnp.asarray(ghq), num_bins, interpret=True))
    got = thist.build_histogram_quantized(
        torch.from_numpy(codes), torch.from_numpy(ghq), num_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    codes_t = np.ascontiguousarray(codes.T)
    want_t = np.asarray(build_histogram_pallas_quantized_t(
        jnp.asarray(codes_t), jnp.asarray(ghq), num_bins, interpret=True))
    got_t = khist.build_histogram_quantized_t(
        torch.from_numpy(codes_t), torch.from_numpy(ghq), num_bins)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(want_t, want)


@pytest.mark.parametrize("num_bins", [16, 64, 256])
def test_plain_k2_matches_jax_kernel(num_bins):
    r = np.random.RandomState(num_bins)
    p, f = 3000, 10
    codes_t = r.randint(0, num_bins, size=(f, p)).astype(np.uint8)
    gh = np.stack([r.randn(p), r.rand(p) + 0.1, np.ones(p)],
                  axis=1).astype(np.float32)
    gh[2700:] = 0.0
    want = np.asarray(build_histogram_pallas_t(
        jnp.asarray(codes_t), jnp.asarray(gh), num_bins, interpret=True))
    got = khist.build_histogram_t(torch.from_numpy(codes_t),
                                  torch.from_numpy(gh), num_bins).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


def test_int32_subtraction_exact_and_dequantize():
    codes, ghq = _qcase(8, 64)
    c, q = torch.from_numpy(codes), torch.from_numpy(ghq)
    mask = torch.from_numpy(np.random.RandomState(2).rand(len(codes)) < 0.3)
    parent = thist.build_histogram_quantized(c, q, 64)
    left = thist.build_histogram_quantized(c, q * mask[:, None].to(q.dtype),
                                           64)
    right = thist.build_histogram_quantized(
        c, q * (~mask)[:, None].to(q.dtype), 64)
    sib = thist.subtract_histogram(parent, left)
    assert sib.dtype == torch.int32 and torch.equal(sib, right)
    s_g, s_h = torch.tensor(37.5), torch.tensor(612.0)
    want = jq.dequantize_histogram(jnp.asarray(parent.numpy()),
                                   jnp.float32(37.5), jnp.float32(612.0))
    np.testing.assert_array_equal(
        tq.dequantize_histogram(parent, s_g, s_h).numpy(), np.asarray(want))
