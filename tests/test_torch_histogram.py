"""K1 histogram: the port's plain version vs the JAX Pallas kernel.

The JAX side runs build_histogram_pallas in interpret mode, as the JAX
package's own tests do on the CPU. Tolerance rtol=atol=1e-4 (the bound of
tests/test_ops.py): the JAX kernel sums a bf16 hi/lo split of gh (rel.
err ~8e-7) and the port sums f32 in another order. The count lane sums
exact integers and must match exactly. test_torch_gpu.py holds the CUDA
kernel against this plain version on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.pallas.histogram_kernel import build_histogram_pallas
from lightgbm_tpu_torch.ops.kernels import histogram as k1

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _case(num_bins, seed, p=3000, f=11, valid=2700):
    r = np.random.RandomState(seed)
    codes = r.randint(0, num_bins, size=(p, f)).astype(
        np.uint8 if num_bins <= 256 else np.int32)
    gh = np.stack([r.randn(p), r.rand(p) + 0.1, np.ones(p)],
                  axis=1).astype(np.float32)
    gh[valid:] = 0.0                 # padded tail rows carry gh == 0
    return codes, gh


def _oracle(codes, gh, num_bins):
    p, f = codes.shape
    out = np.zeros((f, num_bins, 3), np.float64)
    for j in range(f):
        for k in range(3):
            out[j, :, k] = np.bincount(codes[:, j], weights=gh[:, k]
                                       .astype(np.float64),
                                       minlength=num_bins)
    return out


@pytest.mark.parametrize("num_bins", [16, 64, 256])
def test_plain_matches_jax_kernel_and_oracle(num_bins):
    codes, gh = _case(num_bins, seed=num_bins)
    got = k1.build_histogram(torch.from_numpy(codes), torch.from_numpy(gh),
                             num_bins).numpy()
    want = np.asarray(build_histogram_pallas(
        jnp.asarray(codes), jnp.asarray(gh), num_bins, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _oracle(codes, gh, num_bins),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])   # count: exact


def test_packed_row_views_match_unpacked():
    # the growth core hands K1 the code bytes and gh words of its packed
    # int32 rows as strided views; they must equal the plain inputs
    codes, gh = _case(64, seed=7, f=6)
    p = codes.shape[0]
    words = np.zeros((p, 8), np.uint8)
    words[:, :6] = codes
    buf = torch.cat([torch.from_numpy(words.view(np.int32)),
                     torch.from_numpy(gh).view(torch.int32),
                     torch.arange(p, dtype=torch.int32)[:, None]], dim=1)
    got = k1.build_histogram(buf.view(torch.uint8)[:, :6],
                             buf.view(torch.float32)[:, 2:5], 64)
    want = k1.build_histogram(torch.from_numpy(codes),
                              torch.from_numpy(gh), 64)
    assert torch.equal(got, want)


def test_out_of_range_codes_dropped():
    codes = torch.tensor([[0, 20], [3, 1]], dtype=torch.int32)
    gh = torch.ones((2, 3))
    h = k1.build_histogram(codes, gh, 16)
    assert h[1, :, 2].sum() == 1.0 and h[0, :, 2].sum() == 2.0
