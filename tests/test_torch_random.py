"""The threefry port (lightgbm_tpu_torch/utils/random.py) vs jax.random.

The quantized path rounds stochastically with jax.random draws; the port
reproduces jax.random.PRNGKey, split and uniform (threefry2x32,
partitionable counters) bit for bit, so its integer gradients and
histograms can be held bit-exact against the JAX package.
"""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu_torch.utils import random as trandom


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
def test_key_and_split_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trandom.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for num in (2, 3):
        np.testing.assert_array_equal(
            trandom.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num)).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
@pytest.mark.parametrize("n", [1, 1001, 4096])
def test_uniform_bit_exact(seed, n):
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.uniform(jkey, (n,)))
    got = trandom.uniform(trandom.split(trandom.prng_key(seed))[1], n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
