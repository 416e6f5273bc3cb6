"""K4 stable partition: the port's plain version vs the JAX Pallas kernel.

Cases follow tests/test_partition_kernel.py (W in {256, 771, 1024, 2048,
4096}, D in {1, 5, 7, 12}, single-stream windows, an empty middle stream,
byte extremes). The JAX side runs stable_partition3 in interpret mode;
the result must be bit-exact. test_torch_gpu.py holds the CUDA kernel
against this plain version on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.pallas.partition_kernel import stable_partition3 \
    as jax_partition
from lightgbm_tpu_torch.ops.kernels import partition as k4

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _check(win_u32, key, block_rows=256):
    want = np.asarray(jax_partition(jnp.asarray(win_u32), jnp.asarray(key),
                                    block_rows=block_rows, interpret=True))
    got = k4.stable_partition3(torch.from_numpy(win_u32.view(np.int32)),
                               torch.from_numpy(key.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("w,d,seed", [(1024, 12, 0), (2048, 7, 1),
                                      (771, 12, 2), (256, 1, 3)])
def test_random_keys_full_range_payload(w, d, seed):
    r = np.random.RandomState(seed)
    win = r.randint(0, 2**32, size=(w, d), dtype=np.uint32)
    key = r.randint(0, 3, size=w).astype(np.int32)
    _check(win, key)


@pytest.mark.parametrize("fill", [0, 1, 2])
def test_single_stream_only(fill):
    r = np.random.RandomState(17)
    win = r.randint(0, 2**32, size=(512, 5), dtype=np.uint32)
    _check(win, np.full(512, fill, dtype=np.int32))


def test_empty_middle_stream_and_byte_extremes():
    r = np.random.RandomState(4)
    win = np.stack([
        np.full(640, 0xFFFFFFFF, np.uint32),
        np.zeros(640, np.uint32),
        np.full(640, 0x80000000, np.uint32),
        np.full(640, 0x00FF00FF, np.uint32),
        r.randint(0, 2**32, 640, dtype=np.uint32),
    ], axis=1)
    key = np.where(np.arange(640) % 2 == 0, 0, 2).astype(np.int32)
    _check(win, key)


def test_split_pattern_into_second_buffer():
    # the growth core's shape: a 0/1 key over the window, written into a
    # slice of the other working buffer
    r = np.random.RandomState(9)
    w, d = 4096, 11
    win = r.randint(0, 2**32, size=(w, d), dtype=np.uint32)
    key = (r.rand(w) >= 0.37).astype(np.int32)
    _check(win, key, block_rows=512)
    spare = torch.zeros((w + 10, d), dtype=torch.int32)
    out = k4.stable_partition3(torch.from_numpy(win.view(np.int32)),
                               torch.from_numpy(key), spare[5:5 + w])
    assert out.data_ptr() == spare[5:].data_ptr()
    assert torch.equal(spare[:5], torch.zeros((5, d), dtype=torch.int32))
