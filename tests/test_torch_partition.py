"""K4 stable partition: the port's plain version vs the JAX Pallas kernel.

Cases follow tests/test_partition_kernel.py (W in {256, 771, 1024, 2048,
4096}, D in {1, 5, 7, 12}, single-stream windows, an empty middle stream,
byte extremes), plus wide ragged rows. The JAX side runs
stable_partition3 in interpret mode; the result must be bit-exact.
test_torch_gpu.py holds the CUDA kernel against this plain version on the
card; the tests at the end check the wrapper's sizing of the kernel (tile
rows, shared memory, grid, scratch) against the constants of its source.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.pallas.partition_kernel import stable_partition3 \
    as jax_partition
from lightgbm_tpu_torch.ops.kernels import build
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


def test_wide_rows_ragged_window():
    # rows far wider than the path's (D = 260 words, as a wide packed
    # dataset gives) and a window that no block size divides
    r = np.random.RandomState(21)
    w, d = 771, 260
    win = r.randint(0, 2**32, size=(w, d), dtype=np.uint32)
    key = r.randint(0, 3, size=w).astype(np.int32)
    _check(win, key)


# ---- the kernel's sizing (csrc/partition.cu), read from the source ----------

_CU = os.path.join(build.CSRC, "partition.cu")
# an H100 block's shared memory, and the kernel's static shared memory
# (red[4][8] and wsum[8] int32)
_SMEM_LIMIT = 232_448
_STATIC_SMEM = (4 * 8 + 8) * 4


def _constant(name):
    with open(_CU) as fh:
        m = re.search(r"constexpr int %s = ([0-9 *]+);" % name, fh.read())
    assert m, name + " not found in " + _CU
    out = 1
    for factor in m.group(1).split("*"):
        out *= int(factor)
    return out


def test_sizing_constants_match_the_source():
    assert (k4.MAX_TILE, k4.MIN_TILE, k4.STAGE_BYTES, k4.MAX_STAGE_BYTES) \
        == (_constant("kMaxTile"), _constant("kMinTile"),
            _constant("kStageBytes"), _constant("kMaxStageBytes"))
    assert _constant("kThreads") >= k4.MAX_TILE      # one row per thread
    with open(_CU) as fh:
        text = fh.read()
    # the wrapper's formulas are the kernel's
    assert "constexpr int kMaxD = kMaxStageBytes / (8 * kMinTile);" in text
    assert "return (T * D + 6) & ~3;" in text
    assert "return (2 * stage_words(T, D) + T) * 4;" in text
    assert "const int t = (kStageBytes / (8 * D)) & ~3;" in text


@pytest.mark.parametrize("d,want", [(1, 256), (9, 256), (11, 256),
                                    (48, 256), (49, 248), (260, 44),
                                    (6144, 4), (6145, 0), (0, 0)])
def test_tile_rows_for_row_width(d, want):
    t = k4.tile_rows(d)
    assert t == want and t % 4 == 0
    if t:
        # both staged tiles (16-byte chunks) and the slot map fit a block
        assert k4.smem_bytes(d) + _STATIC_SMEM <= _SMEM_LIMIT


def test_shared_memory_fits_every_row_width():
    # every width the wrapper takes, the widest (MAX_D words: 24,560 8-bit
    # or 12,280 16-bit packed columns plus 4 words) included; the path's
    # D = 9 and 11 need no opt-in above 48 KB
    sizes = [k4.smem_bytes(d) for d in range(1, k4.MAX_D + 1)]
    assert max(sizes) + _STATIC_SMEM <= _SMEM_LIMIT
    assert k4.MAX_D == 6144 and k4.tile_rows(k4.MAX_D) == k4.MIN_TILE
    assert k4.smem_bytes(11) <= 48 * 1024 and k4.smem_bytes(9) <= 48 * 1024


@pytest.mark.parametrize("w,d,cap,grid", [(1, 11, 1056, 1),
                                          (256, 11, 1056, 1),
                                          (257, 11, 1056, 2),
                                          (1_000_000, 11, 1056, 1056),
                                          (1056 * 256 + 1, 11, 1056, 1056),
                                          (4_000, 260, 264, 91)])
def test_grid_and_scratch(w, d, cap, grid):
    assert k4.grid_blocks(w, d, cap) == grid
    assert k4.scratch_ints(grid) == 2 * grid


def test_cpu_takes_rows_wider_than_the_kernel():
    # the CPU takes any width (the plain version); on the card the wrapper
    # refuses rows the kernel cannot stage (test_torch_gpu.py)
    win = torch.zeros((4, k4.MAX_D + 1), dtype=torch.int32)
    key = torch.zeros(4, dtype=torch.int32)
    assert torch.equal(k4.stable_partition3(win, key), win)
    assert k4.tile_rows(k4.MAX_D + 1) == 0
