"""K1 histogram: the port's plain version vs the JAX Pallas kernel.

The JAX side runs build_histogram_pallas in interpret mode, as the JAX
package's own tests do on the CPU. Tolerance rtol=atol=1e-4 (the bound of
tests/test_ops.py): the JAX kernel sums a bf16 hi/lo split of gh (rel.
err ~8e-7) and the port sums f32 in another order. The count lane sums
exact integers and must match exactly. test_torch_gpu.py holds the CUDA
kernel against this plain version on the card.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.pallas.histogram_kernel import build_histogram_pallas
from lightgbm_tpu_torch.ops.kernels import build
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


# ---- the CUDA float kernel's fixed-point sums, reproduced on the CPU ----
# csrc/histogram.cu (hist_fixed_kernel) sums f32 values as int32 hi / lo
# words per block: per lane s = 30 - E with the block's sum of |v| < 2^E,
# L = 31 - ceil(log2 n) for n live rows; hi = rint(v * 2^s), lo =
# rint((v * 2^s - hi) * 2^L); a slot's block value is the f32 rounding of
# hi_sum * 2^L + lo_sum, times 2^-(s + L). The block sums of |v| are taken
# in float64 here (the kernel's f32 sum can only move E at an exact power
# of two, which the widths' margin covers).

_CU = os.path.join(build.CSRC, "histogram.cu")


def _cu_max_rows_per_block():
    """kMaxRowsPerBlock of csrc/histogram.cu: the most rows the float
    kernel's launcher lets one block walk."""
    with open(_CU) as fh:
        m = re.search(r"kMaxRowsPerBlock = 1ll << (\d+);", fh.read())
    assert m, "kMaxRowsPerBlock not found in " + _CU
    return 1 << int(m.group(1))

def _dynamic_range_case(p=20_003, f=6, num_bins=64, seed=5):
    """Ordinary rows, plus feature 0's bin 7 with hessians from 1e-7 to
    0.25 and gradients from 1e-6 to 1e3 (log-uniform, random signs) and
    bin 8 with only the small ends of both (chip_smoke.py's k1 case)."""
    r = np.random.RandomState(seed)
    codes = r.randint(0, num_bins, size=(p, f)).astype(np.uint8)
    g, h = r.randn(p), r.rand(p) * 0.25
    for code, (glo, ghi), (hlo, hhi) in ((7, (-6, 3), (-7, np.log10(0.25))),
                                         (8, (-6, -4), (-7, -5))):
        sel = codes[:, 0] == code
        k = int(sel.sum())
        g[sel] = np.where(r.rand(k) < 0.5, -1.0, 1.0) \
            * 10.0 ** r.uniform(glo, ghi, k)
        h[sel] = 10.0 ** r.uniform(hlo, hhi, k)
    gh = np.stack([g, h, np.ones(p)], 1).astype(np.float32)
    gh[r.rand(p) < 0.1] = 0.0          # rows outside the leaf
    return torch.from_numpy(codes), torch.from_numpy(gh)


def _fixed_point_hist(codes, gh, num_bins, grid_x, keep_lo=True):
    """The kernel's block-wise fixed-point histogram in int64 torch ops;
    also returns the largest |hi| and |lo| slot sum of any block."""
    p, f = codes.shape
    block = (torch.arange(p) // k1._THREADS) % grid_x   # grid-stride rows
    live = (gh != 0).any(dim=1)
    slot = (block[:, None] * (f * num_bins)
            + torch.arange(f) * num_bins + codes.long())
    out = torch.zeros((f * num_bins, 3), dtype=torch.float32)
    worst = 0
    for b in range(grid_x):
        rows = (block == b) & live
        n = int(rows.sum())
        if n == 0:
            continue
        L = 31 - (n - 1).bit_length()                  # 31 - ceil(log2 n)
        v = gh[rows].double()
        x = torch.empty_like(v)
        scale = []
        for j in range(3):
            s = 30 - int(np.frexp(float(v[:, j].abs().sum()))[1])
            scale.append(s)
            x[:, j] = torch.ldexp(v[:, j], torch.tensor(s))  # exact
        hi = torch.round(x)                              # half to even
        lo = torch.round((x - hi) * 2.0 ** L) if keep_lo \
            else torch.zeros_like(x)
        sl = (slot[rows] - b * f * num_bins).reshape(-1)
        sums = []
        for w in (hi, lo):
            acc = torch.zeros((f * num_bins, 3), dtype=torch.int64)
            acc.index_add_(0, sl, w.long().repeat_interleave(f, dim=0))
            worst = max(worst, int(acc.abs().max()))
            sums.append(acc)
        t = sums[0] * (1 << L) + sums[1]
        val = t.to(torch.float32) * torch.tensor(
            [2.0 ** -(s + L) for s in scale], dtype=torch.float32)
        out += val
    return out.view(f, num_bins, 3), worst


@pytest.mark.parametrize("grid_x", [1, 7, 64])
def test_fixed_point_sums_meet_the_dynamic_range_bar(grid_x):
    # the kernel's rounding on the dynamic-range rows holds the bar of
    # chip_smoke.py's dynamic-range case against the plain version, with
    # no absolute term: |diff| <= 1e-4 |plain| + 1e-5 sum|terms|, count
    # exact; a single word per lane (lo dropped) loses bin 8's small terms
    codes, gh = _dynamic_range_case()
    want = k1.build_histogram_plain(codes, gh, 64)
    mag = k1.build_histogram_plain(codes, gh.abs(), 64)
    got, worst = _fixed_point_hist(codes, gh, 64, grid_x)
    assert worst <= 2**31 - 1
    diff = (got - want).abs()
    assert bool((diff <= 1e-4 * want.abs() + 1e-5 * mag).all()), \
        float((diff / (1e-4 * want.abs() + 1e-5 * mag)).max())
    assert torch.equal(got[..., 2], want[..., 2])
    hi_only, _ = _fixed_point_hist(codes, gh, 64, grid_x, keep_lo=False)
    diff = (hi_only - want).abs()
    assert not bool((diff <= 1e-4 * want.abs() + 1e-5 * mag).all())


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 3788, 65535, 65536])
def test_fixed_point_widths_cannot_overflow(n):
    # at every live-row count up to the launcher's cap, neither word of a
    # slot can leave int32: a slot takes at most one term per live row;
    # |hi| <= |v| 2^s + 1/2 with sum|v| < 2^E (1 + d), d the relative error
    # of the kernel's f32 sum of |v| (at most rows/256 terms per thread,
    # then 5 shuffle and 8 warp additions); |lo| <= 2^(L - 1)
    cap = _cu_max_rows_per_block()
    assert n <= cap
    L = 31 - (n - 1).bit_length()
    assert n * 2 ** (L - 1) <= 2**31 - 1
    d = (cap // k1._THREADS + 5 + 8) * 2.0 ** -24
    assert 2**30 * (1 + d) + n / 2 <= 2**31 - 1
    # the count lane (0 / 1 weights, sum <= n) scales by s >= 13: integers
    assert 30 - (n.bit_length()) >= 13


@pytest.mark.parametrize("p", [1, 255, 256 * 528, 34_603_008, 34_603_009,
                               10**9 + 7])
def test_launcher_caps_rows_per_block(p, monkeypatch):
    # the float kernel's launch (launch_fixed in csrc/histogram.cu) raises
    # the wrapper's grid to ceil(P / kMaxRowsPerBlock) blocks; with the
    # grid-stride walk (256-row strides) no block then walks more rows than
    # the cap the overflow argument above holds to (132 SMs, an H100)
    cap = _cu_max_rows_per_block()
    assert cap % k1._THREADS == 0
    with open(_CU) as fh:
        text = fh.read()
    assert "(P + kMaxRowsPerBlock - 1) / kMaxRowsPerBlock" in text[
        text.index("int launch_fixed("):]
    monkeypatch.setitem(k1._sm_count, 0, 132)
    g = max(k1._grid_x(torch.device("cuda", 0), p, k1._BLOCKS_PER_SM),
            -(-p // cap))
    per_block = k1._THREADS * -(-p // (g * k1._THREADS))
    assert min(per_block, p) <= cap


# ---- the integer kernels' packed slot words, reproduced on the CPU ----
# csrc/histogram.cu (int_hist_body) adds an int8 operand's (or the packed-
# row entry's) lanes into two int32 words per slot: qg, and qh * 2^k +
# valid for a valid lane of 0 or 1 (any other valid goes whole to the
# slot's third word); a block walks at most kMaxPackedRowsPerBlock rows;
# the flush takes valid's sum from the low k bits, sign-extended, plus the
# third word, and qh's from the rest.


def _cu_pack_constants():
    """(kPackShift, kMaxPackedRowsPerBlock, kThreads, kCluster) of the
    source."""
    with open(_CU) as fh:
        text = fh.read()
    k = re.search(r"constexpr int kPackShift = (\d+);", text)
    r = re.search(r"kMaxPackedRowsPerBlock = (\d+) \* kThreads;", text)
    t = re.search(r"constexpr int kThreads = (\d+);", text)
    c = re.search(r"constexpr int kCluster = (\d+);", text)
    assert k and r and t and c, "packing constants not found in " + _CU
    return (int(k.group(1)), int(r.group(1)) * int(t.group(1)),
            int(t.group(1)), int(c.group(1)))


def _wrap32(v):
    """int64 values as the int32 words atomicAdd leaves (mod 2^32)."""
    return ((np.asarray(v, np.int64) + 2**31) % 2**32) - 2**31


def _unpack_word(w, k):
    """The flush's decode of one packed word: (sum qh, sum valid)."""
    w = np.asarray(w, np.int64)
    c = ((w & ((1 << k) - 1)) ^ (1 << (k - 1))) - (1 << (k - 1))
    return (w - c) >> k, c


@pytest.mark.parametrize("h", [-128, -1, 127])
@pytest.mark.parametrize("n", [1, 255, 1024, "cap"])
def test_packed_words_cannot_overflow(n, h):
    # the worst slot: every row a block may walk in it, each with an
    # extreme qh of an int8 operand and valid 1; the word never leaves
    # int32 and decodes to the exact sums, and the bound of the note at
    # the top of the source holds: valid's sum inside the low k bits'
    # signed range, qh's inside [-2^(31-k), 2^(31-k))
    k, cap, threads, _ = _cu_pack_constants()
    assert threads == k1._THREADS and cap % threads == 0
    n = cap if n == "cap" else n
    assert cap < 2 ** (k - 1)
    assert -128 * cap >= -2 ** (31 - k) and 127 * cap < 2 ** (31 - k)
    assert -2**31 <= n * (h * 2**k + 1) < 2**31
    word = _wrap32(n * (h * 2**k + 1))
    assert tuple(_unpack_word(word, k)) == (n * h, n)
    # a slot hit by no valid row but by qh terms (valid 0, or a valid lane
    # other than 0 / 1, which adds to the third word instead)
    assert tuple(_unpack_word(_wrap32(n * h * 2**k), k)) == (n * h, 0)


def _packed_block_hist(codes, ghq, num_bins, grid_x):
    """The integer kernel's packing arithmetic: per block (grid-stride
    rows, the launcher's grid), int32 words qg, qh * 2^k + valid (valid 0
    or 1) and the other valids summed with wrap-around, decoded at the
    flush, then the blocks' int32 sums added."""
    k, cap, threads, _ = _cu_pack_constants()
    p, f = codes.shape
    grid_x = max(grid_x, -(-p // cap))
    block = (np.arange(p) // threads) % grid_x
    assert np.bincount(block).max() <= cap
    g, h, c = (ghq[:, j].astype(np.int64) for j in range(3))
    cp = np.where((c == 0) | (c == 1), c, 0)
    out = np.zeros((f, num_bins, 3), np.int64)
    for b in range(grid_x):
        rows = np.nonzero(block == b)[0]
        for j in range(f):
            cj = codes[rows, j].astype(np.int64)
            keep = (cj >= 0) & (cj < num_bins)
            sl = cj[keep]

            def word(v):
                return _wrap32(np.bincount(sl, v[rows][keep], num_bins)
                               .astype(np.int64))
            hs, cs = _unpack_word(word(h * 2**k + cp), k)
            out[j] += np.stack([word(g), hs, cs + word(c - cp)], axis=1)
    return _wrap32(out)


@pytest.mark.parametrize("grid_x", [1, 7, 64])
def test_packed_block_sums_match_plain(grid_x):
    # int8 operand lanes at their extremes (-128..127) with 0 / 1 valid,
    # zero rows, codes past B; then valid lanes of any int8 value; and
    # every row in one bin (full skew) with |q| = 127 of either sign and
    # valid 1 or 127
    r = np.random.RandomState(grid_x)
    p, f = 20_003, 4
    codes = r.randint(0, 70, size=(p, f)).astype(np.int32)
    ghq = np.stack([r.randint(-128, 128, p), r.randint(-128, 128, p),
                    r.rand(p) < 0.8], 1).astype(np.int8)
    ghq[r.rand(p) < 0.1] = 0
    odd = ghq.copy()
    odd[:, 2] = np.where(r.rand(p) < 0.5, odd[:, 2],
                         r.choice([2, -1, 127, -128], p))
    for op in (ghq, odd):
        want = k1.build_histogram_quantized_plain(
            torch.from_numpy(codes), torch.from_numpy(op), 64).numpy()
        np.testing.assert_array_equal(
            _packed_block_hist(codes, op, 64, grid_x), want)
    for sign in (1, -1):
        for valid in (1, 127):
            skew = np.stack([np.full(p, 127 * sign),
                             np.full(p, -127 * sign), np.full(p, valid)],
                            1).astype(np.int8)
            got = _packed_block_hist(np.full((p, f), 5, np.int32), skew,
                                     64, grid_x)
            assert (got[:, 5] == [127 * sign * p, -127 * sign * p,
                                  valid * p]).all()
            assert not got[:, np.arange(64) != 5].any()


def _int_launch_grid(grid_x, p, pack, wave, cs, cap):
    """The grid along x of int_launch_shape in csrc/histogram.cu: the
    wrapper's grid in whole clusters, cut to one wave of `wave` blocks,
    raised to the rows cap where packing, in whole clusters."""
    grid_x = -(-grid_x // cs) * cs
    if wave >= cs and grid_x > wave:
        grid_x = wave
    if pack:
        grid_x = max(grid_x, -(-p // cap))
    return -(-grid_x // cs) * cs


@pytest.mark.parametrize("p", [1, 2048, 2049, 256 * 528, 1_000_000,
                               34_603_009, 10**9 + 7])
def test_integer_launcher_caps_rows_per_block(p, monkeypatch):
    # the integer kernels' launch (int_launch_shape in csrc/histogram.cu)
    # rounds the wrapper's grid to whole clusters, cuts it to one wave of
    # the clusters the card holds (62 clusters of 8 on an H100 at 64 bins;
    # 0: the query failed) and raises a packing kernel's grid to
    # ceil(P / kMaxPackedRowsPerBlock). With the grid-stride walk no block
    # then walks more rows than the packed words hold (132 SMs, an H100).
    # A grid of one cluster, which stores its output, takes every row; a
    # larger one adds into the output the launcher zeroes first
    k, cap, threads, cluster = _cu_pack_constants()
    with open(_CU) as fh:
        text = fh.read()
    launcher = text[text.index("int int_launch_shape("):]
    launcher = launcher[:launcher.index("\n}\n")]
    for line in ("grid_x = (grid_x + cs - 1) / cs * cs;",
                 "if (wave >= cs && grid_x > wave) grid_x = wave;",
                 "(P + kMaxPackedRowsPerBlock - 1) / kMaxPackedRowsPerBlock",
                 "if (grid_x < min_grid) grid_x = (int)min_grid;"):
        assert line in launcher
    assert "return pack ? kCluster : 1;" in text
    launch = text[text.index("int launch_clustered("):]
    assert "if ((int)grid.x > cs) {" in launch
    assert "cudaMemsetAsync(out, 0, out_bytes, s)" in launch
    monkeypatch.setitem(k1._sm_count, 0, 132)
    hint = k1._grid_x(torch.device("cuda", 0), p, k1._BLOCKS_PER_SM)
    for wave in (62 * cluster, 0):
        g = _int_launch_grid(hint, p, True, wave, cluster, cap)
        assert g % cluster == 0 and g >= -(-p // cap)
        per_block = threads * -(-p // (g * threads))
        assert min(per_block, p) <= cap
        assert (g == cluster) == (p <= cluster * threads)
        # three words per slot: clusters of one, no rows cap
        g = _int_launch_grid(hint, p, False, wave, 1, cap)
        assert g == (min(hint, wave) if wave else hint)
