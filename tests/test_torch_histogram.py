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
    # JAX is imported here: test_torch_gpu.py imports this file's model of
    # the CUDA kernel on a card's host, which has no JAX
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas.histogram_kernel import \
        build_histogram_pallas
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
# words per block: per lane s = 30 - E with the block's f64 sum of |v| <
# 2^E, L = 31 - ceil(log2 m) for m = min(n, kMaxRowsPerBlock), n the
# block's live rows; hi = rint(v * 2^s), lo = rint((v * 2^s - hi) * 2^L);
# after each chunk of at most kMaxRowsPerBlock of the block's rows (4,096
# grid strides) a slot's value t = hi_sum * 2^L + lo_sum (int64, in units
# of 2^-(s + L)) moves to the window's grid 2^-G, G = 61 - Ew with the
# window's sum of |v| < 2^Ew (shifted left, or rounded half up by an
# arithmetic right shift), the chunks' values add in int64, and the
# slot's f32 is that sum rounded once, times 2^-G.

_CU = os.path.join(build.CSRC, "histogram.cu")


def _cu_text():
    with open(_CU) as fh:
        return fh.read()


def _cu_max_rows_per_block():
    """kMaxRowsPerBlock of csrc/histogram.cu: the most rows of one block's
    walk between two flushes of its fixed-point words."""
    m = re.search(r"kMaxRowsPerBlock = 1ll << (\d+);", _cu_text())
    assert m, "kMaxRowsPerBlock not found in " + _CU
    return 1 << int(m.group(1))


def _cu_fixed_tile_constants():
    """(kFixedTileBytes, kMaxBlockSmemBytes, kFixedWarpBytes) of
    csrc/histogram.cu, in bytes."""
    text = _cu_text()
    tile = int(re.search(r"kFixedTileBytes = (\d+) \* 1024;", text)
               .group(1)) * 1024
    most = int(re.search(r"kMaxBlockSmemBytes = (\d+) \* 1024;", text)
               .group(1)) * 1024
    warps = k1._THREADS // 32 * int(re.search(
        r"kFixedWarpBytes = kWarps \* (\d+);", text).group(1))
    return tile, most, warps

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


def _shift_round(t, k):
    """t * 2^k elementwise for int64 t and int64 shifts k: exact to the
    left, rounded half up to the right (csrc/histogram.cu shift_round)."""
    left = t << k.clamp(min=0)
    rk = (-k).clamp(min=1, max=62)
    right = (t + (torch.ones_like(t) << (rk - 1))) >> rk
    return torch.where(k >= 0, left,
                       torch.where(k <= -63, torch.zeros_like(t), right))


def _fixed_point_hist(codes, gh, num_bins, grid_x, keep_lo=True, cap=None):
    """The kernel's block-wise fixed-point histogram in int64 torch ops,
    flushed every `cap` rows of a block's walk (kMaxRowsPerBlock unless
    given); also returns the largest |hi| and |lo| slot sum of any chunk
    and the largest |accumulator| word."""
    cap = cap or _cu_max_rows_per_block()
    p, f = codes.shape
    r = torch.arange(p)
    block = (r // k1._THREADS) % grid_x                 # grid-stride rows
    chunk = r // (k1._THREADS * grid_x) // (cap // k1._THREADS)
    live = (gh != 0).any(dim=1)
    v = gh.double()
    Ew = torch.frexp(v.abs().sum(0)).exponent.long()
    G = 61 - Ew                                         # (3,)
    S = torch.zeros((grid_x, 3), dtype=torch.float64).index_add_(
        0, block, v.abs())
    n = torch.zeros(grid_x, dtype=torch.int64).index_add_(0, block,
                                                           live.long())
    L = torch.tensor([31 - (min(int(k), cap) - 1).bit_length() if k else 31
                      for k in n])                      # 31 - ceil(log2 m)
    sc = 30 - torch.frexp(S).exponent.long()            # (grid_x, 3)
    x = torch.ldexp(v, sc[block].double())              # exact
    hi = torch.round(x)                                 # half to even
    lo = torch.round((x - hi) * torch.ldexp(torch.ones(p, 1, dtype=torch.float64),
                                            L[block, None].double())) \
        if keep_lo else torch.zeros_like(x)
    chunks = int(chunk.max()) + 1
    group = block * chunks + chunk
    idx = (group[:, None] * (f * num_bins) + torch.arange(f) * num_bins
           + codes.long()).reshape(-1)
    sums = []
    for w in (hi, lo):
        a = torch.zeros((grid_x * chunks * f * num_bins, 3),
                        dtype=torch.int64)
        a.index_add_(0, idx, w.long().repeat_interleave(f, dim=0))
        sums.append(a.view(grid_x, chunks, f * num_bins, 3))
    worst = max(int(w.abs().max()) for w in sums)
    Lb = L[:, None, None, None]
    t = sums[0] * (torch.ones_like(Lb) << Lb) + sums[1]
    k = G - sc[:, None, None, :] - Lb
    acc = _shift_round(t, k.expand_as(t)).sum(dim=(0, 1))
    out = acc.to(torch.float32) * torch.ldexp(torch.ones(3), -G.float())
    return out.view(f, num_bins, 3), worst, int(acc.abs().max())


@pytest.mark.parametrize("grid_x", [1, 7, 64])
def test_fixed_point_sums_meet_the_dynamic_range_bar(grid_x):
    # the kernel's rounding on the dynamic-range rows holds the bar of
    # chip_smoke.py's dynamic-range case against the plain version, with
    # no absolute term: |diff| <= 1e-4 |plain| + 1e-5 sum|terms|, count
    # exact; a single word per lane (lo dropped) loses bin 8's small terms
    codes, gh = _dynamic_range_case()
    want = k1.build_histogram_plain(codes, gh, 64)
    mag = k1.build_histogram_plain(codes, gh.abs(), 64)
    got, worst, _ = _fixed_point_hist(codes, gh, 64, grid_x)
    assert worst <= 2**31 - 1
    diff = (got - want).abs()
    assert bool((diff <= 1e-4 * want.abs() + 1e-5 * mag).all()), \
        float((diff / (1e-4 * want.abs() + 1e-5 * mag)).max())
    assert torch.equal(got[..., 2], want[..., 2])
    hi_only, _, _ = _fixed_point_hist(codes, gh, 64, grid_x,
                                      keep_lo=False)
    diff = (hi_only - want).abs()
    assert not bool((diff <= 1e-4 * want.abs() + 1e-5 * mag).all())


@pytest.mark.parametrize("case", ["dynamic range", "random 100k"])
def test_fixed_point_sums_equal_the_f64_plain_at_the_wrappers_grid(
        case, monkeypatch):
    # at the grid the wrapper asks for (4 blocks per SM, 132 SMs) the
    # kernel's sum -- exact to far below an f32 ulp, rounded once -- is
    # the f64 plain version's on every slot of these inputs: what makes
    # the card's trees the CPU's
    if case == "dynamic range":
        codes, gh = _dynamic_range_case()
    else:
        r = np.random.RandomState(3)
        p = 100_003
        codes = torch.from_numpy(r.randint(0, 64, size=(p, 28))
                                 .astype(np.uint8))
        gh = torch.from_numpy(np.stack([r.randn(p), r.rand(p), np.ones(p)],
                                       1).astype(np.float32))
    monkeypatch.setitem(k1._sm_count, 0, 132)
    grid_x = k1._grid_x(torch.device("cuda", 0), codes.shape[0],
                        k1._BLOCKS_PER_SM)
    got, _, _ = _fixed_point_hist(codes, gh, 64, grid_x)
    assert torch.equal(got, k1.build_histogram_plain(codes, gh, 64))


def _random_case(p, f=28, seed=3):
    r = np.random.RandomState(seed)
    codes = torch.from_numpy(r.randint(0, 64, size=(p, f)).astype(np.uint8))
    gh = torch.from_numpy(np.stack([r.randn(p), r.rand(p), np.ones(p)],
                                   1).astype(np.float32))
    return codes, gh


@pytest.mark.parametrize("grid_x,cap", [(1, 1024), (3, 256), (7, 2048)])
def test_chunked_walk_equals_the_f64_plain(grid_x, cap):
    # a block whose walk is longer than the cap flushes its words after
    # each chunk of at most `cap` rows; the extra flushes round at 2^-61
    # of the window's sum of |v| and leave the f64 plain version's result
    # (the cap cut from 2^16 so that a CPU run walks many chunks)
    for codes, gh in (_dynamic_range_case(), _random_case(30_011)):
        want = k1.build_histogram_plain(codes, gh, 64)
        got, worst, _ = _fixed_point_hist(codes, gh, 64, grid_x, cap=cap)
        assert worst <= 2**31 - 1
        assert torch.equal(got[..., 2], want[..., 2])
        assert int((got != want).sum()) <= want.numel() // 1000


def _widths_cases():
    cap = _cu_max_rows_per_block()
    return [1, 2, 3, 255, 256, 257, 3788, 65535, 65536, cap - 1, cap,
            cap + 1, 2 * cap + 3, 10**9 + 7]


@pytest.mark.parametrize("n", _widths_cases())
def test_fixed_point_widths_cannot_overflow(n):
    # at every live-row count of a block, neither word of a slot can leave
    # int32: a chunk holds m = min(n, cap) of the block's live rows and a
    # slot takes at most one term per row; |hi| <= |v| 2^s + 1/2 with
    # sum|v| < 2^E (1 + d), d the relative error of the kernel's f64 sum of
    # |v| (under 2^33 terms per thread, then 5 shuffle and 8 warp
    # additions); |lo| <= 2^(L - 1)
    cap = _cu_max_rows_per_block()
    m = min(n, cap)
    L = 31 - (m - 1).bit_length()
    assert L >= 31 - (cap - 1).bit_length() >= 11
    assert m * 2 ** (L - 1) <= 2**31 - 1
    d = (2**33 + 5 + 8) * 2.0 ** -53
    assert 2**30 * (1 + d) + m / 2 <= 2**31 - 1
    # the count lane (0 / 1 weights, S = n): x = 2^s, a multiple of 2^s,
    # whose lo word is exact while s + L >= 0; up to the cap s >= 30 -
    # log2(cap) - 1 (13 at 2^16), and s >= 9 at any cap up to 2^20
    s = 30 - n.bit_length()
    assert s + L >= 0
    if n <= cap:
        assert s >= 30 - cap.bit_length() >= 9


@pytest.mark.parametrize("blocks", [528, 1056])
def test_fixed_point_accumulator_cannot_overflow(blocks):
    # the int64 accumulator at the cap: every chunk's value is at most 2^G
    # times its rows' sum of |v| (1 + d) plus its lo words' rounding (at
    # most m 2^(30 - L) at a shift of 31 - L) and one half; over a window of
    # fewer than 2^33 rows (under 2^13 full chunks, plus one partial chunk
    # per block) the slot's sum stays below 2^62
    cap = _cu_max_rows_per_block()
    L = 31 - (cap - 1).bit_length()
    d = (2**33 + 5 + 8) * 2.0 ** -53
    chunks = 2**33 // cap + blocks
    assert 2.0**61 * (1 + d) + chunks * (cap * 2.0 ** (30 - L) + 0.5) \
        < 2.0**62
    # and the model's own worst slot: every row of the window in one bin,
    # all of one sign at one size, two chunks per block (cap cut to 256)
    p = blocks * 2 * 256
    codes = torch.zeros((p, 1), dtype=torch.uint8)
    gh = torch.tensor([[3.0, 0.75, 1.0]]).repeat(p, 1)
    got, worst, top = _fixed_point_hist(codes, gh, 4, blocks, cap=256)
    assert worst <= 2**31 - 1
    assert 2**60 <= top < 2**62
    assert float(got[0, 0, 2]) == p
    torch.testing.assert_close(got[0, 0, :2].double(),
                               torch.tensor([3.0 * p, 0.75 * p],
                                            dtype=torch.float64),
                               rtol=2**-24, atol=0)


@pytest.mark.parametrize("p", [1, 255, 256 * 528, 34_603_008, 34_603_009,
                               10**9 + 7])
def test_launcher_caps_rows_per_block(p, monkeypatch):
    # the float kernels' launch (launch_fixed_grid in csrc/histogram.cu)
    # runs the wrapper's grid cut to the card's resident blocks and refuses
    # none for its size; a block flushes its words every kMaxRowsPerBlock
    # rows of its walk (kChunkStrides grid strides of 256 rows), so no
    # chunk holds more rows than the cap the overflow argument above holds
    # to, at any grid from 1 block to the wrapper's (132 SMs, an H100)
    cap = _cu_max_rows_per_block()
    assert cap % k1._THREADS == 0
    text = _cu_text()
    launcher = text[text.index("int launch_fixed_grid("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert "std::min(grid_x, max_resident(kernel, smem))" in launcher
    assert "kMaxRowsPerBlock" not in launcher.split("{", 1)[1]
    assert "kChunkStrides = kMaxRowsPerBlock / kThreads" in text
    monkeypatch.setitem(k1._sm_count, 0, 132)
    full = k1._grid_x(torch.device("cuda", 0), p, k1._BLOCKS_PER_SM)
    for g in {1, max(1, full // 2), full}:
        strides = -(-p // (g * k1._THREADS))        # a block's walk
        per_chunk = min(strides, cap // k1._THREADS) * k1._THREADS
        assert min(per_chunk, p) <= cap


@pytest.mark.parametrize("f,num_bins,p", [
    (28, 64, 1_000_000), (28, 256, 10**9), (200, 256, 30_000_000),
    (1000, 256, 5_000_000), (4500, 256, 1_000_000), (3, 4096, 1000),
    (28, 8192, 1000)])
def test_fixed_launcher_takes_wide_and_long_windows(f, num_bins, p,
                                                    monkeypatch):
    # shapes whose grid, with feature tiles along y and at most the cap
    # per block, could not all be resident at once: the launcher's feature
    # tile (fixed_feat_tile) fits a block's shared memory, every block walks
    # every tile, and the scratch the wrapper sizes for its grid_x
    # (fixed_scratch_words) holds the accumulator and an entry for every
    # block of any grid the launcher cuts it to
    tile_bytes, most, warp_bytes = _cu_fixed_tile_constants()
    t = max(tile_bytes, num_bins * 24) // (num_bins * 24)
    t = f if t >= f else t - t % 4 if t >= 4 else t
    assert 1 <= t <= f
    assert t * num_bins * 24 + warp_bytes <= most
    text = _cu_text()
    assert "return fixed_acc_words(F, B) + 4ll * grid_x;" in text
    assert "for (int f0 = n ? 0 : F; f0 < F; f0 += feat_tile)" in text
    monkeypatch.setitem(k1._sm_count, 0, 132)
    grid_x = k1._grid_x(torch.device("cuda", 0), p, k1._BLOCKS_PER_SM)
    words = f * num_bins * 3 + 4 * grid_x
    for resident in (1, 264, 528, 660, 1056):
        gx = min(grid_x, resident)
        assert f * num_bins * 3 + 4 * gx <= words


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
