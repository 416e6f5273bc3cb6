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
    g = max(k1._grid_x(torch.device("cuda", 0), p, k1._BLOCKS_PER_SM[0]),
            -(-p // cap))
    per_block = k1._THREADS * -(-p // (g * k1._THREADS))
    assert min(per_block, p) <= cap
