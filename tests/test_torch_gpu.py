"""Card-only tests of lightgbm_tpu_torch: each CUDA kernel against its
plain PyTorch version, and training on the card against the CPU.

Every test here needs an NVIDIA card; the ``cuda_device`` fixture skips
them elsewhere. The file imports neither JAX nor lightgbm_tpu, so on a
machine without JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: K4 is a permutation of 32-bit words and K3 / K3t sum
integers, so they must be bit-exact. K1's (and K2's) grad and hess lanes
are fixed-point sums per block whose f32 block partials meet in global
atomics in any order, so they agree with index_add_ to rtol = atol = 1e-4
(at larger row counts chip_smoke.py's bar, which adds 1e-5 * the bin's
sum of |terms|; without the absolute term for the dynamic-range case);
the count lane sums exact integers and must be equal.
"""
import os
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops.kernels import build
from lightgbm_tpu_torch.ops.kernels import histogram as k1
from lightgbm_tpu_torch.ops.kernels import partition as k4

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins,dtype,f", [
    (64, torch.uint8, 28), (256, torch.uint8, 28), (64, torch.int16, 28),
    (16, torch.int32, 11), (1024, torch.int32, 40)])
def test_k1_matches_plain(cuda_device, num_bins, dtype, f):
    r = np.random.RandomState(num_bins)
    p = 100_003
    codes = torch.from_numpy(r.randint(0, num_bins, size=(p, f))) \
        .to(cuda_device, dtype)
    gh = torch.from_numpy(np.stack(
        [r.randn(p), r.rand(p), np.ones(p)], 1).astype(np.float32)) \
        .to(cuda_device)
    gh[99_000:] = 0.0
    n0 = k1.launches
    got = k1.build_histogram(codes, gh, num_bins)
    torch.cuda.synchronize()
    assert k1.launches == n0 + 1
    want = k1.build_histogram_plain(codes, gh, num_bins)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[..., 2], want[..., 2])


@pytest.mark.gpu
def test_k1_on_packed_row_views(cuda_device):
    # codes read in place from packed int32 rows (row stride 11 words)
    r = np.random.RandomState(0)
    p = 50_001
    buf = torch.from_numpy(r.randint(0, 2**31, size=(p, 11))
                           .astype(np.int32)).to(cuda_device)
    buf[:, 7:10] = torch.from_numpy(np.stack(
        [r.randn(p), r.rand(p), np.ones(p)], 1).astype(np.float32)) \
        .to(cuda_device).view(torch.int32)
    codes = buf.view(torch.uint8)[:, :28]
    gh = buf.view(torch.float32)[:, 7:10]
    got = k1.build_histogram(codes, gh, 256)
    want = k1.build_histogram_plain(codes, gh, 256)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[..., 2], want[..., 2])


@pytest.mark.gpu
@pytest.mark.parametrize("w,d", [(1, 11), (1023, 11), (1025, 3),
                                 (100_003, 11), (3, 1)])
def test_k4_bit_exact(cuda_device, w, d):
    r = np.random.RandomState(w)
    win = torch.from_numpy(r.randint(0, 2**32, size=(w, d), dtype=np.uint32)
                           .view(np.int32)).to(cuda_device)
    key = torch.from_numpy(r.randint(0, 3, size=w).astype(np.int32)) \
        .to(cuda_device)
    n0 = k4.launches
    got = k4.stable_partition3(win, key)
    torch.cuda.synchronize()
    assert k4.launches == n0 + 1
    assert torch.equal(got, k4.stable_partition3_plain(win, key))


@pytest.mark.gpu
def test_k4_into_a_slice_of_the_spare_buffer(cuda_device):
    r = np.random.RandomState(2)
    spare = torch.zeros((5000, 11), dtype=torch.int32, device=cuda_device)
    win = torch.from_numpy(r.randint(0, 2**31, size=(3000, 11))
                           .astype(np.int32)).to(cuda_device)
    key = torch.from_numpy((r.rand(3000) > 0.6).astype(np.int32)) \
        .to(cuda_device)
    k4.stable_partition3(win, key, spare[1000:4000])
    assert torch.equal(spare[1000:4000], k4.stable_partition3_plain(win, key))
    assert not spare[:1000].any() and not spare[4000:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("bits,num_bins,dtype", [
    (8, 64, torch.uint8), (8, 256, torch.uint8), (16, 256, torch.uint8),
    (16, 64, torch.int16), (8, 16, torch.int32), (16, 1024, torch.int32)])
def test_k3_and_k3t_bit_exact(cuda_device, bits, num_bins, dtype):
    r = np.random.RandomState(num_bins + bits)
    p, f = 100_003, 28
    codes = torch.from_numpy(r.randint(0, num_bins, size=(p, f))) \
        .to(cuda_device, dtype)
    q = (1 << (bits - 1)) - 1
    ghq = torch.from_numpy(np.stack(
        [r.randint(-q, q + 1, p), r.randint(0, q + 1, p), np.ones(p)],
        1)).to(cuda_device, torch.int8 if bits <= 8 else torch.int32)
    ghq[99_000:] = 0
    n0 = (k1.launches_q, k1.launches_qt)
    got = k1.build_histogram_quantized(codes, ghq, num_bins)
    codes_t = codes.t().contiguous()
    got_t = k1.build_histogram_quantized_t(codes_t, ghq, num_bins)
    torch.cuda.synchronize()
    assert (k1.launches_q, k1.launches_qt) == (n0[0] + 1, n0[1] + 1)
    want = k1.build_histogram_quantized_plain(codes, ghq, num_bins)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got_t, want)


@pytest.mark.gpu
def test_k3_on_packed_quantized_rows(cuda_device):
    # codes read in place from the compact core's quantized rows (row
    # stride 9 words); the operand comes from the packed (qg|qh) word
    from lightgbm_tpu_torch.ops import quantize as q
    r = np.random.RandomState(3)
    p = 50_001
    buf = torch.from_numpy(r.randint(0, 2**31, size=(p, 9))
                           .astype(np.int32)).to(cuda_device)
    ghq = q.gh_operand_scaled(buf[:, 7], None, 8, 127,
                              torch.tensor(0.01, device=cuda_device),
                              torch.tensor(0.02, device=cuda_device))
    codes = buf.view(torch.uint8)[:, :28]
    got = k1.build_histogram_quantized(codes, ghq, 256)
    assert torch.equal(got, k1.build_histogram_quantized_plain(codes, ghq,
                                                               256))


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,counter,op_dtype,acc_dtype,col_major", [
    ("build_histogram", "launches", torch.float32, torch.float32, False),
    ("build_histogram_t", "launches_t", torch.float32, torch.float32, True),
    ("build_histogram_quantized", "launches_q", torch.int8, torch.int32,
     False),
    ("build_histogram_quantized_t", "launches_qt", torch.int32, torch.int32,
     True)])
def test_empty_window_launches_nothing(cuda_device, wrapper, counter,
                                       op_dtype, acc_dtype, col_major):
    # a zero-row window returns a zero histogram without a launch, so no
    # launch count moves
    codes = torch.zeros((0, 28), dtype=torch.uint8, device=cuda_device)
    gh = torch.zeros((0, 3), dtype=op_dtype, device=cuda_device)
    names = ("launches", "launches_t", "launches_q", "launches_qt")
    n0 = {c: getattr(k1, c) for c in names}
    got = getattr(k1, wrapper)(codes.t() if col_major else codes, gh, 64)
    torch.cuda.synchronize()
    assert {c: getattr(k1, c) for c in names} == n0
    assert got.shape == (28, 64, 3) and got.dtype == acc_dtype
    assert not got.any()
    # the same wrapper on one row does launch, and counts on its own
    # counter only
    codes1 = torch.ones((1, 28), dtype=torch.uint8, device=cuda_device)
    gh1 = torch.ones((1, 3), dtype=op_dtype, device=cuda_device)
    getattr(k1, wrapper)(codes1.t() if col_major else codes1, gh1, 64)
    torch.cuda.synchronize()
    assert {c: getattr(k1, c) - n0[c] for c in names} == {
        c: int(c == counter) for c in names}


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins", [16, 64, 256])
def test_k2_matches_plain(cuda_device, num_bins):
    r = np.random.RandomState(num_bins)
    f, p = 28, 60_001
    codes_t = torch.from_numpy(r.randint(0, num_bins, size=(f, p))) \
        .to(cuda_device, torch.uint8)
    gh = torch.from_numpy(np.stack(
        [r.randn(p), r.rand(p), np.ones(p)], 1).astype(np.float32)) \
        .to(cuda_device)
    gh[r.rand(p) < 0.5] = 0.0
    n0 = (k1.launches, k1.launches_t)
    got = k1.build_histogram_t(codes_t, gh, num_bins)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_t) == (n0[0], n0[1] + 1)
    want = k1.build_histogram_t_plain(codes_t, gh, num_bins)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[..., 2], want[..., 2])


@pytest.mark.gpu
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_train_on_card_matches_cpu(cuda_device, objective, monkeypatch):
    # the compact strategy (K1 and K4); auto would pick masked at 20k rows
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    r = np.random.RandomState(5)
    n = 20_000
    x = r.randn(n, 10)
    x[r.rand(n) < 0.03, 2] = np.nan
    y = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 3] * x[:, 4] + 0.5 * r.randn(n)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    params = {"objective": objective, "num_leaves": 31, "max_bin": 63,
              "min_gain_to_split": 1e-3, "verbosity": -1}
    n0 = (k1.launches, k4.launches)
    card = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                      device=cuda_device)
    assert k1.launches > n0[0] and k4.launches > n0[1]
    cpu = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                     device="cpu")

    def structure(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves])) for t in b._gbdt.models]

    assert structure(card) == structure(cpu)
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,quant", [
    ("masked", False), ("masked", True), ("compact", True)])
def test_new_paths_on_card_match_cpu(cuda_device, strategy, quant,
                                     monkeypatch):
    # masked float (K2), masked quantized (K3t), compact quantized (K3,
    # K4): the same trees on the card as on the CPU; quantized leaf sums
    # come from exact integer histograms
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    r = np.random.RandomState(6)
    n = 20_000
    x = r.randn(n, 10)
    y = (x[:, 0] * 1.5 - x[:, 1] + 0.5 * r.randn(n) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "min_gain_to_split": 1e-3, "verbosity": -1,
              "quantized_grad": quant}
    counters = ("launches_t", "launches_q", "launches_qt")
    n0 = {c: getattr(k1, c) for c in counters}
    card = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                      device=cuda_device)
    moved = {c for c in counters if getattr(k1, c) > n0[c]}
    assert moved == {("masked", False): {"launches_t"},
                     ("masked", True): {"launches_qt"},
                     ("compact", True): {"launches_q"}}[(strategy, quant)]
    cpu = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                     device="cpu")

    def structure(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves])) for t in b._gbdt.models]

    assert structure(card) == structure(cpu)
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


def _bar_ok(got, want, mag, atol=1e-4):
    """chip_smoke.py's K1 / K2 bar: |diff| <= atol + 1e-4 |plain| + 1e-5
    sum|terms| per bin."""
    return bool(((got - want).abs()
                 <= atol + 1e-4 * want.abs() + 1e-5 * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["100k", "cap"])
def test_k1_every_row_in_one_bin(cuda_device, size):
    # the worst contention: every row adds to the one slot of each feature,
    # all of one sign. "cap" takes one block more rows than the wrapper's
    # grid holds at 65,536 rows per block (~35M rows on an H100), so the
    # float kernel's launcher grows the grid and every block walks exactly
    # kMaxRowsPerBlock rows: the widest fixed-point words it allows
    with open(os.path.join(build.CSRC, "histogram.cu")) as fh:
        cap = 1 << int(re.search(r"kMaxRowsPerBlock = 1ll << (\d+);",
                                 fh.read()).group(1))
    full = k1._grid_x(cuda_device, 1 << 40, k1._BLOCKS_PER_SM[0])
    p = 100_003 if size == "100k" else (full + 1) * cap
    if size == "cap":
        grid = max(k1._grid_x(cuda_device, p, k1._BLOCKS_PER_SM[0]),
                   -(-p // cap))
        assert grid == full + 1 and p == grid * cap
    r = np.random.RandomState(p % 1000)
    codes = torch.full((p, 4), 5, dtype=torch.uint8, device=cuda_device)
    gh = torch.from_numpy(np.stack(
        [1e3 * r.rand(p), 0.25 * r.rand(p), np.ones(p)], 1)
        .astype(np.float32)).to(cuda_device)
    got = k1.build_histogram(codes, gh, 64)
    torch.cuda.synchronize()
    want = gh.double().sum(0)
    for f in range(4):
        torch.testing.assert_close(got[f, 5].double(), want, rtol=1e-5,
                                   atol=0.0)
    assert float(got[:, 5, 2].min()) == p == float(got[:, 5, 2].max())
    others = torch.ones(64, dtype=torch.bool, device=cuda_device)
    others[5] = False
    assert not got[:, others].any()


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins", [16, 64, 256])
@pytest.mark.parametrize("form", ["k1", "k1_packed_27", "k2"])
def test_k1_k2_ragged_row_counts(cuda_device, num_bins, form):
    # row counts that 256 does not divide; K1 over contiguous codes and
    # over 27 code bytes of 44-byte packed rows (whole 32-bit code words
    # and a byte tail), K2 over (F, N) codes
    r = np.random.RandomState(num_bins + len(form))
    p, f = 250_007, 28
    codes = torch.from_numpy(r.randint(0, num_bins, size=(p, f))) \
        .to(cuda_device, torch.uint8)
    gh = torch.from_numpy(np.stack(
        [r.randn(p), r.rand(p), np.ones(p)], 1).astype(np.float32)) \
        .to(cuda_device)
    gh[r.rand(p) < 0.3] = 0.0
    if form == "k1_packed_27":
        buf = torch.zeros((p, 11), dtype=torch.int32, device=cuda_device)
        buf.view(torch.uint8)[:, :f] = codes
        codes = buf.view(torch.uint8)[:, :27]
    n0 = (k1.launches, k1.launches_t)
    if form == "k2":
        got = k1.build_histogram_t(codes.t().contiguous(), gh, num_bins)
    else:
        got = k1.build_histogram(codes, gh, num_bins)
    torch.cuda.synchronize()
    assert (k1.launches - n0[0], k1.launches_t - n0[1]) == (
        (0, 1) if form == "k2" else (1, 0))
    want = k1.build_histogram_plain(codes, gh, num_bins)
    mag = k1.build_histogram_plain(codes, gh.abs(), num_bins)
    assert _bar_ok(got, want, mag)
    assert torch.equal(got[..., 2], want[..., 2])


@pytest.mark.gpu
def test_k1_dynamic_range(cuda_device):
    # feature 0's bin 7: hessians 1e-7..0.25, gradients 1e-6..1e3; bin 8:
    # only the small ends; held without the absolute term
    r = np.random.RandomState(5)
    p, f = 200_003, 28
    dc = r.randint(0, 64, size=(p, f)).astype(np.uint8)
    g, h = r.randn(p), r.rand(p) * 0.25
    for code, (glo, ghi), (hlo, hhi) in ((7, (-6, 3), (-7, np.log10(0.25))),
                                         (8, (-6, -4), (-7, -5))):
        sel = dc[:, 0] == code
        k = int(sel.sum())
        g[sel] = np.where(r.rand(k) < 0.5, -1.0, 1.0) \
            * 10.0 ** r.uniform(glo, ghi, k)
        h[sel] = 10.0 ** r.uniform(hlo, hhi, k)
    codes = torch.from_numpy(dc).to(cuda_device)
    gh = torch.from_numpy(np.stack([g, h, np.ones(p)], 1)
                          .astype(np.float32)).to(cuda_device)
    got = k1.build_histogram(codes, gh, 64)
    want = k1.build_histogram_plain(codes, gh, 64)
    mag = k1.build_histogram_plain(codes, gh.abs(), 64)
    assert _bar_ok(got, want, mag, atol=0.0)
    assert torch.equal(got[..., 2], want[..., 2])


@pytest.mark.gpu
def test_k2_all_but_three_rows_zero(cuda_device):
    # a deep leaf of the masked strategy: almost every block has no live
    # row and adds nothing
    r = np.random.RandomState(9)
    f, p = 28, 60_001
    codes_t = torch.from_numpy(r.randint(0, 64, size=(f, p))) \
        .to(cuda_device, torch.uint8)
    gh = torch.zeros((p, 3), dtype=torch.float32, device=cuda_device)
    keep = torch.tensor([0, 31_337, p - 1], device=cuda_device)
    gh[keep] = torch.tensor([[-0.37, 0.21, 1.0], [1.5e-6, 3e-7, 1.0],
                             [812.5, 0.0625, 1.0]], device=cuda_device)
    got = k1.build_histogram_t(codes_t, gh, 64)
    want = k1.build_histogram_t_plain(codes_t, gh, 64)
    mag = k1.build_histogram_t_plain(codes_t, gh.abs(), 64)
    assert _bar_ok(got, want, mag, atol=0.0)
    assert torch.equal(got[..., 2], want[..., 2])
    assert int((got[..., 2] != 0).sum()) <= 3 * f
