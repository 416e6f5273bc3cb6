"""Card-only tests of lightgbm_tpu_torch: each CUDA kernel against its
plain PyTorch version, and training on the card against the CPU.

Every test here needs an NVIDIA card; the ``cuda_device`` fixture skips
them elsewhere. The file imports neither JAX nor lightgbm_tpu, so on a
machine without JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: K4 is a permutation of 32-bit words and K3 / K3t (and the
packed-row entry, counted as K3) sum integers, so they must be
bit-exact; so must the split-key kernel (both entries: the compact core's
packed one and the masked core's column one, which copies operand rows)
and the device-window entries of K3 and K4 (which read their window from
the split descriptor). K1's
(and K2's) grad and hess lanes are fixed-point sums per block that meet
in an int64 accumulator and round once to f32: the same bits in every
launch, and within rtol = atol = 1e-4 of the plain version's f64 sum
rounded once (at larger row counts chip_smoke.py's bar, which adds 1e-5 *
the bin's sum of |terms|; without the absolute term for the
dynamic-range case); the count lane sums exact integers and must be
equal.
"""
import gc
import os
import re
import weakref

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.ops import quantize as quant_ops
from lightgbm_tpu_torch.ops.kernels import build
from lightgbm_tpu_torch.ops.kernels import desc as dsc
from lightgbm_tpu_torch.ops.kernels import histogram as k1
from lightgbm_tpu_torch.ops.kernels import partition as k4
from lightgbm_tpu_torch.ops.kernels import split_key as kkey

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_requant_ratio_card_matches_cpu(cuda_device):
    # the leaf-local re-quantization ratio of every 16-bit leaf max: the
    # card's f32 quotient is the CPU's, bit for bit
    m = torch.arange(32768, dtype=torch.float32)
    for qcap in (127, 7):
        assert torch.equal(
            quant_ops.requant_ratio(m.to(cuda_device), qcap).cpu(),
            quant_ops.requant_ratio(m, qcap))


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


def _k4_case(device, w, d, seed, key=None):
    r = np.random.RandomState(seed)
    win = torch.from_numpy(r.randint(0, 2**32, size=(w, d), dtype=np.uint32)
                           .view(np.int32)).to(device)
    if key is None:
        key = r.randint(0, 3, size=w).astype(np.int32)
    return win, torch.from_numpy(np.asarray(key, np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 9, 11, 260])
@pytest.mark.parametrize("size", ["1", "31", "T-1", "T", "T+1", "cap+1"])
def test_k4_window_sizes(cuda_device, size, d):
    # around one tile (T rows for D-word rows), and one tile more than the
    # grid holds, so that one block moves two tiles
    t = k4.tile_rows(d)
    cap = k4._launcher(cuda_device, d)[1]
    w = {"1": 1, "31": 31, "T-1": t - 1, "T": t, "T+1": t + 1,
         "cap+1": cap * t + 1}[size]
    win, key = _k4_case(cuda_device, w, d, w + d)
    n0, r0 = k4.launches, k4.rows
    got = k4.stable_partition3(win, key)
    torch.cuda.synchronize()
    assert (k4.launches - n0, k4.rows - r0) == (1, w)
    if size == "cap+1":
        assert k4.grid_blocks(w, d, cap) == cap
    assert torch.equal(got, k4.stable_partition3_plain(win, key))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["all 0", "all 1", "all 2",
                                     "no 1 (empty middle stream)"])
def test_k4_key_patterns(cuda_device, pattern):
    w = 70_001
    key = {"all 0": np.zeros(w), "all 1": np.ones(w),
           "all 2": np.full(w, 2),
           "no 1 (empty middle stream)": 2 * (np.arange(w) % 3 == 1)}[pattern]
    win, key = _k4_case(cuda_device, w, 11, 3, key)
    got = k4.stable_partition3(win, key)
    assert torch.equal(got, k4.stable_partition3_plain(win, key))


@pytest.mark.gpu
def test_k4_back_to_back_on_one_stream(cuda_device):
    # three calls queued without a wait: the second and third reuse the
    # scratch block the caching allocator hands back, at another grid
    a_win, a_key = _k4_case(cuda_device, 300_007, 11, 4)
    b_win, b_key = _k4_case(cuda_device, 4_099, 11, 5)
    got_a = k4.stable_partition3(a_win, a_key)
    got_b = k4.stable_partition3(b_win, b_key)
    got_a2 = k4.stable_partition3(a_win, a_key)
    torch.cuda.synchronize()
    want_a = k4.stable_partition3_plain(a_win, a_key)
    assert torch.equal(got_a, want_a) and torch.equal(got_a2, want_a)
    assert torch.equal(got_b, k4.stable_partition3_plain(b_win, b_key))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [9, 11])
def test_k4_unaligned_slices(cuda_device, d):
    # window and output are row slices at every 16-byte misalignment; the
    # rows around the output slice stay untouched
    src, _ = _k4_case(cuda_device, 20_000, d, 6)
    for begin in (0, 1, 2, 3, 5):
        win = src[begin:begin + 9_001]
        key = torch.from_numpy(np.random.RandomState(begin).randint(
            0, 2, 9_001).astype(np.int32)).to(cuda_device)
        spare = torch.full((20_000, d), -7, dtype=torch.int32,
                           device=cuda_device)
        k4.stable_partition3(win, key, spare[begin + 3:begin + 9_004])
        assert torch.equal(spare[begin + 3:begin + 9_004],
                           k4.stable_partition3_plain(win, key))
        assert bool((spare[:begin + 3] == -7).all())
        assert bool((spare[begin + 9_004:] == -7).all())


@pytest.mark.gpu
def test_k4_run_to_run_equal(cuda_device):
    win, key = _k4_case(cuda_device, 1_000_003, 11, 8)
    first = k4.stable_partition3(win, key)
    again = k4.stable_partition3(win, key)
    assert torch.equal(first, again)
    assert torch.equal(first, k4.stable_partition3_plain(win, key))


@pytest.mark.gpu
def test_k4_empty_window_launches_nothing(cuda_device):
    win = torch.zeros((0, 11), dtype=torch.int32, device=cuda_device)
    n0, r0 = k4.launches, k4.rows
    got = k4.stable_partition3(win, torch.zeros(0, dtype=torch.int32,
                                                device=cuda_device))
    assert got.shape == (0, 11) and (k4.launches, k4.rows) == (n0, r0)


@pytest.mark.gpu
def test_k4_sizing_matches_the_library(cuda_device):
    lib = build.load("partition")
    for d in (1, 9, 11, 48, 49, 260, k4.MAX_D, k4.MAX_D + 1):
        assert lib.lgbt_partition_tile_rows(d) == k4.tile_rows(d)
        if k4.tile_rows(d):
            assert lib.lgbt_partition_smem_bytes(d) == k4.smem_bytes(d)
            assert k4._launcher(cuda_device, d)[1] >= \
                torch.cuda.get_device_properties(cuda_device) \
                .multi_processor_count


@pytest.mark.gpu
def test_k4_refused_launch_raises(cuda_device, monkeypatch):
    # a grid larger than the card holds at once is refused by the
    # cooperative launch: the wrapper raises and counts nothing; rows wider
    # than the kernel stages are refused before any launch
    d = 11
    cap = k4._launcher(cuda_device, d)[1]
    win, key = _k4_case(cuda_device, 2 * cap * k4.tile_rows(d), d, 9)
    monkeypatch.setitem(k4._max_grid, (cuda_device.index or 0, d), 2 * cap)
    n0 = k4.launches
    with pytest.raises(RuntimeError, match="partition kernel launch"):
        k4.stable_partition3(win, key)
    assert k4.launches == n0
    wide = torch.zeros((8, k4.MAX_D + 1), dtype=torch.int32,
                       device=cuda_device)
    with pytest.raises(ValueError, match="words"):
        k4.stable_partition3(wide, torch.zeros(8, dtype=torch.int32,
                                               device=cuda_device))
    assert k4.launches == n0


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
    # the compact core's device loop: K1's and K4's window entries and the
    # split-key kernel
    n0 = (k1.launches_win, k4.launches_win, kkey.launches)
    card = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                      device=cuda_device)
    assert k1.launches_win > n0[0] and k4.launches_win > n0[1] \
        and kkey.launches > n0[2]
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
    # masked float (K2), masked quantized (K3t), compact quantized (K3's
    # and K4's window entries): the same trees on the card as on the CPU;
    # quantized leaf sums come from exact integer histograms
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    r = np.random.RandomState(6)
    n = 20_000
    x = r.randn(n, 10)
    y = (x[:, 0] * 1.5 - x[:, 1] + 0.5 * r.randn(n) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "min_gain_to_split": 1e-3, "verbosity": -1,
              "quantized_grad": quant}
    counters = ("launches_t", "launches_q", "launches_qt", "launches_qwin")
    n0 = {c: getattr(k1, c) for c in counters}
    card = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                      device=cuda_device)
    moved = {c for c in counters if getattr(k1, c) > n0[c]}
    assert moved == {("masked", False): {"launches_t"},
                     ("masked", True): {"launches_qt"},
                     ("compact", True): {"launches_qwin"}}[(strategy,
                                                             quant)]
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
    # all of one sign. "cap" gives every block of the wrapper's grid (cut
    # to the blocks the card holds at once) a walk longer than
    # kMaxRowsPerBlock (~554M rows on an H100), so each block flushes its
    # words after a full chunk -- the widest fixed-point words it allows --
    # and again after the rest
    with open(os.path.join(build.CSRC, "histogram.cu")) as fh:
        cap = 1 << int(re.search(r"kMaxRowsPerBlock = 1ll << (\d+);",
                                 fh.read()).group(1))
    full = k1._grid_x(cuda_device, 1 << 40, k1._BLOCKS_PER_SM)
    p = 100_003 if size == "100k" else (full + 1) * cap
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
@pytest.mark.parametrize("case", ["wide F", "one block, chunked walk"])
def test_k1_wide_and_long_windows(cuda_device, case, monkeypatch):
    # shapes whose grid could not all be resident when the feature tiles
    # lay along the grid and a block walked at most the cap: 4,500
    # features of 256 bins (563 tiles walked in turn by every block), and
    # a grid of one block over 2^20 + 4,099 rows (17 chunks of at most
    # kMaxRowsPerBlock = 2^16, 17 flushes), which must give the bits of
    # the CPU model of the kernel (tests/test_torch_histogram.py)
    r = np.random.RandomState(len(case))
    if case == "wide F":
        p, f, nb = 20_003, 4_500, 256
    else:
        p, f, nb = (1 << 20) + 4_099, 28, 64
        monkeypatch.setattr(k1, "_grid_x", lambda dev, rows, per_sm: 1)
    codes = torch.from_numpy(r.randint(0, nb, size=(p, f))
                             .astype(np.uint8)).to(cuda_device)
    gh = torch.from_numpy(np.stack([r.randn(p), r.rand(p), np.ones(p)], 1)
                          .astype(np.float32)).to(cuda_device)
    gh[torch.from_numpy(r.rand(p) < 0.2).to(cuda_device)] = 0.0
    outs = [k1.build_histogram(codes, gh, nb) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    want = k1.build_histogram_plain(codes, gh, nb)
    mag = k1.build_histogram_plain(codes, gh.abs(), nb)
    assert _bar_ok(outs[0], want, mag)
    assert torch.equal(outs[0][..., 2], want[..., 2])
    if case == "wide F":
        assert int((outs[0] != want).sum()) <= want.numel() // 100
    else:
        from test_torch_histogram import _fixed_point_hist
        model, _, _ = _fixed_point_hist(codes.cpu(), gh.cpu(), nb, 1)
        assert torch.equal(outs[0].cpu(), model)


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


def _packed_rows_cap():
    """kMaxPackedRowsPerBlock of csrc/histogram.cu: the most rows a block
    of a packing integer kernel walks."""
    with open(os.path.join(build.CSRC, "histogram.cu")) as fh:
        text = fh.read()
    per = int(re.search(r"kMaxPackedRowsPerBlock = (\d+) \* kThreads;",
                        text).group(1))
    return per * int(re.search(r"constexpr int kThreads = (\d+);",
                               text).group(1))


def _quant_rows(device, w, item_bits, seed, c_cols=28):
    """(W, cw + 2) int32 rows as the compact core packs them: random code
    words (fields up to 2^item_bits - 1, so some codes fall past B), one
    (qg << 16 | qh) word of 16-bit stored integers, a row id."""
    r = np.random.RandomState(seed)
    cw = -(-c_cols // (32 // item_bits))
    words = r.randint(-2**31, 2**31, size=(w, cw), dtype=np.int64)
    q = r.randint(-32767, 32768, size=(w, 2))
    gh = quant_ops.pack_gh(torch.from_numpy(q[:, 0]),
                           torch.from_numpy(q[:, 1]))
    rows = torch.cat([torch.from_numpy(words.astype(np.int32)), gh[:, None],
                      torch.arange(w, dtype=torch.int32)[:, None]], dim=1)
    return rows.to(device), cw, c_cols


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [4, 8, 16])
@pytest.mark.parametrize("size", ["1", "31", "255", "256", "257", "R-1",
                                  "R", "R+1", "1M"])
def test_k3_packed_rows_entry_bit_exact(cuda_device, size, item_bits):
    # around one warp, one block's row stride and the rows-per-block cap R
    # of the packed words, and the root window; grad_bits 8 (int8 lanes,
    # packed words) and 16 (three words), at ratio 1 and at the root's
    # requant_ratio
    cap = _packed_rows_cap()
    w = {"1": 1, "31": 31, "255": 255, "256": 256, "257": 257,
         "R-1": cap - 1, "R": cap, "R+1": cap + 1, "1M": 1_000_003}[size]
    rows, cw, c_cols = _quant_rows(cuda_device, w, item_bits, w + item_bits)
    nb = {4: 16, 8: 64, 16: 256}[item_bits]
    qg, qh = quant_ops.unpack_gh(rows[:, cw])
    for grad_bits in (8, 16):
        qcap = quant_ops.quant_max(grad_bits, w)
        for ratios in ((torch.ones((), device=cuda_device),) * 2,
                       tuple(quant_ops.requant_ratio(m.float(), qcap)
                             for m in (qg.abs().max(), qh.abs().max()))):
            args = (rows, cw, c_cols, item_bits) + ratios + (
                qcap, grad_bits, nb)
            n0 = k1.launches_q
            got = k1.build_histogram_quantized_rows(*args)
            torch.cuda.synchronize()
            assert k1.launches_q == n0 + 1
            want = k1.build_histogram_quantized_rows_plain(*args)
            assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", ["qg=+cap", "qg=-cap", "qh=-cap"])
def test_k3_full_skew_packed_words(cuda_device, lanes):
    # every row of every block in one bin of each feature, each lane at
    # +-qcap_op (stored 16-bit integers clamped by the re-quantization), a
    # negative hessian included: the packed words at their widest; the
    # same through the int8 operand, with qh = -128 on every row
    w = 1_000_003
    qcap = quant_ops.quant_max(8, w)
    q = {"qg=+cap": (32767, 5), "qg=-cap": (-32767, 5),
         "qh=-cap": (3, -32767)}[lanes]
    rows, cw, c_cols = _quant_rows(cuda_device, w, 8, 1)
    rows[:, :cw] = 0x05050505
    rows[:, cw] = int(quant_ops.pack_gh(torch.tensor([q[0]]),
                                        torch.tensor([q[1]]))[0])
    one = torch.ones((), device=cuda_device)
    got = k1.build_histogram_quantized_rows(rows, cw, c_cols, 8, one, one,
                                            qcap, 8, 64)
    want = [max(-qcap, min(qcap, v)) * w for v in q] + [w]
    assert got[:, 5].tolist() == [want] * c_cols
    assert int(got.abs().sum()) == sum(abs(v) for v in want) * c_cols
    codes = torch.full((w, 28), 5, dtype=torch.uint8, device=cuda_device)
    ghq = torch.tensor([q[0] // abs(q[0]) * 127, -128, 1], dtype=torch.int8,
                       device=cuda_device).repeat(w, 1)
    got = k1.build_histogram_quantized(codes, ghq, 64)
    assert torch.equal(got, k1.build_histogram_quantized_plain(codes, ghq,
                                                               64))
    assert got[0, 5].tolist() == [q[0] // abs(q[0]) * 127 * w, -128 * w, w]


@pytest.mark.gpu
def test_k3_packed_rows_counting_and_refused_launch(cuda_device):
    # one launch counted per call, in launches_q only; none for an empty
    # window; a launch the kernel refuses (a bin count whose one-feature
    # tile exceeds a block's shared memory) raises and counts nothing
    names = ("launches", "launches_t", "launches_q", "launches_qt")
    one = torch.ones((), device=cuda_device)
    rows, cw, c_cols = _quant_rows(cuda_device, 300, 8, 2)
    n0 = {c: getattr(k1, c) for c in names}
    empty = k1.build_histogram_quantized_rows(rows[:0], cw, c_cols, 8, one,
                                              one, 127, 8, 64)
    assert not empty.any() and empty.shape == (c_cols, 64, 3)
    assert {c: getattr(k1, c) for c in names} == n0
    k1.build_histogram_quantized_rows(rows, cw, c_cols, 8, one, one, 127, 8,
                                      64)
    torch.cuda.synchronize()
    assert {c: getattr(k1, c) - n0[c] for c in names} == {
        c: int(c == "launches_q") for c in names}
    rows16, cw16, _ = _quant_rows(cuda_device, 300, 16, 3)
    with pytest.raises(RuntimeError, match="kernel launch"):
        k1.build_histogram_quantized_rows(rows16, cw16, 28, 16, one, one,
                                          127, 8, 1 << 20)
    codes = torch.zeros((300, 28), dtype=torch.uint8, device=cuda_device)
    ghq = torch.ones((300, 3), dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError, match="kernel launch"):
        k1.build_histogram_quantized(codes, ghq, 1 << 20)
    assert k1.launches_q == n0["launches_q"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 256, 257, 2048, 2049])
@pytest.mark.parametrize("num_bins,op_dtype,f", [
    (64, torch.int8, 28), (256, torch.int8, 40), (1024, torch.int32, 40)])
def test_k3_one_cluster_grids_store_every_word(cuda_device, p, num_bins,
                                               op_dtype, f):
    # the launcher owns the output's initialisation: a grid of one cluster
    # (up to 2,048 rows for the int8 operand, one block of 256 for the
    # int32 one) stores every output word, a larger one adds into what the
    # launcher zeroes first. The wrapper hands it memory it does not zero:
    # here memory the caching allocator hands back dirty. Several feature
    # tiles at 1,024 bins; K3 and K3t
    r = np.random.RandomState(p + num_bins)
    codes = torch.from_numpy(r.randint(0, num_bins, size=(p, f))) \
        .to(cuda_device, torch.int32)
    q = 127 if op_dtype == torch.int8 else 30_000
    ghq = torch.from_numpy(np.stack(
        [r.randint(-q, q + 1, p), r.randint(-q, q + 1, p), np.ones(p)],
        1)).to(cuda_device, op_dtype)
    want = k1.build_histogram_quantized_plain(codes, ghq, num_bins)
    for wrapper, c in ((k1.build_histogram_quantized, codes),
                       (k1.build_histogram_quantized_t,
                        codes.t().contiguous())):
        junk = torch.full((f, num_bins, 3), -7, dtype=torch.int32,
                          device=cuda_device)
        ptr = junk.data_ptr()
        del junk
        got = wrapper(c, ghq, num_bins)
        torch.cuda.synchronize()
        assert got.data_ptr() == ptr and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [2048, 2049, 1_000_003])
def test_k3_int8_valid_lane_any_value(cuda_device, p):
    # the contract takes any int8 operand: valid lanes other than 0 / 1
    # (2, -1, 127, -128; no caller builds them) count exactly, through
    # K3 and K3t, on a grid of one cluster (2,048 rows) and larger; and
    # every row in one bin with valid 127 (the third word at its widest)
    r = np.random.RandomState(p % 997)
    codes = torch.from_numpy(r.randint(0, 70, size=(p, 28))) \
        .to(cuda_device, torch.uint8)
    valid = np.where(r.rand(p) < 0.5, r.rand(p) < 0.8,
                     r.choice([2, -1, 127, -128], p))
    ghq = torch.from_numpy(np.stack(
        [r.randint(-128, 128, p), r.randint(-128, 128, p), valid], 1)
        .astype(np.int8)).to(cuda_device)
    ghq[torch.from_numpy(r.rand(p) < 0.1).to(cuda_device)] = 0
    want = k1.build_histogram_quantized_plain(codes, ghq, 64)
    assert torch.equal(k1.build_histogram_quantized(codes, ghq, 64), want)
    assert torch.equal(k1.build_histogram_quantized_t(
        codes.t().contiguous(), ghq, 64), want)
    skew = torch.tensor([-128, 127, 127], dtype=torch.int8,
                        device=cuda_device).repeat(p, 1)
    one_bin = torch.full((p, 28), 5, dtype=torch.uint8, device=cuda_device)
    got = k1.build_histogram_quantized(one_bin, skew, 64)
    assert got[:, 5].tolist() == [[-128 * p, 127 * p, 127 * p]] * 28
    assert int(got.abs().sum()) == 382 * p * 28


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [4, 8, 16])
def test_k3_row_slices_at_every_misalignment(cuda_device, item_bits):
    # the compact core's windows start at any row of its working buffer,
    # so the rows (and the codes and operand views K3 reads) start at every
    # 4-byte offset modulo 16 and end short of the buffer or at its end
    rows, cw, c_cols = _quant_rows(cuda_device, 40_000, item_bits, 11)
    nb = {4: 16, 8: 64, 16: 256}[item_bits]
    qcap = quant_ops.quant_max(8, 40_000)
    one = torch.ones((), device=cuda_device)
    ratio = quant_ops.requant_ratio(torch.tensor(20_000.0,
                                                 device=cuda_device), qcap)
    for begin in (0, 1, 2, 3, 5):
        for end in (begin + 9_001, 40_000):
            win = rows[begin:end]
            args = (win, cw, c_cols, item_bits, ratio, one, qcap, 8, nb)
            got = k1.build_histogram_quantized_rows(*args)
            assert torch.equal(
                got, k1.build_histogram_quantized_rows_plain(*args))
            if item_bits == 8:
                ghq = quant_ops.gh_operand_scaled(win[:, cw], None, 8, qcap,
                                                  ratio, one)
                codes = win.view(torch.uint8)[:, :c_cols]
                assert torch.equal(
                    k1.build_histogram_quantized(codes, ghq, nb),
                    k1.build_histogram_quantized_plain(codes, ghq, nb))
                # an operand that is itself a strided row slice
                wide = torch.zeros((end - begin + 7, 5), dtype=torch.int8,
                                   device=cuda_device)
                ghq_s = wide[3:3 + end - begin, 1:4]
                ghq_s.copy_(ghq)
                assert torch.equal(
                    k1.build_histogram_quantized(codes, ghq_s, nb),
                    k1.build_histogram_quantized_plain(codes, ghq, nb))


# ---- the compact core's device loop ---------------------------------------

def _buffers(device, n, d, seed):
    """Two (n, d) int32 working buffers of random words whose last column
    is the row id."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        b = torch.from_numpy(r.randint(-2**31, 2**31, size=(n, d),
                                       dtype=np.int64).astype(np.int32))
        b[:, d - 1] = torch.arange(n, dtype=torch.int32)
        out.append(b.to(device))
    return out


def _desc(device, **fields):
    d = torch.zeros(dsc.SIZE, dtype=torch.int32)
    for name, v in fields.items():
        d[getattr(dsc, name)] = int(v)
    return d.to(device)


# windows: (src, begin, count) in buffers of 300,007 rows
_WINDOWS = [(0, 0, 300_007), (1, 17, 1), (0, 1_001, 31), (1, 4_095, 257),
            (0, 123_457, 65_537)]


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [4, 8, 16])
@pytest.mark.parametrize("renew", [False, True])
def test_split_key_matches_plain(cuda_device, item_bits, renew):
    n, per = 300_007, 32 // item_bits
    data, spare = _buffers(cuda_device, n, 9, item_bits)
    r = np.random.RandomState(item_bits + renew)
    nb = min(1 << item_bits, 200)
    mixed = 0
    for i, (src, begin, count) in enumerate(_WINDOWS):
        elide = i % 2
        fields = dict(GO=1, SRC=src, BEGIN=begin, COUNT=count,
                      THR=r.randint(0, nb), DLEFT=i % 2,
                      COL=r.randint(0, 7 * per), BASE=r.randint(0, 5),
                      ELIDE=elide, NUMBINS=nb, MISSING=i % 3,
                      DEFAULT=r.randint(0, nb))
        got_d, want_d = _desc(cuda_device, **fields), _desc("cpu", **fields)
        got_k = torch.full((n,), -7, dtype=torch.int32, device=cuda_device)
        want_k = got_k.cpu()
        n0 = kkey.launches
        kkey.split_key(data, spare, got_d, got_k, item_bits=item_bits,
                       cw=7, renew=renew)
        torch.cuda.synchronize()
        assert kkey.launches == n0 + 1
        kkey.split_key_plain(data.cpu(), spare.cpu(), want_d, want_k,
                             item_bits=item_bits, cw=7, renew=renew)
        assert torch.equal(got_k.cpu(), want_k)
        assert torch.equal(got_d.cpu(), want_d)
        mixed += 0 < int(want_d[dsc.LPHYS]) < count
    assert mixed >= 2                  # windows with rows on both sides
    # GO = 0: nothing is written
    d0 = _desc(cuda_device, GO=0, SRC=0, BEGIN=0, COUNT=n, NUMBINS=nb)
    key = torch.full((n,), -7, dtype=torch.int32, device=cuda_device)
    kkey.split_key(data, spare, d0, key, item_bits=item_bits, cw=7,
                   renew=renew)
    assert torch.equal(d0.cpu(), _desc("cpu", GO=0, COUNT=n, NUMBINS=nb))
    assert bool((key == -7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [9, 11])
def test_k4_window_entry_bit_exact(cuda_device, d):
    n = 300_007
    r = np.random.RandomState(d)
    data, spare = _buffers(cuda_device, n, d, d)
    for src, begin, count in _WINDOWS + [(1, 0, 1)]:
        key = torch.from_numpy(r.randint(0, 2, size=n).astype(np.int32)) \
            .to(cuda_device)
        desc = _desc(cuda_device, GO=1, SRC=src, BEGIN=begin, COUNT=count)
        want = [data.cpu(), spare.cpu()]
        k4.stable_partition3_window_plain(want[0], want[1], key.cpu(),
                                          desc.cpu())
        n0 = k4.launches_win
        k4.stable_partition3_window(data, spare, key, desc)
        torch.cuda.synchronize()
        assert k4.launches_win == n0 + 1
        assert torch.equal(data.cpu(), want[0])
        assert torch.equal(spare.cpu(), want[1])
    before = (data.clone(), spare.clone())
    k4.stable_partition3_window(data, spare, key, _desc(
        cuda_device, GO=0, SRC=0, BEGIN=0, COUNT=n))
    assert torch.equal(data, before[0]) and torch.equal(spare, before[1])


def _window_descs(device):
    """Descriptors of split windows: (src, begin, count, lphys,
    left_small), the histogram reading buffer 1 - src."""
    for src, begin, count in _WINDOWS:
        for left_small in (0, 1):
            lphys = count // 3 if left_small else count - count // 3
            yield _desc(device, GO=1, SRC=src, BEGIN=begin, COUNT=count,
                        LPHYS=lphys, LEFT_SMALL=left_small)


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [4, 8, 16])
@pytest.mark.parametrize("grad_bits", [8, 16])
def test_k3_window_entry_bit_exact(cuda_device, item_bits, grad_bits):
    n = 300_007
    rows, cw, c_cols = _quant_rows(cuda_device, n, item_bits, item_bits)
    data = rows
    spare, _ = _quant_rows(cuda_device, n, item_bits, item_bits + 1)[:2]
    nb = {4: 16, 8: 64, 16: 256}[item_bits]
    qcap = quant_ops.quant_max(grad_bits, n)
    ratios = (torch.full((), 0.37, device=cuda_device),
              torch.full((), 0.0051, device=cuda_device))
    for desc in _window_descs(cuda_device):
        args = (cw, c_cols, item_bits) + ratios + (qcap, grad_bits, nb)
        n0 = k1.launches_qwin
        got = k1.build_histogram_quantized_window(data, spare, desc, *args)
        torch.cuda.synchronize()
        assert k1.launches_qwin == n0 + 1
        want = k1.build_histogram_quantized_window_plain(data, spare, desc,
                                                         *args)
        assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [4, 8, 16])
def test_k1_window_entry_matches_plain(cuda_device, item_bits):
    n = 300_007
    r = np.random.RandomState(item_bits)
    per = 32 // item_bits
    cw = -(-28 // per)
    bufs = _buffers(cuda_device, n, cw + 4, item_bits)
    for b in bufs:
        b.view(torch.float32)[:, cw:cw + 3] = torch.from_numpy(np.stack(
            [r.randn(n), r.rand(n), np.ones(n)], 1).astype(np.float32)) \
            .to(cuda_device)
    nb = {4: 16, 8: 64, 16: 256}[item_bits]
    for desc in _window_descs(cuda_device):
        n0 = k1.launches_win
        got = k1.build_histogram_window(bufs[0], bufs[1], desc, cw, 28,
                                        item_bits, nb)
        torch.cuda.synchronize()
        assert k1.launches_win == n0 + 1
        want = k1.build_histogram_window_plain(bufs[0], bufs[1], desc, cw,
                                               28, item_bits, nb)
        rows = k1.window_rows(bufs[0], bufs[1], desc.cpu())
        mag = k1.build_histogram_plain(
            k1.packed_codes(rows, cw, 28, item_bits),
            rows.view(torch.float32)[:, cw:cw + 3].abs(), nb)
        assert _bar_ok(got, want, mag)


@pytest.mark.gpu
def test_window_entries_replay_from_a_graph(cuda_device):
    # split key, K4 and K3's window entry captured once, then replayed
    # after the descriptor is rewritten: the cooperative and the cluster
    # launches record into the graph, and each replay reads the new window
    n = 300_007
    data, cw, c_cols = _quant_rows(cuda_device, n, 8, 3)
    spare = torch.empty_like(data)
    key = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    desc = _desc(cuda_device, GO=1, SRC=0, BEGIN=0, COUNT=n, THR=40,
                 COL=5, NUMBINS=64)
    one = torch.ones((), device=cuda_device)
    qcap = quant_ops.quant_max(8, n)

    def step():
        desc[dsc.LPHYS:dsc.LPHYS + 1].zero_()     # a fill, not a copy
        kkey.split_key(data, spare, desc, key, item_bits=8, cw=cw,
                       renew=False)
        k4.stable_partition3_window(data, spare, key, desc)
        return k1.build_histogram_quantized_window(
            data, spare, desc, cw, c_cols, 8, one, one, qcap, 8, 64)

    step()                                   # warm-up outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        hist = step()
    for src, begin, count in _WINDOWS[1:]:
        for t in (data, spare):
            t[:, cw + 1] = torch.arange(n, dtype=torch.int32,
                                        device=cuda_device)
        want = [data.cpu(), spare.cpu()]
        wdesc = _desc("cpu", GO=1, SRC=src, BEGIN=begin, COUNT=count,
                      THR=40, COL=5, NUMBINS=64, LEFT_SMALL=1)
        desc.copy_(wdesc.to(cuda_device))
        wkey = torch.zeros(n, dtype=torch.int32)
        kkey.split_key_plain(want[0], want[1], wdesc, wkey, item_bits=8,
                             cw=cw, renew=False)
        k4.stable_partition3_window_plain(want[0], want[1], wkey, wdesc)
        want_h = k1.build_histogram_quantized_window_plain(
            want[0], want[1], wdesc, cw, c_cols, 8, one.cpu(), one.cpu(),
            qcap, 8, 64)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(desc.cpu(), wdesc)
        assert torch.equal(data.cpu(), want[0])
        assert torch.equal(spare.cpu(), want[1])
        assert torch.equal(hist.cpu(), want_h)


def _compact_learner(device, n, params, seed=9, strategy="compact"):
    """A learner of `strategy` over n rows of 12 features, and fixed
    gradients with signal, on `device`."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 12)
    x[r.rand(n) < 0.03, 2] = np.nan
    params = dict({"objective": "binary", "num_leaves": 31, "max_bin": 63,
                   "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
                   "verbosity": -1}, **params)
    ds = tlgb.Dataset(x, (x[:, 0] > 0).astype(float), params=params) \
        .construct()._inner
    lr = tdl.DeviceTreeLearner(Config(params), ds, strategy=strategy,
                               device=device)
    g = (x[:, 0] > 0.3) - 0.5 + 0.3 * r.randn(n) \
        + 0.2 * np.nan_to_num(x[:, 2])
    h = 0.1 + r.rand(n)
    return lr, (torch.from_numpy(g.astype(np.float32)).to(device),
                torch.from_numpy(h.astype(np.float32)).to(device))


class _L2:
    """L2 gradients towards the labels y (a device tensor)."""

    def __init__(self, y):
        self.y = y

    def get_gradients(self, score):
        return score - self.y, torch.ones_like(score)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_compact_tree_grows_without_a_host_sync(cuda_device, quant):
    # a tree, and a fused boosting iteration, under the sync debug mode
    # "error": any device->host copy or synchronisation inside raises
    lr, (g, h) = _compact_learner(cuda_device, 70_000,
                                  {"quantized_grad": quant})
    lr.grow(g, h, iter_seed=0)          # captures the step (synchronises)
    step = lr.make_fused_step(_L2(g))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec, leaf_id, k = lr.grow_compact(g, h, iter_seed=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rec_h, k, _ = lr.fetch_tree(rec, k)
    assert k == 30 and int(leaf_id.max()) == 30
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_score, rec, leaf_id, k, finite = step(torch.zeros_like(g), 2,
                                                  0.1, 0.25)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert lr.fetch_tree(rec, k, finite)[1:] == (30, [1.0])
    assert int(leaf_id.max()) == 30


@pytest.mark.gpu
@pytest.mark.parametrize("renew", [False, True])
@pytest.mark.parametrize("grad_bits", [8, 16])
def test_quantized_device_loop_equals_host_loop(cuda_device, renew,
                                                grad_bits):
    # from the same gradients on the card: the device loop's records and
    # leaf ids equal the host loop's (integer histograms, exact partition)
    lr, (g, h) = _compact_learner(
        cuda_device, 70_000, {"quantized_grad": True, "grad_bits": grad_bits,
                              "quant_renew": renew})
    for seed in (0, 1):
        rec, leaf, k = lr.grow(g, h, iter_seed=seed)
        data, quant = lr.quant_working_buffer(g, h, tdl.trandom.prng_key(
            seed))
        hrec, hleaf, hk = tdl.grow_tree_compact_core(
            data, torch.empty_like(data), lr._ones_mask, lr.meta,
            c_cols=lr.c_cols, item_bits=lr.item_bits, quant=quant,
            **lr._statics())
        assert k == hk == 30
        np.testing.assert_array_equal(rec, hrec)
        assert torch.equal(leaf, hleaf)


@pytest.mark.gpu
@pytest.mark.parametrize("op", [torch.float32, torch.int8, torch.int32])
@pytest.mark.parametrize("code_bits", [8, 16])
@pytest.mark.parametrize("n", [60_000, 1_000_000, 100_003])
def test_split_key_column_matches_plain(cuda_device, n, code_bits, op):
    # the masked core's column entry: leaf ids and the left operand bit
    # for bit (an f32 operand compared as its int32 words), an EFB member
    # and a plain feature, each missing type, and GO = 0
    r = np.random.RandomState(n % 997 + code_bits)
    c, nb = 6, 200
    codes = r.randint(0, 2 * nb, size=(c, n))
    if code_bits == 16:
        # a tenth of the codes above 32767: negative as int16
        big = r.rand(c, n) < 0.1
        codes[big] = r.randint(32_768, 65_536, int(big.sum()))
    codes_t = torch.from_numpy(codes.astype(np.uint8) if code_bits == 8
                               else codes.astype(np.uint16).view(np.int16)) \
        .to(cuda_device)
    leaf0 = torch.from_numpy(r.randint(0, 5, n).astype(np.int32)) \
        .to(cuda_device)
    if op == torch.float32:
        gh = torch.from_numpy(r.randn(n, 3).astype(np.float32))
    else:
        gh = torch.from_numpy(r.randint(-127, 128, (n, 3))).to(op)
    gh = gh.to(cuda_device)
    mixed = 0
    for i in range(6):
        fields = dict(GO=1, THR=r.randint(0, nb), DLEFT=i % 2,
                      COL=r.randint(0, c), BASE=r.randint(0, 40),
                      ELIDE=i % 2, NUMBINS=nb, MISSING=i % 3,
                      DEFAULT=r.randint(0, nb), LEAF=i % 5, NEW_ID=5 + i)
        desc = _desc(cuda_device, **fields)
        got_l, want_l = leaf0.clone(), leaf0.clone()
        got_g = torch.full_like(gh, 7)
        want_g = got_g.clone()
        n0 = kkey.launches_col
        kkey.split_key_column(codes_t, desc, got_l, gh, got_g)
        torch.cuda.synchronize()
        assert kkey.launches_col == n0 + 1
        kkey.split_key_column_plain(codes_t, desc, want_l, gh, want_g)
        assert torch.equal(got_l, want_l)
        mixed += 0 < int((got_l != leaf0).sum()) \
            < int((leaf0 == i % 5).sum())
        words = (lambda t: t.view(torch.int32)) if op == torch.float32 \
            else (lambda t: t)
        assert torch.equal(words(got_g), words(want_g))
    assert mixed >= 3                  # splits with rows on both sides
    before = (got_l.clone(), got_g.clone())
    kkey.split_key_column(codes_t, _desc(cuda_device, GO=0, LEAF=0,
                                         NEW_ID=9), got_l, gh, got_g)
    torch.cuda.synchronize()
    assert torch.equal(got_l, before[0]) and torch.equal(got_g, before[1])


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_masked_captured_tree_matches_cpu(cuda_device, quant):
    # the masked core's captured step on the card against the same step
    # run eagerly on the CPU from the same gradients: leaf, feature and
    # count columns and leaf ids equal; K2 and the split scan's prefix
    # sums add f32 in another order, so the children's sums are held to
    # K1's bar, the outputs within 1e-4, and the gain, a difference of
    # terms G^2 / H far larger than itself, within 1e-4 of those terms.
    # Quantized, records equal to the masked host loop's on the card bit
    # for bit (exact integer histograms)
    params = {"quantized_grad": quant, "min_gain_to_split": 1e-3}
    lr, (g, h) = _compact_learner(cuda_device, 20_000, params,
                                  strategy="masked")
    cpu, _ = _compact_learner("cpu", 20_000, params, strategy="masked")
    ints = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_LCNT, tdl.R_RCNT]
    floats = [tdl.R_LOUT, tdl.R_ROUT]
    gmax, hmax = float(g.abs().max()), float(h.abs().max())
    for seed in (0, 1):
        rec, leaf, k = lr.grow(g, h, iter_seed=seed)
        crec, cleaf, ck = cpu.grow(g.cpu(), h.cpu(), iter_seed=seed)
        assert k == ck == 30
        np.testing.assert_array_equal(rec[:, ints], crec[:, ints])
        # a child's sums come from the parent's histogram (the right
        # child's as parent - left): K1's bar, 1e-4 relative plus 1e-5 of
        # the parent's sum of |terms|, which its count * max|term| bounds
        parent = crec[:, tdl.R_LCNT] + crec[:, tdl.R_RCNT]
        for col, top in ((tdl.R_LSG, gmax), (tdl.R_LSH, hmax),
                         (tdl.R_RSG, gmax), (tdl.R_RSH, hmax)):
            assert (np.abs(rec[:, col] - crec[:, col])
                    <= 1e-4 * np.abs(crec[:, col])
                    + 1e-5 * parent * top).all(), col
        np.testing.assert_allclose(rec[:, floats], crec[:, floats],
                                   rtol=1e-4, atol=1e-4)
        terms = crec[:, tdl.R_LSG] ** 2 / crec[:, tdl.R_LSH] \
            + crec[:, tdl.R_RSG] ** 2 / crec[:, tdl.R_RSH]
        assert (np.abs(rec[:, tdl.R_GAIN] - crec[:, tdl.R_GAIN])
                <= 1e-4 * (1.0 + terms)).all()
        assert torch.equal(leaf.cpu(), cleaf)
        if quant:
            gh, scale3 = lr.masked_operand(g, h, seed)
            hrec, hleaf, hk = tdl.grow_tree(lr.codes_t, gh, lr._ones_mask,
                                            lr.meta, scale3=scale3,
                                            **lr._statics())
            assert hk == k
            np.testing.assert_array_equal(rec, hrec)
            assert torch.equal(leaf, hleaf)
    assert lr._loop.graph is not None


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_masked_tree_grows_without_a_host_sync(cuda_device, quant):
    # a masked tree, and a fused iteration on it, under the sync debug
    # mode "error"; a tree that stops early (large min_gain_to_split)
    # replays the remaining steps with nothing written
    lr, (g, h) = _compact_learner(cuda_device, 20_000,
                                  {"quantized_grad": quant},
                                  strategy="masked")
    lr.grow(g, h, iter_seed=0)          # captures the step (synchronises)
    step = lr.make_fused_step(_L2(g))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec, leaf_id, k = lr.grow_masked(g, h, iter_seed=1)
        new_score, rec2, leaf2, k2, finite = step(torch.zeros_like(g), 2,
                                                  0.1, 0.25)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert lr.fetch_tree(rec2, k2, finite)[1:] == (30, [1.0])
    assert int(leaf2.max()) == 30
    early, (g, h) = _compact_learner(
        cuda_device, 20_000, {"quantized_grad": quant,
                              "min_gain_to_split": 30.0}, strategy="masked")
    rec, leaf, k = early.grow(g, h, iter_seed=0)
    assert 1 < k < 30 and not rec[k:].any()
    assert int(leaf.max()) == k


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_masked_launches_per_replay(cuda_device, quant):
    # the captured step launches the column split key and K2 (or K3t)
    # once each; a tree adds them per replay, plus the root's K2 / K3t,
    # and nothing of the compact core's kernels
    lr, (g, h) = _compact_learner(cuda_device, 20_000,
                                  {"quantized_grad": quant},
                                  strategy="masked")
    lr.grow(g, h, iter_seed=0)
    hist = "launches_qt" if quant else "launches_t"
    other = "launches_t" if quant else "launches_qt"
    assert {k.rsplit(".", 1)[-1]: v
            for k, v in lr._loop.launches_per_step.items()} == {
        "launches_col": 1, hist: 1, other: 0}
    names = ("launches", "launches_win", "launches_qwin", "launches_q")
    n0 = (kkey.launches_col, getattr(k1, hist), getattr(k1, other),
          kkey.launches, k4.launches_win, k4.launches,
          [getattr(k1, a) for a in names])
    lr.grow(g, h, iter_seed=1)
    torch.cuda.synchronize()
    assert kkey.launches_col - n0[0] == 30
    assert getattr(k1, hist) - n0[1] == 31
    assert (getattr(k1, other), kkey.launches, k4.launches_win,
            k4.launches, [getattr(k1, a) for a in names]) == n0[2:]


@pytest.mark.gpu
def test_capture_after_a_dropped_learner(cuda_device):
    # a dropped learner frees its CUDA graph at once (no reference cycle
    # leaves it to the cyclic collector, which could free it while the
    # next learner captures), and the next learner captures and grows
    for strategy in ("masked", "compact"):
        old, (g, h) = _compact_learner(cuda_device, 70_000, {},
                                       strategy=strategy)
        old.grow(g, h)
        assert old._loop.graph is not None
        gone = weakref.ref(old)
        del old
        assert gone() is None
        new, _ = _compact_learner(cuda_device, 70_000, {},
                                  strategy=strategy)
        rec, leaf, k = new.grow(g, h)
        assert k == 30 and new._loop.graph is not None and gc.isenabled()


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [4, 8, 16])
@pytest.mark.parametrize("m", [200_000, 100_003])
def test_route_rows_matches_plain(cuda_device, item_bits, m):
    # the router over random packed rows and random records of a 255-leaf
    # tree (k = 0: every row in leaf 0; k = 254: every record), bit-exact
    r = np.random.RandomState(item_bits + m)
    per, nb = 32 // item_bits, 1 << item_bits
    cw, f, L = 7, 28, 255
    rows = torch.from_numpy(r.randint(-2**31, 2**31, size=(m, cw),
                                      dtype=np.int64).astype(np.int32))
    f_numbins = r.randint(3, min(nb, 256), f)
    f_elide = np.arange(f) % 3 == 0
    table = torch.from_numpy(np.stack([
        r.randint(0, cw * per, f), np.where(f_elide, r.randint(0, nb // 2, f),
                                            0),
        f_elide, f_numbins, np.arange(f) % 3,
        r.randint(0, 100, f) % f_numbins], axis=1).astype(np.int32))
    rec = np.zeros((L - 1, 13), np.float32)
    feats = r.randint(0, f, L - 1)
    rec[:, tdl.R_LEAF] = [r.randint(0, i + 1) for i in range(L - 1)]
    rec[:, tdl.R_FEAT] = feats
    rec[:, tdl.R_THR] = r.randint(0, f_numbins[feats])
    rec[:, tdl.R_DLEFT] = r.randint(0, 2, L - 1)
    dev = [t.to(cuda_device) for t in (rows, torch.from_numpy(rec), table)]
    for k in (0, L - 1):
        kt = torch.tensor(k, dtype=torch.int32)
        n0 = kkey.launches_route
        got = kkey.route_rows(dev[0], dev[1], kt.to(cuda_device), dev[2],
                              item_bits=item_bits)
        torch.cuda.synchronize()
        assert kkey.launches_route == n0 + 1
        want = kkey.route_rows_plain(rows, torch.from_numpy(rec), kt, table,
                                     item_bits=item_bits)
        assert torch.equal(got.cpu(), want)
        assert (k == 0) == (not bool(want.any()))


def _bag(device, n, frac, seed):
    """A fused iteration's bag of n rows: (bag_idx, oob_idx) on device,
    the in-bag rows first in row order."""
    bag_k = max(1, int(n * frac))
    w = tdl.exact_k_bag_weights(tdl.trandom.prng_key(seed), n, bag_k, device)
    order = torch.argsort((w <= 0).to(torch.int32), stable=True)
    return order[:bag_k], order[bag_k:]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_bag_carry_captured_tree_matches_cpu(cuda_device, quant):
    # the bag's carry, captured on the card, against the same step run
    # eagerly on the CPU from the same gradients and bag: leaf, feature
    # and count columns equal, the outputs within 1e-4 and the gain within
    # 1e-4 of its terms (the split scan's prefix sums and K1 add in
    # another order), every row's leaf
    # equal (the out-of-bag rows' from the router on the card and its
    # plain version on the CPU)
    params = {"quantized_grad": quant, "bagging_fraction": 0.7,
              "bagging_freq": 1}
    lr, (g, h) = _compact_learner(cuda_device, 70_000, params)
    cpu, _ = _compact_learner("cpu", 70_000, params)
    ints = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_LCNT, tdl.R_RCNT]
    floats = [tdl.R_LOUT, tdl.R_ROUT]
    for seed in (0, 1):
        bag_idx, oob_idx = _bag(cuda_device, 70_000, 0.7, seed)
        rec, leaf, k = lr.grow_compact(g, h, seed, bag_idx, oob_idx)
        rec_h, k, _ = lr.fetch_tree(rec, k)
        crec, cleaf, ck = cpu.grow_compact(g.cpu(), h.cpu(), seed,
                                           bag_idx.cpu(), oob_idx.cpu())
        crec_h, ck, _ = cpu.fetch_tree(crec, ck)
        assert k == ck == 30
        np.testing.assert_array_equal(rec_h[:, ints], crec_h[:, ints])
        np.testing.assert_allclose(rec_h[:, floats], crec_h[:, floats],
                                   rtol=1e-4, atol=1e-4)
        # the gain, a difference of terms G^2 / H far larger than itself,
        # within 1e-4 of those terms (test_masked_captured_tree_matches_cpu)
        terms = crec_h[:, tdl.R_LSG] ** 2 / crec_h[:, tdl.R_LSH] \
            + crec_h[:, tdl.R_RSG] ** 2 / crec_h[:, tdl.R_RSH]
        assert (np.abs(rec_h[:, tdl.R_GAIN] - crec_h[:, tdl.R_GAIN])
                <= 1e-4 * (1.0 + terms)).all()
        assert crec_h[0, tdl.R_LCNT] + crec_h[0, tdl.R_RCNT] == 49_000
        assert torch.equal(leaf.cpu(), cleaf)
    # the bag's carry, the only one made
    assert list(lr._states) == [(49_000, quant_ops.quant_max(8, 49_000)
                                 if quant else 0)]
    assert lr._loop.graph is not None


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_bagged_iteration_without_a_host_sync(cuda_device, strategy):
    # a bagged fused iteration and a GOSS one under the sync debug mode
    # "error": the bag drawn, gathered (compact: the bag's carry and the
    # router; masked: the weighted operand), the tree, the score update
    lr, (g, h) = _compact_learner(cuda_device, 70_000,
                                  {"bagging_fraction": 0.8,
                                   "bagging_freq": 1}, strategy=strategy)
    bag_step = lr.make_fused_step(_L2(g))
    goss_step = lr.make_fused_step(_L2(g), goss=(14_000, 7_000, 8.0))
    score = torch.zeros_like(g)
    for step in (bag_step, goss_step):
        step(score, 0, 0.1, 0.25, 3)    # captures the carry's step
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            new_score, rec, leaf_id, k, finite = step(score, 1, 0.1, 0.25, 4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert lr.fetch_tree(rec, k, finite)[1:] == (30, [1.0])
        assert int(leaf_id.max()) == 30 and int(leaf_id.min()) == 0
    if strategy == "compact":
        # the two bags' carries
        assert sorted(lr._states) == [(21_000, 0), (56_000, 0)]


@pytest.mark.gpu
def test_bag_launches_per_replay(cuda_device):
    # the bag's captured step launches what the full carry's does: the
    # split key, K4's and K1's window entries once each; a bagged tree
    # adds them per replay, plus the root's K1 and one router launch
    lr, (g, h) = _compact_learner(cuda_device, 70_000, {})
    lr.grow(g, h, iter_seed=0)
    full = dict(lr._loop.launches_per_step)
    bag_idx, oob_idx = _bag(cuda_device, 70_000, 0.6, 0)
    lr.grow_compact(g, h, 0, bag_idx, oob_idx)
    assert lr._loop.launches_per_step == full
    assert {k.rsplit(".", 1)[-1]: v for k, v in full.items()} == {
        "launches": 1, "launches_win": 1, "launches_qwin": 0}
    n0 = (kkey.launches, k4.launches_win, k1.launches_win,
          kkey.launches_route, k1.launches_qwin, k4.launches, k1.launches)
    rec, leaf, k = lr.grow_compact(g, h, 1, bag_idx, oob_idx)
    torch.cuda.synchronize()
    assert (kkey.launches - n0[0], k4.launches_win - n0[1],
            k1.launches_win - n0[2], kkey.launches_route - n0[3]) \
        == (30, 30, 31, 1)
    assert (k1.launches_qwin, k4.launches, k1.launches) == n0[4:]


def _valid_task(n, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8)
    x[r.rand(n) < 0.03, 2] = np.nan
    y = (x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 3] * x[:, 4]
         + 0.5 * r.randn(n) > 0).astype(np.float64)
    return x, y


def _higgs_like(n, seed, w=None):
    # chip_smoke.py's generator: 28 features, informative and noise
    r = np.random.RandomState(seed)
    x = r.randn(n, 28).astype(np.float32)
    if w is None:
        w = r.randn(28) * (r.rand(28) > 0.4)
    logit = x @ w * 0.3 + 0.2 * x[:, 0] * x[:, 1] - 0.1 * x[:, 2] ** 2
    return x, (logit + r.randn(n) * 1.5 > 0).astype(np.float64), w


def _f32_threshold_rows(inner, x):
    # chip_smoke.py's f32_threshold_rows: rows between a bin's f64 upper
    # bound (where the bins split) and its f32 rounding (what predict
    # compares with)
    out = np.zeros(len(x), bool)
    for f, mapper in enumerate(inner.bin_mappers):
        ub = np.asarray(mapper.bin_upper_bound, dtype=np.float64)[:-1]
        ub32 = ub.astype(np.float32).astype(np.float64)
        keep = ub != ub32
        lo, hi = np.minimum(ub, ub32)[keep], np.maximum(ub, ub32)[keep]
        if len(hi):
            col = x[:, f].astype(np.float64)
            i = np.minimum(np.searchsorted(hi, col), len(hi) - 1)
            out |= (col > lo[i]) & (col <= hi[i])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_valid_set_and_early_stopping_card_matches_cpu(cuda_device,
                                                       strategy,
                                                       monkeypatch):
    # chip_smoke's reference run at test size: a validation set binned by
    # reference and early stopping on the fused iteration (learning_rate
    # 0.5 overfits the 31-leaf trees within the rounds); the same best
    # iteration and eval history as on the CPU, the validation scores
    # equal predict, 1 learner sync per tree (the validation update adds
    # none). Each iteration past the first few risks a gain near-tie
    # that the card's f32 sums break the other way (ROADMAP section 3),
    # so the run is kept as short as the reference phase's.
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    xt, yt, w = _higgs_like(20_000, 99)
    xv, yv, _ = _higgs_like(5_000, 100, w)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "learning_rate": 0.5, "min_data_in_leaf": 20,
         "min_gain_to_split": 1e-3, "metric": ["binary_logloss", "auc"],
         "verbosity": -1}
    out = []
    for device in ("cuda", "cpu"):
        ds = tlgb.Dataset(xt, yt)
        ev = {}
        b = tlgb.train(p, ds, 40, valid_sets=[ds.create_valid(xv, yv)],
                       valid_names=["v"], evals_result=ev,
                       early_stopping_rounds=5, verbose_eval=False,
                       device=device)
        out.append((b, ev))
    (card, cev), (cpu, pev) = out
    assert 1 <= card.best_iteration == cpu.best_iteration < 35
    for d in pev:
        for m in pev[d]:
            np.testing.assert_allclose(cev[d][m], pev[d][m], rtol=1e-4,
                                       atol=1e-4)
    gb = card._gbdt
    assert gb.learner.stats.host_syncs == gb.learner.stats.trees
    moved = _f32_threshold_rows(gb.learner.dataset, xv)
    assert moved.mean() < 0.01
    np.testing.assert_allclose(
        gb.valid_updaters[0].score[0].cpu().numpy()[~moved],
        card.predict(xv, raw_score=True, num_iteration=-1)[~moved],
        rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_reset_parameter_recaptures_on_card(cuda_device, strategy,
                                            monkeypatch):
    # lambda_l2 changes at iteration 2: the learner frees its captured
    # loop and captures a new one at the next tree (one more capture),
    # and the card's trees equal the CPU's
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y = _valid_task(70_000, 5)
    p = {"objective": "binary", "num_leaves": 15, "lambda_l2": 0.0,
         "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "verbosity": -1}
    out = []
    for device in ("cuda", "cpu"):
        captures = []
        b = tlgb.train(p, tlgb.Dataset(x, y), 5, device=device,
                       callbacks=[
                           tlgb.reset_parameter(
                               lambda_l2=[0.0, 0.0, 50.0, 50.0, 50.0]),
                           lambda env: captures.append(
                               env.model._gbdt.learner.stats.captures)])
        out.append(b)
        assert captures == [1, 1, 2, 2, 2]
    card, cpu = out
    assert card._gbdt.learner._loop.graph is not None
    def shape(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.threshold_in_bin[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves])) for t in b._gbdt.models]
    assert shape(card) == shape(cpu)
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cv_card_matches_cpu(cuda_device):
    # three learners capture their loops in turn, between the others'
    # replays
    x, y = _valid_task(30_000, 5)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "metric": ["binary_logloss", "auc"], "verbosity": -1}
    card = tlgb.cv(p, tlgb.Dataset(x, y), 3, nfold=3,
                   return_cvbooster=True)
    cpu = tlgb.cv(p, tlgb.Dataset(x, y), 3, nfold=3, device="cpu")
    boosters = card.pop("cvbooster").boosters
    assert sorted(card) == sorted(cpu)
    for key in cpu:
        np.testing.assert_allclose(card[key], cpu[key], rtol=1e-4,
                                   atol=1e-4)
    assert all(b._gbdt.learner._loop.graph is not None for b in boosters)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["host-int", "device-window", "K2"])
def test_k1_k2_repeat_bit_for_bit(cuda_device, entry):
    # the blocks' fixed-point sums meet in an int64 accumulator, which no
    # order of the blocks changes, and round once: 20 launches on one
    # input give the same bits, and nearly every slot equals the plain
    # version's f64 sum rounded once
    n = 300_007
    r = np.random.RandomState(21)
    bufs = _buffers(cuda_device, n, 11, 21)
    for b in bufs:
        b.view(torch.float32)[:, 7:10] = torch.from_numpy(np.stack(
            [r.randn(n), r.rand(n), np.ones(n)], 1).astype(np.float32)) \
            .to(cuda_device)
    codes = bufs[0].view(torch.uint8)[:, :28]
    gh = bufs[0].view(torch.float32)[:, 7:10]
    if entry == "host-int":
        def run():
            return k1.build_histogram(codes, gh, 64)
        want = k1.build_histogram_plain(codes, gh, 64)
    elif entry == "device-window":
        desc = _desc(cuda_device, GO=1, SRC=1, BEGIN=0, COUNT=n, LPHYS=n,
                     LEFT_SMALL=1)

        def run():
            return k1.build_histogram_window(bufs[0], bufs[1], desc, 7, 28,
                                             8, 64)
        want = k1.build_histogram_window_plain(bufs[0], bufs[1], desc, 7,
                                               28, 8, 64)
    else:
        codes_t = codes.t().contiguous()
        gh_half = gh.contiguous() * torch.from_numpy(
            r.rand(n) < 0.5).to(cuda_device)[:, None].float()

        def run():
            return k1.build_histogram_t(codes_t, gh_half, 64)
        want = k1.build_histogram_t_plain(codes_t, gh_half, 64)
    outs = [run() for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert int((outs[0] != want).sum()) <= want.numel() // 100
    assert torch.equal(outs[0][..., 2], want[..., 2])


def _objective_task(objective, n, seed):
    """(x, y): chip_smoke.py's targets for each objective from one margin."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 12)
    margin = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 3] * x[:, 4]
    if objective == "poisson":
        y = r.poisson(np.exp(0.5 * margin)).astype(np.float64)
    elif objective == "multiclass":
        y = np.digitize(margin + 0.5 * r.randn(n), [-1.0, 1.0]) \
            .astype(np.float64)
    else:
        y = margin + 1.5 * r.randn(n)
    return x, y


def _shape(b):
    # features, children and leaf counts (chip_smoke.py's shape_of): where
    # a leaf has no row in the bins between two thresholds both split it
    # alike and f32 rounding picks one on each device (ROADMAP section 3)
    return [(list(t.split_feature[:t.num_leaves - 1]),
             list(t.left_child[:t.num_leaves - 1]),
             list(t.leaf_count[:t.num_leaves])) for t in b._gbdt.models]


@pytest.mark.gpu
@pytest.mark.parametrize("objective", ["regression_l1", "poisson"])
def test_objective_card_matches_cpu(cuda_device, objective, monkeypatch):
    # regression_l1 renews its leaves on the host (the generic iteration,
    # 2 learner syncs per tree: the records and the leaf map); poisson
    # runs the fused iteration (1): the card's trees are the CPU's
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y = _objective_task(objective, 20_000, 31)
    p = {"objective": objective, "num_leaves": 15, "max_bin": 63,
         "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "verbosity": -1}
    card, cpu = (tlgb.train(p, tlgb.Dataset(x, y), 5, device=d)
                 for d in ("cuda", "cpu"))
    lr = card._gbdt.learner
    renew = objective == "regression_l1"
    assert (card._gbdt._fused_step is None) == renew
    assert lr.stats.host_syncs == (2 if renew else 1) * lr.stats.trees
    assert _shape(card) == _shape(cpu)
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_multiclass_card_matches_cpu(cuda_device, strategy, monkeypatch):
    # 3 classes on the per-class loop: one learner grows all three trees
    # of an iteration in its device loop, capturing its step once
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y = _objective_task("multiclass", 20_000, 32)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
         "max_bin": 63, "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "verbosity": -1}
    card, cpu = (tlgb.train(p, tlgb.Dataset(x, y), 4, device=d)
                 for d in ("cuda", "cpu"))
    lr = card._gbdt.learner
    assert card.num_trees() == cpu.num_trees() == 12
    assert lr.stats.captures == 1 and lr.stats.trees == 12
    assert lr.stats.host_syncs == lr.stats.trees
    assert _shape(card) == _shape(cpu)
    got = card.predict(x)
    assert got.shape == (20_000, 3)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, cpu.predict(x), rtol=1e-4, atol=1e-4)


def _cat_desc(device, words, **fields):
    """A categorical split's descriptor: the fields, CAT = 1 and the
    bitset words after them."""
    d = torch.zeros(dsc.size(len(words)), dtype=torch.int32)
    for name, v in fields.items():
        d[getattr(dsc, name)] = int(v)
    d[dsc.CAT] = 1
    d[dsc.WORDS:] = torch.as_tensor(np.asarray(words, np.int64)
                                    .astype(np.uint32).view(np.int32))
    return d.to(device)


def _bitsets(r, n_words):
    """Bitsets of n_words words: every bit set, none, and a random one."""
    return [np.full(n_words, 0xFFFFFFFF, np.int64),
            np.zeros(n_words, np.int64),
            r.randint(0, 2**32, n_words, dtype=np.int64)]


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [8, 16])
@pytest.mark.parametrize("n_words", [2, 8])
def test_split_key_categorical_matches_plain(cuda_device, item_bits,
                                             n_words):
    # the packed entry with a categorical descriptor: a row goes left iff
    # its logical bin's bit is set (bins past the words go right), over
    # an EFB member and a plain feature; key, left count bit-exact
    n, per = 300_007, 32 // item_bits
    data, spare = _buffers(cuda_device, n, 9, item_bits)
    r = np.random.RandomState(item_bits * 10 + n_words)
    nb = min(32 * n_words, 1 << item_bits)
    for i, words in enumerate(_bitsets(r, n_words)):
        for elide in (0, 1):
            src, begin, count = _WINDOWS[(i + elide) % len(_WINDOWS)]
            fields = dict(GO=1, SRC=src, BEGIN=begin, COUNT=count,
                          COL=r.randint(0, 7 * per), BASE=r.randint(0, 5),
                          ELIDE=elide, NUMBINS=nb, MISSING=2,
                          DEFAULT=r.randint(0, nb))
            got_d = _cat_desc(cuda_device, words, **fields)
            want_d = _cat_desc("cpu", words, **fields)
            got_k = torch.full((n,), -7, dtype=torch.int32,
                               device=cuda_device)
            want_k = got_k.cpu()
            kkey.split_key(data, spare, got_d, got_k, item_bits=item_bits,
                           cw=7, renew=True)
            kkey.split_key_plain(data.cpu(), spare.cpu(), want_d, want_k,
                                 item_bits=item_bits, cw=7, renew=True)
            assert torch.equal(got_k.cpu(), want_k)
            assert torch.equal(got_d.cpu(), want_d)
            if i == 1:
                assert int(want_d[dsc.LPHYS]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("code_bits", [8, 16])
@pytest.mark.parametrize("n_words", [2, 8])
def test_split_key_column_categorical_matches_plain(cuda_device, code_bits,
                                                    n_words):
    # the column entry with a categorical descriptor: leaf ids and the
    # left operand bit for bit
    r = np.random.RandomState(code_bits + n_words)
    c, n = 6, 100_003
    hi = 1 << code_bits
    codes = r.randint(0, min(hi, 40 * n_words), size=(c, n))
    codes_t = torch.from_numpy(codes.astype(np.uint8) if code_bits == 8
                               else codes.astype(np.uint16).view(np.int16)) \
        .to(cuda_device)
    leaf0 = torch.from_numpy(r.randint(0, 3, n).astype(np.int32)) \
        .to(cuda_device)
    gh = torch.from_numpy(r.randn(n, 3).astype(np.float32)).to(cuda_device)
    for i, words in enumerate(_bitsets(r, n_words)):
        for elide in (0, 1):
            desc = _cat_desc(cuda_device, words, GO=1, COL=r.randint(0, c),
                             BASE=r.randint(0, 9), ELIDE=elide,
                             NUMBINS=32 * n_words, MISSING=0,
                             DEFAULT=r.randint(0, 32), LEAF=i % 3,
                             NEW_ID=4)
            got_l, want_l = leaf0.clone(), leaf0.clone()
            got_g = torch.full_like(gh, 7)
            want_g = got_g.clone()
            kkey.split_key_column(codes_t, desc, got_l, gh, got_g)
            kkey.split_key_column_plain(codes_t, desc, want_l, gh, want_g)
            assert torch.equal(got_l, want_l)
            assert torch.equal(got_g.view(torch.int32),
                               want_g.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("item_bits", [8, 16])
@pytest.mark.parametrize("n_words", [2, 8, 32])
def test_route_rows_categorical_matches_plain(cuda_device, item_bits,
                                              n_words):
    # the router with categorical records (half the features categorical,
    # each record's bitset staged beside it): bit-exact; W = 32 (1,024
    # bins) stages fewer records per pass
    r = np.random.RandomState(item_bits + n_words)
    per, m, cw, f, L = 32 // item_bits, 100_003, 7, 28, 255
    rows = torch.from_numpy(r.randint(-2**31, 2**31, size=(m, cw),
                                      dtype=np.int64).astype(np.int32))
    nb = min(32 * n_words, 1 << item_bits)
    f_numbins = r.randint(3, nb, f)
    f_elide = np.arange(f) % 3 == 0
    table = torch.from_numpy(np.stack([
        r.randint(0, cw * per, f), np.where(f_elide, r.randint(0, 9, f), 0),
        f_elide, f_numbins, np.arange(f) % 3,
        r.randint(0, 100, f) % f_numbins], axis=1).astype(np.int32))
    f_cat = torch.from_numpy((np.arange(f) % 2).astype(np.int32))
    rec = np.zeros((L - 1, 13), np.float32)
    feats = r.randint(0, f, L - 1)
    rec[:, tdl.R_LEAF] = [r.randint(0, i + 1) for i in range(L - 1)]
    rec[:, tdl.R_FEAT] = feats
    rec[:, tdl.R_THR] = r.randint(0, f_numbins[feats])
    rec[:, tdl.R_DLEFT] = r.randint(0, 2, L - 1)
    words = torch.from_numpy(r.randint(-2**31, 2**31, (L - 1, n_words),
                                       dtype=np.int64).astype(np.int32))
    words[:5] = -1                    # every bit set
    words[5:10] = 0                   # none
    dev = [t.to(cuda_device) for t in (rows, torch.from_numpy(rec), table,
                                       words, f_cat)]
    for k in (0, L - 1):
        kt = torch.tensor(k, dtype=torch.int32)
        n0 = kkey.launches_route
        got = kkey.route_rows(dev[0], dev[1], kt.to(cuda_device), dev[2],
                              item_bits=item_bits, rec_cat=dev[3],
                              f_cat=dev[4])
        torch.cuda.synchronize()
        assert kkey.launches_route == n0 + 1
        want = kkey.route_rows_plain(rows, torch.from_numpy(rec), kt, table,
                                     item_bits=item_bits, rec_cat=words,
                                     f_cat=f_cat)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,quant", [
    ("compact", False), ("compact", True), ("masked", False)])
def test_categorical_training_on_card_matches_cpu(cuda_device, strategy,
                                                  quant, monkeypatch):
    # a Higgs-shaped task with 4 categorical columns of 64 categories on
    # each strategy's device loop: the same trees on the card as on the
    # CPU as functions of the training rows (per tree, the rows of each
    # leaf on the card are the rows of one leaf on the CPU), raw scores
    # within 1e-4. A categorical cut whose leaf has rows in its valid bins
    # only is one partition from either walk direction (k bins left, or
    # the other n - k) with equal gains in exact arithmetic, and the split
    # scan's f32 prefix sums run in another order on the card, so each
    # device may call either side left: the tree text may then differ by
    # children swapped
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    r = np.random.RandomState(8)
    n = 20_000
    x = r.randn(n, 10)
    cats = r.randint(0, 64, (n, 4))
    effect = r.randn(4, 64) * 0.5
    x[:, 6:] = cats
    margin = x[:, 0] - 0.5 * x[:, 1] + effect[np.arange(4), cats].sum(1)
    y = (margin + 0.5 * r.randn(n) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "min_gain_to_split": 1e-3, "verbosity": -1,
              "quantized_grad": quant, "categorical_feature": [6, 7, 8, 9]}
    n0 = (kkey.launches, kkey.launches_col)
    card = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                      device=cuda_device)
    assert (kkey.launches > n0[0]) == (strategy == "compact")
    assert (kkey.launches_col > n0[1]) == (strategy == "masked")
    cpu = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=5,
                     device="cpu")

    from lightgbm_tpu_torch.ops.predict import (predict_leaf_index,
                                                trees_to_arrays)
    xt = torch.from_numpy(x.astype(np.float32))
    la, lb = (predict_leaf_index(xt, trees_to_arrays(b._gbdt.models, "cpu"))
              .numpy() for b in (card, cpu))
    assert la.shape == lb.shape
    for t in range(la.shape[1]):
        pairs = set(zip(la[:, t].tolist(), lb[:, t].tolist()))
        assert len(pairs) == len(set(la[:, t])) == len(set(lb[:, t])), t
    assert any(t.num_cat for t in card._gbdt.models)
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


def _ranking_task(n_queries, seed, sizes=None):
    """chip_smoke.py's make_ranking_like shape: grades 0..4 from a score
    shifted per query; `sizes` gives ragged queries (default 20 each)."""
    r = np.random.RandomState(seed)
    group = np.asarray(sizes if sizes is not None
                       else [20] * n_queries, dtype=np.int64)
    n = int(group.sum())
    x = r.randn(n, 12).astype(np.float32)
    s = x[:, 0] - 0.5 * x[:, 1] + 0.3 * x[:, 2] * x[:, 3] \
        + np.repeat(r.randn(len(group)) * 0.5, group) + 0.8 * r.randn(n)
    y = np.digitize(s, np.quantile(s, [0.5, 0.75, 0.9, 0.97]))
    return x, y.astype(np.float64), group


@pytest.mark.gpu
@pytest.mark.parametrize("norm", [True, False])
def test_lambdarank_gradients_card_match_cpu(cuda_device, norm,
                                             monkeypatch):
    # ragged queries (1 to 40 documents: L = 64), in two chunks of the
    # pair budget on the card; exp on the card may move a value by an
    # ulp. The card's gradient makes no host sync.
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objectives import objective as tobj
    r = np.random.RandomState(5)
    sizes = r.randint(1, 41, 3000)
    _, y, group = _ranking_task(0, 6, sizes)
    n = len(y)
    meta = Metadata(n)
    meta.set_label(y)
    meta.set_weight(0.5 + r.rand(n))
    meta.set_group(group)
    cfg = Config({"objective": "lambdarank", "lambdamart_norm": norm})
    monkeypatch.setattr(tobj, "_PAIR_BUDGET", 2000 * 64 * 64)
    objs = []
    for dev in ("cpu", cuda_device):
        o = tobj.LambdarankNDCG(cfg)
        o.init(meta, n, dev)
        objs.append(o)
    assert objs[1]._chunk == 2000
    for scale in (0.0, 1.0):
        score = torch.from_numpy((scale * r.randn(n)).astype(np.float32))
        want = objs[0].get_gradients(score)
        score = score.to(cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = objs[1].get_gradients(score)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,quant", [("compact", False),
                                            ("masked", False),
                                            ("compact", True)])
def test_lambdarank_training_card_matches_cpu(cuda_device, strategy, quant,
                                              monkeypatch):
    # 1,000 queries of 20 on the fused iteration: one host sync per tree,
    # the CPU's trees as functions of the training rows
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y, group = _ranking_task(1000, 7)
    p = {"objective": "lambdarank", "num_leaves": 15, "max_bin": 63,
         "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "quantized_grad": quant, "grad_bits": 8, "verbosity": -1}
    card, cpu = (tlgb.train(p, tlgb.Dataset(x, y, group=group), 4,
                            device=d) for d in ("cuda", "cpu"))
    lr = card._gbdt.learner
    assert card._gbdt._fused_step is not None
    assert lr.stats.host_syncs == lr.stats.trees == 4
    assert _shape(card) == _shape(cpu)
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_dart_rf_scores_match_predict_on_card(cuda_device, boosting,
                                              monkeypatch):
    # DART's rescaled trees and RF's running average keep the training
    # scores equal to the model's predictions; the card's trees are the
    # CPU's
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y = _valid_task(20_000, 41)
    p = {"objective": "binary", "boosting": boosting, "num_leaves": 15,
         "max_bin": 63, "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "drop_rate": 0.5, "skip_drop": 0.0, "bagging_fraction": 0.8,
         "bagging_freq": 1 if boosting == "rf" else 0, "verbosity": -1}
    card, cpu = (tlgb.train(p, tlgb.Dataset(x, y), 6, device=d)
                 for d in ("cuda", "cpu"))
    if boosting == "dart":
        assert card._gbdt.drop_index == cpu._gbdt.drop_index
    else:
        assert card._gbdt.average_output
    assert _shape(card) == _shape(cpu)
    moved = _f32_threshold_rows(card.train_set._inner, x)
    raw = card.predict(x, raw_score=True)
    score = card._gbdt.score_updater.score[0].cpu().numpy()
    np.testing.assert_allclose(raw[~moved], score[~moved], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(raw, cpu.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


def _model_text(n=20_000, seed=51, objective="binary"):
    x, y = _valid_task(n, seed)
    p = {"objective": objective, "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 20, "verbosity": -1}
    if objective == "multiclass":
        p["num_class"] = 3
        y = (y + (x[:, 5] > 0.5)).astype(np.float64)
    return tlgb.train(p, tlgb.Dataset(x, y), 6, device="cpu") \
        .model_to_string(), x, y


@pytest.mark.gpu
@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_pred_leaf_card_matches_cpu(cuda_device, objective, monkeypatch):
    # the raw-value walk compares f32 values with f32 thresholds on both
    # devices: the same leaves, whole and in tree chunks
    from lightgbm_tpu_torch.ops import predict as tpredict
    text, x, _ = _model_text(objective=objective)
    card = tlgb.Booster(model_str=text, device="cuda")
    cpu = tlgb.Booster(model_str=text, device="cpu")
    want = cpu.predict(x, pred_leaf=True)
    assert np.array_equal(card.predict(x, pred_leaf=True), want)
    card._gbdt.invalidate_ensemble_cache()
    monkeypatch.setattr(tpredict, "WALK_ELEMENTS", 3 * len(x))
    assert np.array_equal(card.predict(x, pred_leaf=True), want)
    assert np.array_equal(card.predict(x, raw_score=True),
                          cpu.predict(x, raw_score=True))
    kw = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=1.5)
    np.testing.assert_allclose(card.predict(x, **kw), cpu.predict(x, **kw),
                               rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_sparse_predict_card_matches_cpu(cuda_device, monkeypatch):
    import scipy.sparse as sp
    from lightgbm_tpu_torch import basic as tbasic
    text, x, _ = _model_text()
    dense = np.where(np.abs(x) < 0.8, 0.0, np.nan_to_num(x))
    monkeypatch.setattr(tbasic, "_SPARSE_PREDICT_BATCH", 4096)
    card = tlgb.Booster(model_str=text, device="cuda")
    cpu = tlgb.Booster(model_str=text, device="cpu")
    csr = sp.csr_matrix(dense)
    assert np.array_equal(card.predict(csr, pred_leaf=True),
                          cpu.predict(dense, pred_leaf=True))
    assert np.array_equal(card.predict(csr), cpu.predict(dense))


@pytest.mark.gpu
def test_refit_stats_card_match_plain(cuda_device):
    # one index_add_ on the card against the same sums on the CPU (f64:
    # the order of the card's atomic adds moves the last digits only)
    from lightgbm_tpu_torch.continual import refit as trefit
    r = np.random.RandomState(5)
    leaves = r.randint(0, 31, size=(50_000, 12)).astype(np.int32)
    g = r.randn(3, 50_000).astype(np.float32)
    h = r.rand(3, 50_000).astype(np.float32)
    n0 = trefit.dispatches
    got = trefit.leaf_stats(leaves, torch.as_tensor(g, device=cuda_device),
                            torch.as_tensor(h, device=cuda_device),
                            num_tree_per_iteration=3, max_leaves=31)
    assert trefit.dispatches == n0 + 1
    want = trefit.leaf_stats(leaves, torch.as_tensor(g),
                             torch.as_tensor(h), num_tree_per_iteration=3,
                             max_leaves=31)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    text, x, y = _model_text()
    card = tlgb.Booster(model_str=text, device="cuda").refit(x, y, 0.9)
    cpu = tlgb.Booster(model_str=text, device="cpu").refit(x, y, 0.9)
    for a, b in zip(card._gbdt.models, cpu._gbdt.models):
        np.testing.assert_allclose(a.leaf_value[:a.num_leaves],
                                   b.leaf_value[:b.num_leaves], rtol=1e-9,
                                   atol=1e-12)


# ---- out of core: the shard's pipeline and the chunk core on the card ------

@pytest.mark.gpu
@pytest.mark.parametrize("subset", [False, True])
def test_shard_chunks_on_card_equal_the_wire(cuda_device, subset):
    # pinned host store, side copy stream, two device buffers: every chunk
    # is the wire's rows, whatever the caller does with the one before
    from lightgbm_tpu_torch.io.stream import DeviceDataShard
    r = np.random.RandomState(5)
    wire = r.randint(0, 2**32, (70_001, 7), dtype=np.uint64) \
        .astype(np.uint32)
    sh = DeviceDataShard(wire, item_bits=8, c_cols=28, chunk_rows=8192,
                         device=cuda_device)
    assert sh.wire.is_pinned()
    ids = np.sort(r.choice(len(wire), 30_000, replace=False)) if subset \
        else None
    want = wire if ids is None else wire[ids]
    got = torch.empty((len(want), 7), dtype=torch.int32, device=cuda_device)
    for s, cnt, chunk in sh.iter_chunks(row_ids=ids):
        assert chunk.device.type == "cuda"
        got[s:s + cnt] = chunk * 1          # work on the compute stream
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)
    assert sh.h2d_bytes == want.nbytes and sh.cursor == -(-len(want) // 8192)
    assert 0.0 <= sh.overlap_fraction() <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_chunk_tree_on_card_equals_cpu(cuda_device, quant, monkeypatch):
    # exact gradients (multiples of 0.25, unit hessians): strategy=chunk's
    # device loop on the card (the compact core's, one K4 launch per
    # split) grows the chunk core's host loop records, bit for bit, and
    # the CPU's tree: float records equal; quantized (whose split scan reads
    # dequantized f32 sums, rounded on each device) the leaf, feature and
    # count columns and every row's leaf equal, the outputs within 1e-4
    # (test_bag_carry_captured_tree_matches_cpu's bar)
    monkeypatch.setenv("LGBM_TPU_CHUNK", "8192")
    params = {"quantized_grad": quant, "grad_bits": 8}
    lr, _ = _compact_learner(cuda_device, 70_000, params, strategy="chunk")
    cpu, _ = _compact_learner("cpu", 70_000, params, strategy="chunk")
    r = np.random.RandomState(4)
    g = torch.from_numpy((r.randint(-8, 9, 70_000) * 0.25)
                         .astype(np.float32))
    h = torch.ones(70_000)
    rec, leaf, k = lr.grow(g.to(cuda_device), h.to(cuda_device))
    crec, cleaf, ck = cpu.grow(g, h)
    hrec, hleaf, hk = lr.chunk_host_loop(g.to(cuda_device),
                                         h.to(cuda_device))[:3]
    assert k == ck == hk == 30
    np.testing.assert_array_equal(rec, hrec)
    assert torch.equal(leaf, hleaf) and torch.equal(leaf.cpu(), cleaf)
    if quant:
        ints = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_LCNT, tdl.R_RCNT]
        np.testing.assert_array_equal(rec[:, ints], crec[:, ints])
        np.testing.assert_allclose(rec[:, [tdl.R_LOUT, tdl.R_ROUT]],
                                   crec[:, [tdl.R_LOUT, tdl.R_ROUT]],
                                   rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(rec, crec)
    step = lr._loop.launches_per_step
    assert step["lightgbm_tpu_torch.ops.kernels.partition.launches_win"] \
        == 1


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_resume_on_card_equals_uninterrupted(cuda_device, quant, tmp_path,
                                             monkeypatch):
    # a 70,000-row compact run (bagging 0.8: the router too) checkpointed
    # at iteration 4 and resumed to 8 on the card writes the uninterrupted
    # run's model text, byte for byte: every device op on the path gives
    # the same bits run to run, and the scores come back from the stored
    # f32 arrays
    from lightgbm_tpu_torch.callback import checkpoint
    monkeypatch.delenv("LGBM_TPU_STRATEGY", raising=False)
    r = np.random.RandomState(8)
    x = r.randn(70_000, 10)
    y = (x[:, 0] - x[:, 1] + 0.5 * r.randn(70_000) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "bagging_fraction": 0.8, "bagging_freq": 1,
              "quantized_grad": quant, "grad_bits": 8, "verbosity": -1}
    full = tlgb.train(dict(params), tlgb.Dataset(x, y), 8)
    tlgb.train(dict(params), tlgb.Dataset(x, y), 4,
               callbacks=[checkpoint(str(tmp_path), checkpoint_freq=4)])
    resumed = tlgb.train(dict(params), tlgb.Dataset(x, y), 8,
                         resume_from=str(tmp_path))
    assert resumed._gbdt.device.type == "cuda"
    assert resumed._gbdt.learner.strategy == "compact"
    assert resumed.model_to_string() == full.model_to_string()


@pytest.mark.gpu
@pytest.mark.parametrize("spec,iteration", [
    ("nan_grad@iter=3,frac=0.01", 3), ("inf_grad@p=0.5;seed=5", 2)])
def test_fault_plan_poisons_the_same_rows_on_card(cuda_device, spec,
                                                  iteration):
    from lightgbm_tpu_torch.resilience import faults
    g = torch.from_numpy(np.random.RandomState(1).randn(1, 100_000)
                         .astype(np.float32))
    h = torch.ones_like(g)
    card, host = faults.FaultPlan(spec), faults.FaultPlan(spec)
    for it in range(iteration + 1):
        gc_, _ = card.inject_gradients(g.to(cuda_device),
                                       h.to(cuda_device), it)
        gh_, _ = host.inject_gradients(g, h, it)
    assert gc_.device.type == "cuda"
    assert torch.equal(~torch.isfinite(gc_.cpu()), ~torch.isfinite(gh_))
    assert card.events == host.events and card.events


# ---------------------------------------------------------------------------
# online serving on the card

def _serve_model(objective="binary", seed=7, rounds=8):
    r = np.random.RandomState(seed)
    x = r.randn(2000, 8)
    x[r.rand(2000) < 0.03, 3] = np.nan
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * np.nan_to_num(x[:, 3]) * x[:, 2]
    noisy = m + 0.5 * r.randn(2000)
    params = {"objective": objective, "num_leaves": 31, "max_bin": 63,
              "verbosity": -1}
    if objective == "multiclass":
        params["num_class"] = 3
        y = np.digitize(noisy, [-0.7, 0.7]).astype(float)
    else:
        y = (noisy > 0).astype(float)
    bst = tlgb.train(params, tlgb.Dataset(x, y), rounds, device="cpu")
    return bst, x, y


@pytest.mark.gpu
@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_serving_predictor_on_card_matches_cpu_walk(cuda_device, objective):
    from lightgbm_tpu_torch.serving import ModelRegistry
    bst, x, _ = _serve_model(objective)
    text = bst.model_to_string()
    card = ModelRegistry(warm_buckets=(1, 16))
    card.load(text)
    host = ModelRegistry(warm_buckets=(1,), device="cpu")
    host.load(text)
    assert card.get().device_key == "cuda:0"
    assert card.get().arrays.split_feature.device.type == "cuda"
    assert card.get().tree_class.device.type == "cpu"
    for raw in (False, True):
        for n in (1, 5, 16, 33, 300, 4096):
            got = card.predictor.predict(card.get(), x[:n], raw_score=raw)
            want = host.predictor.predict(host.get(), x[:n], raw_score=raw)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_serving_no_new_entry_after_warmup_on_card(cuda_device):
    from lightgbm_tpu_torch.serving import ModelRegistry
    bst, x, y = _serve_model()
    reg = ModelRegistry(warm_buckets=(1, 16, 256))
    reg.load(bst.model_to_string())
    builds = reg.predictor.compile_count
    assert builds == 3
    for n in range(1, 257, 7):
        reg.predictor.predict(reg.get(), x[:n])
    assert reg.predictor.compile_count == builds
    refit = tlgb.Booster(model_str=bst.model_to_string(), device="cpu")
    refit.refit(x[:500], y[:500], decay_rate=0.9)
    reg.load(refit.model_to_string(), version="refit", warm=False)
    assert reg.get("refit").shape_sig == reg.get("v1").shape_sig
    out = reg.predictor.predict(reg.get("refit"), x[:100])
    assert reg.predictor.compile_count == builds
    np.testing.assert_allclose(out[:, 0], refit.predict(x[:100]),
                               rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_placement_ordinal_past_device_count_raises(cuda_device):
    from lightgbm_tpu_torch.fleet import PlacementPlan
    from lightgbm_tpu_torch.serving import ModelRegistry
    from lightgbm_tpu_torch.utils.log import LightGBMError
    count = torch.cuda.device_count()
    plan = PlacementPlan("v9=%d" % count)
    with pytest.raises(LightGBMError, match="ordinal %d" % count):
        plan.assign("v9")
    assert plan.assign("v1") == torch.device("cuda", 0)
    bst, _, _ = _serve_model(rounds=2)
    reg = ModelRegistry(warm_buckets=(1,), placement=PlacementPlan(
        "v9=%d" % count))
    with pytest.raises(LightGBMError, match="ordinal %d" % count):
        reg.load(bst, version="v9")


@pytest.mark.gpu
def test_cli_serve_without_cpu_key_runs_on_card(cuda_device, tmp_path):
    import json
    import urllib.request
    from lightgbm_tpu_torch.cli import _serve
    bst, x, _ = _serve_model(rounds=4)
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    httpd = _serve({"task": "serve", "input_model": path,
                    "serve_port": "0", "serve_warm_buckets": "4"},
                   block=False)
    try:
        assert httpd.app.registry.get().device_key.startswith("cuda")
        req = urllib.request.Request(
            "http://127.0.0.1:%d/predict" % httpd.server_address[1],
            data=json.dumps({"rows": x[:3].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        np.testing.assert_allclose(out["predictions"], bst.predict(x[:3]),
                                   rtol=0, atol=1e-6)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.app.close()


# ---------------------------------------------------------------------------
# the fleet and the continual loop on the card

@pytest.mark.gpu
def test_export_cache_restart_on_card_builds_no_entry(cuda_device,
                                                      tmp_path):
    from lightgbm_tpu_torch.fleet import ExportCache
    from lightgbm_tpu_torch.serving import ModelRegistry
    bst, x, _ = _serve_model()
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    first = ModelRegistry(warm_buckets=(1, 16, 256),
                          export_cache=ExportCache(path + ".xcache"))
    first.load(path, version="v1")
    assert first.predictor.compile_count == 3
    again = ModelRegistry(warm_buckets=(1, 16, 256),
                          export_cache=ExportCache(path + ".xcache"))
    again.load(path, version="v1")
    assert again.export_cache.last_restore == {"restored": 3, "rebuilt": 0,
                                               "missed": 0}
    m = again.get("v1")
    assert m.device_key == "cuda:0"
    host = ModelRegistry(warm_buckets=(1,), device="cpu")
    host.load(path)
    for n in (1, 7, 16, 100, 256):
        got = again.predictor.predict(m, x[:n])
        want = host.predictor.predict(host.get(), x[:n])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert again.predictor.compile_count == 0


@pytest.mark.gpu
def test_continuation_on_card_has_the_cpus_structure(cuda_device,
                                                     monkeypatch):
    from lightgbm_tpu_torch.continual import update
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    r = np.random.RandomState(11)
    x = r.randn(24_000, 8)
    y = (1.5 * x[:, 0] - x[:, 1] + 0.5 * r.randn(24_000) > 0).astype(float)
    xn = r.randn(4_000, 8) + 0.5
    yn = (1.5 * xn[:, 0] - xn[:, 1] + 0.5 * r.randn(4_000) > 0
          ).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
              "verbosity": -1}
    out = {}
    for dev in ("cuda", "cpu"):
        ds = tlgb.Dataset(x, y, device=dev)
        b = tlgb.train(params, ds, 3)
        update.append_rows(ds, xn, yn, booster=b)
        k1.launches_win = k4.launches_win = 0
        c = update.continue_training(b, ds, 2)
        out[dev] = (c, k1.launches_win, k4.launches_win)
    card, host = out["cuda"][0], out["cpu"][0]
    assert card.device.type == "cuda" and out["cuda"][1] > 0 \
        and out["cuda"][2] > 0

    def structure(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves])) for t in b._gbdt.models]
    assert structure(card) == structure(host)
    xa = np.vstack([x, xn])
    np.testing.assert_allclose(card.predict(xa), host.predict(xa), rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
def test_manifest_follower_loads_onto_the_card(cuda_device, tmp_path):
    from lightgbm_tpu_torch.fleet import ManifestFollower, ManifestPublisher
    from lightgbm_tpu_torch.serving import ServingApp
    bst, x, _ = _serve_model(rounds=4)
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    mpath = str(tmp_path / "manifest.json")
    ManifestPublisher(mpath).seed({"v1": path}, stable="v1")
    app = ServingApp(max_batch=16, start=False)
    try:
        assert ManifestFollower(app, mpath).poll_once() is True
        assert app.router.stable == "v1"
        m = app.registry.get("v1")
        assert m.device_key == "cuda:0"
        np.testing.assert_allclose(
            app.registry.predictor.predict(m, x[:9])[:, 0],
            bst.predict(x[:9]), rtol=0, atol=1e-6)
    finally:
        app.close()


@pytest.mark.gpu
def test_capi_trains_on_the_card(cuda_device, monkeypatch):
    # the C ABI with no device key trains on the card; its model text is
    # the Booster's of the same params, and its predictions equal
    import ctypes
    monkeypatch.delenv("LGBM_TPU_DEVICE_TYPE", raising=False)
    lib = ctypes.CDLL(build.capi_library())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    r = np.random.RandomState(3)
    x = np.ascontiguousarray(r.randn(70_000, 6))
    y = (x[:, 0] + 0.5 * r.randn(70_000) > 0).astype(np.float32)
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.LGBM_DatasetCreateFromMat(
        x.ctypes.data_as(ctypes.c_void_p), 1, 70_000, 6, 1, b"max_bin=63",
        None, ctypes.byref(ds)) == 0, lib.LGBM_GetLastError()
    assert lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p), 70_000, 0) == 0
    params = {"objective": "binary", "num_leaves": "31", "verbosity": "-1"}
    assert lib.LGBM_BoosterCreate(ds, " ".join(
        "%s=%s" % kv for kv in params.items()).encode(),
        ctypes.byref(bst)) == 0, lib.LGBM_GetLastError()
    fin = ctypes.c_int()
    for _ in range(3):
        assert lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)) == 0
    n = ctypes.c_int64()
    assert lib.LGBM_BoosterSaveModelToString(bst, 0, -1, 0, ctypes.byref(n),
                                             None) == 0
    buf = ctypes.create_string_buffer(n.value)
    assert lib.LGBM_BoosterSaveModelToString(bst, 0, -1, n.value,
                                             ctypes.byref(n), buf) == 0
    pred = np.zeros(1000)
    assert lib.LGBM_BoosterPredictForMat(
        bst, x.ctypes.data_as(ctypes.c_void_p), 1, 1000, 6, 1, 0, -1, b"",
        ctypes.byref(n), pred.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double))) == 0
    ref = tlgb.train(dict(params), tlgb.Dataset(x, y, params={
        "max_bin": "63"}), 3)
    assert ref._gbdt.device.type == "cuda"
    assert buf.value.decode() == ref.model_to_string()
    np.testing.assert_allclose(pred, ref.predict(x[:1000]), atol=1e-6)
    assert lib.LGBM_BoosterFree(bst) == 0
    assert lib.LGBM_DatasetFree(ds) == 0


_DP_MODES = {"quantized": {"quantized_grad": True, "grad_bits": 8},
             "bagging": {"bagging_fraction": 0.8, "bagging_freq": 1},
             "goss": {"boosting": "goss", "learning_rate": 0.5}}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(_DP_MODES))
def test_data_parallel_world_size_one_modes_captured(cuda_device, mode):
    # quantized, bagged and GOSS data-parallel at world size 1 under
    # NCCL: the fused iteration at one host sync per tree, the split step
    # captured with its collectives inside, K3's window entry (quantized)
    # or K1's launched, and the router for each sampled tree's other rows
    import socket
    from lightgbm_tpu_torch.distributed import bootstrap
    r = np.random.RandomState(5)
    x = r.randn(70_000, 6)
    y = (x[:, 0] + 0.5 * r.randn(70_000) > 0).astype(float)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    bootstrap.initialize("127.0.0.1:%d" % port, 1, 0)
    try:
        k1.launches_win = k1.launches_qwin = kkey.launches_route = 0
        rounds = 4
        dp = tlgb.train(dict({"objective": "binary", "num_leaves": 31,
                              "verbosity": -1, "tree_learner": "data"},
                             **_DP_MODES[mode]), tlgb.Dataset(x, y), rounds)
        lr = dp._gbdt.learner
        assert dp._gbdt._fused_step is not None
        assert lr._loop.graph is not None
        assert lr._loop.launches_per_step[
            "lightgbm_tpu_torch.parallel.network.collectives"] >= 1
        assert lr.stats.host_syncs == lr.stats.trees == rounds
        if mode == "quantized":
            assert k1.launches_qwin > 0 and k1.launches_win == 0
        else:
            assert k1.launches_win > 0 and k1.launches_qwin == 0
            # GOSS samples after its warm-up of int(1 / 0.5) iterations
            assert kkey.launches_route == (rounds if mode == "bagging"
                                           else rounds - 2)
        del dp, lr
        gc.collect()
    finally:
        bootstrap.shutdown()


@pytest.mark.gpu
def test_data_parallel_world_size_one_nccl_equals_serial(cuda_device):
    # tree_learner=data at world size 1 under NCCL: the serial compact
    # trees byte for byte, the collective captured in the split step, one
    # host sync per tree
    import socket
    from lightgbm_tpu_torch.distributed import bootstrap
    from lightgbm_tpu_torch.parallel import network
    r = np.random.RandomState(5)
    x = r.randn(70_000, 6)
    y = (x[:, 0] + 0.5 * r.randn(70_000) > 0).astype(float)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    bootstrap.initialize("127.0.0.1:%d" % port, 1, 0)
    try:
        assert bootstrap.cuda_backend() == "nccl"
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
        ds = tlgb.Dataset(x, y)
        os.environ["LGBM_TPU_STRATEGY"] = "compact"
        try:
            serial = tlgb.train(p, ds, 3)
        finally:
            os.environ.pop("LGBM_TPU_STRATEGY")
        dp = tlgb.train(dict(p, tree_learner="data"), ds, 3)
        lr = dp._gbdt.learner
        assert lr._loop.graph is not None
        assert lr._loop.launches_per_step[
            "lightgbm_tpu_torch.parallel.network.collectives"] == 1
        assert lr.stats.host_syncs == lr.stats.trees == 3

        def trees(b):
            return [ln for ln in b.model_to_string().splitlines()
                    if not ln.startswith("[tree_learner")]
        assert trees(dp) == trees(serial)
        assert network.collectives > 0
    finally:
        bootstrap.shutdown()
