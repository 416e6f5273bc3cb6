#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (lightgbm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # the full-width run (1M x 28, 10 rounds)
    python3 chip_smoke.py --rows 200000 --rounds 3   # a short first check

Phases, one JSON line each:
  device     card name and power limit, and the kernels' build (one nvcc
             per source, started together; ptxas registers and shared
             memory per kernel);
  k1         the histogram kernel vs its plain PyTorch version at the main
             path's shapes (the root window of the packed working rows,
             a child window, a ragged tail at 256 bins);
  k4         the stable partition kernel vs its plain version, bit-exact;
  train      lightgbm_tpu_torch.train on a Higgs-shaped 1,000,000 x 28
             binary task (num_leaves=255, max_bin=63, learning_rate=0.1,
             min_data_in_leaf=20) for 10 rounds: launches of every kernel
             during that run, host syncs per tree, time, peak memory,
             held-out AUC, and a model-text round trip;
  reference  a small task trained on the card and on the CPU (the plain
             versions): the same trees and predictions;
  profile    one more boosting iteration under torch.profiler.
Then the card's name and power limit, the kernels line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero.

The script needs the lightgbm_tpu_torch package beside it and a CUDA
card; it imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print("chip_smoke: FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def make_higgs_like(n, f, seed=17, w=None):
    """Seeded Higgs-shaped binary task: informative and noise features,
    moderately separable classes (the repo benchmark's generator). Pass
    `w` to draw another sample from the same ground truth."""
    r = np.random.RandomState(seed)
    x = r.randn(n, f).astype(np.float32)
    if w is None:
        w = r.randn(f) * (r.rand(f) > 0.4)
    logit = x @ w * 0.3 + 0.2 * x[:, 0] * x[:, 1] - 0.1 * x[:, 2] ** 2
    y = (logit + r.randn(n) * 1.5 > 0).astype(np.float64)
    return x, y, w


def auc(y, s):
    """Tie-aware rank AUC."""
    order = np.argsort(s, kind="mergesort")
    _, inv, counts = np.unique(s[order], return_inverse=True,
                               return_counts=True)
    avg = np.cumsum(counts) - (counts - 1) / 2.0
    ranks = np.empty(len(s))
    ranks[order] = avg[inv]
    npos = float(y.sum())
    nneg = len(y) - npos
    return float((ranks[y > 0].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg))


def time_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got, want):
    d = (got - want).abs()
    rel = d / want.abs().clamp(min=1e-3)
    return float(d.max()), float(rel.max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch import convert
        from lightgbm_tpu_torch.ops.kernels import build
        from lightgbm_tpu_torch.ops.kernels import histogram as k1
        from lightgbm_tpu_torch.ops.kernels import partition as k4
    except ImportError as e:
        fail("lightgbm_tpu_torch not importable beside chip_smoke.py: %s"
             % e)
    dev = torch.device("cuda")

    # ---- device + build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "not measured"
    t0 = time.time()
    log = build.build_all(verbose=True)
    build_s = time.time() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "Compiling entry" in ln
                    or "spill" in ln]
             for name, text in log.items()}
    emit({"phase": "device", "nvidia_smi": smi_line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 2),
          "ptxas": ptxas})

    # ---- data and the main path's working rows --------------------------
    f = 28
    t0 = time.time()
    x, y, w_true = make_higgs_like(args.rows, f)
    xv, yv, _ = make_higgs_like(100_000, f, seed=4242, w=w_true)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}
    ds = lgb.Dataset(x, y, params=params)
    ds.construct()
    data_s = time.time() - t0
    from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
    from lightgbm_tpu_torch.config import Config
    probe = DeviceTreeLearner(Config(params), ds._inner, device=dev)
    r = np.random.RandomState(0)
    g = torch.from_numpy(r.randn(args.rows).astype(np.float32)).to(dev)
    h = torch.from_numpy((r.rand(args.rows) * 0.25).astype(np.float32)) \
        .to(dev)
    buf = probe.working_buffer(g, h)                     # (N, 7 + 4) int32
    d_cols = buf.shape[1]
    cw = d_cols - 4
    b_root = probe.col_device_bins
    c_cols = probe.c_cols

    # ---- K1 vs plain ------------------------------------------------------
    k1_rows = []

    def k1_case(label, codes, gh, nb, reps):
        got = k1.build_histogram(codes, gh, nb)
        want = k1.build_histogram_plain(codes, gh, nb)
        # f32 sums in two orders differ by up to ~eps * sqrt(n) * the bin's
        # sum of |terms|; at 1M rows a bin sums ~15k gradients that cancel,
        # so the tolerance adds 1e-5 * sum|terms| to rtol = atol = 1e-4
        mag = k1.build_histogram_plain(codes, gh.abs(), nb)
        torch.cuda.synchronize()
        ea, er = errors(got, want)
        diff = (got - want).abs()
        ok = bool((diff <= 1e-4 + 1e-4 * want.abs() + 1e-5 * mag).all()
                  and torch.equal(got[..., 2], want[..., 2]))
        err_vs_mag = float((diff / mag.clamp(min=1e-30)).max())
        p, ff = codes.shape
        kern = time_ms(torch, lambda: k1.build_histogram(codes, gh, nb), reps)
        plain = time_ms(torch, lambda: k1.build_histogram_plain(
            codes, gh, nb), 3, warmup=1)
        c = codes.long()
        slot = (c + torch.arange(ff, device=dev) * nb).reshape(-1)
        src = gh.repeat_interleave(ff, dim=0)
        out = torch.zeros((ff * nb, 3), device=dev)
        lib = time_ms(torch, lambda: out.index_add_(0, slot, src), reps)
        del c, slot, src, out
        bms, by = bound(p * ff * codes.element_size() + 12 * p
                        + 12 * ff * nb, 3 * p * ff)
        row = {"shape": label, "P": p, "F": ff, "B": nb,
               "max_abs_err": ea, "max_rel_err": er,
               "max_err_over_abs_sum": err_vs_mag, "ok": ok,
               "count_exact": bool(torch.equal(got[..., 2], want[..., 2])),
               "ms": kern, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bms, "bound_by": by}
        k1_rows.append(row)
        return row

    codes_root = buf.view(torch.uint8)[:, :c_cols]
    gh_root = buf.view(torch.float32)[:, cw:cw + 3]
    k1_case("root window (packed rows)", codes_root, gh_root, b_root, 20)
    k1_case("child window (packed rows)", codes_root[:250_000],
            gh_root[:250_000], b_root, 50)
    rt = np.random.RandomState(1)
    tail_codes = torch.from_numpy(rt.randint(
        0, 256, size=(args.rows + 3, f)).astype(np.uint8)).to(dev)
    tail_gh = torch.from_numpy(np.stack(
        [rt.randn(args.rows + 3), rt.rand(args.rows + 3),
         np.ones(args.rows + 3)], 1).astype(np.float32)).to(dev)
    k1_case("ragged tail, 256 bins", tail_codes, tail_gh, 256, 20)
    del tail_codes, tail_gh
    emit({"phase": "k1", "tolerance": "|diff| <= 1e-4 + 1e-4*|plain| + "
          "1e-5*sum|terms| per bin; count lane exact",
          "cases": k1_rows})
    if not all(rw["ok"] for rw in k1_rows):
        fail("K1 disagrees with its plain version")

    # ---- K4 vs plain ------------------------------------------------------
    k4_rows = []

    def k4_case(label, win, key, reps):
        out = torch.empty_like(win)
        got = k4.stable_partition3(win, key, out)
        want = k4.stable_partition3_plain(win, key)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, want))
        kern = time_ms(torch, lambda: k4.stable_partition3(win, key, out),
                       reps)
        plain = time_ms(torch, lambda: k4.stable_partition3_plain(win, key),
                        3, warmup=1)
        wn, dn = win.shape
        bms, by = bound(wn * (8 * dn + 4), 0)
        row = {"shape": label, "W": wn, "D": dn, "bit_exact": exact,
               "max_abs_err": 0.0 if exact else float("inf"),
               "ms": kern, "plain_ms": plain, "library_ms": None,
               "library": "no single PyTorch call computes a stable "
                          "3-way row partition", "bound_ms": bms,
               "bound_by": by}
        k4_rows.append(row)
        return row

    # the root split's window: rows keyed by a feature threshold
    key_root = (codes_root[:, 0].to(torch.int32) > b_root // 3) \
        .to(torch.int32).contiguous()
    k4_case("root split window", buf, key_root, 20)
    w2 = torch.from_numpy(rt.randint(0, 2**32, size=(args.rows + 3, d_cols),
                                     dtype=np.uint32).view(np.int32)).to(dev)
    key2 = torch.from_numpy(rt.randint(0, 3, size=args.rows + 3)
                            .astype(np.int32)).to(dev)
    k4_case("ragged, 3 keys", w2, key2, 20)
    del w2, key2, buf, probe, key_root
    emit({"phase": "k4", "tolerance": "bit-exact", "cases": k4_rows})
    if not all(rw["bit_exact"] for rw in k4_rows):
        fail("K4 disagrees with its plain version")

    # ---- train: the main path ---------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    k4.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    bst = lgb.train(params, ds, num_boost_round=args.rounds)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {"k1": k1.launches, "k4": k4.launches}
    peak = torch.cuda.max_memory_allocated()
    stats = bst._gbdt.learner.stats
    pv = bst.predict(xv)
    valid_auc = auc(yv, pv)
    text = bst.model_to_string()
    back = convert.booster_from_model_string(text)
    rt_err = float(np.max(np.abs(back.predict(xv, raw_score=True)
                                 - bst.predict(xv, raw_score=True))))
    steady = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.time()
        bst.update()
        torch.cuda.synchronize()
        steady.append(time.time() - t1)
    train = {"phase": "train", "rows": args.rows, "features": f,
             "rounds": args.rounds, "params": params,
             "trees": bst.num_trees() - 3, "launches": launches,
             "splits_per_tree": stats.splits / max(stats.trees, 1),
             "growth_host_syncs_per_tree":
                 stats.host_syncs / max(stats.trees, 1),
             "dataset_s": data_s, "train_s": train_s,
             "s_per_iter_in_train": train_s / args.rounds,
             "s_per_iter_steady": float(np.median(steady)),
             "peak_device_bytes": int(peak), "valid_rows": len(yv),
             "valid_auc": valid_auc, "model_text_roundtrip_max_abs": rt_err}
    emit(train)
    if launches["k1"] <= 0 or launches["k4"] <= 0:
        fail("a kernel of the main path was never launched: %s" % launches)
    if not np.all(np.isfinite(pv)) or pv.shape != (len(yv),):
        fail("predictions are not finite or of the wrong shape")
    if valid_auc <= 0.7:
        fail("held-out AUC %.4f <= 0.7" % valid_auc)
    if rt_err > 1e-6:
        fail("model-text round trip differs by %g" % rt_err)

    # ---- reference: card vs CPU on a small input ------------------------
    xs, ys, _ = make_higgs_like(20_000, f, seed=99)
    sp = dict(params, num_leaves=31, min_gain_to_split=1e-3)
    on_card = lgb.train(sp, lgb.Dataset(xs, ys), num_boost_round=5)
    on_cpu = lgb.train(sp, lgb.Dataset(xs, ys), num_boost_round=5,
                       device="cpu")

    def shape_of(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves]))
                for t in b._gbdt.models]

    same_trees = shape_of(on_card) == shape_of(on_cpu)
    ref_err = float(np.max(np.abs(on_card.predict(xs, raw_score=True)
                                  - on_cpu.predict(xs, raw_score=True))))
    emit({"phase": "reference", "rows": 20_000, "rounds": 5,
          "same_trees": same_trees, "max_abs_raw_diff": ref_err,
          "tolerance": 1e-4})
    if not same_trees or ref_err > 1e-4:
        fail("card and CPU runs disagree on the small reference task")

    # ---- profile one more iteration ---------------------------------------
    prof_row = {"phase": "profile"}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        bst.update()
        torch.cuda.synchronize()
        wall = time.time() - t1
    # device-side events only (kernels, copies): an operator's own entry
    # repeats the time of the kernels it launched
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    prof_row.update({
        "wall_ms": wall * 1e3, "device_ms": total_us / 1e3,
        "device_busy_share": total_us / 1e3 / (wall * 1e3),
        "device_launches": sum(e.count for e in kern),
        "top": [{"name": e.key[:90],
                 "device_ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top]})
    emit(prof_row)

    # ---- kernels line ------------------------------------------------------
    r1, r4 = k1_rows[0], k4_rows[0]
    kernels = [
        {"name": "K1 histogram", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/pallas/histogram_kernel.py:41",
         "launches": launches["k1"],
         "max_abs_err": max(rw["max_abs_err"] for rw in k1_rows),
         "ms": r1["ms"], "plain_ms": r1["plain_ms"],
         "bound_ms": r1["bound_ms"], "bound_by": r1["bound_by"],
         "library_ms": r1["library_ms"]},
        {"name": "K4 stable partition", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/partition.cu",
         "replaces": "lightgbm_tpu/ops/pallas/partition_kernel.py:48",
         "launches": launches["k4"],
         "max_abs_err": max(rw["max_abs_err"] for rw in k4_rows),
         "ms": r4["ms"], "plain_ms": r4["plain_ms"],
         "bound_ms": r4["bound_ms"], "bound_by": r4["bound_by"],
         "library_ms": None}]
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
