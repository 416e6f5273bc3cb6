#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (lightgbm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase (1M x 28, 10 rounds)
    python3 chip_smoke.py --rows 200000 --rounds 3   # a short first check
    python3 chip_smoke.py --phases device,k1,k3      # only those phases
    python3 chip_smoke.py --phases k1,k2,k3 --parent-src OLD
        # beside each histogram case, OLD's kernel (another checkout of
        # the repo, e.g. an earlier commit from `git archive`) on the
        # same inputs in the same run

Phases, one JSON line each:
  device       card name and power limit, and the kernels' build (one nvcc
               per source, started together; ptxas registers and shared
               memory per kernel); per built library and kernel, the count
               of each atomic opcode in its SASS (cuobjdump -sass; "not
               measured" without cuobjdump);
  k1           the float histogram kernel vs its plain PyTorch version at
               the compact path's shapes (the root window of the packed
               working rows, a child window, a ragged tail at 256 bins),
               and a dynamic-range case held without the absolute term;
  k2           the same kernel over column-major (F, N) codes, the masked
               strategy's layout, at 60,000 and at the full row count;
  k3           the exact integer histogram kernel vs its plain version,
               bit-exact: packed quantized rows (int8 operand), a child
               window, a ragged tail at 256 bins with an int32 operand, and
               K3t over (F, N) codes at 60,000 rows;
  k4           the stable partition kernel vs its plain version, bit-exact;
  train        lightgbm_tpu_torch.train on a Higgs-shaped 1,000,000 x 28
               binary task (num_leaves=255, max_bin=63, learning_rate=0.1,
               min_data_in_leaf=20) for 10 rounds on the compact strategy:
               launches of every kernel during that run, host syncs per
               tree, time, peak memory, held-out AUC, and a model-text
               round trip;
  profile      one more float boosting iteration under torch.profiler;
  train_quant  the same data and parameters with quantized_grad (grad_bits
               8): K3 / K1 / K4 launches, time, peak memory, and held-out
               AUC > 0.7 and within 0.005 of the float run's; one more
               iteration profiled;
  train_masked 60,000 x 28 (the masked strategy, which auto picks below
               65,536 rows), float and quantized: K2 / K3t launches, AUC,
               time, one more iteration profiled;
  reference    small tasks trained on the card and on the CPU (the plain
               versions): compact float, compact quantized, masked float
               and masked quantized. Every run gives raw scores within
               1e-4 and the same trees; quantized runs also equal root
               histograms and the same trees from identical gradients.
               Compact quantized may grow other trees only where its
               witness shows stored integers that differ between the
               devices from the same scores.
Kernel times: `ms` is the mean over repeated launches between CUDA
events, the host enqueuing as it goes (on a small launch this reads the
wrapper's launch rate); `device_ms` puts a sleep kernel in front, which
holds the stream until every launch is enqueued, so it reads the device
alone.
A run of every phase (the default) then prints the card's name and power
limit and the kernels line; every run ends with {"ok": true, "device":
{...}}. A phase that needs another's result (profile and train_quant need
the float train run) runs it without printing it. Any failed check exits
non-zero.

The script needs the lightgbm_tpu_torch package beside it and a CUDA
card; it imports nothing of JAX.
"""
import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# the integer adds of K3 run on the same CUDA cores; the published f32
# rate is their bound here (int32 units are not faster)

# ~50 ms of GPU clock cycles: longer than the host takes to enqueue one
# timed run of launches
SLEEP_CYCLES = 100_000_000
# the grid --parent-src's kernel is launched at: two blocks per SM for
# every operand, as the launcher before the fixed-point float kernel chose
PARENT_BLOCKS_PER_SM = 2

PHASES = ("device", "k1", "k2", "k3", "k4", "train", "profile",
          "train_quant", "train_masked", "reference")


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


def time_ms(torch, fn, reps, warmup=2, hold=False):
    """Mean ms per call of fn over reps calls, between CUDA events around
    the calls as the host enqueues them: on a small launch this reads the
    host's launch rate (a wrapper's Python costs tens of microseconds).
    hold puts a sleep kernel in front, which holds the stream while the
    host enqueues the calls, so that the events time the device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(SLEEP_CYCLES)
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


_SASS_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")


def sass_atomics(nvcc_path, libs):
    """{library: {kernel: {opcode: count}}} of the atomic instructions
    (shared-memory ATOMS.*, global ATOM.* / RED.*) in each built library's
    SASS, read with cuobjdump -sass from nvcc's toolkit; "not measured"
    where cuobjdump is absent."""
    tool = os.path.join(os.path.dirname(nvcc_path), "cuobjdump") \
        if nvcc_path else ""
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump") or ""
    if not tool:
        return "not measured: no cuobjdump"
    filt = os.path.join(os.path.dirname(tool), "cu++filt")
    out = {}
    for name, path in libs.items():
        text = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, timeout=120).stdout
        funcs, cur = {}, None
        for ln in text.splitlines():
            m = _SASS_FUNC.search(ln)
            if m:
                cur = funcs.setdefault(m.group(1), {})
                continue
            m = _SASS_OP.search(ln)
            if cur is not None and m and m.group(1).startswith(
                    ("ATOMS", "ATOM.", "ATOMG", "RED.")):
                cur[m.group(1)] = cur.get(m.group(1), 0) + 1
        names = list(funcs)
        if os.path.isfile(filt) and names:
            dem = subprocess.run([filt], input="\n".join(names),
                                 capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()
            if len(dem) == len(names):
                funcs = {re.sub(r"^void |<unnamed>::|\(anonymous "
                                r"namespace\)::", "", d).split("(")[0]:
                         funcs[n] for n, d in zip(names, dem)}
        out[name] = funcs
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all): "
                    + ",".join(PHASES))
    ap.add_argument("--parent-src", default=None, metavar="DIR",
                    help="another checkout of the repo: its "
                    "csrc/histogram.cu is built and timed beside every "
                    "case of the k1, k2 and k3 phases")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown or not phases:
        ap.error("unknown phases %s; choose from %s"
                 % (unknown, ",".join(PHASES)))
    run = set(phases)
    every = run == set(PHASES)

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
    parent_build = None
    if args.parent_src:
        parent_lib = os.path.join(build.build_dir(),
                                  "libparent_histogram_%d.so" % os.getpid())
        os.makedirs(build.build_dir(), exist_ok=True)
        parent_build = subprocess.Popen(
            [build.nvcc()] + build.FLAGS + ["-o", parent_lib, os.path.join(
                args.parent_src, "lightgbm_tpu_torch", "csrc",
                "histogram.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log = build.build_all(verbose=True)
    parent = None
    if parent_build is not None:
        text, _ = parent_build.communicate()
        if parent_build.returncode:
            fail("nvcc failed for --parent-src's histogram.cu:\n" + text)
        parent = ctypes.CDLL(parent_lib)
    build_s = time.time() - t0
    if "device" in run:
        ptxas = {name: [ln.strip() for ln in text.splitlines()
                        if "registers" in ln or "Compiling entry" in ln
                        or "spill" in ln]
                 for name, text in log.items()}
        emit({"phase": "device", "nvidia_smi": smi_line,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": round(build_s, 2),
              "ptxas": ptxas,
              "sass_atomics": sass_atomics(
                  build.nvcc(), {n: build.library_path(n)
                                 for n in build.SOURCES})})

    # ---- data (built once, for the phases that need it) -----------------
    # auto picks the growth strategy by row count (compact at 1M rows,
    # masked at 60,000); the reference phase forces each in turn
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    f = 28
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}
    need_float = bool(run & {"train", "profile", "train_quant"})
    need_data = need_float or bool(run & {"k1", "k2", "k3", "k4"})
    t0 = time.time()
    x, y, w_true = make_higgs_like(args.rows, f)
    xv, yv, _ = make_higgs_like(100_000, f, seed=4242, w=w_true)
    if need_data:
        ds = lgb.Dataset(x, y, params=params)
        ds.construct()
    data_s = time.time() - t0
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.device_learner import (
        R_DLEFT, R_FEAT, R_LCNT, R_LEAF, R_RCNT, R_THR, DeviceTreeLearner,
        _quant_prepare)
    from lightgbm_tpu_torch.ops import quantize as quant_ops
    from lightgbm_tpu_torch.utils.random import prng_key

    kernel_rows = {}
    if run & {"k1", "k2", "k3", "k4"}:
        kernel_rows = kernel_phases(
            torch, dev, args, run, k1, k4, build, ds, params, Config,
            DeviceTreeLearner, quant_ops, prng_key, parent)

    counters = {"k1": "launches", "k2": "launches_t", "k3": "launches_q",
                "k3t": "launches_qt"}

    def reset_counts():
        for attr in counters.values():
            setattr(k1, attr, 0)
        k4.launches = 0

    def read_counts():
        out = {k: getattr(k1, attr) for k, attr in counters.items()}
        out["k4"] = k4.launches
        return out

    def timed_train(p, dset):
        """Train from zeroed launch counts; (booster, counts, seconds,
        peak device bytes)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        b = lgb.train(p, dset, num_boost_round=args.rounds)
        torch.cuda.synchronize()
        secs = time.time() - t1
        return b, read_counts(), secs, int(torch.cuda.max_memory_allocated())

    def steady_s(b):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.time()
            b.update()
            torch.cuda.synchronize()
            times.append(time.time() - t1)
        return float(np.median(times))

    # ---- profile one more iteration ---------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_one(b):
        """One more boosting iteration of booster `b` under torch.profiler:
        wall, device time and busy share, launches, the top kernels."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            b.update()
            torch.cuda.synchronize()
            wall = time.time() - t1
        # device-side events only (kernels, copies): an operator's own
        # entry repeats the time of the kernels it launched
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in kern)
        top = sorted(kern, key=lambda e: e.self_device_time_total,
                     reverse=True)[:10]
        return {
            "wall_ms": wall * 1e3, "device_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e3 / (wall * 1e3),
            "device_launches": sum(e.count for e in kern),
            "top": [{"name": e.key[:90],
                     "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}

    # ---- train: the main path (compact, float) ----------------------------
    launches = qlaunches = None
    valid_auc = None
    if need_float:
        bst, launches, train_s, peak = timed_train(params, ds)
        stats = bst._gbdt.learner.stats
        pv = bst.predict(xv)
        valid_auc = auc(yv, pv)
        text = bst.model_to_string()
        back = convert.booster_from_model_string(text)
        rt_err = float(np.max(np.abs(back.predict(xv, raw_score=True)
                                     - bst.predict(xv, raw_score=True))))
        train = {"phase": "train", "rows": args.rows, "features": f,
                 "rounds": args.rounds, "params": params,
                 "strategy": bst._gbdt.learner.strategy,
                 "trees": bst.num_trees(), "launches": launches,
                 "splits_per_tree": stats.splits / max(stats.trees, 1),
                 "growth_host_syncs_per_tree":
                     stats.host_syncs / max(stats.trees, 1),
                 "dataset_s": data_s, "train_s": train_s,
                 "s_per_iter_in_train": train_s / args.rounds,
                 "s_per_iter_steady": steady_s(bst),
                 "peak_device_bytes": peak, "valid_rows": len(yv),
                 "valid_auc": valid_auc,
                 "model_text_roundtrip_max_abs": rt_err}
        if "train" in run:
            emit(train)
        if train["strategy"] != "compact":
            fail("the 1M-row run did not take the compact strategy")
        if launches["k1"] <= 0 or launches["k4"] <= 0:
            fail("a kernel of the main path was never launched: %s"
                 % launches)
        if not np.all(np.isfinite(pv)) or pv.shape != (len(yv),):
            fail("predictions are not finite or of the wrong shape")
        if valid_auc <= 0.7:
            fail("held-out AUC %.4f <= 0.7" % valid_auc)
        if rt_err > 1e-6:
            fail("model-text round trip differs by %g" % rt_err)
        if "profile" in run:
            emit(dict({"phase": "profile"}, **profile_one(bst)))
        del bst, back

    # ---- train_quant: the same data with quantized gradients --------------
    if "train_quant" in run:
        qparams = dict(params, quantized_grad=True, grad_bits=8)
        qbst, qlaunches, qtrain_s, qpeak = timed_train(qparams, ds)
        qpv = qbst.predict(xv)
        qauc = auc(yv, qpv)
        train_quant = {
            "phase": "train_quant", "rows": args.rows,
            "rounds": args.rounds, "grad_bits": 8, "quant_renew": True,
            "strategy": qbst._gbdt.learner.strategy, "launches": qlaunches,
            "train_s": qtrain_s,
            "s_per_iter_in_train": qtrain_s / args.rounds,
            "s_per_iter_steady": steady_s(qbst), "peak_device_bytes": qpeak,
            "valid_auc": qauc, "float_valid_auc": valid_auc,
            "auc_diff": qauc - valid_auc, "profile": profile_one(qbst)}
        emit(train_quant)
        if train_quant["strategy"] != "compact":
            fail("the quantized 1M-row run did not take the compact "
                 "strategy")
        if qlaunches["k3"] <= 0 or qlaunches["k4"] <= 0 or qlaunches["k1"]:
            fail("quantized run: K3 and K4 must launch and K1 must not: %s"
                 % qlaunches)
        if not np.all(np.isfinite(qpv)) or qauc <= 0.7 \
                or abs(qauc - valid_auc) > 0.005:
            fail("quantized AUC %.5f vs float %.5f (want > 0.7, within "
                 "0.005)" % (qauc, valid_auc))
        del qbst
    if need_data:
        del ds

    # ---- train_masked: 60,000 rows, float and quantized -------------------
    masked_rows = []
    if "train_masked" in run:
        xm, ym, _ = make_higgs_like(60_000, f, seed=23, w=w_true)
        dsm = lgb.Dataset(xm, ym, params=params)
        dsm.construct()
        for quant in (False, True):
            mp = dict(params, quantized_grad=quant, grad_bits=8)
            mb, mlaunches, ms_s, mpeak = timed_train(mp, dsm)
            mauc = auc(yv, mb.predict(xv))
            row = {"quantized_grad": quant,
                   "strategy": mb._gbdt.learner.strategy,
                   "launches": mlaunches, "train_s": ms_s,
                   "s_per_iter_in_train": ms_s / args.rounds,
                   "peak_device_bytes": mpeak, "valid_auc": mauc,
                   "profile": profile_one(mb)}
            masked_rows.append(row)
            want = "k3t" if quant else "k2"
            if row["strategy"] != "masked" or mlaunches[want] <= 0 \
                    or mlaunches["k4"] or mauc <= 0.7:
                emit({"phase": "train_masked", "runs": masked_rows})
                fail("masked run (quantized=%s) did not go through %s or "
                     "AUC %.4f <= 0.7" % (quant, want, mauc))
            del mb
        emit({"phase": "train_masked", "rows": 60_000,
              "rounds": args.rounds, "runs": masked_rows})

    if "reference" in run:
        reference_phase(torch, dev, lgb, k1, params, f, Config,
                        DeviceTreeLearner, _quant_prepare, quant_ops,
                        prng_key, (R_DLEFT, R_FEAT, R_LCNT, R_LEAF, R_RCNT,
                                   R_THR))

    # ---- kernels line (a run of every phase) -----------------------------
    if every:
        def kernel_entry(name, source, replaces, n, rows, err_key):
            r0 = rows[0]
            return {"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": n,
                    "max_abs_err": max(rw[err_key] for rw in rows),
                    "ms": r0["ms"], "device_ms": r0["device_ms"],
                    "plain_ms": r0["plain_ms"],
                    "bound_ms": r0["bound_ms"], "bound_by": r0["bound_by"],
                    "library_ms": r0["library_ms"]}

        hk = "lightgbm_tpu/ops/pallas/histogram_kernel.py"
        kr = kernel_rows
        kernels = [
            kernel_entry("K1 histogram",
                         "lightgbm_tpu_torch/csrc/histogram.cu", hk + ":41",
                         launches["k1"], kr["k1"], "max_abs_err"),
            kernel_entry("K2 histogram, (F, N) codes",
                         "lightgbm_tpu_torch/csrc/histogram.cu", hk + ":73",
                         masked_rows[0]["launches"]["k2"], kr["k2"],
                         "max_abs_err"),
            kernel_entry("K3 integer histogram",
                         "lightgbm_tpu_torch/csrc/histogram.cu",
                         hk + ":114", qlaunches["k3"], kr["k3"],
                         "max_abs_err"),
            kernel_entry("K3t integer histogram, (F, N) codes",
                         "lightgbm_tpu_torch/csrc/histogram.cu",
                         hk + ":152", masked_rows[1]["launches"]["k3t"],
                         kr["k3t"], "max_abs_err"),
            kernel_entry("K4 stable partition",
                         "lightgbm_tpu_torch/csrc/partition.cu",
                         "lightgbm_tpu/ops/pallas/partition_kernel.py:48",
                         launches["k4"], kr["k4"], "max_abs_err")]
        print(smi_line, flush=True)
        emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_phases(torch, dev, args, run, k1, k4, build, ds, params, Config,
                  DeviceTreeLearner, quant_ops, prng_key, parent):
    """The k1, k2, k3 and k4 phases that `run` names, on the main path's
    working rows; {kernel: [case rows]} for the kernels line. `parent`,
    where given, is another checkout's histogram library, checked and
    timed through the same wrappers beside each histogram case. Every tensor made here is freed on
    return, before the training phases."""
    f = 28
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
    codes_root = buf.view(torch.uint8)[:, :c_cols]
    gh_root = buf.view(torch.float32)[:, cw:cw + 3]
    # the ragged 256-bin codes of k1 and k3
    tail_codes = None
    if run & {"k1", "k3"}:
        tail_codes = torch.from_numpy(np.random.RandomState(1).randint(
            0, 256, size=(args.rows + 3, f)).astype(np.uint8)).to(dev)
    out = {}

    def library_ms(pf, src, nb, reps):
        """One index_add_ over precomputed flat slots: the library call
        that computes the same histogram ((P, F) view `pf`)."""
        p, ff = pf.shape
        slot = (pf.long() + torch.arange(ff, device=dev) * nb).reshape(-1)
        src_r = src.repeat_interleave(ff, dim=0)
        res = torch.zeros((ff * nb, 3), dtype=src.dtype, device=dev)
        try:
            return time_ms(torch, lambda: res.index_add_(0, slot, src_r),
                           reps), "index_add_ (%s)" % src.dtype
        except RuntimeError as e:
            return None, "none: index_add_ on %s raised %s" % (
                src.dtype, str(e).splitlines()[0][:160])

    @contextlib.contextmanager
    def parent_kernel():
        """Inside, the histogram wrappers launch `parent`'s library (the
        same entry) at its launcher's grid: the same Python path and
        inputs, the other kernel."""
        lib, per_sm = build.load("histogram"), dict(k1._BLOCKS_PER_SM)
        build._libs["histogram"] = parent
        k1._BLOCKS_PER_SM.update({kd: PARENT_BLOCKS_PER_SM for kd in per_sm})
        try:
            yield
        finally:
            build._libs["histogram"] = lib
            k1._BLOCKS_PER_SM.update(per_sm)

    def timings(row, fn, reps, with_parent):
        """row's ms and device_ms of fn; with_parent (and a parent) also
        parent_ms and parent_device_ms, the device times in the order
        parent, change, change, parent."""
        row["ms"] = time_ms(torch, fn, reps)
        if parent is None or not with_parent:
            row["device_ms"] = time_ms(torch, fn, reps, hold=True)
            return
        d = []
        for on_parent in (True, False, False, True):
            with parent_kernel() if on_parent else contextlib.nullcontext():
                d.append(time_ms(torch, fn, reps, hold=True))
        with parent_kernel():
            row["parent_ms"] = time_ms(torch, fn, reps)
        row["device_ms"] = (d[1] + d[2]) / 2
        row["parent_device_ms"] = (d[0] + d[3]) / 2

    # ---- K1 / K2 vs plain -------------------------------------------------
    def float_case(rows, label, kernel, plain, codes, gh, nb, reps, pf,
                   atol=1e-4):
        got = kernel(codes, gh, nb)
        again = kernel(codes, gh, nb)
        want = plain(codes, gh, nb)
        # f32 sums in two orders differ by up to ~eps * sqrt(n) * the bin's
        # sum of |terms|; at 1M rows a bin sums ~15k gradients that cancel,
        # so the tolerance adds 1e-5 * sum|terms| to rtol = atol = 1e-4
        mag = plain(codes, gh.abs(), nb)
        torch.cuda.synchronize()
        ea, er = errors(got, want)

        def within(res):
            return bool(((res - want).abs() <= atol + 1e-4 * want.abs()
                         + 1e-5 * mag).all()
                        and torch.equal(res[..., 2], want[..., 2]))
        diff = (got - want).abs()
        count_exact = bool(torch.equal(got[..., 2], want[..., 2]))
        ok = within(got)
        err_vs_mag = float((diff / mag.clamp(min=1e-30)).max())
        p, ff = pf.shape
        extra = {}
        if parent is not None:
            with parent_kernel():
                extra["parent_ok"] = within(kernel(codes, gh, nb))
        timings(extra, lambda: kernel(codes, gh, nb), reps, True)
        plain_ms = time_ms(torch, lambda: plain(codes, gh, nb), 3, warmup=1)
        lib, lib_note = library_ms(pf, gh, nb, reps)
        bms, by = bound(p * ff * codes.element_size() + 12 * p
                        + 12 * ff * nb, 3 * p * ff)
        row = {"shape": label, "P": p, "F": ff, "B": nb,
               "max_abs_err": ea, "max_rel_err": er,
               "max_err_over_abs_sum": err_vs_mag, "ok": ok,
               "count_exact": count_exact,
               "run_to_run_equal": bool(torch.equal(got, again)),
               "plain_ms": plain_ms, "library_ms": lib,
               "library": lib_note, "bound_ms": bms, "bound_by": by}
        row.update(extra)
        rows.append(row)
        return row

    tolerance = ("|diff| <= 1e-4 + 1e-4*|plain| + 1e-5*sum|terms| per bin; "
                 "count lane exact")
    if "k1" in run:
        rk = np.random.RandomState(11)
        k1_rows = []
        float_case(k1_rows, "root window (packed rows)", k1.build_histogram,
                   k1.build_histogram_plain, codes_root, gh_root, b_root, 20,
                   codes_root)
        float_case(k1_rows, "child window (packed rows)",
                   k1.build_histogram, k1.build_histogram_plain,
                   codes_root[:250_000], gh_root[:250_000], b_root, 50,
                   codes_root[:250_000])
        tail_gh = torch.from_numpy(np.stack(
            [rk.randn(args.rows + 3), rk.rand(args.rows + 3),
             np.ones(args.rows + 3)], 1).astype(np.float32)).to(dev)
        float_case(k1_rows, "ragged tail, 256 bins", k1.build_histogram,
                   k1.build_histogram_plain, tail_codes, tail_gh, 256, 20,
                   tail_codes)
        # dynamic range: feature 0's bin 7 holds hessians from 1e-7 to 0.25
        # and gradients from 1e-6 to 1e3 (log-uniform, random signs), bin 8
        # only the small ends of both, beside ordinary rows; held without
        # the absolute term, so a sum that drops small terms fails
        pd = min(args.rows, 200_003)
        dc = rk.randint(0, b_root, size=(pd, f)).astype(np.uint8)
        dg, dh = rk.randn(pd), rk.rand(pd) * 0.25
        for code, (glo, ghi), (hlo, hhi) in ((7, (-6, 3), (-7, np.log10(
                0.25))), (8, (-6, -4), (-7, -5))):
            sel = dc[:, 0] == code
            k = int(sel.sum())
            dg[sel] = np.where(rk.rand(k) < 0.5, -1.0, 1.0) \
                * 10.0 ** rk.uniform(glo, ghi, k)
            dh[sel] = 10.0 ** rk.uniform(hlo, hhi, k)
        dcodes = torch.from_numpy(dc).to(dev)
        dgh = torch.from_numpy(np.stack([dg, dh, np.ones(pd)], 1)
                               .astype(np.float32)).to(dev)
        dyn = float_case(k1_rows, "dynamic range (bins 7, 8 of feature 0)",
                         k1.build_histogram, k1.build_histogram_plain,
                         dcodes, dgh, b_root, 20, dcodes, atol=0.0)
        dyn["tolerance"] = ("|diff| <= 1e-4*|plain| + 1e-5*sum|terms| per "
                            "bin; count lane exact")
        emit({"phase": "k1", "tolerance": tolerance, "cases": k1_rows})
        if not all(rw["ok"] for rw in k1_rows):
            fail("K1 disagrees with its plain version")
        out["k1"] = k1_rows
        del tail_gh, dcodes, dgh

    if "k2" in run:
        # the masked strategy's left-child operand: the rows outside the
        # leaf (here a random half) carry gh == 0
        rk = np.random.RandomState(12)
        k2_rows = []
        codes_t_full = codes_root.t().contiguous()           # (F, N) uint8
        gh_masked = gh_root.contiguous() * torch.from_numpy(
            rk.rand(args.rows) < 0.5).to(dev)[:, None].float()
        for n_cols, reps in ((60_000, 50), (args.rows, 20)):
            ct = codes_t_full[:, :n_cols].contiguous()
            float_case(k2_rows, "(F, N) column codes, masked left child",
                       k1.build_histogram_t, k1.build_histogram_t_plain, ct,
                       gh_masked[:n_cols].contiguous(), b_root, reps, ct.t())
            del ct
        emit({"phase": "k2", "tolerance": tolerance, "cases": k2_rows})
        if not all(rw["ok"] for rw in k2_rows):
            fail("K2 disagrees with its plain version")
        out["k2"] = k2_rows
        del codes_t_full, gh_masked

    # ---- K3 / K3t vs plain -------------------------------------------------
    def int_case(rows, label, kernel, plain, codes, ghq, nb, reps, pf):
        got = kernel(codes, ghq, nb)
        want = plain(codes, ghq, nb)
        torch.cuda.synchronize()
        exact = bool(got.dtype == torch.int32 and torch.equal(got, want))
        p, ff = pf.shape
        extra = {}
        if parent is not None:
            with parent_kernel():
                extra["parent_bit_exact"] = bool(torch.equal(
                    kernel(codes, ghq, nb), want))
        timings(extra, lambda: kernel(codes, ghq, nb), reps, True)
        plain_ms = time_ms(torch, lambda: plain(codes, ghq, nb), 3, warmup=1)
        lib, lib_note = library_ms(pf, ghq.to(torch.int32), nb, reps)
        bms, by = bound(p * ff * codes.element_size()
                        + 3 * p * ghq.element_size() + 12 * ff * nb,
                        3 * p * ff)
        row = {"shape": label, "P": p, "F": ff, "B": nb,
               "operand": str(ghq.dtype), "bit_exact": exact,
               "max_abs_err": 0.0 if exact else float(
                   (got.long() - want.long()).abs().max()),
               "plain_ms": plain_ms, "library_ms": lib,
               "library": lib_note, "bound_ms": bms, "bound_by": by}
        row.update(extra)
        rows.append(row)
        return row

    if "k3" in run:
        rk = np.random.RandomState(13)
        qprobe = DeviceTreeLearner(Config(dict(params, quantized_grad=True,
                                               grad_bits=8)),
                                   ds._inner, device=dev)
        qbuf, qrows = qprobe.quant_working_buffer(g, h, prng_key(0))
        qcw = qbuf.shape[1] - 2                              # (N, 9)
        r_g, r_h = (quant_ops.requant_ratio(qrows.root_max[i], qrows.qcap_op)
                    for i in (0, 1))
        ghq_root = quant_ops.gh_operand_scaled(qbuf[:, qcw], None, 8,
                                               qrows.qcap_op, r_g, r_h)
        qcodes = qbuf.view(torch.uint8)[:, :c_cols]
        k3_rows, k3t_rows = [], []
        int_case(k3_rows, "root window (quantized packed rows, D=9)",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, qcodes, ghq_root,
                 b_root, 20, qcodes)
        int_case(k3_rows, "child window (quantized packed rows)",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, qcodes[:250_000],
                 ghq_root[:250_000], b_root, 50, qcodes[:250_000])
        q16 = (1 << 15) - 1
        tail_ghq = torch.from_numpy(np.stack(
            [rk.randint(-q16, q16 + 1, args.rows + 3),
             rk.randint(0, q16 + 1, args.rows + 3), np.ones(args.rows + 3)],
            1).astype(np.int32)).to(dev)
        int_case(k3_rows,
                 "ragged tail, 256 bins, int32 operand (grad_bits 16)",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, tail_codes, tail_ghq,
                 256, 20, tail_codes)
        del tail_ghq
        ct60 = codes_root[:60_000].t().contiguous()
        ghq60 = ghq_root[:60_000] * torch.from_numpy(
            rk.rand(60_000) < 0.5).to(dev)[:, None].to(torch.int8)
        int_case(k3t_rows, "(F, N) column codes, masked left child",
                 k1.build_histogram_quantized_t,
                 k1.build_histogram_quantized_t_plain, ct60, ghq60, b_root,
                 50, ct60.t())
        emit({"phase": "k3", "tolerance": "bit-exact",
              "cases": k3_rows + k3t_rows})
        if not all(rw["bit_exact"] for rw in k3_rows + k3t_rows):
            fail("K3 / K3t disagree with their plain version")
        out["k3"], out["k3t"] = k3_rows, k3t_rows
        del ct60, ghq60, qbuf, ghq_root, qcodes, qprobe

    # ---- K4 vs plain ------------------------------------------------------
    if "k4" in run:
        rk = np.random.RandomState(14)
        k4_rows = []

        def k4_case(label, win, key, reps):
            res = torch.empty_like(win)
            got = k4.stable_partition3(win, key, res)
            want = k4.stable_partition3_plain(win, key)
            torch.cuda.synchronize()
            exact = bool(torch.equal(got, want))
            times = {}
            timings(times, lambda: k4.stable_partition3(win, key, res), reps,
                    False)
            plain = time_ms(torch,
                            lambda: k4.stable_partition3_plain(win, key),
                            3, warmup=1)
            wn, dn = win.shape
            bms, by = bound(wn * (8 * dn + 4), 0)
            row = {"shape": label, "W": wn, "D": dn, "bit_exact": exact,
                   "max_abs_err": 0.0 if exact else float("inf"),
                   "plain_ms": plain, "library_ms": None,
                   "library": "no single PyTorch call computes a stable "
                              "3-way row partition", "bound_ms": bms,
                   "bound_by": by}
            row.update(times)
            k4_rows.append(row)
            return row

        # the root split's window: rows keyed by a feature threshold
        key_root = (codes_root[:, 0].to(torch.int32) > b_root // 3) \
            .to(torch.int32).contiguous()
        k4_case("root split window", buf, key_root, 20)
        w2 = torch.from_numpy(rk.randint(0, 2**32,
                                         size=(args.rows + 3, d_cols),
                                         dtype=np.uint32).view(np.int32)) \
            .to(dev)
        key2 = torch.from_numpy(rk.randint(0, 3, size=args.rows + 3)
                                .astype(np.int32)).to(dev)
        k4_case("ragged, 3 keys", w2, key2, 20)
        k4_case("quantized rows, D=9", w2[:, :9].contiguous(), key2, 20)
        emit({"phase": "k4", "tolerance": "bit-exact", "cases": k4_rows})
        if not all(rw["bit_exact"] for rw in k4_rows):
            fail("K4 disagrees with its plain version")
        out["k4"] = k4_rows
    return out


def reference_phase(torch, dev, lgb, k1, params, f, Config,
                    DeviceTreeLearner, _quant_prepare, quant_ops, prng_key,
                    record_cols):
    """The reference phase: small tasks trained on the card and on the
    CPU, held to the same trees and raw scores within 1e-4."""
    R_DLEFT, R_FEAT, R_LCNT, R_LEAF, R_RCNT, R_THR = record_cols
    # ---- reference: card vs CPU on small inputs ---------------------------
    xs, ys, w_small = make_higgs_like(20_000, f, seed=99)
    sp = dict(params, num_leaves=31, min_gain_to_split=1e-3)

    def shape_of(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves]))
                for t in b._gbdt.models]

    def grown_q(device, strategy, qp):
        """Three trees grown from fixed gradients (iter_seed 0..2) and the
        first one's exact root histogram, as the strategy's core builds
        it (quantize with prng_key(0), K3 / K3t on the card, the plain
        versions on the CPU)."""
        dsr = lgb.Dataset(xs, ys, params=qp).construct()
        lr = DeviceTreeLearner(Config(qp), dsr._inner, strategy=strategy,
                               device=device)
        # binary-logloss gradients at a score with signal, made in numpy
        # so both devices get the same f32 inputs (noise gradients would
        # make every split a near-tie)
        prob = 1.0 / (1.0 + np.exp(-0.3 * (xs @ w_small)))
        gr = torch.from_numpy((prob - ys).astype(np.float32)).to(device)
        hr = torch.from_numpy((prob * (1.0 - prob)).astype(np.float32)) \
            .to(device)
        trees = []
        for seed in range(3):
            rec, leaf, k = lr.grow(gr, hr, iter_seed=seed)
            trees.append((rec[:k], leaf.cpu()))
        if strategy == "masked":
            packed, _, _, _ = _quant_prepare(gr, hr, prng_key(0),
                                             quant_bits=8,
                                             quant_renew=False)
            ghq = quant_ops.gh_operand(
                packed, torch.ones_like(packed, dtype=torch.bool), 8)
            root = k1.build_histogram_quantized_t(lr.codes_t, ghq,
                                                  lr.col_device_bins)
        else:
            data, qr = lr.quant_working_buffer(gr, hr, prng_key(0))
            rgs = [quant_ops.requant_ratio(qr.root_max[i], qr.qcap_op)
                   for i in (0, 1)]
            ghq = quant_ops.gh_operand_scaled(data[:, data.shape[1] - 2],
                                              None, 8, qr.qcap_op, *rgs)
            root = k1.build_histogram_quantized(
                data.view(torch.uint8)[:, :lr.c_cols], ghq,
                lr.col_device_bins)
        return trees, root.cpu()

    def record_diffs(ta, tb):
        """How the split records of two growers' trees differ: per tree,
        the split counts, whether leaf / feature / threshold / counts and
        the row -> leaf maps are equal, whether the f32 columns agree to
        rtol = atol = 1e-4, and their largest relative difference. The
        split scan's f32 prefix sums run in another order on the card,
        and a gain is a difference of squared sums, so equal integer
        histograms give f32 columns that differ by up to ~5e-5 relative
        (measured); 1e-4 is the card-vs-CPU bound of the float runs."""
        out = []
        ints = [R_LEAF, R_FEAT, R_THR, R_LCNT, R_RCNT]
        # default_left is left out of the f32 columns: where the leaf has
        # no rows in the feature's missing bin both directions make the
        # same split and f32 rounding picks one (the row -> leaf maps
        # hold the routing)
        floats = [c for c in range(13) if c not in ints and c != R_DLEFT]
        for (ra, la), (rb, lb) in zip(ta, tb):
            same_shape = ra.shape == rb.shape
            fa, fb = ra[:, floats], rb[:, floats]
            out.append({
                "splits": [len(ra), len(rb)],
                "ints_equal": bool(same_shape and np.array_equal(
                    ra[:, ints], rb[:, ints])),
                "leaf_ids_equal": bool(torch.equal(la, lb)),
                "floats_close": bool(same_shape and np.allclose(
                    fa, fb, rtol=1e-4, atol=1e-4)),
                "max_rel_diff": float(np.max(
                    np.abs(fa - fb) / np.maximum(np.abs(fb), 1e-3)))
                if same_shape and len(ra) else None})
        return out

    def gradient_witness(card_b, qp, strategy):
        """From the same f32 scores (the CPU run's after iterations 1..4),
        the largest gap in ulps between the card's and the CPU's objective
        gradients and hessians, and the number of rows whose stored (qg|qh)
        integer differs when both are quantized as that iteration's tree
        quantizes them (key prng_key(iteration), the strategy's storage
        bits)."""
        cpu_b = lgb.train(qp, lgb.Dataset(xs, ys), num_boost_round=1,
                          device="cpu")
        lr = card_b._gbdt.learner
        renew = strategy == "compact" and lr.quant_renew
        out = []
        for it in range(1, 5):
            sc = cpu_b._gbdt.score_updater.score[0].clone()
            gc, hc = cpu_b._gbdt.objective.get_gradients(sc)
            gd, hd = card_b._gbdt.objective.get_gradients(sc.to(dev))
            gd, hd = gd.cpu(), hd.cpu()

            def ulps(a, b):
                return int((a.view(torch.int32).long()
                            - b.view(torch.int32).long()).abs().max())

            pc = _quant_prepare(gc, hc, prng_key(it),
                                quant_bits=lr.quant_bits,
                                quant_renew=renew)[0]
            pd = _quant_prepare(gd.to(dev), hd.to(dev), prng_key(it),
                                quant_bits=lr.quant_bits,
                                quant_renew=renew)[0].cpu()
            out.append({"iteration": it, "max_ulp_gap_grad": ulps(gd, gc),
                        "max_ulp_gap_hess": ulps(hd, hc),
                        "grad_rows_differ": int((gd != gc).sum()),
                        "stored_rows_differ": int((pd != pc).sum())})
            cpu_b.update()
        return out

    # Every run is held to the same trees and raw scores within 1e-4, with
    # one exemption, which rests on a reading made in the same run: the
    # card's and the CPU's objective gradients may differ in the last ulp
    # (torch.exp), and at the compact core's 16-bit storage a row whose
    # g * s lies that close to an integer rounds the other way, so a
    # near-tie split may go another way. Compact quantized may therefore
    # grow other trees only where its witness counts rows whose stored
    # integer differs between the devices from the same scores. The
    # grower itself (quantization, K3 / K3t, the split scan) is held to
    # the same trees from identical gradients.
    ref_rows = []
    for strategy, quant in (("compact", False), ("compact", True),
                            ("masked", False), ("masked", True)):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        qp = dict(sp, quantized_grad=quant, grad_bits=8)
        on_card = lgb.train(qp, lgb.Dataset(xs, ys), num_boost_round=5)
        on_cpu = lgb.train(qp, lgb.Dataset(xs, ys), num_boost_round=5,
                           device="cpu")
        row = {"strategy": strategy, "quantized_grad": quant,
               "same_trees": shape_of(on_card) == shape_of(on_cpu),
               "max_abs_raw_diff": float(np.max(np.abs(
                   on_card.predict(xs, raw_score=True)
                   - on_cpu.predict(xs, raw_score=True)))),
               "raw_tolerance": 1e-4}
        row["ok"] = row["max_abs_raw_diff"] <= row["raw_tolerance"]
        if quant:
            wit = gradient_witness(on_card, qp, strategy)
            row["gradient_witness"] = wit
            row["witness_stored_rows_differ"] = sum(
                w["stored_rows_differ"] for w in wit)
        exempt = (strategy == "compact" and quant
                  and row["witness_stored_rows_differ"] > 0)
        row["other_trees_allowed"] = exempt
        row["ok"] = row["ok"] and (row["same_trees"] or exempt)
        if quant:
            card_trees, card_root = grown_q(dev, strategy, qp)
            cpu_trees, cpu_root = grown_q(torch.device("cpu"), strategy, qp)
            diffs = record_diffs(card_trees, cpu_trees)
            row["fixed_gradient_trees"] = diffs
            row["same_trees_from_fixed_gradients"] = all(
                d["ints_equal"] and d["leaf_ids_equal"] and d["floats_close"]
                for d in diffs)
            row["root_hist_equal"] = bool(torch.equal(card_root, cpu_root))
            row["ok"] = (row["ok"] and row["root_hist_equal"]
                         and row["same_trees_from_fixed_gradients"])
        ref_rows.append(row)
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    emit({"phase": "reference", "rows": 20_000, "rounds": 5,
          "runs": ref_rows})
    if not all(rw["ok"] for rw in ref_rows):
        fail("card and CPU runs disagree on the small reference tasks")


if __name__ == "__main__":
    sys.exit(main())
