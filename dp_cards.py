#!/usr/bin/env python3
"""Data-parallel training of lightgbm_tpu_torch across the cards of one
host: one process per card under NCCL (or per CPU rank under gloo).

    python3 dp_cards.py --ranks 4                 # 4 cards, NCCL
    python3 dp_cards.py --ranks 4 --device cpu --rows 20000   # gloo, CPU

Every rank trains the higgs-1m rows and params (bench.py:35,58,
:371-379: 1M x 28, 255 leaves, max_bin 63) with tree_learner=data for
--rounds rounds in each reduction mode (psum, and reduce-scatter, the
default at more than one rank), then times 3 steady iterations and
profiles one more (the collectives' device time by kernel name, per
rank); the launcher trains the serial run on all rows beside them.
It checks that every rank wrote byte-equal model text, that the trees
equal the serial ones structurally (split feature and counts at every
node, gains within 1e-4 relative, 2e-5 where a threshold differs) and
that the held-out AUC is within 0.001 of the serial run's, and prints
one JSON line per mode and, last, {"ok": ...}. Exits non-zero on a failed
check. Where a mode's trees part from serial, its line carries both
picks at the first differing node summed in f64 (split_witness).
"""
import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def rank_main(args):
    sys.path.insert(0, HERE)
    os.environ["LGBM_TPU_DP_REDUCE"] = args.mode
    import torch
    import chip_smoke
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.distributed import bootstrap
    from lightgbm_tpu_torch.parallel import network
    dev = None if args.device == "cuda" else "cpu"
    bootstrap.initialize("127.0.0.1:%d" % args.port, args.ranks, args.rank)

    def sync():
        if dev is None:
            torch.cuda.synchronize()
    params = json.loads(args.params)
    x, y, _ = chip_smoke.make_higgs_like(args.rows, 28)
    ds = lgb.Dataset(x, y, params=dict(params), device=dev)
    ds.construct()
    bootstrap.barrier("data")
    sync()
    t0 = time.time()
    b = lgb.train(dict(params, tree_learner="data"), ds, args.rounds)
    sync()
    train_s = time.time() - t0
    print("rank %d: trained in %.1f s" % (args.rank, train_s),
          file=sys.stderr, flush=True)
    lr = b._gbdt.learner
    trees = max(lr.stats.trees, 1)
    out = {"rank": args.rank, "rows": list(lr.row_block),
           "s_per_iter": train_s / args.rounds,
           "host_syncs_per_tree": lr.stats.host_syncs / trees,
           "collectives_per_tree": network.collectives / trees,
           "collective_bytes_per_tree": network.collective_bytes / trees,
           "scatter_cols": lr.scatter_cols,
           "captured": lr._loop.graph is not None,
           "backend": bootstrap.cuda_backend()}
    with open(args.out, "w") as f:
        f.write(b.model_to_string())
    steady = []
    for _ in range(3):
        bootstrap.barrier("steady")
        sync()
        t1 = time.time()
        b.update()
        sync()
        steady.append(time.time() - t1)
    out["steady_s_per_iter"] = float(np.median(steady))
    if dev is None:
        # every rank runs the profiled iteration (its collectives need all
        # of them); each reports its own collectives' device time
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        bootstrap.barrier("profile")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            b.update()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        nccl = [e for e in kern if "nccl" in e.key.lower()]
        out["profiled_device_ms"] = sum(
            e.self_device_time_total for e in kern) / 1e3
        out["nccl_device_ms"] = sum(
            e.self_device_time_total for e in nccl) / 1e3
        out["nccl_launches"] = sum(e.count for e in nccl)
    print(json.dumps(out), flush=True)
    bootstrap.shutdown()


def split_witness(serial, dp, inner, label, cfg, diff):
    """At the node where two models first split otherwise (`diff`, from
    chip_smoke._structural_diff), each model's split with its gain summed
    in f64 over its own partition of the rows (chip_smoke._f64_gains):
    close f64 gains make a near-tie that f32 rounding can turn; far ones a
    fault. None when the models part otherwise."""
    import chip_smoke
    m = re.match(r"tree (\d+) node (\d+)", diff or "")
    if m is None:
        return None
    ti, i = int(m.group(1)), int(m.group(2))
    out = {"tree": ti, "node": i}
    for name, g in (("serial", serial), ("dp", dp)):
        gains, counts = chip_smoke._f64_gains(
            g, inner, label, ti + 1, cfg.lambda_l2,
            cfg.min_gain_to_split)[ti]
        t = g.models[ti]
        out[name] = {"feature": int(t.split_feature[i]),
                     "threshold": float(t.threshold[i]),
                     "count": int(t.internal_count[i]),
                     "f64_count": int(counts[i]),
                     "f32_gain": float(t.split_gain[i]),
                     "f64_gain": float(gains[i])}
    a, b = out["serial"]["f64_gain"], out["dp"]["f64_gain"]
    out["f64_gap"] = abs(a - b) / max(1.0, abs(a))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--modes", default="psum,scatter")
    ap.add_argument("--mode-timeout", type=float, default=300.0,
                    help="seconds a mode's ranks may take; then they are "
                    "killed and their output printed")
    # one rank (internal)
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--mode", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--params", default="")
    args = ap.parse_args()
    if args.rank >= 0:
        return rank_main(args)

    import torch
    sys.path.insert(0, HERE)
    import chip_smoke
    import lightgbm_tpu_torch as lgb
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print("dp_cards: %d ranks need %d cards, found %d"
                  % (args.ranks, args.ranks, torch.cuda.device_count()),
                  file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi, flush=True)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1}
    dev = None if args.device == "cuda" else "cpu"
    x, y, w = chip_smoke.make_higgs_like(args.rows, 28)
    xv, yv, _ = chip_smoke.make_higgs_like(100_000, 28, seed=4242, w=w)
    ds = lgb.Dataset(x, y, params=dict(params), device=dev)
    ds.construct()
    os.environ["LGBM_TPU_STRATEGY"] = "compact"
    if dev is None:
        torch.cuda.synchronize()
    t0 = time.time()
    serial = lgb.train(dict(params), ds, args.rounds)
    if dev is None:
        torch.cuda.synchronize()
    serial_s = (time.time() - t0) / args.rounds
    os.environ.pop("LGBM_TPU_STRATEGY")
    serial_auc = chip_smoke.auc(yv, serial.predict(xv))
    problems = []
    tmp = tempfile.mkdtemp(prefix="dp_cards_")
    try:
        for mode in args.modes.split(","):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            outs = [os.path.join(tmp, "%s%d.txt" % (mode, r))
                    for r in range(args.ranks)]
            t0 = time.time()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 "--ranks", str(args.ranks), "--port", str(port), "--mode",
                 mode, "--out", outs[r], "--rows", str(args.rows), "--rounds",
                 str(args.rounds), "--device", args.device,
                 "--params", json.dumps(params)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(args.ranks)]
            results, deadline = [], time.time() + args.mode_timeout
            try:
                outs_err = []
                for p in procs:
                    try:
                        outs_err.append(p.communicate(
                            timeout=max(1.0, deadline - time.time())))
                    except subprocess.TimeoutExpired:
                        for q in procs:
                            q.kill()
                        outs_err = [q.communicate() for q in procs]
                        problems.append("%s: the ranks did not exit in %.0f s"
                                        % (mode, args.mode_timeout))
                        break
                for p, (out, err) in zip(procs, outs_err):
                    lines = [ln for ln in out.splitlines()
                             if ln.startswith("{")]
                    if not lines:
                        print(err[-3000:], file=sys.stderr)
                        print(json.dumps({"ok": False, "problems": problems + [
                            "%s: a rank exited %s without results"
                            % (mode, p.returncode)]}))
                        return 1
                    results.append(json.loads(lines[-1]))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            texts = [open(o).read() for o in outs]
            b = lgb.Booster(model_str=texts[0], device=dev)
            for t in b._gbdt.models:
                t.rebin_inner(ds._inner)
            diff = chip_smoke._structural_diff(serial._gbdt, b._gbdt,
                                               args.rounds)[0]
            dp_auc = chip_smoke.auc(yv, b.predict(xv))
            row = {"mode": mode, "ranks": args.ranks, "rows": args.rows,
                   "rounds": args.rounds, "wall_s": time.time() - t0,
                   "serial_s_per_iter": serial_s, "serial_auc": serial_auc,
                   "auc": dp_auc,
                   "text_equal": all(t == texts[0] for t in texts),
                   "structural_diff": diff,
                   "split_witness": split_witness(
                       serial._gbdt, b._gbdt, ds._inner,
                       np.asarray(ds._inner.metadata.label),
                       serial._gbdt.config, diff),
                   "per_rank": results}
            print(json.dumps(row), flush=True)
            if not row["text_equal"]:
                problems.append("%s: ranks wrote different model text" % mode)
            if diff is not None:
                problems.append("%s: %s" % (mode, diff))
            if abs(dp_auc - serial_auc) > 1e-3:
                problems.append("%s: AUC %.6f vs serial %.6f" % (
                    mode, dp_auc, serial_auc))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": not problems, "problems": problems}))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
