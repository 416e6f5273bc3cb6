#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (lightgbm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase (1M x 28, 10 rounds)
    python3 chip_smoke.py --rows 200000 --rounds 3   # a short first check
    python3 chip_smoke.py --phases device,k1,k3      # only those phases
    python3 chip_smoke.py --phases k1,k2,k3,k4,profile --parent-src OLD
        # beside each histogram and partition case, OLD's kernel (another
        # checkout of the repo, e.g. an earlier commit from `git archive`)
        # on the same inputs in the same run, and one profiled iteration
        # with OLD's partition kernel (train_quant: with OLD's quantized
        # histograms, the operand built in torch and then OLD's K3)

Phases, one JSON line each:
  device       card name and power limit, and the kernels' build (one nvcc
               per source, started together; ptxas registers and shared
               memory per kernel); per built library and kernel, the count
               of each atomic opcode in its SASS (cuobjdump -sass; "not
               measured" without cuobjdump); the integer kernels'
               registers, spills and shared-memory adds (ATOMS.ADD);
  k1           the float histogram kernel vs its plain PyTorch version at
               the compact path's shapes (the root window of the packed
               working rows, a child window, a ragged tail at 256 bins),
               and a dynamic-range case held without the absolute term,
               4,500 features of 256 bins, and a grid of one block over
               2^20 + 4,099 rows (17 flushes of its words); every case,
               and the device-window entry's, launched 20
               times on one input: the same bits each time (fails
               otherwise), and the count of slots unequal to the plain
               version's (an f64 sum rounded once);
  k2           the same kernel over column-major (F, N) codes, the masked
               strategy's layout, at 60,000 and at the full row count (20
               launches each, the same bits); then
               the split key's column entry (the masked core's decode and
               row update) vs its plain version, bit-exact in leaf ids and
               the left operand: 60,000 rows, the full row count and a
               ragged count, uint8 and 16-bit codes, f32, int8 and int32
               operands, and a GO = 0 descriptor that changes nothing;
  k3           the exact integer histogram kernel vs its plain version,
               bit-exact: packed quantized rows (int8 operand), a child
               window, a ragged tail at 256 bins with an int32 operand,
               K3t over (F, N) codes at 60,000 rows, and a flush probe
               (one row per thread of the grid); then the packed-row entry
               (the operand built in the kernel, as the compact core
               calls it) at the root and the child windows of 250k, 62k,
               16k, 4k and 1k rows, beside the two-step it replaces
               (gh_operand_scaled, then K3) on this tree and the parent's;
  k4           the stable partition kernel vs its plain version, bit-exact:
               the root split window (D = 11), a ragged 3-key window, the
               quantized rows (D = 9), the compact core's child windows
               (250k, 62k, 16k, 4k and 1k rows at D = 11 and D = 9), wide
               rows (D = 260) and one tile more than the grid holds; then
               the device-window entries of the compact core's device loop
               (the window read from the split descriptor), bit-exact or,
               for K1, within K1's bar: the split-key kernel, K4's, K3's
               and K1's window entries at the root and the child windows;
               then the split key's router entry (the out-of-bag rows'
               leaves from a tree's records), bit-exact: the records of a
               255-leaf tree over the main path's 8-bit codes, random
               records over 4-bit and 16-bit codes, M = 200,000 and a
               ragged M, k = L - 1 and k = 0;
  train        lightgbm_tpu_torch.train on a Higgs-shaped 1,000,000 x 28
               binary task (num_leaves=255, max_bin=63, learning_rate=0.1,
               min_data_in_leaf=20) for 10 rounds on the compact strategy,
               the main path: the fused iteration, whose tree grows in the
               device loop (one captured split step replayed 254 times):
               launches of every kernel during that run, per tree and per
               captured step, the partition kernel's rows and its byte
               bound per tree, host syncs per tree, time, peak memory,
               held-out AUC, a model-text round trip, and the training
               scores against predict on the training rows (apart from
               those an f32 threshold of predict moves); beside it the
               same 10 rounds on the host loop (the generic iteration and
               grow_tree_compact_core, one host sync per split): its time,
               launches and AUC, which the main path's must be within
               0.001 of;
  profile      one more float boosting iteration under torch.profiler on
               each loop, the partition kernel's and the split-key kernel's
               launches and device time summed over their kernels (named
               from the libraries' SASS); with --parent-src first one
               host-loop iteration on OLD's partition kernel;
  train_quant  the same data and parameters with quantized_grad (grad_bits
               8): K3 / K1 / K4 launches, time, peak memory, and held-out
               AUC > 0.7 and within 0.005 of the float run's; beside it the
               host loop, and the generic iteration on the device loop,
               whose trees and AUC must equal the host loop's (the same
               trees from the same gradients); one more iteration of each
               loop profiled, K3's kernels summed (with --parent-src also
               one host-loop iteration on the parent's two-step);
  loop         20,000-row trees (31 leaves) of each strategy grown by its
               captured device loop on the card, by the same step run
               eagerly on the CPU (the plain versions) and by its host
               loop on the card, float and quantized, from the same
               gradients: against the CPU equal leaf, feature and count
               columns and leaf ids, f32 columns within 1e-4; quantized,
               records equal to the host loop's bit for bit; the capture's
               time and launches per step, and a tree grown under the sync
               debug mode "error"; then the compact core's bag carry (a
               14,000-row bag of the 20,000 rows), float and quantized,
               against the same step on the CPU from the same bag, every
               row's leaf equal (the router's for the out-of-bag rows),
               and one bagged tree under the sync debug mode "error";
  train_masked 60,000 x 28 (the masked strategy, which auto picks below
               65,536 rows), float and quantized, 10 rounds on the fused
               iteration, whose tree grows in the masked core's device loop
               (the column split key and K2 / K3t replayed 254 times per
               tree): launches per tree and per captured step, host syncs
               per tree (1), capture time, time, steady s per iteration,
               peak memory and held-out AUC; beside it the same rounds on
               the masked host loop (grow_tree, one host sync per split),
               whose float AUC the device loop's must be within 0.001 of;
               quantized, also the generic iteration on the device loop,
               whose trees must equal the host loop's; one more iteration
               of each loop profiled;
  train_bag    lightgbm_tpu_torch.train with row sampling: the 1M-row task
               with bagging_fraction 0.8 (bagging_freq 1), float and
               quantized, and with GOSS (top_rate 0.2, other_rate 0.1; 10
               rounds of warm-up and --rounds / 2 sampled), all on the fused
               iteration (the compact core's bag carry and the router);
               the 60,000-row masked task with the same bagging, float and
               quantized (fused), and with pos/neg bagging 0.5 / 0.5 (the
               generic iteration, a host bag). Per case: time, steady s per
               iteration, host syncs and launches per tree (the router's
               among them), K4's window rows per tree (bag rows), each
               carry's capture time, peak memory, held-out AUC. Fails
               unless 1 host sync per tree, the training scores equal
               predict(raw_score=True) on the training rows within 1e-5,
               the AUC is > 0.7 and at most 0.005 below the unbagged float
               run's on the same data (the train / train_masked phase's,
               else one made here), one router launch per sampled compact
               tree, and GOSS ran both its fused steps;
  train_valid  lightgbm_tpu_torch.train on the train phase's 1M-row task
               with its 100,000 held-out rows as a validation set (binned
               by reference), metric auc and binary_logloss, early stopping
               (5 rounds) and evals_result, on the fused iteration: host
               syncs per tree (1), the validation set's scores (the binned
               walk of each tree) against predict(raw_score=True) within
               1e-5 apart from the rows an f32 threshold moves (counted),
               the recorded last validation AUC against the AUC of those
               scores; steady s per iteration (update and evaluation),
               eval ms per iteration (and one iteration's taken apart:
               each dataset's fetch, each metric) and device fetches per
               iteration,
               beside the train phase's steady s per iteration; the
               validation update's device ms and launches per tree
               (profiled);
  train_objectives
               lightgbm_tpu_torch.train with each objective but binary and
               the multiclass ones (regression, regression_l1, huber,
               fair, quantile, mape, poisson, tweedie, gamma,
               cross_entropy, cross_entropy_lambda) on the train phase's
               rows, 5 rounds each, targets drawn from the generator's
               margin (OBJECTIVE_TARGETS); per objective the iteration
               (fused, or generic with leaf renewal on the host), steady s
               per iteration, host syncs and score fetches per tree, the
               renewal's host ms per tree, launches per tree; fails unless
               the held-out default metric beats the constant model's, the
               scores are finite, and 1 host sync per tree (2 with
               renewal: the leaf map);
  train_multiclass
               bench.py's 5-class variant of the same rows, multiclass and
               multiclassova for 5 rounds with the held-out rows as a
               validation set (multi_logloss, multi_error): steady s per
               iteration (5 trees), captures (1 per learner), host syncs
               per tree (1), K1 / K4 window launches per iteration; fails
               unless held-out multi_logloss is below the class prior's and
               the class-0 one-vs-rest AUC > 0.7 (bench.py's gate);
  reference    small tasks trained on the card and on the CPU (the plain
               versions): compact float and compact quantized on the device
               loop (the fused iteration) and on the host loop, masked
               float and masked quantized on the device loop. Every run
               gives raw scores within 1e-4 and the same trees; quantized
               runs also equal root histograms and the same trees from
               identical gradients.
               Compact quantized may grow other trees only where its
               witness shows stored integers that differ between the
               devices from the same scores. Then bagged (0.7) and GOSS
               (learning_rate 0.5: 3 sampled trees) runs of each strategy,
               float and quantized, held to the same trees and raw scores
               within 1e-4, or, where a tied threshold sends out-of-bag
               rows each device's way, within 1e-4 on the other rows (at
               most 2 % so separated). Then every objective of
               train_objectives on compact float, and 3-class multiclass
               on compact and masked float and compact quantized: the same
               trees, raw scores within 1e-5 (fair and gamma, whose leaves
               divide cancelling gradient sums by small hessian sums and
               so carry the split scan's f32 order, within 4e-4, each
               device's first tree within 64 f32 roundings of the root's
               sums of the exact f64 leaf values; quantized 1e-4, with
               the binary rows' witness
               exemption); and the two
               card-vs-plain
               float cases that flaked before K1 / K2 summed in a fixed
               order, 10 runs each, all of which must agree.
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

PHASES = ("device", "k1", "k2", "k3", "k4", "train", "profile",
          "train_quant", "train_masked", "train_bag", "train_valid",
          "train_objectives", "train_multiclass", "loop", "reference")


T0 = time.time()


def emit(obj):
    """One JSON line on stdout; a phase's line also notes the seconds
    since start on stderr."""
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        print("chip_smoke: %s done at %.1f s" % (obj["phase"],
                                                  time.time() - T0),
              file=sys.stderr, flush=True)


def fail(msg):
    print("chip_smoke: FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def higgs_margin(x, w):
    """The generator's noiseless margin of rows x under ground truth w."""
    return x @ w * 0.3 + 0.2 * x[:, 0] * x[:, 1] - 0.1 * x[:, 2] ** 2


def make_higgs_like(n, f, seed=17, w=None, n_classes=1):
    """Seeded Higgs-shaped binary task: informative and noise features,
    moderately separable classes (the repo benchmark's generator,
    bench.py's make_higgs_like without categorical columns). Pass `w` to
    draw another sample from the same ground truth. n_classes > 1:
    bench.py's multiclass variant, the noisy margin's quantiles cut into
    balanced classes (class 0 = lowest margin), from the same draws."""
    r = np.random.RandomState(seed)
    x = r.randn(n, f).astype(np.float32)
    if w is None:
        w = r.randn(f) * (r.rand(f) > 0.4)
    noisy = higgs_margin(x, w) + r.randn(n) * 1.5
    if n_classes > 1:
        edges = np.quantile(noisy, np.linspace(0, 1, n_classes + 1)[1:-1])
        return x, np.searchsorted(edges, noisy).astype(np.float64), w
    return x, (noisy > 0).astype(np.float64), w


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


def _cuobjdump(nvcc_path):
    tool = os.path.join(os.path.dirname(nvcc_path), "cuobjdump") \
        if nvcc_path else ""
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump") or ""
    return tool


def _kernel_name(demangled):
    """A demangled kernel signature without its return type, namespace and
    parameter list (the first "(" outside the template arguments, which
    cu++filt writes with casts such as "(bool)1")."""
    name = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "",
                  demangled)
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def sass_functions(nvcc_path, path):
    """{kernel: {opcode: count}} of the atomic instructions (shared-memory
    ATOMS.*, global ATOM.* / RED.*) of each kernel in one built library's
    SASS, read with cuobjdump -sass from nvcc's toolkit; kernels by their
    demangled names without namespace or arguments; {} where cuobjdump is
    absent."""
    tool = _cuobjdump(nvcc_path)
    if not tool:
        return {}
    filt = os.path.join(os.path.dirname(tool), "cu++filt")
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
            funcs = {_kernel_name(d): funcs[n] for n, d in zip(names, dem)}
    return funcs


def sass_atomics(nvcc_path, libs):
    """{library: sass_functions} for each built library; "not measured"
    where cuobjdump is absent."""
    if not _cuobjdump(nvcc_path):
        return "not measured: no cuobjdump"
    return {name: sass_functions(nvcc_path, path)
            for name, path in libs.items()}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_kernels(text, nvcc_path, pattern):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas -v output for the entries whose mangled name contains
    `pattern`, demangled with cu++filt where the toolkit has it."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = _PTXAS_ENTRY.search(ln)
        if m:
            cur = out.setdefault(m.group(1), {}) if pattern in m.group(1) \
                else None
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_REGS.search(ln)
        if m:
            cur["registers"] = int(m.group(1))
    filt = os.path.join(os.path.dirname(_cuobjdump(nvcc_path)), "cu++filt")
    names = list(out)
    if os.path.isfile(filt) and names:
        dem = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(dem) == len(names):
            out = {_kernel_name(d): out[n] for n, d in zip(names, dem)}
    return out


@contextlib.contextmanager
def parent_k4(torch, k4, lib):
    """Inside, the partition wrapper, and the growth core that imports it
    by name, launch `lib`, another checkout's partition library: through
    the same wrapper where `lib` has this tree's C interface, else through
    a launcher of the three-launch interface (count, scan, scatter) that
    the kernel had before its cooperative form."""
    from lightgbm_tpu_torch.models import device_learner
    from lightgbm_tpu_torch.ops.kernels import build
    if hasattr(lib, "lgbt_partition_max_grid"):
        own = build.load("partition")
        build._libs["partition"] = lib
        try:
            yield
        finally:
            build._libs["partition"] = own
        return
    lib.lgbt_partition_tile_rows.restype = ctypes.c_int
    tile = int(lib.lgbt_partition_tile_rows())
    fn = lib.lgbt_partition_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]

    def launch(win, key3, out=None):
        if out is None:
            out = torch.empty_like(win)
        w, d = win.shape
        if w:
            scratch = torch.empty(6 * -(-w // tile), dtype=torch.int32,
                                  device=win.device)
            build.check(fn(win.data_ptr(), key3.data_ptr(), w, d,
                           scratch.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream(win.device)
                           .cuda_stream), "parent partition kernel launch")
        return out

    saved = (k4.stable_partition3, device_learner.stable_partition3)
    k4.stable_partition3 = device_learner.stable_partition3 = launch
    try:
        yield
    finally:
        k4.stable_partition3, device_learner.stable_partition3 = saved


def parent_histogram(src, lib):
    """The histogram wrapper module of another checkout (its
    lightgbm_tpu_torch imported as a package of its own,
    parent_lightgbm_tpu_torch) launching `lib`, that checkout's built
    histogram library: the parent's kernels as its own wrapper launched
    them (its grid, its output)."""
    import importlib.util
    pkg = os.path.join(src, "lightgbm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_lightgbm_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(spec.name + ".ops.kernels.build")._libs[
        "histogram"] = lib
    return importlib.import_module(spec.name + ".ops.kernels.histogram")


@contextlib.contextmanager
def parent_two_step(k1, pk1):
    """Inside, the compact core builds its quantized histograms as the
    parent did: the (W, 3) operand by gh_operand_scaled, then K3 through
    `pk1`, the parent's histogram wrapper."""
    from lightgbm_tpu_torch.models import device_learner
    from lightgbm_tpu_torch.ops import quantize as quant_ops
    own = device_learner.build_histogram_quantized_rows

    def two_step(rows, cw, c_cols, item_bits, r_g, r_h, qcap_op, grad_bits,
                 num_bins):
        ghq = quant_ops.gh_operand_scaled(rows[:, cw], None, grad_bits,
                                          qcap_op, r_g, r_h)
        return pk1.build_histogram_quantized(
            k1.packed_codes(rows, cw, c_cols, item_bits), ghq, num_bins)

    device_learner.build_histogram_quantized_rows = two_step
    try:
        yield
    finally:
        device_learner.build_histogram_quantized_rows = own


@contextlib.contextmanager
def host_loop(torch, generic_only=False):
    """Inside, training takes the generic iteration and, unless
    generic_only, grows each tree with the strategy's host loop
    (grow_tree_compact_core or grow_tree: one host sync per split, the
    compact core on the kernels' host-int entries) instead of its device
    loop: the path of the port before the device loops, held beside
    them."""
    from lightgbm_tpu_torch.models import device_learner as dl
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.utils.random import prng_key
    own = (GBDT._fused_eligible, dl.DeviceTreeLearner.grow)

    def grow(self, grad, hess, iter_seed=0, bag_indices=None):
        if bag_indices is not None:
            raise RuntimeError("the host loops grow on every row")
        grad, hess = grad.float(), hess.float()
        mask = self._base_mask(iter_seed)
        mask = self._ones_mask if mask is None else mask
        if self.strategy == "masked":
            gh, scale3 = self.masked_operand(grad, hess, iter_seed)
            return dl.grow_tree(self.codes_t, gh, mask, self.meta,
                                scale3=scale3, stats=self.stats,
                                **self._statics())
        quant = None
        if self.quant_bits:
            data, quant = self.quant_working_buffer(grad, hess,
                                                    prng_key(iter_seed))
        else:
            data = self.working_buffer(grad, hess)
        return dl.grow_tree_compact_core(
            data, torch.empty_like(data), mask, self.meta,
            c_cols=self.c_cols, item_bits=self.item_bits, quant=quant,
            stats=self.stats, **self._statics())

    GBDT._fused_eligible = lambda self: False
    if not generic_only:
        dl.DeviceTreeLearner.grow = grow
    try:
        yield
    finally:
        GBDT._fused_eligible, dl.DeviceTreeLearner.grow = own


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all): "
                    + ",".join(PHASES))
    ap.add_argument("--parent-src", default=None, metavar="DIR",
                    help="another checkout of the repo: its "
                    "csrc/histogram.cu and csrc/partition.cu are built and "
                    "timed beside every case of the k1, k2, k3 and k4 "
                    "phases, and profiled with the partition kernel")
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
        from lightgbm_tpu_torch.ops.kernels import split_key as kkey
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
    parent_builds = {}
    if args.parent_src:
        os.makedirs(build.build_dir(), exist_ok=True)
        for name in ("histogram", "partition"):
            lib = os.path.join(build.build_dir(), "libparent_%s_%d.so"
                               % (name, os.getpid()))
            parent_builds[name] = (lib, subprocess.Popen(
                [build.nvcc()] + build.FLAGS + ["-o", lib, os.path.join(
                    args.parent_src, "lightgbm_tpu_torch", "csrc",
                    name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = build.build_all(verbose=True)
    parents = {}
    for name, (lib, proc) in parent_builds.items():
        text, _ = proc.communicate()
        if proc.returncode:
            fail("nvcc failed for --parent-src's %s.cu:\n%s" % (name, text))
        parents[name] = ctypes.CDLL(lib)
    if parents:
        parents["histogram_wrapper"] = parent_histogram(
            args.parent_src, parents["histogram"])
    build_s = time.time() - t0
    if "device" in run:
        ptxas = {name: [ln.strip() for ln in text.splitlines()
                        if "registers" in ln or "Compiling entry" in ln
                        or "spill" in ln]
                 for name, text in log.items()}
        atomics = sass_atomics(build.nvcc(), {n: build.library_path(n)
                                              for n in build.SOURCES})
        # the integer kernels: registers, spills and shared-memory adds
        int_kernels = {}
        for kind in ("hist_int_kernel", "hist_rows_kernel"):
            for name, info in ptxas_kernels(log.get("histogram", ""),
                                            build.nvcc(), kind).items():
                sass = atomics.get("histogram", {}).get(name, {}) \
                    if isinstance(atomics, dict) else {}
                int_kernels[name] = dict(
                    info, atoms_add=sass.get("ATOMS.ADD", "not measured"))
        emit({"phase": "device", "nvidia_smi": smi_line,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": round(build_s, 2),
              "ptxas": ptxas, "sass_atomics": atomics,
              "int_kernels": int_kernels or "not measured: no ptxas "
                                            "output (library cached)"})
    # the partition kernel's kernels and K3's (the integer histogram
    # kernels) by name, for the profiles
    k4_names = sorted(sass_functions(build.nvcc(),
                                     build.library_path("partition")))
    parent_k4_names = sorted(sass_functions(
        build.nvcc(), parent_builds["partition"][0])) if parents else []

    def int_hist_names(path):
        # the integer kernels: every instantiation but the float one
        return sorted(n for n in sass_functions(build.nvcc(), path)
                      if n.startswith("hist_") and "fixed" not in n)
    k3_names = int_hist_names(build.library_path("histogram"))
    key_names = sorted(sass_functions(build.nvcc(),
                                      build.library_path("split_key")))
    # K1 / K2: the float kernels of the histogram library
    float_hist_names = sorted(
        n for n in sass_functions(build.nvcc(),
                                  build.library_path("histogram"))
        if n.startswith("hist_fixed"))
    parent_k3_names = int_hist_names(parent_builds["histogram"][0]) \
        if parents else []

    # ---- data (built once, for the phases that need it) -----------------
    # auto picks the growth strategy by row count (compact at 1M rows,
    # masked at 60,000); the reference phase forces each in turn
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    f = 28
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}
    need_float = bool(run & {"train", "profile", "train_quant"})
    need_data = need_float or bool(run & {
        "k1", "k2", "k3", "k4", "train_bag", "train_valid",
        "train_objectives", "train_multiclass"})
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
            DeviceTreeLearner, quant_ops, prng_key, parents)

    # every kernel entry's launch count: (module, attribute); the device
    # loop's window entries and the split key count apart from the
    # host-int entries
    counters = {"k1": (k1, "launches"), "k2": (k1, "launches_t"),
                "k3": (k1, "launches_q"), "k3t": (k1, "launches_qt"),
                "k4": (k4, "launches"), "k1_win": (k1, "launches_win"),
                "k3_win": (k1, "launches_qwin"),
                "k4_win": (k4, "launches_win"),
                "split_key": (kkey, "launches"),
                "split_key_col": (kkey, "launches_col"),
                "route": (kkey, "launches_route"),
                "k4_rows": (k4, "rows"), "k4_rows_win": (k4, "rows_win")}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def k4_path(b, counts):
        """The partition kernel over a run (either entry): rows and
        launches per tree, and the byte bound of its windows per tree, sum
        W * (8D + 4) bytes."""
        lr = b._gbdt.learner
        d = lr.codes_pack.shape[1] + (2 if lr.quant_bits else 4)
        trees = max(b.num_trees(), 1)
        rows = counts["k4_rows"] + counts["k4_rows_win"]
        return {"D": d, "launches_per_tree":
                (counts["k4"] + counts["k4_win"]) / trees,
                "rows_per_tree": rows / trees,
                "bound_ms_per_tree": bound(rows * (8 * d + 4) / trees,
                                           0)[0]}

    def timed_train(p, dset, loop="device", rounds=None):
        """Train from zeroed launch counts on the device loop (the fused
        iteration), the host loop, or the generic iteration over the
        device loop, for `rounds` (default --rounds) rounds; (booster,
        counts, seconds, peak device bytes)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        with on_loop(loop):
            b = lgb.train(p, dset, num_boost_round=rounds or args.rounds)
        torch.cuda.synchronize()
        secs = time.time() - t1
        return b, read_counts(), secs, int(torch.cuda.max_memory_allocated())

    def on_loop(loop):
        return {"device": contextlib.nullcontext, "host": lambda: host_loop(
            torch), "generic": lambda: host_loop(torch, generic_only=True)
        }[loop]()

    def growth(b, counts, secs):
        """How a run's trees grew: host syncs, splits and kernel launches
        per tree, and the captured split step of the device loop."""
        lr = b._gbdt.learner
        trees = max(lr.stats.trees, 1)
        out = {"host_syncs_per_tree": lr.stats.host_syncs / trees,
               "splits_per_tree": lr.stats.splits / trees,
               "launches_per_tree": {k: v / trees for k, v in counts.items()
                                     if v and not k.endswith("rows")
                                     and not k.endswith("rows_win")},
               "s_per_iter_in_train": secs / max(b.current_iteration(), 1)}
        if lr._loop is not None and lr._loop.graph is not None:
            out["captured_step_launches"] = {
                k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]: v
                for k, v in lr._loop.launches_per_step.items()}
            out["replays_per_tree"] = lr._loop.num_steps
            out["capture_s"] = lr._loop.capture_s
        return out

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

    def profile_one(b, k4_kernels=None, k3_kernels=None):
        """One more boosting iteration of booster `b` under torch.profiler:
        wall, device time and busy share, launches, the top kernels, and
        the partition kernel's and K3's (those named k4_kernels and
        k3_kernels, default this tree's) device time and launches
        summed."""
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

        def summed(names):
            # by base name: the profiler writes template arguments as
            # written in the source, cu++filt with casts
            if not names:
                return "not measured: no kernel names (no cuobjdump)"
            pat = re.compile(r"(?:^|\s|::)(%s)[<(]" % "|".join(
                sorted({re.escape(n.split("<")[0]) for n in names})))
            part = [e for e in kern if pat.search(e.key)]
            return {"kernels": [e.key[:90] for e in part],
                    "device_ms": sum(e.self_device_time_total
                                     for e in part) / 1e3,
                    "launches": sum(e.count for e in part)}
        return {
            "k4": summed(k4_kernels or k4_names),
            "k3": summed(k3_kernels or k3_names),
            "k1": summed(float_hist_names),
            "split_key": summed([n for n in key_names
                                 if not n.startswith("route_rows")]),
            "router": summed([n for n in key_names
                              if n.startswith("route_rows")]),
            "wall_ms": wall * 1e3, "device_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e3 / (wall * 1e3),
            "device_launches": sum(e.count for e in kern),
            "top": [{"name": e.key[:90],
                     "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}

    def host_side(p, dset):
        """The same training on the host loop, beside the main path."""
        hb, hl, hs, hp = timed_train(p, dset, loop="host")
        # of the timed rounds, before the steady ones
        out = dict(growth(hb, hl, hs), train_s=hs, peak_device_bytes=hp,
                   launches=hl, valid_auc=auc(yv, hb.predict(xv)))
        if hb._gbdt.learner.strategy == "compact":
            out["k4_path"] = k4_path(hb, hl)
        with host_loop(torch):
            out["s_per_iter_steady"] = steady_s(hb)
        return hb, hl, out

    # ---- train: the main path (compact, float) ----------------------------
    launches = qlaunches = host_launches = qhost_launches = None
    valid_auc = train = None
    if need_float:
        bst, launches, train_s, peak = timed_train(params, ds)
        pv = bst.predict(xv)
        valid_auc = auc(yv, pv)
        text = bst.model_to_string()
        back = convert.booster_from_model_string(text)
        rt_err = float(np.max(np.abs(back.predict(xv, raw_score=True)
                                     - bst.predict(xv, raw_score=True))))
        tdiff = np.abs(bst._gbdt.score_updater.score[0].cpu().numpy()
                       - bst.predict(x, raw_score=True))
        tmoved = f32_threshold_rows(ds._inner, x)
        hbst, host_launches, host = host_side(params, ds)
        train = dict({"phase": "train", "rows": args.rows, "features": f,
                      "rounds": args.rounds, "params": params,
                      "strategy": bst._gbdt.learner.strategy,
                      "growth": "device loop, fused iteration",
                      "trees": bst.num_trees(), "launches": launches,
                      "k4_path": k4_path(bst, launches)},
                     **growth(bst, launches, train_s))
        train.update({
            "dataset_s": data_s, "train_s": train_s,
            "s_per_iter_steady": steady_s(bst), "peak_device_bytes": peak,
            "valid_rows": len(yv), "valid_auc": valid_auc,
            "model_text_roundtrip_max_abs": rt_err,
            # the training scores against predict on the training rows:
            # the rows f32 thresholds move, and the others
            "train_score_vs_predict": {
                "f32_threshold_rows": int(tmoved.sum()),
                "their_max_abs": float(np.max(tdiff[tmoved], initial=0.0)),
                "other_rows_max_abs": float(np.max(tdiff[~tmoved]))},
            "host_loop": host,
            "auc_minus_host_loop": valid_auc - host["valid_auc"]})
        if "train" in run:
            emit(train)
        if train["strategy"] != "compact":
            fail("the 1M-row run did not take the compact strategy")
        if min(launches[k] for k in ("k1_win", "k4_win", "split_key")) <= 0 \
                or launches["k1"] or launches["k4"]:
            fail("the main path did not go through the device loop's "
                 "kernels (K1's and K4's window entries, the split key): "
                 "%s" % launches)
        if host_launches["k1"] <= 0 or host_launches["k4"] <= 0:
            fail("the host loop did not launch K1 and K4: %s"
                 % host_launches)
        if train["host_syncs_per_tree"] != 1:
            fail("the device loop made %s host syncs per tree"
                 % train["host_syncs_per_tree"])
        if not np.all(np.isfinite(pv)) or pv.shape != (len(yv),):
            fail("predictions are not finite or of the wrong shape")
        if valid_auc <= 0.7 or abs(train["auc_minus_host_loop"]) > 0.001:
            fail("held-out AUC %.5f (want > 0.7 and within 0.001 of the "
                 "host loop's %.5f)" % (valid_auc, host["valid_auc"]))
        if rt_err > 1e-6:
            fail("model-text round trip differs by %g" % rt_err)
        if "profile" in run:
            prof = {"phase": "profile"}
            with host_loop(torch):
                if parents:
                    with parent_k4(torch, k4, parents["partition"]):
                        prof["parent_k4_iteration"] = profile_one(
                            hbst, parent_k4_names)["k4"]
                prof["host_loop"] = profile_one(hbst)
            emit(dict(prof, **profile_one(bst)))
        del bst, back, hbst

    # ---- train_quant: the same data with quantized gradients --------------
    if "train_quant" in run:
        qparams = dict(params, quantized_grad=True, grad_bits=8)
        qbst, qlaunches, qtrain_s, qpeak = timed_train(qparams, ds)
        qpv = qbst.predict(xv)
        qauc = auc(yv, qpv)
        qhbst, qhost_launches, qhost = host_side(qparams, ds)
        # the generic iteration over the device loop: the host loop's
        # scores, so its trees must be the host loop's
        qgbst, qglaunches, qg_s, _ = timed_train(qparams, ds, loop="generic")
        # (the host loop's booster has grown its steady rounds since)
        same_trees = [t.to_string() for t in qgbst._gbdt.models] \
            == [t.to_string() for t in qhbst._gbdt.models[:args.rounds]]
        qgauc = auc(yv, qgbst.predict(xv))
        train_quant = dict({
            "phase": "train_quant", "rows": args.rows,
            "rounds": args.rounds, "grad_bits": 8, "quant_renew": True,
            "strategy": qbst._gbdt.learner.strategy,
            "growth": "device loop, fused iteration", "launches": qlaunches,
            "k4_path": k4_path(qbst, qlaunches)},
            **growth(qbst, qlaunches, qtrain_s))
        train_quant.update({
            "train_s": qtrain_s, "s_per_iter_steady": steady_s(qbst),
            "peak_device_bytes": qpeak, "valid_auc": qauc,
            "float_valid_auc": valid_auc, "auc_diff": qauc - valid_auc,
            "profile": profile_one(qbst), "host_loop": qhost,
            "auc_minus_host_loop": qauc - qhost["valid_auc"],
            "generic_on_device_loop": {
                "train_s": qg_s, "valid_auc": qgauc,
                "same_trees_as_host_loop": same_trees,
                "launches": qglaunches}})
        with host_loop(torch):
            qhost["profile"] = profile_one(qhbst)
            if parents:
                # the parent's path in the host loop: the operand built by
                # gh_operand_scaled, then K3 on the parent's library
                with parent_two_step(k1, parents["histogram_wrapper"]):
                    par = profile_one(qhbst, k3_kernels=parent_k3_names)
                qhost["parent_iteration"] = {
                    key: par[key] for key in ("k3", "device_ms",
                                              "device_launches", "wall_ms")}
        emit(train_quant)
        if train_quant["strategy"] != "compact":
            fail("the quantized 1M-row run did not take the compact "
                 "strategy")
        if qlaunches["k3_win"] <= 0 or qlaunches["k4_win"] <= 0 \
                or qlaunches["split_key"] <= 0 or qlaunches["k1_win"] \
                or qlaunches["k3"] or qlaunches["k4"]:
            fail("quantized run: K3's and K4's window entries and the split "
                 "key must launch, and nothing else: %s" % qlaunches)
        if qhost_launches["k3"] <= 0 or qhost_launches["k4"] <= 0:
            fail("the quantized host loop did not launch K3 and K4: %s"
                 % qhost_launches)
        if train_quant["host_syncs_per_tree"] != 1:
            fail("the quantized device loop made %s host syncs per tree"
                 % train_quant["host_syncs_per_tree"])
        if not same_trees or round(qgauc, 7) != round(qhost["valid_auc"], 7):
            fail("the device loop grew other quantized trees than the host "
                 "loop from the same scores (AUC %.7f vs %.7f)"
                 % (qgauc, qhost["valid_auc"]))
        if not np.all(np.isfinite(qpv)) or qauc <= 0.7 \
                or abs(qauc - valid_auc) > 0.005:
            fail("quantized AUC %.5f vs float %.5f (want > 0.7, within "
                 "0.005)" % (qauc, valid_auc))
        del qbst, qhbst, qgbst
    # ---- train_masked: 60,000 rows, float and quantized -------------------
    masked_rows = []
    xm = ym = dsm = None
    if run & {"train_masked", "train_bag"}:
        xm, ym, _ = make_higgs_like(60_000, f, seed=23, w=w_true)
        dsm = lgb.Dataset(xm, ym, params=params)
        dsm.construct()
    if "train_masked" in run:
        for quant in (False, True):
            mp = dict(params, quantized_grad=quant, grad_bits=8)
            mb, mlaunches, ms_s, mpeak = timed_train(mp, dsm)
            mpv = mb.predict(xv)
            mauc = auc(yv, mpv)
            row = dict({"quantized_grad": quant,
                        "strategy": mb._gbdt.learner.strategy,
                        "growth": "device loop, fused iteration",
                        "fused": mb._gbdt._fused_step is not None,
                        "launches": mlaunches},
                       **growth(mb, mlaunches, ms_s))
            row.update({"train_s": ms_s, "s_per_iter_steady": steady_s(mb),
                        "peak_device_bytes": mpeak, "valid_auc": mauc,
                        "profile": profile_one(mb)})
            mhb, mhl, mhost = host_side(mp, dsm)
            with host_loop(torch):
                mhost["profile"] = profile_one(mhb)
            row["host_loop"] = mhost
            row["auc_minus_host_loop"] = mauc - mhost["valid_auc"]
            if quant:
                # the generic iteration over the device loop: the host
                # loop's scores, so its trees must be the host loop's
                gb, gl, g_s, _ = timed_train(mp, dsm, loop="generic")
                gauc = auc(yv, gb.predict(xv))
                row["generic_on_device_loop"] = {
                    "train_s": g_s, "valid_auc": gauc, "launches": gl,
                    "same_trees_as_host_loop":
                        [t.to_string() for t in gb._gbdt.models]
                        == [t.to_string()
                            for t in mhb._gbdt.models[:args.rounds]]}
                del gb
            masked_rows.append(row)
            want = "k3t" if quant else "k2"
            step = row.get("captured_step_launches", {})
            hist_key = "histogram." + ("launches_qt" if quant
                                       else "launches_t")
            problems = []
            if row["strategy"] != "masked" or not row["fused"]:
                problems.append("not the masked strategy's fused iteration")
            if mlaunches[want] <= 0 or mlaunches["split_key_col"] <= 0 \
                    or step.get(hist_key) != 1 \
                    or step.get("split_key.launches_col") != 1:
                problems.append("%s and the column split key not launched "
                                "from the replayed step" % want)
            if any(mlaunches[k] for k in ("k1", "k3", "k4", "k1_win",
                                          "k3_win", "k4_win", "split_key")):
                problems.append("a compact core's kernel launched")
            if row["host_syncs_per_tree"] != 1:
                problems.append("%s host syncs per tree"
                                % row["host_syncs_per_tree"])
            if not np.all(np.isfinite(mpv)) or mauc <= 0.7:
                problems.append("AUC %.5f" % mauc)
            if not quant and abs(row["auc_minus_host_loop"]) > 0.001:
                problems.append("AUC %.5f not within 0.001 of the host "
                                "loop's %.5f" % (mauc, mhost["valid_auc"]))
            if quant:
                gen = row["generic_on_device_loop"]
                if not gen["same_trees_as_host_loop"] \
                        or round(gen["valid_auc"], 7) \
                        != round(mhost["valid_auc"], 7):
                    problems.append("the device loop grew other quantized "
                                    "trees than the host loop from the "
                                    "same scores")
            if problems:
                emit({"phase": "train_masked", "runs": masked_rows})
                fail("masked run (quantized=%s): %s"
                     % (quant, "; ".join(problems)))
            del mb, mhb
        emit({"phase": "train_masked", "rows": 60_000,
              "rounds": args.rounds, "runs": masked_rows})

    # ---- train_bag: bagging, GOSS and pos/neg bagging ----------------------
    bag_rows = []
    if "train_bag" in run:
        # every sampling key set in every case: a Booster updates its
        # Dataset's config with its parameters, and the next Booster on
        # the same Dataset would inherit what it does not set
        plain = {"boosting": "gbdt", "quantized_grad": False, "grad_bits": 8,
                 "bagging_fraction": 1.0, "bagging_freq": 0,
                 "pos_bagging_fraction": 1.0, "neg_bagging_fraction": 1.0}

        def unbagged_auc(dset, known):
            # the unbagged float run of the same data: the train /
            # train_masked phase's, else one made here
            if known is not None:
                return known
            ub, _, _, _ = timed_train(dict(params, **plain), dset)
            out = auc(yv, ub.predict(xv))
            del ub
            return out

        base_1m = unbagged_auc(ds, valid_auc)
        base_60k = unbagged_auc(dsm, masked_rows[0]["valid_auc"]
                                if masked_rows else None)
        bag = {"bagging_fraction": 0.8, "bagging_freq": 1}
        # GOSS samples after 1 / learning_rate = 10 warm-up iterations
        goss = {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1}
        pos_neg = {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.5,
                   "bagging_freq": 1}
        for name, extra, rounds, dset, xt, base in (
                ("higgs-1m bagging 0.8", bag, args.rounds, ds, x, base_1m),
                ("higgs-1m-quant bagging 0.8",
                 dict(bag, quantized_grad=True, grad_bits=8), args.rounds,
                 ds, x, base_1m),
                ("higgs-1m goss", goss,
                 int(1.0 / params["learning_rate"]) + max(1, args.rounds // 2),
                 ds, x, base_1m),
                ("higgs-60k-masked bagging 0.8", bag, args.rounds, dsm, xm,
                 base_60k),
                ("higgs-60k-masked-quant bagging 0.8",
                 dict(bag, quantized_grad=True, grad_bits=8), args.rounds,
                 dsm, xm, base_60k),
                ("higgs-60k-masked pos/neg bagging 0.5", pos_neg,
                 args.rounds, dsm, xm, base_60k)):
            row, problems = bag_case(
                torch, name, dict(params, **dict(plain, **extra)), extra,
                rounds, dset, xt, base, timed_train, growth, k4_path, steady_s,
                lambda b: auc(yv, b.predict(xv)), profile_one)
            bag_rows.append(row)
            if problems:
                emit({"phase": "train_bag", "runs": bag_rows})
                fail("train_bag %s: %s" % (name, "; ".join(problems)))
        emit({"phase": "train_bag", "runs": bag_rows})

    # ---- train_valid: a validation set, evaluation, early stopping --------
    if "train_valid" in run:
        row, problems = train_valid_phase(
            torch, lgb, params, ds, xv, yv, args.rounds, train, growth,
            profile, reset_counts, read_counts)
        emit(row)
        if problems:
            fail("train_valid: %s" % "; ".join(problems))

    # ---- train_objectives / train_multiclass: the other objectives --------
    if "train_objectives" in run:
        row, problems = objectives_phase(
            torch, lgb, params, ds, x, xv, w_true, 5, timed_train, growth,
            steady_s)
        emit(row)
        if problems:
            fail("train_objectives: %s" % "; ".join(problems))
    if "train_multiclass" in run:
        row, problems = multiclass_phase(
            torch, lgb, params, ds, args.rows, f, xv, 5, reset_counts,
            read_counts, growth, steady_s)
        emit(row)
        if problems:
            fail("train_multiclass: %s" % "; ".join(problems))
    if need_data:
        del ds

    if "loop" in run:
        loop_phase(torch, dev, lgb, params, f, Config, DeviceTreeLearner,
                   (R_LCNT, R_RCNT))

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
        pk = "lightgbm_tpu/ops/pallas/partition_kernel.py:48"
        hcu = "lightgbm_tpu_torch/csrc/histogram.cu"
        pcu = "lightgbm_tpu_torch/csrc/partition.cu"
        kr = kernel_rows
        # launches: each entry's path, run from zeroed counts -- the main
        # path (the device loop) for the window entries and the split key,
        # the host loop beside it for the host-int entries of K1, K3, K4,
        # the masked strategy's device loop (float, quantized for K3t) for
        # K2 / K3t and the column split key
        kernels = [
            kernel_entry("K1 histogram, device-window entry", hcu,
                         hk + ":41", launches["k1_win"], kr["k1_win"],
                         "max_abs_err"),
            kernel_entry("K1 histogram, host-int entry", hcu, hk + ":41",
                         host_launches["k1"], kr["k1"], "max_abs_err"),
            kernel_entry("K2 histogram, (F, N) codes", hcu, hk + ":73",
                         masked_rows[0]["launches"]["k2"], kr["k2"],
                         "max_abs_err"),
            kernel_entry("K3 integer histogram, device-window entry", hcu,
                         hk + ":114", qlaunches["k3_win"], kr["k3_win"],
                         "max_abs_err"),
            kernel_entry("K3 integer histogram, packed-row entry", hcu,
                         hk + ":114", qhost_launches["k3"],
                         kr["k3_rows"] + kr["k3"], "max_abs_err"),
            kernel_entry("K3t integer histogram, (F, N) codes", hcu,
                         hk + ":152", masked_rows[1]["launches"]["k3t"],
                         kr["k3t"], "max_abs_err"),
            kernel_entry("K4 stable partition, device-window entry", pcu, pk,
                         launches["k4_win"], kr["k4_win"], "max_abs_err"),
            kernel_entry("K4 stable partition, host-int entry", pcu, pk,
                         host_launches["k4"], kr["k4"], "max_abs_err"),
            # no Pallas kernel: XLA fuses the JAX core's window decode
            kernel_entry("split key", "lightgbm_tpu_torch/csrc/split_key.cu",
                         "lightgbm_tpu/models/device_learner.py:2083",
                         launches["split_key"], kr["split_key"],
                         "max_abs_err"),
            # the masked core's decode and row update (device_learner.py
            # :402-419), in XLA too
            kernel_entry("split key, column entry",
                         "lightgbm_tpu_torch/csrc/split_key.cu",
                         "lightgbm_tpu/models/device_learner.py:402",
                         masked_rows[0]["launches"]["split_key_col"],
                         kr["split_key_col"], "max_abs_err"),
            # the out-of-bag rows' leaves of a bagged compact tree
            # (route_rows_by_rec, a fori_loop in XLA); launches from the
            # 1M-row bagged run of train_bag; its first case is that
            # run's shape (200,000 out-of-bag rows, a 255-leaf tree)
            kernel_entry("split key, router entry",
                         "lightgbm_tpu_torch/csrc/split_key.cu",
                         "lightgbm_tpu/models/device_learner.py:2174",
                         bag_rows[0]["launches"]["route"], kr["route"],
                         "max_abs_err")]
        print(smi_line, flush=True)
        emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def f32_threshold_rows(inner, x):
    """(N,) bool: the training rows that lie between a bin's upper bound
    (f64: what the bins, and so the training scores, split at) and its
    f32 rounding (what predict compares raw values with, as in the JAX
    package): predict may send them to the other side of a split on that
    bin, with or without sampling."""
    out = np.zeros(len(x), bool)
    for f, mapper in enumerate(inner.bin_mappers):
        ub = np.asarray(mapper.bin_upper_bound, dtype=np.float64)[:-1]
        ub32 = ub.astype(np.float32).astype(np.float64)
        keep = ub != ub32
        lo, hi = np.minimum(ub, ub32)[keep], np.maximum(ub, ub32)[keep]
        if not len(hi):
            continue
        col = x[:, f].astype(np.float64)
        i = np.minimum(np.searchsorted(hi, col, side="left"), len(hi) - 1)
        out |= (col > lo[i]) & (col <= hi[i])
    return out


def bag_case(torch, name, p, extra, rounds, dset, x_train, base_auc,
             timed_train, growth, k4_path, steady_s, valid_auc_of,
             profile_one):
    """One train_bag run: `rounds` rounds of the main path's entry point
    with the sampling settings `extra`; (row, problems). The row: time,
    steady s per iteration, host syncs and launches per tree (the router's
    among them), K4's window rows per tree, each carry's capture time,
    peak memory, held-out AUC beside the unbagged float run's, and the
    largest gap between the training scores and predict(raw_score=True)
    on the training rows (out-of-bag rows score through the router),
    and one more iteration profiled,
    over the rows whose values no f32 threshold of predict moves across a
    bin boundary (f32_threshold_rows: a dozen of 1M rows, on the
    unsampled path too)."""
    b, counts, secs, peak = timed_train(p, dset, rounds=rounds)
    gb = b._gbdt
    lr = gb.learner
    diff = np.abs(gb.score_updater.score[0].cpu().numpy()
                  - b.predict(x_train, raw_score=True))
    moved = f32_threshold_rows(dset._inner, x_train)
    gap = float(np.max(diff[~moved]))
    vauc = valid_auc_of(b)
    row = dict({"case": name, "settings": extra, "rounds": rounds,
                "strategy": lr.strategy,
                "iteration": "fused" if gb._fused_step else "generic",
                "fused_steps": sorted("goss" if k else "plain"
                                      for k in gb._fused_step or {}),
                "launches": counts}, **growth(b, counts, secs))
    row["carries"] = {"%d rows, qcap_op %d" % key if key != "masked"
                      else key: {"capture_s": loop.capture_s}
                      for key, (_, loop) in lr._states.items()}
    if lr.strategy == "compact":
        row["k4_path"] = k4_path(b, counts)
    row.update(train_s=secs, peak_device_bytes=peak, valid_auc=vauc,
               unbagged_float_auc=base_auc,
               auc_minus_unbagged=vauc - base_auc,
               train_score_vs_predict_max_abs=gap,
               f32_threshold_rows=int(moved.sum()),
               their_max_abs=float(np.max(diff[moved], initial=0.0)),
               s_per_iter_steady=steady_s(b), profile=profile_one(b))
    problems = []
    if row["host_syncs_per_tree"] != 1:
        problems.append("%s host syncs per tree" % row["host_syncs_per_tree"])
    if not gap <= 1e-5:
        problems.append("training scores differ from predict by %g" % gap)
    if not vauc > 0.7 or vauc < base_auc - 0.005:
        problems.append("AUC %.5f (want > 0.7 and at most 0.005 below the "
                        "unbagged %.5f)" % (vauc, base_auc))
    pos_neg = p.get("pos_bagging_fraction", 1.0) < 1.0
    if row["iteration"] != ("generic" if pos_neg else "fused"):
        problems.append("took the %s iteration" % row["iteration"])
    if p.get("boosting") == "goss" and row["fused_steps"] != ["goss",
                                                              "plain"]:
        problems.append("GOSS ran the fused steps %s" % row["fused_steps"])
    # one router launch per sampled compact tree (GOSS samples after its
    # 1 / learning_rate warm-up)
    sampled = rounds - (int(1.0 / p["learning_rate"])
                        if p.get("boosting") == "goss" else 0)
    if lr.strategy == "compact" and (counts["route"] != sampled
                                     or counts["split_key_col"]):
        problems.append("%d router launches for %d sampled trees"
                        % (counts["route"], sampled))
    if lr.strategy == "masked" and (counts["route"] or counts["split_key"]
                                    or counts["split_key_col"] <= 0):
        problems.append("the masked loop's kernels did not run alone")
    del b
    return row, problems


def train_valid_phase(torch, lgb, params, ds, xv, yv, rounds, train,
                      growth, profile, reset_counts, read_counts):
    """The train_valid phase: the main path with the held-out rows as a
    validation set, evaluated every iteration, under early stopping;
    (row, problems)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from lightgbm_tpu_torch.models.gbdt import ScoreUpdater
    # every sampling key set: the Dataset's config keeps what earlier
    # phases' Boosters set
    p = dict(params, boosting="gbdt", quantized_grad=False,
             bagging_fraction=1.0, bagging_freq=0, pos_bagging_fraction=1.0,
             neg_bagging_fraction=1.0, metric=["auc", "binary_logloss"])
    dv = ds.create_valid(xv, yv)
    ev = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    b = lgb.train(p, ds, num_boost_round=rounds, valid_sets=[dv],
                  valid_names=["valid"], early_stopping_rounds=5,
                  evals_result=ev, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = read_counts()
    gb = b._gbdt
    lr = gb.learner
    vu = gb.valid_updaters[0]
    row = dict({"phase": "train_valid", "rows": ds.num_data(),
                "valid_rows": len(yv), "rounds": rounds,
                "metric": p["metric"], "early_stopping_rounds": 5,
                "iteration": "fused" if gb._fused_step else "generic",
                "best_iteration": b.best_iteration, "trees": b.num_trees(),
                "train_s": train_s, "launches": counts,
                "peak_device_bytes": int(torch.cuda.max_memory_allocated())},
               **growth(b, counts, train_s))
    vs = vu.score[0].cpu().numpy()
    pr = b.predict(xv, raw_score=True, num_iteration=-1)
    moved = f32_threshold_rows(ds._inner, xv)
    gap = float(np.max(np.abs(vs - pr)[~moved]))
    rec_auc = ev["valid"]["auc"][-1]
    row.update(valid_score_vs_predict_max_abs=gap,
               f32_threshold_rows=int(moved.sum()),
               recorded_valid_auc=rec_auc,
               auc_of_valid_scores=auc(yv, vs),
               valid_history={m: v for m, v in ev["valid"].items()})

    # steady iterations as train() runs them: the update, then the
    # training and validation metrics (host numpy over fetched scores)
    ups = [gb.score_updater] + gb.valid_updaters
    s0, f0 = lr.stats.host_syncs, sum(u.fetches for u in ups)
    upd, evl = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.time()
        b.update()
        torch.cuda.synchronize()
        t2 = time.time()
        b.eval_train()
        b.eval_valid()
        t3 = time.time()
        upd.append(t2 - t1)
        evl.append(t3 - t2)
    both = [a + c for a, c in zip(upd, evl)]
    # one more iteration's evaluation taken apart: each dataset's fetch
    # (the f64 host copy) and each metric on it
    b.update()
    torch.cuda.synchronize()
    parts = {}
    for dname, su, metrics in [("training", gb.score_updater,
                                gb.train_metrics)] + list(zip(
                                    gb.valid_names, gb.valid_updaters,
                                    gb.valid_metrics)):
        t1 = time.time()
        host = su.host_scores()[0]
        parts["%s fetch" % dname] = (time.time() - t1) * 1e3
        for m in metrics:
            t1 = time.time()
            m.eval(host, gb.objective)
            parts["%s %s" % (dname, m.name)] = (time.time() - t1) * 1e3
    row.update({
        "s_per_iter_steady": float(np.median(both)),
        "update_s_per_iter_steady": float(np.median(upd)),
        "eval_ms_per_iter": float(np.median(evl)) * 1e3,
        "eval_breakdown_ms": parts,
        "fetches_per_iter": (lr.stats.host_syncs - s0
                             + sum(u.fetches for u in ups) - f0) / 4,
        "train_phase_s_per_iter_steady": train["s_per_iter_steady"]
        if train else "not measured: train phase not run"})

    # the validation update alone: each tree walked over the validation
    # codes, into a fresh updater, profiled
    fresh = ScoreUpdater(dv._inner, 1, vu.score.device)
    fresh.add_tree(gb.models[0], 0)
    torch.cuda.synchronize()
    trees = gb.models[1:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        for t in trees:
            fresh.add_tree(t, 0)
        torch.cuda.synchronize()
        wall = time.time() - t1
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    row["valid_update_per_tree"] = {
        "device_ms": sum(e.self_device_time_total for e in kern)
        / 1e3 / len(trees),
        "launches": sum(e.count for e in kern) / len(trees),
        "wall_ms": wall * 1e3 / len(trees),
        "depth": float(np.mean([t.depth() for t in trees]))}
    problems = []
    if row["iteration"] != "fused":
        problems.append("took the generic iteration")
    if row["host_syncs_per_tree"] != 1:
        problems.append("%s host syncs per tree" % row["host_syncs_per_tree"])
    if not gap <= 1e-5:
        problems.append("validation scores differ from predict by %g" % gap)
    if not abs(rec_auc - row["auc_of_valid_scores"]) <= 1e-9:
        problems.append("recorded AUC %.9f, AUC of the scores %.9f"
                        % (rec_auc, row["auc_of_valid_scores"]))
    if not rec_auc > 0.7 or not np.all(np.isfinite(vs)):
        problems.append("validation AUC %.5f" % rec_auc)
    del b
    return row, problems


# the objectives beside binary, and how each one's targets come from the
# generator's margin m: the noisy margin (the L2-like and renewal ones),
# Poisson counts at mean exp(m / 2), a Gamma draw of that mean, or a
# probability sigmoid(m + noise)
OBJECTIVE_TARGETS = (
    ("regression", "noisy"), ("regression_l1", "noisy"), ("huber", "noisy"),
    ("fair", "noisy"), ("quantile", "noisy"), ("mape", "noisy"),
    ("poisson", "poisson"), ("tweedie", "poisson"), ("gamma", "gamma"),
    ("cross_entropy", "probability"),
    ("cross_entropy_lambda", "probability"))


def objective_targets(kind, m, r):
    """Targets of `kind` from margins m, drawing from RandomState r."""
    if kind == "noisy":
        return m + r.randn(len(m)) * 1.5
    if kind == "poisson":
        return r.poisson(np.exp(0.5 * m)).astype(np.float64)
    if kind == "gamma":
        return r.gamma(2.0, np.exp(0.5 * m) / 2.0)
    return 1.0 / (1.0 + np.exp(-(m + r.randn(len(m)) * 1.5)))


class _Labels:
    """The metadata a metric's init reads."""

    def __init__(self, label):
        self.label, self.weight = label, None


def held_out_metric(b, xv, yv):
    """(name, the model's value, the constant model's value) of booster
    b's default metric on held-out rows (lower is better for every
    objective here); the constant model scores every row at the
    objective's boost-from-score."""
    from lightgbm_tpu_torch.metrics import metric as tm
    gb = b._gbdt
    m = tm.create_metrics([], gb.config, gb.objective.name)[0]
    m.init(_Labels(yv), len(yv))
    raw = b.predict(xv, raw_score=True)
    k = gb.num_class
    const = np.array([[gb.objective.boost_from_score(c)] for c in range(k)])
    const = np.broadcast_to(const, (k, len(yv)))
    score = raw.T if k > 1 else raw
    return m.name, m.eval(score, gb.objective)[0], \
        m.eval(const if k > 1 else const[0], gb.objective)[0]


def objectives_phase(torch, lgb, params, ds, x, xv, w, rounds, timed_train,
                     growth, steady_s):
    """train_objectives: every objective but binary and the multiclass
    ones on the higgs-1m rows (the train phase's Dataset, its label set to
    each objective's targets in turn), `rounds` rounds each; per objective
    the iteration it ran (fused, or generic with leaf renewal), steady s
    per iteration, host syncs and fetches per tree, the renewal's host ms
    per tree, launches per tree, and the held-out default metric against
    the constant model's. Returns (row, problems)."""
    from lightgbm_tpu_torch.models import gbdt as tg
    r = np.random.RandomState(31)
    m_t, m_v = higgs_margin(x, w), higgs_margin(xv, w)
    y_binary = ds.get_label()
    renew_ms = []
    renew = tg.GBDT._renew_tree_output

    def timed_renew(self, tree, class_id):
        t1 = time.perf_counter()
        renew(self, tree, class_id)
        renew_ms.append((time.perf_counter() - t1) * 1e3)
    runs, problems = [], []
    tg.GBDT._renew_tree_output = timed_renew
    try:
        for objective, kind in OBJECTIVE_TARGETS:
            yt = objective_targets(kind, m_t, r)
            yv = objective_targets(kind, m_v, r)
            ds.set_label(yt)
            del renew_ms[:]
            p = dict(params, objective=objective, num_class=1)
            b, counts, secs, peak = timed_train(p, ds, rounds=rounds)
            gb, lr = b._gbdt, b._gbdt.learner
            trees = max(lr.stats.trees, 1)
            row = dict({"objective": objective, "targets": kind,
                        "iteration": "fused" if gb._fused_step else
                        "generic (leaf renewal)",
                        "fetches_per_tree": gb.score_updater.fetches / trees,
                        "renew_host_ms_per_tree": float(np.mean(renew_ms))
                        if renew_ms else None, "train_s": secs,
                        "peak_device_bytes": peak},
                       **growth(b, counts, secs))
            name, got, const = held_out_metric(b, xv, yv)
            scores = gb.score_updater.score.cpu().numpy()
            row.update({"metric": name, "valid_metric": got,
                        "constant_model_metric": const,
                        "finite": bool(np.isfinite(scores).all()
                                       and np.isfinite(got)),
                        "s_per_iter_steady": steady_s(b)})
            runs.append(row)
            want_syncs = 1 if gb._fused_step else 2
            if not row["finite"] or not got < const:
                problems.append("%s: held-out %s %.6g vs the constant "
                                "model's %.6g" % (objective, name, got,
                                                  const))
            if row["host_syncs_per_tree"] != want_syncs:
                problems.append("%s: %s host syncs per tree" % (
                    objective, row["host_syncs_per_tree"]))
            if min(counts[k] for k in ("k1_win", "k4_win", "split_key")) \
                    <= 0:
                problems.append("%s: the device loop's kernels did not "
                                "launch: %s" % (objective, counts))
            del b
    finally:
        tg.GBDT._renew_tree_output = renew
        ds.set_label(y_binary)
    return {"phase": "train_objectives", "rows": len(x), "rounds": rounds,
            "runs": runs}, problems


def multiclass_phase(torch, lgb, params, ds, rows, f, xv, rounds,
                     reset_counts, read_counts, growth, steady_s):
    """train_multiclass: bench.py's 5-class variant of the higgs-1m rows
    (the same features, so the train phase's Dataset with its label set
    to the classes), multiclass and multiclassova for `rounds` rounds with
    the 100,000 held-out rows as a validation set (multi_logloss,
    multi_error); per run steady s per iteration (5 trees), captures,
    host syncs per tree, K1 / K4 launches per iteration, and the gates:
    held-out multi_logloss below the class prior's, class-0 one-vs-rest
    AUC > 0.7 (bench.py's gate). Returns (row, problems)."""
    k = 5
    _, ym, w = make_higgs_like(rows, f, n_classes=k)
    _, yvm, _ = make_higgs_like(len(xv), f, seed=4242, w=w, n_classes=k)
    y_binary = ds.get_label()
    prior = np.bincount(ym.astype(int), minlength=k) / len(ym)
    prior_loss = float(-np.mean(np.log(prior[yvm.astype(int)])))
    runs, problems = [], []
    ds.set_label(ym)
    try:
        for objective in ("multiclass", "multiclassova"):
            p = dict(params, objective=objective, num_class=k,
                     metric=["multi_logloss", "multi_error"])
            ev = {}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.time()
            b = lgb.train(p, ds, rounds, valid_sets=[ds.create_valid(xv, yvm)],
                          valid_names=["v"], evals_result=ev,
                          verbose_eval=False)
            torch.cuda.synchronize()
            secs = time.time() - t1
            counts = read_counts()
            gb, lr = b._gbdt, b._gbdt.learner
            raw = b.predict(xv, raw_score=True)
            iters = max(b.current_iteration(), 1)
            row = dict({"objective": objective, "num_class": k,
                        "trees": b.num_trees(), "captures": lr.stats.captures,
                        "k1_win_per_iteration": counts["k1_win"] / iters,
                        "k4_win_per_iteration": counts["k4_win"] / iters,
                        "valid_multi_logloss": ev["v"]["multi_logloss"][-1],
                        "valid_multi_error": ev["v"]["multi_error"][-1],
                        "class_prior_logloss": prior_loss,
                        "class0_auc": auc((yvm == 0).astype(np.float64),
                                          raw[:, 0]),
                        "finite": bool(np.isfinite(raw).all()),
                        "train_s": secs,
                        "peak_device_bytes":
                            int(torch.cuda.max_memory_allocated())},
                       **growth(b, counts, secs))
            row["s_per_iter_steady"] = steady_s(b)
            runs.append(row)
            if not row["finite"] or raw.shape != (len(xv), k) \
                    or not row["valid_multi_logloss"] < prior_loss \
                    or not row["class0_auc"] > 0.7:
                problems.append("%s: held-out multi_logloss %.5f (class "
                                "prior %.5f), class-0 AUC %.5f, shape %s"
                                % (objective, row["valid_multi_logloss"],
                                   prior_loss, row["class0_auc"],
                                   raw.shape))
            if row["captures"] != 1 or row["host_syncs_per_tree"] != 1 \
                    or gb._fused_step is not None:
                problems.append("%s: %s captures, %s host syncs per tree "
                                "(want 1 and 1 on the generic iteration)"
                                % (objective, row["captures"],
                                   row["host_syncs_per_tree"]))
            if counts["k1_win"] <= 0 or counts["k4_win"] <= 0:
                problems.append("%s: K1 / K4's window entries did not "
                                "launch: %s" % (objective, counts))
            del b
    finally:
        ds.set_label(y_binary)
    return {"phase": "train_multiclass", "rows": rows, "rounds": rounds,
            "runs": runs}, problems


def kernel_phases(torch, dev, args, run, k1, k4, build, ds, params, Config,
                  DeviceTreeLearner, quant_ops, prng_key, parents):
    """The k1, k2, k3 and k4 phases that `run` names, on the main path's
    working rows; {kernel: [case rows]} for the kernels line. `parents`,
    where given, holds another checkout's histogram and partition
    libraries and its histogram wrapper module, checked and timed beside
    each case. Every tensor made here
    is freed on return, before the training phases."""
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

    def parent_of(kernel):
        """The parent's wrapper of the same name as `kernel`."""
        return getattr(parents["histogram_wrapper"], kernel.__name__)

    def k4_parent():
        return parent_k4(torch, k4, parents["partition"])

    def timings(row, fn, reps, parent_fn=None,
                on_parent=contextlib.nullcontext):
        """row's ms and device_ms of fn; with parents, also parent_ms and
        parent_device_ms, parent_fn (default fn) run under on_parent(),
        the device times in the order parent, change, change, parent."""
        row["ms"] = time_ms(torch, fn, reps)
        if not parents:
            row["device_ms"] = time_ms(torch, fn, reps, hold=True)
            return
        pfn = parent_fn or fn
        d = []
        for par in (True, False, False, True):
            with on_parent() if par else contextlib.nullcontext():
                d.append(time_ms(torch, pfn if par else fn, reps,
                                 hold=True))
        with on_parent():
            row["parent_ms"] = time_ms(torch, pfn, reps)
        row["device_ms"] = (d[1] + d[2]) / 2
        row["parent_device_ms"] = (d[0] + d[3]) / 2

    # the device-window entries: their window comes from a split
    # descriptor; buffer 0 is `buf` (or the quantized rows), buffer 1 a
    # second buffer of the same shape
    from lightgbm_tpu_torch.ops.kernels import desc as dsc
    from lightgbm_tpu_torch.ops.kernels import split_key as kkey
    spare = torch.empty_like(buf)
    windows = [min(wn, args.rows) for wn in (args.rows, 250_000, 62_000,
                                             16_000, 4_000, 1_000)]

    def reps_for(wn):
        return 20 if wn > 500_000 else 50 if wn > 100_000 else 200

    def desc_for(**fields):
        d = torch.zeros(dsc.SIZE, dtype=torch.int32)
        for name, v in fields.items():
            d[getattr(dsc, name)] = int(v)
        return d.to(dev)

    def hist_desc(wn):
        """The histogram window of rows [0, wn) of buffer 0, as a split
        whose left child (the smaller) they are."""
        return desc_for(GO=1, SRC=1, BEGIN=0, COUNT=wn, LPHYS=wn,
                        LEFT_SMALL=1)

    def window_case(rows_out, label, check, fn, plain_fn, reps, nbytes,
                    nops=0, host_fn=None, library=None):
        """A device-window entry against its plain version: check() ->
        (ok, max_abs_err) on the same inputs, then fn (one launch) timed
        on both timers, plain_fn, and host_fn (the host-int entry over the
        same window) on the device timer."""
        ok, err = check()
        row = {"shape": label, "ok": bool(ok), "max_abs_err": float(err),
               "ms": time_ms(torch, fn, reps),
               "device_ms": time_ms(torch, fn, reps, hold=True),
               "plain_ms": time_ms(torch, plain_fn, 3, warmup=1)}
        if host_fn is not None:
            row["host_entry_device_ms"] = time_ms(torch, host_fn, reps,
                                                  hold=True)
        bms, by = bound(nbytes, nops)
        lib, note = library or (None, "none: no single PyTorch call "
                                      "computes it")
        row.update(bound_ms=bms, bound_by=by, library_ms=lib, library=note)
        rows_out.append(row)
        return row

    # ---- K1 / K2 vs plain -------------------------------------------------
    def repeat(fn, n=20):
        """fn's result over n launches on one input, and whether every
        launch gave the same bits."""
        outs = [fn() for _ in range(n)]
        return outs[0], all(torch.equal(o, outs[0]) for o in outs[1:])

    def float_case(rows, label, kernel, plain, codes, gh, nb, reps, pf,
                   atol=1e-4):
        got, same = repeat(lambda: kernel(codes, gh, nb))
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
        if parents:
            extra["parent_ok"] = within(parent_of(kernel)(codes, gh, nb))
        timings(extra, lambda: kernel(codes, gh, nb), reps,
                lambda: parent_of(kernel)(codes, gh, nb))
        plain_ms = time_ms(torch, lambda: plain(codes, gh, nb), 3, warmup=1)
        lib, lib_note = library_ms(pf, gh, nb, reps)
        bms, by = bound(p * ff * codes.element_size() + 12 * p
                        + 12 * ff * nb, 3 * p * ff)
        row = {"shape": label, "P": p, "F": ff, "B": nb,
               "max_abs_err": ea, "max_rel_err": er,
               "max_err_over_abs_sum": err_vs_mag, "ok": ok,
               "count_exact": count_exact, "repeat_20_equal": same,
               "slots_unequal_to_f64_plain": int((got != want).sum()),
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
        # shapes a grid with the feature tiles along y, each block walking
        # at most kMaxRowsPerBlock rows, could not hold at once: 4,500
        # features of 256 bins (every block walks 563 tiles in turn), and
        # a grid of one block over 2^20 + 4,099 rows (its words flushed
        # every kMaxRowsPerBlock = 2^16 rows: 17 chunks)
        for label, pw, fw, nbw, grid in (
                ("wide F: 4,500 features of 256 bins", 20_003, 4_500, 256,
                 None),
                ("one block over 2^20 + 4,099 rows: 17 chunks",
                 (1 << 20) + 4_099, f, b_root, 1)):
            wcodes = torch.from_numpy(rk.randint(0, nbw, size=(pw, fw))
                                      .astype(np.uint8)).to(dev)
            wgh = torch.from_numpy(np.stack(
                [rk.randn(pw), rk.rand(pw), np.ones(pw)], 1)
                .astype(np.float32)).to(dev)
            grid_x = k1._grid_x
            if grid:
                k1._grid_x = lambda dev_, rows_, per_sm: grid
            try:
                float_case(k1_rows, label, k1.build_histogram,
                           k1.build_histogram_plain, wcodes, wgh, nbw, 3,
                           wcodes)
            finally:
                k1._grid_x = grid_x
            del wcodes, wgh
        # K1's device-window entry over rows [0, W) of the working rows
        k1w_rows = []
        for wn in windows:
            hd = hist_desc(wn)
            wargs = (buf, spare, hd, cw, c_cols, 8, b_root)

            def check():
                got, same = repeat(lambda: k1.build_histogram_window(*wargs))
                want = k1.build_histogram_window_plain(*wargs)
                mag = k1.build_histogram_plain(codes_root[:wn],
                                               gh_root[:wn].abs(), b_root)
                ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()
                           + 1e-5 * mag).all()) \
                    and torch.equal(got[..., 2], want[..., 2])
                win_extra[wn] = {"repeat_20_equal": same,
                                 "slots_unequal_to_f64_plain":
                                     int((got != want).sum())}
                return ok, (got - want).abs().max()
            win_extra = {}
            window_case(
                k1w_rows, "device-window entry, rows [0, %d) (D=11)" % wn,
                check, lambda: k1.build_histogram_window(*wargs),
                lambda: k1.build_histogram_window_plain(*wargs),
                reps_for(wn), wn * (c_cols + 12) + 12 * c_cols * b_root,
                3 * wn * c_cols,
                host_fn=lambda: k1.build_histogram(
                    codes_root[:wn], gh_root[:wn], b_root),
                library=library_ms(codes_root[:wn], gh_root[:wn], b_root,
                                   reps_for(wn)))
            k1w_rows[-1].update(win_extra[wn])
        emit({"phase": "k1", "tolerance": tolerance,
              "cases": k1_rows + k1w_rows})
        if not all(rw["ok"] for rw in k1_rows + k1w_rows):
            fail("K1 disagrees with its plain version")
        if not all(rw["repeat_20_equal"] for rw in k1_rows + k1w_rows):
            fail("K1 gave other bits in 20 launches on one input")
        out["k1"], out["k1_win"] = k1_rows, k1w_rows
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
        col_rows = split_key_column_cases(
            torch, dev, k1, kkey, dsc, desc_for, window_case, reps_for,
            codes_t_full, probe.meta["t_feature_table"][0].tolist(),
            args.rows)
        emit({"phase": "k2", "tolerance": tolerance, "cases": k2_rows,
              "split_key_column_cases": col_rows})
        if not all(rw["ok"] for rw in k2_rows + col_rows):
            fail("K2 or the column split key disagrees with its plain "
                 "version")
        if not all(rw["repeat_20_equal"] for rw in k2_rows):
            fail("K2 gave other bits in 20 launches on one input")
        out["k2"], out["split_key_col"] = k2_rows, col_rows
        del codes_t_full, gh_masked

    # ---- K3 / K3t vs plain -------------------------------------------------
    def int_case(rows, label, kernel, plain, codes, ghq, nb, reps, pf):
        got = kernel(codes, ghq, nb)
        want = plain(codes, ghq, nb)
        torch.cuda.synchronize()
        exact = bool(got.dtype == torch.int32 and torch.equal(got, want))
        p, ff = pf.shape
        extra = {}
        if parents:
            extra["parent_bit_exact"] = bool(torch.equal(
                parent_of(kernel)(codes, ghq, nb), want))
        timings(extra, lambda: kernel(codes, ghq, nb), reps,
                lambda: parent_of(kernel)(codes, ghq, nb))
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

    def rows_case(rows_out, label, rows, cw, qcap, r_g, r_h, nb, reps):
        """The packed-row entry over `rows` (grad_bits 8) against its plain
        version, bit-exact; the two-step it replaces timed beside it."""
        kargs = (rows, cw, c_cols, 8, r_g, r_h, qcap, 8, nb)

        def fn():
            return k1.build_histogram_quantized_rows(*kargs)

        def two_step(k3=k1.build_histogram_quantized):
            ghq = quant_ops.gh_operand_scaled(rows[:, cw], None, 8, qcap,
                                              r_g, r_h)
            return k3(rows.view(torch.uint8)[:, :c_cols], ghq, nb)

        def parent_two_step():
            return two_step(parent_of(k1.build_histogram_quantized))
        got = fn()
        want = k1.build_histogram_quantized_rows_plain(*kargs)
        torch.cuda.synchronize()
        exact = bool(got.dtype == torch.int32 and torch.equal(got, want))
        row = {"two_step_bit_exact": bool(torch.equal(two_step(), want))}
        if parents:
            row["parent_bit_exact"] = bool(torch.equal(parent_two_step(),
                                                       want))
        timings(row, fn, reps, parent_two_step)
        row["two_step_ms"] = time_ms(torch, two_step, reps)
        row["two_step_device_ms"] = time_ms(torch, two_step, reps,
                                            hold=True)
        w, d = rows.shape
        bms, by = bound(w * 4 * d + 12 * c_cols * nb, 3 * w * c_cols)
        row.update({
            "shape": label, "W": w, "D": d, "F": c_cols, "B": nb,
            "qcap_op": qcap, "bit_exact": exact,
            "max_abs_err": 0.0 if exact else float(
                (got.long() - want.long()).abs().max()),
            "plain_ms": time_ms(torch, lambda: k1
                                .build_histogram_quantized_rows_plain(
                                    *kargs), 3, warmup=1),
            "library_ms": None,
            "library": "none: no single PyTorch call re-quantizes the "
                       "rows and sums their histogram",
            "bound_ms": bms, "bound_by": by})
        rows_out.append(row)
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
        # the row walk cut short: one row per thread of the operand
        # path's full grid, so the time is mostly the blocks' flush
        grid = k1._grid_x(dev, 1 << 40, k1._BLOCKS_PER_SM)
        pn = min(grid * k1._THREADS, args.rows)
        int_case(k3_rows, "flush probe: one row per thread of the grid",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, qcodes[:pn],
                 ghq_root[:pn], b_root, 50, qcodes[:pn])
        # the packed-row entry: the root and the compact core's child
        # windows of the quantized rows, the operand built in the kernel;
        # beside it the two-step (gh_operand_scaled, then K3), on this
        # tree's library and, with parents, on the parent's
        rows_rows = []
        for wn in (args.rows, 250_000, 62_000, 16_000, 4_000, 1_000):
            wn = min(wn, args.rows)
            rows_case(rows_rows, "packed quantized rows, D=9", qbuf[:wn],
                      qcw, qrows.qcap_op, r_g, r_h, b_root,
                      20 if wn > 500_000 else 50 if wn > 100_000 else 200)
        # K3's device-window entry over rows [0, W) of the quantized rows
        k3w_rows = []
        qspare = torch.empty_like(qbuf)
        for wn in windows:
            hd = hist_desc(wn)
            wargs = (qbuf, qspare, hd, qcw, c_cols, 8, r_g, r_h,
                     qrows.qcap_op, 8, b_root)

            def check():
                got = k1.build_histogram_quantized_window(*wargs)
                want = k1.build_histogram_quantized_window_plain(*wargs)
                return torch.equal(got, want), \
                    (got.long() - want.long()).abs().max()
            window_case(
                k3w_rows, "device-window entry, rows [0, %d) (D=9)" % wn,
                check, lambda: k1.build_histogram_quantized_window(*wargs),
                lambda: k1.build_histogram_quantized_window_plain(*wargs),
                reps_for(wn), wn * 4 * qbuf.shape[1] + 12 * c_cols * b_root,
                3 * wn * c_cols,
                host_fn=lambda: k1.build_histogram_quantized_rows(
                    qbuf[:wn], qcw, c_cols, 8, r_g, r_h, qrows.qcap_op, 8,
                    b_root))
        emit({"phase": "k3", "tolerance": "bit-exact",
              "cases": k3_rows + k3t_rows + rows_rows + k3w_rows})
        if not all(rw["bit_exact"] and rw.get("parent_bit_exact", True)
                   and rw.get("two_step_bit_exact", True)
                   for rw in k3_rows + k3t_rows + rows_rows) \
                or not all(rw["ok"] for rw in k3w_rows):
            fail("K3 / K3t disagree with their plain version")
        out["k3"], out["k3t"], out["k3_rows"] = k3_rows, k3t_rows, rows_rows
        out["k3_win"] = k3w_rows
        del ct60, ghq60, qbuf, qspare, ghq_root, qcodes, qprobe

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
            if parents:
                with k4_parent():
                    times["parent_bit_exact"] = bool(torch.equal(
                        k4.stable_partition3(win, key, res), want))
            timings(times, lambda: k4.stable_partition3(win, key, res), reps,
                    on_parent=k4_parent)
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

        # the root split window: rows keyed by a feature threshold
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
        q9 = w2[:, :9].contiguous()
        k4_case("quantized rows, D=9", q9, key2, 20)
        # the compact core's child windows: leading row slices of the
        # working rows, a 0 / 1 key as the growth core passes
        for wn in (250_000, 62_000, 16_000, 4_000, 1_000):
            wn = min(wn, args.rows)
            reps = 50 if wn > 100_000 else 200
            k4_case("child window, D=11", buf[:wn], key_root[:wn], reps)
            k4_case("child window, D=9", q9[:wn], key_root[:wn], reps)
        ww = min(100_003, args.rows + 3)
        wide = torch.from_numpy(rk.randint(0, 2**32, size=(ww, 260),
                                           dtype=np.uint32).view(np.int32)) \
            .to(dev)
        k4_case("wide rows, D=260", wide, key2[:ww], 20)
        del wide
        # one tile more than the grid holds: one block moves two tiles
        over = k4._launcher(dev, d_cols)[1] * k4.tile_rows(d_cols) + 1
        k4_case("grid capacity + 1 tile", w2[:over], key2[:over], 50)
        # K4's device-window entry: rows [0, W) of buffer 0 into buffer 1
        # (D = 11, and D = 9 with the quantized width)
        k4w_rows, key_rows = [], []
        for src_buf, dn in ((buf, d_cols), (q9[:args.rows], 9)):
            dst_buf, plain_dst = torch.empty_like(src_buf), \
                torch.empty_like(src_buf)
            for wn in windows:
                wd = desc_for(GO=1, SRC=0, BEGIN=0, COUNT=wn)

                def check():
                    k4.stable_partition3_window(src_buf, dst_buf, key_root,
                                                wd)
                    k4.stable_partition3_window_plain(src_buf, plain_dst,
                                                      key_root, wd)
                    same = torch.equal(dst_buf[:wn], plain_dst[:wn])
                    return same, 0.0 if same else float("inf")
                window_case(
                    k4w_rows, "device-window entry, rows [0, %d) (D=%d)"
                    % (wn, dn), check,
                    lambda: k4.stable_partition3_window(src_buf, dst_buf,
                                                        key_root, wd),
                    lambda: k4.stable_partition3_window_plain(
                        src_buf, plain_dst, key_root, wd),
                    reps_for(wn), wn * (8 * dn + 4),
                    host_fn=lambda: k4.stable_partition3(
                        src_buf[:wn], key_root[:wn], dst_buf[:wn]))
            del dst_buf, plain_dst
        # the split key over the same windows: feature 0's decision on the
        # float rows, and with the side maxes on the quantized rows (D = 9)
        qprobe = DeviceTreeLearner(Config(dict(params, quantized_grad=True,
                                               grad_bits=8)),
                                   ds._inner, device=dev)
        qrows_buf, _ = qprobe.quant_working_buffer(g, h, prng_key(0))
        feat = probe.meta["t_feature_table"][0].tolist()
        for rows_buf, renew in ((buf, False), (qrows_buf, True)):
            kcw = rows_buf.shape[1] - (2 if renew else 4)
            other = spare if rows_buf is buf else torch.empty_like(rows_buf)
            for wn in windows:
                kd = desc_for(GO=1, SRC=0, BEGIN=0, COUNT=wn,
                              THR=b_root // 3, DLEFT=1, COL=feat[0],
                              BASE=feat[1], ELIDE=feat[2], NUMBINS=feat[3],
                              MISSING=feat[4], DEFAULT=feat[5])
                kw = dict(item_bits=8, cw=kcw, renew=renew)
                key_t, key_p = torch.empty_like(key_root), \
                    torch.empty_like(key_root)
                # the timed launches add into their own descriptors' counts
                kd_t, kd_p = kd.clone(), kd.clone()

                def check():
                    d1, d2 = kd.clone(), kd.clone()
                    kkey.split_key(rows_buf, other, d1, key_t, **kw)
                    kkey.split_key_plain(rows_buf, other, d2, key_p, **kw)
                    same = torch.equal(key_t[:wn], key_p[:wn]) \
                        and torch.equal(d1, d2)
                    return same, 0.0 if same else float("inf")
                window_case(
                    key_rows, "rows [0, %d) (D=%d%s)" % (
                        wn, rows_buf.shape[1], ", side maxes" if renew
                        else ""), check,
                    lambda: kkey.split_key(rows_buf, other, kd_t, key_t,
                                           **kw),
                    lambda: kkey.split_key_plain(rows_buf, other, kd_p,
                                                 key_p, **kw),
                    reps_for(wn), wn * (12 if renew else 8))
        del qprobe, qrows_buf
        route_rows_out = router_cases(torch, dev, kkey, probe, g, h,
                                      window_case, args.rows)
        emit({"phase": "k4", "tolerance": "bit-exact",
              "cases": k4_rows + k4w_rows, "split_key_cases": key_rows,
              "router_cases": route_rows_out})
        if not all(rw["bit_exact"] and rw.get("parent_bit_exact", True)
                   for rw in k4_rows) \
                or not all(rw["ok"] for rw in k4w_rows + key_rows
                           + route_rows_out):
            fail("K4, the split key or the router disagrees with its plain "
                 "version")
        out["k4"], out["k4_win"], out["split_key"] = \
            k4_rows, k4w_rows, key_rows
        out["route"] = route_rows_out
    return out


def router_cases(torch, dev, kkey, probe, g, h, window_case, rows):
    """The split key's router entry against its plain version, bit-exact
    in every row's leaf: the records of one 255-leaf tree grown by the
    main path's learner over the main path's packed 8-bit codes, and
    random records over random packed rows of 4-bit and 16-bit codes (28
    features, EFB bundle columns and plain ones, each missing type); M =
    200,000 rows and a ragged M; k = 0 (every row in leaf 0) and k = L - 1.
    The byte bound: the rows, the records and the feature table read once,
    one leaf id written per row."""
    rec, _, k = probe.grow_compact(g, h, 0)
    sets = [("8-bit codes of the main path, the records of its tree",
             probe.codes_pack, rec, k, probe.meta["t_feature_table"], 8)]
    r = np.random.RandomState(22)
    for bits in (4, 16):
        per, nb, cw, f, L = 32 // bits, 1 << bits, 7, 28, 255
        rws = torch.from_numpy(r.randint(-2**31, 2**31, size=(rows, cw),
                                         dtype=np.int64).astype(np.int32))
        nbins = r.randint(3, min(nb, 256), f)
        elide = np.arange(f) % 3 == 0
        table = torch.from_numpy(np.stack([
            r.randint(0, cw * per, f),
            np.where(elide, r.randint(0, nb // 2, f), 0), elide, nbins,
            np.arange(f) % 3, r.randint(0, 100, f) % nbins],
            axis=1).astype(np.int32))
        rr = np.zeros((L - 1, 13), np.float32)
        feats = r.randint(0, f, L - 1)
        rr[:, 0] = [r.randint(0, i + 1) for i in range(L - 1)]
        rr[:, 1], rr[:, 2] = feats, r.randint(0, nbins[feats])
        rr[:, 3] = r.randint(0, 2, L - 1)
        sets.append(("random %d-bit codes and records" % bits, rws.to(dev),
                     torch.from_numpy(rr).to(dev),
                     torch.tensor(L - 1, dtype=torch.int32, device=dev),
                     table.to(dev), bits))
    out = []
    for label, codes, recs, k_full, table, bits in sets:
        for m in (min(200_000, rows), min(100_003, rows)):
            rws = codes[:m].contiguous()
            for k in (k_full, torch.zeros_like(k_full)):
                kw = dict(item_bits=bits)

                def check():
                    got = kkey.route_rows(rws, recs, k, table, **kw)
                    want = kkey.route_rows_plain(rws, recs, k, table, **kw)
                    same = torch.equal(got, want)
                    return same, 0.0 if same else float(
                        (got - want).abs().max())
                nbytes = rws.numel() * 4 + recs.numel() * 4 \
                    + table.numel() * 4 + 4 * m
                row = window_case(
                    out, "%s, M=%d, k=%d" % (label, m, int(k)), check,
                    lambda: kkey.route_rows(rws, recs, k, table, **kw),
                    lambda: kkey.route_rows_plain(rws, recs, k, table, **kw),
                    200, nbytes)
                row.update(M=m, CW=rws.shape[1], k=int(k), item_bits=bits)
    return out


def split_key_column_cases(torch, dev, k1, kkey, dsc, desc_for, window_case,
                           reps_for, codes_t_full, feat, rows):
    """The split key's column entry (the masked core's) against its plain
    version, bit-exact in leaf ids and the left operand (an f32 operand as
    its int32 words): the main path's (F, N) codes at 60,000 rows, at the
    full row count and at a ragged count, uint8 and 16-bit codes, f32,
    int8 and int32 operands, and a GO = 0 descriptor that must change
    nothing. Each case is the first split of a tree: every row in leaf 0,
    the middle of the feature's bins as threshold. Timed with NEW_ID = LEAF, so
    that every timed launch finds the same rows; the byte bound counts
    each row's leaf id read, its code read, the gh read of the rows going
    left, the operand row written and the leaf id written of the rows
    going right."""
    r = np.random.RandomState(21)
    out = []
    for n in (60_000, rows, 100_003):
        n = min(n, codes_t_full.shape[1])
        c8 = codes_t_full[:, :n].contiguous()
        # 16-bit codes: the same bins spread by m (above 32767 too, where
        # the int16 view is negative), and the split's bins with them
        m = 1031
        c16 = (c8.to(torch.int32) * m).to(torch.int16)
        for codes_t, cbytes, mul in ((c8, 1, 1), (c16, 2, m)):
            leaf0 = torch.zeros(n, dtype=torch.int32, device=dev)
            for op in (torch.float32, torch.int8, torch.int32):
                if op == torch.float32:
                    gh = torch.from_numpy(r.randn(n, 3).astype(np.float32))
                else:
                    gh = torch.from_numpy(r.randint(-127, 128, (n, 3))).to(op)
                gh = gh.to(dev)
                fields = dict(GO=1, THR=(feat[3] // 2) * mul, DLEFT=1,
                              COL=feat[0], BASE=feat[1] * mul,
                              ELIDE=feat[2], NUMBINS=feat[3] * mul,
                              MISSING=feat[4], DEFAULT=feat[5] * mul,
                              LEAF=0)
                check_desc = desc_for(NEW_ID=1, **fields)
                time_desc = desc_for(NEW_ID=0, **fields)
                got_l, want_l = leaf0.clone(), leaf0.clone()
                got_g, want_g = torch.empty_like(gh), torch.empty_like(gh)

                def words(t):
                    return t.view(torch.int32) if t.dtype == torch.float32 \
                        else t

                def check():
                    kkey.split_key_column(codes_t, check_desc, got_l, gh,
                                          got_g)
                    kkey.split_key_column_plain(codes_t, check_desc, want_l,
                                                gh, want_g)
                    same = torch.equal(got_l, want_l) \
                        and torch.equal(words(got_g), words(want_g))
                    # GO = 0 writes nothing
                    l0, g0 = got_l.clone(), got_g.clone()
                    kkey.split_key_column(codes_t, desc_for(GO=0), got_l,
                                          gh, got_g)
                    same = same and torch.equal(got_l, l0) \
                        and torch.equal(words(got_g), words(g0))
                    return same, 0.0 if same else float("inf")
                tl, tg = leaf0.clone(), torch.empty_like(gh)
                row = window_case(
                    out, "(28, %d) codes of %d bytes, %s operand"
                    % (n, cbytes, str(op).split(".")[-1]), check,
                    lambda: kkey.split_key_column(codes_t, time_desc, tl,
                                                  gh, tg),
                    lambda: kkey.split_key_column_plain(codes_t, time_desc,
                                                        tl, gh, tg),
                    reps_for(n), 0)
                left = int((want_l == 0).sum())
                ob = 3 * gh.element_size()
                nbytes = n * (4 + cbytes + ob) + left * ob + (n - left) * 4
                row["left_rows"] = left
                row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
    return out


def loop_phase(torch, dev, lgb, params, f, Config, DeviceTreeLearner,
               count_cols):
    """The loop phase: 20,000-row trees (31 leaves) of each strategy grown
    by its captured device loop on the card, by the same step run eagerly
    on the CPU (the kernels' plain versions) and by its host loop on the
    card, from the same numpy gradients, float and quantized. Against the
    CPU: equal leaf, feature and count columns and leaf ids, f32 columns
    within 1e-4 (the split scan's f32 prefix sums, and K1's / K2's, run in
    another order on the card: the reference phase's bound).
    Quantized, against the host loop on the same card: equal records,
    bit for bit. Also the capture's time and launches per step, and one
    tree grown on the card under the sync debug mode "error" (any
    synchronisation inside raises)."""
    R_LCNT, R_RCNT = count_cols
    xs, ys, w = make_higgs_like(20_000, f, seed=31)
    prob = 1.0 / (1.0 + np.exp(-0.3 * (xs @ w)))
    g = torch.from_numpy((prob - ys).astype(np.float32))
    h = torch.from_numpy((prob * (1.0 - prob)).astype(np.float32))
    # leaf, feature, counts; two thresholds with no training row between
    # them split alike (f32 rounding picks one), the leaf ids hold the
    # rows' routing
    ints = [0, 1, R_LCNT, R_RCNT]
    runs = []
    for strategy in ("compact", "masked"):
        for quant in (False, True):
            p = dict(params, num_leaves=31, min_gain_to_split=1e-3,
                     quantized_grad=quant, grad_bits=8)
            inner = lgb.Dataset(xs, ys, params=p).construct()._inner
            card = DeviceTreeLearner(Config(p), inner, strategy=strategy,
                                     device=dev)
            cpu = DeviceTreeLearner(Config(p), inner, strategy=strategy,
                                    device="cpu")
            on_device = card.grow_masked if strategy == "masked" \
                else card.grow_compact
            gc, hc = g.to(dev), h.to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.time()
            # the carry and the capture
            if strategy == "masked":
                card._masked_state()
            else:
                card._device_state()
            torch.cuda.synchronize()
            capture_s = time.time() - t1
            trees = []
            floats = [c for c in range(13)
                      if c not in ints and c not in (2, 3)]
            for seed in range(2):
                rc, lc, kc = card.grow(gc, hc, iter_seed=seed)
                rp, lp, kp = cpu.grow(g, h, iter_seed=seed)
                with host_loop(torch):
                    rh, lh, kh = card.grow(gc, hc, iter_seed=seed)
                trees.append({
                    "splits": [kc, kp, kh],
                    "ints_equal": bool(np.array_equal(rc[:, ints],
                                                      rp[:, ints])),
                    "floats_close": bool(np.allclose(
                        rc[:, floats], rp[:, floats], rtol=1e-4,
                        atol=1e-4)),
                    "max_rel_diff": float(np.max(
                        np.abs(rc[:, floats] - rp[:, floats])
                        / np.maximum(np.abs(rp[:, floats]), 1e-3))),
                    "leaf_ids_equal": bool(torch.equal(lc.cpu(), lp)),
                    "host_loop_records_equal": bool(np.array_equal(rc,
                                                                   rh)),
                    "host_loop_leaf_ids_equal": bool(torch.equal(lc, lh))})
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                on_device(gc, hc, iter_seed=2)
                no_sync = True
            except RuntimeError as e:
                no_sync = str(e)[:200]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ok = no_sync is True and all(
                t["ints_equal"] and t["leaf_ids_equal"]
                and t["floats_close"] and t["splits"][0] > 1
                and (not quant or (t["host_loop_records_equal"]
                                   and t["host_loop_leaf_ids_equal"]))
                for t in trees)
            runs.append({
                "strategy": strategy, "quantized_grad": quant, "ok": ok,
                "trees": trees, "capture_s": capture_s,
                "captured_step_launches": {
                    k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]: v
                    for k, v in card._loop.launches_per_step.items()},
                "replays_per_tree": card._loop.num_steps,
                "capture_s_in_loop": card._loop.capture_s,
                "no_sync_inside_tree": no_sync,
                "peak_device_bytes": int(torch.cuda.max_memory_allocated())})
    runs += bag_loop_runs(torch, dev, lgb, params, xs, ys, g, h, Config,
                          DeviceTreeLearner, ints, count_cols)
    emit({"phase": "loop", "rows": 20_000, "num_leaves": 31, "runs": runs})
    if not all(r["ok"] for r in runs):
        fail("a captured device loop disagrees with the same step on the "
             "CPU or with the host loop, or synchronised inside a tree")


def bag_loop_runs(torch, dev, lgb, params, xs, ys, g, h, Config,
                  DeviceTreeLearner, ints, count_cols):
    """The loop phase's bag carry: 20,000-row compact trees grown on a
    fused iteration's bag of 14,000 rows (exact_k_bag_weights, the in-bag
    rows first), float and quantized, by the bag's captured step on the
    card and the same step eagerly on the CPU, from the same gradients and
    bag: equal leaf, feature and count columns and leaf ids of every row
    (the out-of-bag rows' from the router and its plain version), f32
    columns within 1e-4; and one bagged tree grown under the sync debug
    mode "error"."""
    from lightgbm_tpu_torch.models import device_learner as dl
    R_LCNT, R_RCNT = count_cols
    n, bag_k = len(ys), 14_000

    def bag(seed):
        w = dl.exact_k_bag_weights(dl.trandom.prng_key(seed), n, bag_k, dev)
        order = torch.argsort((w <= 0).to(torch.int32), stable=True)
        return order[:bag_k], order[bag_k:]

    floats = [c for c in range(13) if c not in ints and c not in (2, 3)]
    runs = []
    for quant in (False, True):
        p = dict(params, num_leaves=31, min_gain_to_split=1e-3,
                 quantized_grad=quant, grad_bits=8)
        inner = lgb.Dataset(xs, ys, params=p).construct()._inner
        card = DeviceTreeLearner(Config(p), inner, strategy="compact",
                                 device=dev)
        cpu = DeviceTreeLearner(Config(p), inner, strategy="compact",
                                device="cpu")
        gc, hc = g.to(dev), h.to(dev)
        trees = []
        for seed in range(2):
            bi, oi = bag(seed)
            rc, lc, kc = card.grow_compact(gc, hc, seed, bi, oi)
            rc, kc, _ = card.fetch_tree(rc, kc)
            rp, lp, kp = cpu.grow_compact(g, h, seed, bi.cpu(), oi.cpu())
            rp, kp, _ = cpu.fetch_tree(rp, kp)
            trees.append({
                "splits": [kc, kp],
                "bag_rows": int(rp[0, R_LCNT] + rp[0, R_RCNT]),
                "ints_equal": bool(np.array_equal(rc[:, ints], rp[:, ints])),
                "floats_close": bool(np.allclose(
                    rc[:, floats], rp[:, floats], rtol=1e-4, atol=1e-4)),
                "leaf_ids_equal": bool(torch.equal(lc.cpu(), lp))})
        bi, oi = bag(2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card.grow_compact(gc, hc, 2, bi, oi)
            no_sync = True
        except RuntimeError as e:
            no_sync = str(e)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ok = no_sync is True and all(
            t["ints_equal"] and t["leaf_ids_equal"] and t["floats_close"]
            and t["splits"][0] > 1 and t["bag_rows"] == bag_k
            for t in trees)
        runs.append({
            "strategy": "compact", "bag": "%d of %d rows" % (bag_k, n),
            "quantized_grad": quant, "ok": ok, "trees": trees,
            "carries": [list(key) for key in card._states],
            "captured_step_launches": {
                k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]: v
                for k, v in card._loop.launches_per_step.items()},
            "capture_s_in_loop": card._loop.capture_s,
            "no_sync_inside_tree": no_sync})
    return runs


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
    def reference_row(strategy, quant):
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
        return row

    ref_rows = []
    for strategy, quant, growth in (
            ("compact", False, "device loop"),
            ("compact", True, "device loop"),
            ("compact", False, "host loop"), ("compact", True, "host loop"),
            ("masked", False, "device loop"),
            ("masked", True, "device loop")):
        # a host-loop run: the generic iteration over the strategy's host
        # loop, on both devices
        with host_loop(torch) if growth == "host loop" \
                else contextlib.nullcontext():
            row = reference_row(strategy, quant)
        row["growth"] = growth
        ref_rows.append(row)

    def tie_separated(ba, bb):
        """Rows that reach another leaf of some tree on the two devices."""
        sep = np.zeros(len(xs), bool)
        for ta, tb in zip(ba._gbdt.models, bb._gbdt.models):
            sep |= np.array([ta.predict_leaf_row(rw) != tb.predict_leaf_row(rw)
                             for rw in xs])
        return sep

    def goss_witness(qp, first):
        """At the first sampled iteration whose trees differ between the
        devices, the GOSS sample each device draws from its own run's
        scores (both runs trained `first` rounds, whose trees are equal),
        under the iteration's bag key: the rows whose place in the sample
        differs (the order of |g * h| over all rows decides which rows the
        uniforms pick, so f32 noise in the scores or a last-ulp difference
        in the gradients moves the sample); and the card's sampler from the
        CPU's gradients, which must give the CPU's sample bit for bit."""
        from lightgbm_tpu_torch.models import device_learner as dl
        card_b = lgb.train(qp, lgb.Dataset(xs, ys), num_boost_round=first)
        cpu_b = lgb.train(qp, lgb.Dataset(xs, ys), num_boost_round=first,
                          device="cpu")
        gb = cpu_b._gbdt
        top_k, other_k, mult = gb._goss_params()
        sd = card_b._gbdt.score_updater.score[0]
        sc = gb.score_updater.score[0]
        gd, hd = card_b._gbdt.objective.get_gradients(sd)
        gc, hc = gb.objective.get_gradients(sc)
        key = prng_key((gb.config.bagging_seed + first) % (2**31 - 1))
        args = (key, len(ys), top_k, other_k, mult)
        want = dl.goss_sample(gc, hc, *args)
        own = dl.goss_sample(gd, hd, *args)
        same = dl.goss_sample(gc.to(dev), hc.to(dev), *args)
        return {"iteration": first,
                "trees_before_equal": shape_of(card_b) == shape_of(cpu_b),
                "max_abs_score_diff": float((sd.cpu() - sc).abs().max()),
                "grad_rows_differ": int((gd.cpu() != gc).sum()),
                "bag_rows_differ": int((own[3].cpu() != want[3]).sum()),
                "sampler_equal_from_same_gradients": all(
                    torch.equal(a.cpu(), b) for a, b in zip(same, want))}

    # sampled runs on the fused iteration: the bag drawn on each device
    # from the same key. Held to the same trees (their leaf counts are the
    # in-bag rows') and raw scores within 1e-4; where two thresholds tie
    # for a leaf's in-bag rows, f32 rounding picks one on each device and
    # the out-of-bag rows between them go each device's way (ROADMAP
    # section 3), so raw scores are then held on the other rows, with at
    # most 2 % of the rows so separated. Compact quantized keeps its
    # witness exemption. GOSS may grow other sampled trees only where its
    # own witness shows that the devices' samples differ from the same
    # scores, with its warm-up trees equal and its sampler bit-exact from
    # the same gradients.
    goss = {"boosting": "goss", "learning_rate": 0.5}
    for strategy, quant, name, extra in (
            ("compact", False, "bagging", {"bagging_fraction": 0.7,
                                           "bagging_freq": 1}),
            ("compact", True, "bagging", {"bagging_fraction": 0.7,
                                          "bagging_freq": 1}),
            ("compact", False, "goss", goss), ("compact", True, "goss", goss),
            ("masked", False, "bagging", {"bagging_fraction": 0.7,
                                          "bagging_freq": 1}),
            ("masked", True, "bagging", {"bagging_fraction": 0.7,
                                         "bagging_freq": 1}),
            ("masked", False, "goss", goss), ("masked", True, "goss", goss)):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        qp = dict(sp, quantized_grad=quant, grad_bits=8, **extra)
        on_card = lgb.train(qp, lgb.Dataset(xs, ys), num_boost_round=5)
        on_cpu = lgb.train(qp, lgb.Dataset(xs, ys), num_boost_round=5,
                           device="cpu")
        diff = np.abs(on_card.predict(xs, raw_score=True)
                      - on_cpu.predict(xs, raw_score=True))
        lr = on_card._gbdt.learner
        row = {"strategy": strategy, "quantized_grad": quant,
               "growth": "device loop", "sampling": name, "settings": extra,
               "fused_steps": len(on_card._gbdt._fused_step or {}),
               "host_syncs_per_tree": lr.stats.host_syncs
               / max(lr.stats.trees, 1),
               "same_trees": shape_of(on_card) == shape_of(on_cpu),
               "max_abs_raw_diff": float(diff.max()), "raw_tolerance": 1e-4}
        ok = row["same_trees"] and row["max_abs_raw_diff"] <= 1e-4
        if row["same_trees"] and not ok:
            sep = tie_separated(on_card, on_cpu)
            row["tie_separated_rows"] = int(sep.sum())
            row["max_abs_raw_diff_other_rows"] = float(diff[~sep].max())
            ok = sep.mean() <= 0.02 \
                and row["max_abs_raw_diff_other_rows"] <= 1e-4
        if not row["same_trees"] and name == "goss":
            # the first iteration whose tree differs; GOSS samples from
            # iteration 2 on (learning_rate 0.5)
            first = next(i for i, (a, b) in enumerate(zip(
                shape_of(on_card), shape_of(on_cpu))) if a != b)
            wit = goss_witness(qp, first)
            row["goss_witness"] = wit
            row["other_trees_allowed"] = ok = bool(
                first >= 2 and wit["trees_before_equal"]
                and wit["bag_rows_differ"] > 0
                and wit["sampler_equal_from_same_gradients"])
        elif not row["same_trees"] and strategy == "compact" and quant:
            wit = gradient_witness(on_card, qp, strategy)
            row["gradient_witness"] = wit
            row["witness_stored_rows_differ"] = sum(
                w["stored_rows_differ"] for w in wit)
            row["other_trees_allowed"] = ok = \
                row["witness_stored_rows_differ"] > 0
        row["ok"] = bool(ok and row["host_syncs_per_tree"] == 1
                         and row["fused_steps"] == (2 if name == "goss"
                                                    else 1))
        ref_rows.append(row)
    ref_rows += valid_reference_rows(lgb, sp, xs, ys, w_small, shape_of)
    ref_rows += objective_reference_rows(torch, dev, lgb, sp, xs, w_small,
                                         shape_of, _quant_prepare, prng_key)
    repeats = formerly_flaky_cases(torch, dev, lgb, k1, Config,
                                   DeviceTreeLearner, record_cols)
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    emit({"phase": "reference", "rows": 20_000, "rounds": 5,
          "runs": ref_rows, "formerly_flaky_cases": repeats})
    if not all(rw["ok"] for rw in ref_rows):
        fail("card and CPU runs disagree on the small reference tasks")
    if not all(c["agree"] == c["runs"] for c in repeats):
        fail("a formerly flaky card-vs-plain case disagreed: %s" % repeats)


def objective_reference_rows(torch, dev, lgb, sp, xs, w_small, shape_of,
                             _quant_prepare, prng_key):
    """The reference phase's objective runs, card against CPU on the
    20,000-row task: every objective of OBJECTIVE_TARGETS on compact float
    (the same trees, raw scores within 1e-5; fair and gamma within
    FAIR_GAMMA_TOL: their leaves divide cancelling gradient sums by small
    hessian sums, which carries the split scan's f32 sums -- added in
    another order on the card, from histograms equal bit for bit -- to
    ~1.2e-4 after 5 trees; their rows carry the leaf witness, which holds
    the first tree's leaves on each device to the exact f64 -G / H within
    the f32 rounding of the split scan's sums), and
    3-class multiclass on
    compact and masked float (the same) and on compact quantized (raw
    within 1e-4 and the same trees, or -- the quantized exemption of the
    binary rows -- other trees only where the stored integers of the
    card's gradients from the CPU's scores differ). Each row carries
    "ok"."""
    rows = []
    r = np.random.RandomState(31)
    m = higgs_margin(xs, w_small)
    _, ymc, _ = make_higgs_like(len(xs), xs.shape[1], seed=99, n_classes=3)
    cases = [(o, objective_targets(kind, m, r), "compact", False,
              FAIR_GAMMA_TOL if o in ("fair", "gamma") else 1e-5)
             for o, kind in OBJECTIVE_TARGETS]
    cases += [("multiclass", ymc, st, q, 1e-4 if q else 1e-5)
              for st, q in (("compact", False), ("masked", False),
                            ("compact", True))]
    for objective, y, strategy, quant, tol in cases:
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        p = dict(sp, objective=objective, quantized_grad=quant, grad_bits=8,
                 num_class=3 if objective == "multiclass" else 1)
        card = lgb.train(p, lgb.Dataset(xs, y), num_boost_round=5)
        cpu = lgb.train(p, lgb.Dataset(xs, y), num_boost_round=5,
                        device="cpu")
        row = {"objective": objective, "strategy": strategy,
               "quantized_grad": quant,
               "iteration": "fused" if card._gbdt._fused_step
               else "generic",
               "same_trees": shape_of(card) == shape_of(cpu),
               "max_abs_raw_diff": float(np.max(np.abs(
                   card.predict(xs, raw_score=True)
                   - cpu.predict(xs, raw_score=True)))),
               "raw_tolerance": tol}
        ok = row["max_abs_raw_diff"] <= tol
        if objective in ("fair", "gamma"):
            row["leaf_witness"] = leaf_witness(torch, dev, lgb, p, xs, y)
            ok = ok and all(w["within"] for w in row["leaf_witness"].values())
        if quant and not row["same_trees"]:
            row["stored_rows_differ"] = multiclass_witness(
                torch, dev, lgb, p, xs, y, card, _quant_prepare, prng_key)
            row["other_trees_allowed"] = row["stored_rows_differ"] > 0
            ok = ok and row["other_trees_allowed"]
        else:
            ok = ok and row["same_trees"]
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


# card against CPU for fair and gamma: ~3x the gap measured on an H100
# 80GB HBM3 (1.23e-4, chip_smoke.py reference phase)
FAIR_GAMMA_TOL = 4e-4


def leaf_witness(torch, dev, lgb, p, xs, y):
    """The first tree's leaf values on the card and on the CPU against the
    exact ones: -G / H of each leaf's rows in f64 from that device's own
    f32 gradients at the init score, shrunk, plus the init score. A leaf's
    G and H come out of the split scan's f32 sums over the bins of the
    nodes above it, so each error is counted in units of one f32 rounding
    of the root's sums carried into the leaf, lr * 2^-24 (sum|g| + |G / H|
    sum h) / H; per device the largest count and relative error, and
    whether every leaf lies within 64 units (the bins of one feature's
    scan)."""
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        b = lgb.train(p, lgb.Dataset(xs, y), num_boost_round=1,
                      device=device.type)
        gb = b._gbdt
        init = gb.objective.boost_from_score(0)
        g, h = (t.double().cpu().numpy() for t in gb.objective.get_gradients(
            torch.full((len(y),), init, dtype=torch.float32,
                       device=device)))
        leaf = gb.learner.last_leaf_id.cpu().numpy()
        tree = gb.models[0]
        nl = tree.num_leaves
        gs = np.bincount(leaf, weights=g, minlength=nl)
        hs = np.bincount(leaf, weights=h, minlength=nl)
        lr = p["learning_rate"]
        exact = -gs / hs * lr + init
        got = np.asarray(tree.leaf_value[:nl], dtype=np.float64)
        err = np.abs(got - exact)
        unit = lr * 2.0 ** -24 * (np.abs(g).sum()
                                  + np.abs(gs / hs) * h.sum()) / hs
        units = float(np.max(err / unit))
        out[name] = {"max_err_in_root_f32_units": units,
                     "max_rel_err": float(np.max(
                         err / np.maximum(np.abs(exact), 1e-30))),
                     "within": units <= 64.0}
    return out


def multiclass_witness(torch, dev, lgb, p, xs, y, card_b, _quant_prepare,
                       prng_key):
    """From the CPU run's scores after iterations 1..4, the rows whose
    stored (qg|qh) integers differ when the card's and the CPU's softmax
    gradients are quantized as each class's tree quantizes them (key
    prng_key(iteration * K + class))."""
    cpu_b = lgb.train(p, lgb.Dataset(xs, y), num_boost_round=1, device="cpu")
    lr = card_b._gbdt.learner
    k_cls = cpu_b._gbdt.num_tree_per_iteration
    differ = 0
    for it in range(1, 5):
        sc = cpu_b._gbdt.score_updater.score.clone()
        gc, hc = cpu_b._gbdt.objective.get_gradients(sc)
        gd, hd = card_b._gbdt.objective.get_gradients(sc.to(dev))
        for c in range(k_cls):
            key = prng_key(it * k_cls + c)
            pc = _quant_prepare(gc[c], hc[c], key, quant_bits=lr.quant_bits,
                                quant_renew=lr.quant_renew)[0]
            pd = _quant_prepare(gd[c], hd[c], key, quant_bits=lr.quant_bits,
                                quant_renew=lr.quant_renew)[0].cpu()
            differ += int((pd != pc).sum())
        cpu_b.update()
    return differ


def formerly_flaky_cases(torch, dev, lgb, k1, Config, DeviceTreeLearner,
                         record_cols, runs=10):
    """The two card-vs-plain float cases that failed now and then while
    the blocks' f32 partials met in atomic order, each run `runs` times:
    K1 over 100,003 rows of 11 int32 codes of 16 bins against its plain
    version (rtol = atol = 1e-4, counts equal; tests/test_torch_gpu.py
    test_k1_matches_plain[16-dtype3-11]), and the masked core's captured
    20,000-row tree against the same step on the CPU from the same
    gradients (leaf, feature and count columns and leaf ids equal;
    test_masked_captured_tree_matches_cpu[False]). Returns the count of
    runs that agree, per case."""
    _, R_FEAT, R_LCNT, R_LEAF, R_RCNT, _ = record_cols
    r = np.random.RandomState(16)
    p = 100_003
    codes = torch.from_numpy(r.randint(0, 16, size=(p, 11))).to(
        dev, torch.int32)
    gh = torch.from_numpy(np.stack([r.randn(p), r.rand(p), np.ones(p)], 1)
                          .astype(np.float32)).to(dev)
    gh[99_000:] = 0.0
    want = k1.build_histogram_plain(codes, gh, 16)
    agree = 0
    for _ in range(runs):
        got = k1.build_histogram(codes, gh, 16)
        agree += bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)
                      and torch.equal(got[..., 2], want[..., 2]))
    out = [{"case": "K1 (100,003 x 11) int32 codes, 16 bins vs plain",
            "runs": runs, "agree": agree}]
    # the card test's learner: 20,000 rows of 12 features, NaNs in one,
    # fixed gradients with signal
    r = np.random.RandomState(9)
    n = 20_000
    x = r.randn(n, 12)
    x[r.rand(n) < 0.03, 2] = np.nan
    mp = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
          "verbosity": -1}
    inner = lgb.Dataset(x, (x[:, 0] > 0).astype(float), params=mp) \
        .construct()._inner
    g = (x[:, 0] > 0.3) - 0.5 + 0.3 * r.randn(n) \
        + 0.2 * np.nan_to_num(x[:, 2])
    h = 0.1 + r.rand(n)
    gt, ht = (torch.from_numpy(a.astype(np.float32)) for a in (g, h))
    cpu = DeviceTreeLearner(Config(mp), inner, strategy="masked",
                            device="cpu")
    want = [cpu.grow(gt, ht, iter_seed=s) for s in (0, 1)]
    card = DeviceTreeLearner(Config(mp), inner, strategy="masked",
                             device=dev)
    ints = [R_LEAF, R_FEAT, R_LCNT, R_RCNT]
    agree = 0
    for _ in range(runs):
        ok = True
        for s, (crec, cleaf, ck) in zip((0, 1), want):
            rec, leaf, k = card.grow(gt.to(dev), ht.to(dev), iter_seed=s)
            ok = ok and k == ck and np.array_equal(rec[:, ints],
                                                   crec[:, ints]) \
                and torch.equal(leaf.cpu(), cleaf)
        agree += bool(ok)
    out.append({"case": "masked captured 20,000-row tree vs the CPU",
                "runs": runs, "agree": agree})
    return out


def valid_reference_rows(lgb, sp, xs, ys, w_small, shape_of):
    """The reference phase's validation-set runs, card against CPU on the
    20,000-row task: early stopping with a 5,000-row validation set on
    each strategy, a lambda_l2 reset at iteration 2 on each strategy, and a
    3-fold cv of 3 rounds. Each row carries "ok"."""
    xv, yv, _ = make_higgs_like(5_000, xs.shape[1], seed=100, w=w_small)
    rows = []

    def leaves(b, x):
        return np.array([[t.predict_leaf_row(r) for t in b._gbdt.models]
                         for r in x])

    # early stopping: learning_rate 0.5 overfits the 31-leaf trees within
    # the 40 rounds
    es = dict(sp, learning_rate=0.5, metric=["binary_logloss", "auc"])
    for strategy in ("compact", "masked"):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        runs = []
        for device in (None, "cpu"):
            dtr = lgb.Dataset(xs, ys)
            ev = {}
            b = lgb.train(es, dtr, 40, valid_sets=[dtr.create_valid(xv, yv)],
                          valid_names=["valid"], early_stopping_rounds=5,
                          evals_result=ev, verbose_eval=False, device=device)
            runs.append((b, ev))
        (card, cev), (cpu, pev) = runs
        diffs = {m: float(np.max(np.abs(np.array(cev["valid"][m])
                                        - np.array(pev["valid"][m]))))
                 for m in pev["valid"]}
        row = {"case": "early stopping", "strategy": strategy,
               "best_iteration": [card.best_iteration, cpu.best_iteration],
               "history_len": len(cev["valid"]["auc"]),
               "valid_history_max_abs_diff": diffs,
               "training_history_max_abs_diff": float(np.max(np.abs(
                   np.array(cev["training"]["binary_logloss"])
                   - np.array(pev["training"]["binary_logloss"])))),
               "host_syncs_per_tree": card._gbdt.learner.stats.host_syncs
               / max(card._gbdt.learner.stats.trees, 1)}
        ok = (card.best_iteration == cpu.best_iteration > 0
              and card.best_iteration < 35
              and row["training_history_max_abs_diff"] <= 1e-4
              and row["host_syncs_per_tree"] == 1)
        if max(diffs.values()) > 1e-4 and shape_of(card) == shape_of(cpu):
            # validation rows that reach another leaf on the two devices
            # (tied thresholds, see the bagged rows above): the metrics
            # on the others, every iteration
            sep = (leaves(card, xv) != leaves(cpu, xv)).any(axis=1)
            row["tie_separated_rows"] = int(sep.sum())
            other = 0.0
            for it in range(1, row["history_len"] + 1):
                a, c = (auc(yv[~sep], b.predict(xv[~sep], raw_score=True,
                                                 num_iteration=it))
                        for b in (card, cpu))
                other = max(other, abs(a - c))
            row["valid_auc_max_abs_diff_other_rows"] = other
            ok = ok and sep.mean() <= 0.02 and other <= 1e-4
        elif max(diffs.values()) > 1e-4:
            ok = False
        row["ok"] = bool(ok)
        rows.append(row)

    # a lambda_l2 reset at iteration 2: one more capture, the CPU's trees
    l2 = [0.0, 0.0, 50.0, 50.0, 50.0]
    rp = dict(sp, lambda_l2=0.0)
    for strategy in ("compact", "masked"):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        runs = []
        for device in (None, "cpu"):
            caps = []
            b = lgb.train(rp, lgb.Dataset(xs, ys), 5, device=device,
                          verbose_eval=False, callbacks=[
                              lgb.reset_parameter(lambda_l2=l2),
                              lambda env: caps.append(
                                  env.model._gbdt.learner.stats.captures)])
            runs.append((b, caps))
        (card, ccaps), (cpu, _) = runs
        diff = float(np.max(np.abs(card.predict(xs, raw_score=True)
                                   - cpu.predict(xs, raw_score=True))))
        row = {"case": "reset lambda_l2 at iteration 2",
               "strategy": strategy, "captures_after_each_iteration": ccaps,
               "graph_captured": card._gbdt.learner._loop.graph is not None,
               "same_trees": shape_of(card) == shape_of(cpu),
               "max_abs_raw_diff": diff}
        row["ok"] = bool(ccaps == [1, 1, 2, 2, 2] and row["same_trees"]
                         and row["graph_captured"] and diff <= 1e-4)
        rows.append(row)

    # cv: three learners capture their loops in turn
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    cp = dict(sp, metric=["binary_logloss", "auc"])
    card = lgb.cv(cp, lgb.Dataset(xs, ys), 3, nfold=3)
    cpu = lgb.cv(cp, lgb.Dataset(xs, ys), 3, nfold=3, device="cpu")
    diffs = {k: float(np.max(np.abs(np.array(card[k]) - np.array(cpu[k]))))
             for k in cpu}
    rows.append({"case": "cv 3-fold, 3 rounds", "keys": sorted(card),
                 "max_abs_diff": diffs,
                 "ok": bool(sorted(card) == sorted(cpu)
                            and max(diffs.values()) <= 1e-4)})
    return rows


if __name__ == "__main__":
    sys.exit(main())
