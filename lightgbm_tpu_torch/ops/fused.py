"""The growth cores' split loop on the device, a tree's leaf values from
its split records, and the host-loop learner's per-split steps.

Port of lightgbm_tpu/ops/fused.py (run_split_loop, and the per-split
programs of the host-loop learner: fused_root_step, fused_split_step and
their quantized forms) and lightgbm_tpu/models/device_learner.py::
leaf_values_from_rec.

**The host-loop learner's steps** (models/serial_learner.py, the JAX
package's SerialTreeLearner): one split = the stable partition of the
leaf's window in the permutation buffer, the left child's histogram from
the window's gathered rows (K1's host-int entry; quantized: K3's operand
entry over the packed (qg|qh) words), the sibling as parent - left, and
both children's split scans (with their CEGB costs), batched in one
find_best_split over the two. The caller fetches the left count and the
two winners in one copy: one host sync per split, as in JAX.

The JAX package runs a growth core's split body -- the compact core's
and the masked core's alike -- as one device program per tree: a
``lax.while_loop`` that exits when no leaf has a positive gain
(``grow_program=per_split``), or a fixed-trip ``lax.scan`` of
num_leaves - 1 steps whose body is gated by ``lax.cond`` (``fused_tree``),
both with the same records. The port has the fixed-trip form only, for
both settings: an early exit cannot be seen on the host without a
device->host sync. Its step is a function over the learner's
device-resident state that gates every write on the step's own ``go``
flag (tensor ops with ``torch.where``), and whose kernels return at once
when the split descriptor's GO field is 0 (or, where a kernel must run,
sum what no gated write reads), so a stopped tree's state passes through
the remaining steps untouched.

On the card ``SplitLoop`` captures the step once as a CUDA graph and
replays it num_leaves - 1 times per tree, with no host sync in between; on
the CPU it runs the same step eagerly (the kernels' plain versions), which
is what the tests hold against the JAX package. The learner
(models/device_learner.py) makes one per learner: over the compact core's
``split_step`` (split key, K4's and K1's / K3's window entries) or the
masked core's ``masked_split_step`` (the split key's column entry, K2 /
K3t over all rows).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import quantize as quant_ops
from . import split as split_ops
from .histogram import (build_histogram, build_histogram_quantized,
                        gather_and_build, gather_and_build_quantized)
from .partition import (decide_left, decide_left_categorical,
                        reorder_window)

R_LEAF, R_LOUT, R_ROUT = 0, 11, 12      # split-record columns read here


class SplitLoop:
    """Runs `step` num_steps times per tree on `device`.

    On the card ``capture`` must come first, once: it runs one eager step
    with the caller's state idle (every write gated off), which loads the
    kernels' libraries and fills the wrappers' caches outside the capture,
    then captures the step. A wrapper counts its launch while the step is
    captured, where no kernel runs: the capture's increments of the
    `counters` ((module, attribute) pairs) are taken back, and every replay
    adds the captured step's launches."""

    def __init__(self, step: Callable[[], None], num_steps: int,
                 device: torch.device, counters: Sequence[Tuple[object, str]]):
        self.step = step
        self.num_steps = num_steps
        self.device = torch.device(device)
        self.counters = tuple(counters)
        self.graph = None
        self.launches_per_step: Dict[str, int] = {}
        self.capture_s = 0.0           # warm-up step and capture, seconds

    def capture(self) -> None:
        """Warm up and capture the step (card only); the caller's state
        must be idle, and is left as it was."""
        t0 = time.perf_counter()
        self.step()
        torch.cuda.synchronize(self.device)
        before = [getattr(m, a) for m, a in self.counters]
        graph = torch.cuda.CUDAGraph()
        # a graph freed while another captures invalidates that capture
        # (its reset is not permitted then); a graph held by a dead
        # reference cycle is freed by the cyclic collector, whenever it
        # runs: not during the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.step()
        finally:
            if collecting:
                gc.enable()
        for (m, a), b in zip(self.counters, before):
            self.launches_per_step["%s.%s" % (m.__name__, a)] = \
                getattr(m, a) - b
            setattr(m, a, b)
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        """num_steps steps, in order, with no host sync between them."""
        if self.device.type != "cuda":
            for _ in range(self.num_steps):
                self.step()
            return
        if self.graph is None:
            raise RuntimeError("SplitLoop.run on the card before capture")
        for _ in range(self.num_steps):
            self.graph.replay()
        for m, a in self.counters:
            setattr(m, a, getattr(m, a) + self.num_steps
                    * self.launches_per_step["%s.%s" % (m.__name__, a)])


def leaf_values_from_rec(rec: torch.Tensor, k: torch.Tensor,
                         num_leaves: int) -> torch.Tensor:
    """The (L,) leaf values of a tree from its (L-1, 13) split records, of
    which the first k (a 0-d device tensor) are real: split i sets its
    leaf's value to its left output and leaf i + 1's to its right output,
    so a leaf holds the left output of the last split of it, else the
    right output of the split that made it (leaf 0 of an unsplit tree:
    0). Fixed-shape tensor ops, no host sync; equal, value for value, to
    the JAX package's sequential replay."""
    L = num_leaves
    dev = rec.device
    i = torch.arange(L - 1, device=dev)
    j = torch.arange(L, device=dev)
    real = i < k
    hit = (rec[:, R_LEAF].long()[:, None] == j[None, :]) & real[:, None]
    last = torch.where(hit, i[:, None], -1).amax(dim=0)            # (L,)
    lout = rec[:, R_LOUT].index_select(0, last.clamp(min=0))
    rout = rec[:, R_ROUT].index_select(0, (j - 1).clamp(min=0))
    made = (j >= 1) & (j <= k)
    return torch.where(last >= 0, lout,
                       torch.where(made, rout, torch.zeros_like(rout)))


class FusedStepOut(NamedTuple):
    """One host-loop split: the permutation buffer (partitioned in place),
    the left count (0-d), both children's histograms and their winners
    (a SplitResult of (2,) tensors: left, right)."""
    indices_buf: torch.Tensor
    left_count: torch.Tensor
    left_hist: torch.Tensor
    right_hist: torch.Tensor
    res: split_ops.SplitResult


def _scan(hist2, sums2, meta, mn2, mx2, scan_kwargs, cost2=None):
    """The split scan of N leaves: hist2 (N, F, B, 3) f32, sums2 (N, 3)
    [sum_grad, sum_hess, count], mn2 / mx2 (N,) output bounds, cost2 (N,
    F) CEGB costs or None; meta = (f_numbins, f_missing, f_default,
    feature mask, monotone, penalty or None)."""
    f_numbins, f_missing, f_default, feature_mask, monotone, penalty = meta
    return split_ops.find_best_split(
        hist2, sums2[:, 0], sums2[:, 1], sums2[:, 2], f_numbins, f_missing,
        f_default, feature_mask, monotone, mn2, mx2, penalty, cost2,
        **scan_kwargs)


def _dequant_scan(hist_q2, scales, sums2, meta, mn2, mx2, scan_kwargs,
                  cost2=None):
    """_scan over exact int32 histograms dequantized with the iteration's
    (2,) [s_g, s_h] scales."""
    hist = quant_ops.dequantize_histogram(hist_q2, scales[0], scales[1])
    return _scan(hist, sums2, meta, mn2, mx2, scan_kwargs, cost2)


def _route_and_partition(indices_buf, binned, iparams, cat_bitset, *,
                         bucket: int):
    """The one copy of the per-split routing and stable partition shared
    by the float and quantized steps. iparams: host ints [begin, count,
    feature, threshold, default_left, missing_type, default_bin,
    numbins_f, is_categorical]; cat_bitset: (W,) int32 words. Returns
    (window (bucket,) row ids before the reorder, gathered (bucket, F)
    codes, validity, go_left, left count)."""
    (begin, count, feature, threshold, default_left, missing_type,
     default_bin, numbins_f, is_categorical) = [int(v) for v in iparams[:9]]
    window = indices_buf[begin:begin + bucket]
    rows = binned.index_select(0, window.long())
    fbins = rows[:, feature].long()
    if binned.dtype == torch.int16:
        fbins = fbins & 0xFFFF
    if is_categorical:
        go_left = decide_left_categorical(fbins, cat_bitset)
    else:
        go_left = decide_left(fbins, threshold, bool(default_left),
                              missing_type, default_bin, numbins_f)
    window, valid, left_count = reorder_window(indices_buf, begin, count,
                                               go_left, bucket)
    return window, rows, valid, go_left, left_count


def _child_args(fparams, device):
    """(2, 3) children's sums and (2,) bounds from the host fparams
    [lsum_g, lsum_h, lcnt, rsum_g, rsum_h, rcnt, lmin, lmax, rmin, rmax]."""
    f = torch.tensor([float(v) for v in fparams], dtype=torch.float32,
                     device=device)
    return f[:6].view(2, 3), f[6::2], f[7::2]


def fused_split_step(indices_buf, binned, grad, hess, iparams, cat_bitset,
                     fparams, parent_hist, feature_meta,
                     child_costs: Optional[torch.Tensor] = None, *,
                     bucket: int, num_bins: int, **scan_kwargs
                     ) -> FusedStepOut:
    """One float split of the host-loop learner: the partition, the left
    child's histogram over the window's gathered rows (rows not going
    left carry gh == 0; K1), the right child as parent - left, and both
    scans. child_costs: (2, F) CEGB costs (left, right) or None."""
    window, rows, valid, go_left, left_count = _route_and_partition(
        indices_buf, binned, iparams, cat_bitset, bucket=bucket)
    w = (valid & go_left).float()
    win = window.long()
    gh = torch.stack([grad.index_select(0, win) * w,
                      hess.index_select(0, win) * w, w], dim=1)
    left_hist = build_histogram(rows, gh, num_bins)
    right_hist = parent_hist - left_hist
    sums2, mn2, mx2 = _child_args(fparams, grad.device)
    res = _scan(torch.stack([left_hist, right_hist]), sums2, feature_meta,
                mn2, mx2, scan_kwargs, child_costs)
    return FusedStepOut(indices_buf, left_count, left_hist, right_hist, res)


def fused_root_step(indices_buf, binned, grad, hess, count: int,
                    feature_meta, root_cost=None, *, bucket: int,
                    num_bins: int, **scan_kwargs):
    """Root histogram (K1) and scan: returns (hist, totals (3,),
    SplitResult of (1,) tensors). root_cost: (F,) CEGB cost or None."""
    hist = gather_and_build(binned, indices_buf, grad, hess, 0, count,
                            num_bins, bucket)
    totals = hist[0].sum(dim=0)
    inf = torch.full((1,), float("inf"), device=hist.device)
    res = _scan(hist[None], totals[None], feature_meta, -inf, inf,
                scan_kwargs, None if root_cost is None else root_cost[None])
    return hist, totals, res


def fused_split_step_q(indices_buf, binned, gh_packed, iparams, cat_bitset,
                       fparams, parent_hist, scales, feature_meta,
                       child_costs: Optional[torch.Tensor] = None, *,
                       bucket: int, num_bins: int, grad_bits: int,
                       **scan_kwargs) -> FusedStepOut:
    """fused_split_step on quantized gradients: the packed (N,) int32
    (qg|qh) words as the left child's integer operand (K3), an exact
    int32 pool and sibling, scans dequantized with (2,) scales."""
    window, rows, valid, go_left, left_count = _route_and_partition(
        indices_buf, binned, iparams, cat_bitset, bucket=bucket)
    ghq = quant_ops.gh_operand(gh_packed.index_select(0, window.long()),
                               valid & go_left, grad_bits)
    left_hist = build_histogram_quantized(rows, ghq, num_bins)
    # exact integer sibling subtraction (FeatureHistogram::Subtract)
    right_hist = parent_hist - left_hist
    sums2, mn2, mx2 = _child_args(fparams, gh_packed.device)
    res = _dequant_scan(torch.stack([left_hist, right_hist]), scales, sums2,
                        feature_meta, mn2, mx2, scan_kwargs, child_costs)
    return FusedStepOut(indices_buf, left_count, left_hist, right_hist, res)


def fused_root_step_q(indices_buf, binned, gh_packed, scales, count: int,
                      feature_meta, root_cost=None, *, bucket: int,
                      num_bins: int, grad_bits: int, **scan_kwargs):
    """Quantized root: the integer histogram (K3) and the dequantized
    scan; returns (hist_q int32, f32 totals (3,), SplitResult). The f32
    totals come from the same dequantized sums the scan reads."""
    hist_q = gather_and_build_quantized(binned, indices_buf, gh_packed, 0,
                                        count, num_bins, bucket, grad_bits)
    totals = quant_ops.dequantize_histogram(
        hist_q[0].sum(dim=0).to(torch.int32), scales[0], scales[1])
    inf = torch.full((1,), float("inf"), device=hist_q.device)
    res = _dequant_scan(hist_q[None], scales, totals[None], feature_meta,
                        -inf, inf, scan_kwargs,
                        None if root_cost is None else root_cost[None])
    return hist_q, totals, res
