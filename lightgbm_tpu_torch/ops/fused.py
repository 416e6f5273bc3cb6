"""The growth cores' split loop on the device, and a tree's leaf values
from its split records.

Port of lightgbm_tpu/ops/fused.py::run_split_loop and lightgbm_tpu/models/
device_learner.py::leaf_values_from_rec.

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
from typing import Callable, Dict, Sequence, Tuple

import torch

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
