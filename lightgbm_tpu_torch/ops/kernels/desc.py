"""The split descriptor: one split's window and decision, in device memory.

The device loops of the compact and the masked core (models/
device_learner.py) write one small int32 tensor per split step with tensor
ops, and the kernels they launch read the split from it instead of taking
it as host ints: the compact core's split-key kernel (ops/kernels/
split_key.py), K4's window entry (ops/kernels/partition.py) and the K1 /
K3 window entries (ops/kernels/histogram.py); the masked core's column
entry of the split key. Their launches then have the same arguments at
every split, so the step replays from one CUDA graph. The CUDA sources
repeat the field numbers they read (``kDesc*`` in csrc/*.cu; the tests
hold them equal to these).

Fields (int32):
  GO          1 while the tree grows; 0 makes every kernel return at once
  SRC         the working buffer (0 or 1) that holds the split leaf's rows;
              the partition moves them to the other one
  BEGIN       the leaf's first row, COUNT its rows
  LPHYS       rows going left, added by the split-key kernel
  LEFT_SMALL  1 when the left child is the smaller (its histogram is built)
  THR, DLEFT  the split's bin threshold and default-left flag
  COL, BASE, ELIDE, NUMBINS, MISSING, DEFAULT
              the split feature's column, EFB base and elide flag, bin
              count, missing type and default bin
  SIDE_MAX    four ints: max |qg|, |qh| of the left rows, then the right
              rows' (leaf re-quantization), maxed in by the split-key kernel
  LEAF        the split leaf (masked core: rows whose leaf id it is split)
  NEW_ID      the right child's leaf id, k + 1 (masked core)
  CAT         1 when the split feature is categorical: a row goes left
              iff its logical bin is set in the W bitset words from WORDS
  WORDS       the categorical split's left-bin bitset, W int32 words (bin
              b at bit b % 32 of word b // 32); W is the learner's, 0
              without categorical features (``size(W)`` fields in all)
"""
from __future__ import annotations

import torch

(GO, SRC, BEGIN, COUNT, LPHYS, LEFT_SMALL, THR, DLEFT, COL, BASE, ELIDE,
 NUMBINS, MISSING, DEFAULT, SIDE_MAX) = range(15)
LEAF = SIDE_MAX + 4
NEW_ID = LEAF + 1
CAT = NEW_ID + 1
WORDS = CAT + 1
SIZE = WORDS                  # the descriptor without bitset words


def size(words: int) -> int:
    """The descriptor's length with `words` bitset words."""
    return SIZE + words


def is_desc(desc: torch.Tensor) -> bool:
    """Whether `desc` has a descriptor's shape: (size(W),) for a W >= 0."""
    return desc.dim() == 1 and desc.shape[0] >= SIZE


def cat_words(desc: torch.Tensor) -> int:
    """The descriptor's bitset words W, from its length (a kernel wrapper
    checks the length first)."""
    return desc.shape[0] - SIZE


def root(n: int, device, words: int = 0) -> torch.Tensor:
    """The descriptor whose histogram window is all n rows of buffer 0:
    the root's (a window entry reads buffer 1 - SRC, from row BEGIN, the
    LPHYS rows of a left-small split)."""
    d = torch.zeros(size(words), dtype=torch.int32)
    d[GO], d[SRC], d[COUNT], d[LPHYS], d[LEFT_SMALL] = 1, 1, n, n, 1
    return d.to(device)


def fields(desc: torch.Tensor):
    """The descriptor's ints on the host (the plain versions on the CPU
    read it this way)."""
    return [int(v) for v in desc.tolist()]
