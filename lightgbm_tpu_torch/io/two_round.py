"""Two-round (out-of-core) text loading.

Port of lightgbm_tpu/io/two_round.py (reference: dataset_loader.cpp:168,
LoadFromFile's two_round branch, and pipeline_reader.h). When the text
file is too big for its float matrix, it is read twice:

  round 1: one sequential pass that counts the rows and reservoir-samples
           ``bin_construct_sample_cnt`` of them (seeded, order-stable),
           from which each feature's BinMapper is built as the in-memory
           path builds it;
  round 2: a second sequential pass that bins each chunk of rows straight
           into the (N, used_features) uint8 / uint16 code matrix.

Peak memory is the sample, a chunk and the codes: the float64 matrix never
exists. The label column streams into its (N,) vector in round 2. The
reservoir's draws are the JAX package's, so the bins are its bins.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..utils import log

CHUNK_ROWS = 65536


def _open_rows(path: str, label_column: int):
    """(delimiter, header) of a CSV / TSV / space file, detected on its
    first line that is neither a comment nor blank, as io/parser.py
    detects them."""
    from .file_io import open_file
    from .parser import _detect_format, _is_number
    with open_file(path) as f:
        first = f.readline()
        while first and (first.startswith("#") or not first.strip()):
            first = f.readline()
    if not first:
        raise ValueError(f"data file is empty: {path}")
    fmt = _detect_format(first)
    if fmt == "libsvm":
        raise ValueError("two_round loading supports csv/tsv text files")
    delim = {"csv": ",", "tsv": "\t", "space": None}[fmt]
    toks = first.strip().split(delim)
    header = not all(_is_number(t) for t in toks if t)
    return delim, header


def _iter_chunks(path: str, delim, header: bool, chunk_rows: int):
    """Yield (start row, float64 (B, C) chunk) in file order; comments and
    blank lines are skipped, and the header (the first line left) with
    them."""
    from .file_io import open_file
    with open_file(path) as f:
        content = (ln for ln in f if ln.strip() and not ln.startswith("#"))
        if header:
            next(content, None)
        start = 0
        while True:
            lines = list(itertools.islice(content, chunk_rows))
            if not lines:
                break
            chunk = np.genfromtxt(lines, delimiter=delim, dtype=np.float64)
            if chunk.ndim == 1:
                chunk = chunk.reshape(len(lines), -1)
            yield start, chunk
            start += chunk.shape[0]


def load_two_round(path: str, config, label_column: int = 0,
                   categorical_feature=None,
                   chunk_rows: int = CHUNK_ROWS):
    """A binned Dataset from a text file in two sequential passes.
    Returns (dataset, label vector or None)."""
    from .binning import (BinMapper, load_forced_bounds,
                          mapper_from_sample_column, resolve_ignore_set)
    from .dataset import Dataset, resolve_categorical_set

    delim, header = _open_rows(path, label_column)
    sample_cnt = int(config.bin_construct_sample_cnt)
    rng = np.random.RandomState(config.data_random_seed)

    # round 1: count and reservoir-sample (Algorithm R, one vectorized
    # draw per chunk; numpy's fancy assignment applies in index order, so
    # a later row overwriting an earlier one at the same slot is the
    # sequential algorithm)
    sample = None
    n = 0
    for _, chunk in _iter_chunks(path, delim, header, chunk_rows):
        b = chunk.shape[0]
        if sample is None:
            sample = np.empty((sample_cnt, chunk.shape[1]), np.float64)
        take = min(max(sample_cnt - n, 0), b)
        if take:
            sample[n:n + take] = chunk[:take]
        if take < b:
            pos = np.arange(n + take, n + b, dtype=np.int64)
            j = (rng.random_sample(b - take) * (pos + 1)).astype(np.int64)
            hit = j < sample_cnt
            sample[j[hit]] = chunk[take:][hit]
        n += b
    if n == 0:
        raise ValueError(f"data file is empty: {path}")
    sample = sample[:min(n, sample_cnt)]
    num_cols = sample.shape[1]
    has_label = num_cols > 1
    feat_of = [c for c in range(num_cols)
               if not (has_label and c == label_column)]
    nf = len(feat_of)
    log.info("two_round: %d rows, %d features, %d sampled",
             n, nf, sample.shape[0])

    # the mappers from the sample (the in-memory path's find-bin recipe)
    feature_names = [f"Column_{i}" for i in range(nf)]
    cat_idx = resolve_categorical_set(
        categorical_feature or config.categorical_feature, feature_names)
    forced_bounds = load_forced_bounds(config.forcedbins_filename)
    ignore = resolve_ignore_set(config.ignore_column, feature_names)
    mappers = []
    for j, c in enumerate(feat_of):
        if j in ignore:
            mappers.append(BinMapper.trivial())
            continue
        mappers.append(mapper_from_sample_column(
            sample[:, c], sample.shape[0], config, j, cat_idx,
            forced_bounds))
    used = [j for j, m in enumerate(mappers) if not m.is_trivial]
    max_bins = max([mappers[j].num_bin for j in used], default=1)

    # round 2: bin each chunk into the code matrix
    dtype = np.uint8 if max_bins <= 256 else np.uint16
    binned = np.zeros((n, max(len(used), 1)), dtype=dtype)
    label = np.zeros(n, np.float64) if has_label else None
    for start, chunk in _iter_chunks(path, delim, header, chunk_rows):
        hi = start + chunk.shape[0]
        if has_label:
            label[start:hi] = chunk[:, label_column]
        for k, j in enumerate(used):
            binned[start:hi, k] = mappers[j].values_to_bins(
                chunk[:, feat_of[j]]).astype(dtype)

    ds = Dataset.from_binned(binned, mappers, config, label=label,
                             feature_names=feature_names)
    return ds, label
