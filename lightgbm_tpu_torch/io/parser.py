"""Text data parsing: CSV / TSV / space-separated / LibSVM with format and
header detection.

Port of lightgbm_tpu/io/parser.py (reference: src/io/parser.cpp:194
CreateParser, parser.hpp CSVParser / TSVParser / LibSVMParser). A local
file goes through the repo's native parser (``cpp/parser.cpp``, built by
io/native.py) when it loads, else through numpy; ``last_parser`` says
which one parsed the last file.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# "native" or "numpy": the parser of the last parse_file call
last_parser: Optional[str] = None


def _detect_format(line: str) -> str:
    tokens = line.strip().split()
    colon_cnt = sum(1 for t in tokens for c in t if c == ":")
    if colon_cnt > 0 and all(":" in t for t in tokens[1:2]):
        return "libsvm"
    if "," in line:
        return "csv"
    if "\t" in line:
        return "tsv"
    return "space"


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return tok.lower() in ("nan", "na", "inf", "-inf")


def parse_file(path: str, label_column: int = 0,
               has_header: Optional[bool] = None):
    """Returns (X, y, query_boundaries or None); y is None for a
    one-column file. has_header None detects a header (a first data line
    with a token that is not a number)."""
    global last_parser
    from .file_io import _scheme_of, open_file
    if not _scheme_of(path):
        from . import native
        if native.available():
            try:
                out = native.parse_file(path, label_column, has_header)
                last_parser = "native"
                return out
            except RuntimeError:  # numpy reads what the native refuses
                pass
    last_parser = "numpy"
    with open_file(path) as f:
        first = f.readline()
        while first and (first.startswith("#") or not first.strip()):
            first = f.readline()
    if not first:
        raise ValueError(f"data file is empty: {path}")
    fmt = _detect_format(first)
    if fmt == "libsvm":
        return _parse_libsvm(path)
    delim = {"csv": ",", "tsv": "\t", "space": None}[fmt]
    toks = first.strip().split(delim)
    header = has_header if has_header is not None else not all(
        _is_number(t) for t in toks if t)
    with open_file(path) as f:
        data = np.genfromtxt(f, delimiter=delim,
                             skip_header=1 if header else 0,
                             dtype=np.float64)
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    if data.shape[1] == 1:
        return data, None, None
    y = data[:, label_column].copy()
    x = np.delete(data, label_column, axis=1)
    return x, y, None


def _parse_libsvm(path: str):
    from .file_io import open_file
    labels = []
    rows = []
    max_feat = -1
    with open_file(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            labels.append(float(toks[0]))
            feats = {}
            for t in toks[1:]:
                if ":" not in t:
                    continue
                k, v = t.split(":", 1)
                idx = int(k)
                feats[idx] = float(v)
                max_feat = max(max_feat, idx)
            rows.append(feats)
    x = np.zeros((len(rows), max_feat + 1))
    for i, feats in enumerate(rows):
        for k, v in feats.items():
            x[i, k] = v
    return x, np.asarray(labels), None
