"""Edge feature transforms: raw CSV/JSON rows -> model-ready features
(port of lightgbm_tpu/serving/transforms.py; the same sidecar format).

The reference CLI predicts straight from a raw data file — binning is
the model's problem, not the client's (reference: application.cpp
Predict + bin.h ValueToBin). The serving edge gets the same property
here: at train time the CLI captures the Dataset's fitted BinMappers
into a ``<model>.transform.json`` sidecar (the exact mechanism the
drift baseline uses), and a serving gateway applies them so clients
send raw feature rows — CSV text or JSON with nulls — and never
pre-bin.

Why this is *bit-identical* to raw predict, not merely close: trained
trees store real-valued thresholds that are exactly bin upper bounds
(``Dataset.real_threshold`` -> ``BinMapper.bin_to_value``), so mapping
a raw value to its bin code and back to the bin's representative value
(``EdgeTransform.prebin_rows``) can never move it across any threshold
the model can test. A client that pre-bins with this sidecar and one
that sends raw floats get byte-for-byte the same predictions.

Sidecar lifecycle mirrors serving/drift.py: ``capture_transform``
(training side, the CLI's write), ``save_transform`` /
``load_transform`` (format-tagged JSON; load returns None on
unreadable or foreign files), ``EdgeTransform`` (serving side,
numpy-only — no device dependency at the gateway).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ..io.binning import BIN_NUMERICAL, BinMapper

__all__ = ["capture_transform", "save_transform", "load_transform",
           "EdgeTransform", "TRANSFORM_FORMAT"]

TRANSFORM_FORMAT = "lgbm_tpu_edge_transform"

# CSV tokens that mean "missing" (case-insensitive), matching the
# loose-parsing habits of the reference's text parser
_MISSING_TOKENS = {"", "na", "nan", "null", "none", "?"}


def capture_transform(dataset) -> dict:
    """Record the fitted bin mappers of a constructed Dataset, keyed by
    raw feature column. Unused/trivial columns carry no mapper — the
    transform passes them through untouched (no tree can test them).
    Accepts either the inner io.dataset.Dataset or the public
    basic.Dataset wrapper (the CLI holds the wrapper; its mappers live
    on the constructed ``_inner``)."""
    if hasattr(dataset, "construct"):
        dataset = dataset.construct()._inner
    mappers: Dict[str, dict] = {}
    for f in getattr(dataset, "used_features", []):
        mappers[str(int(f))] = dataset.bin_mappers[f].to_dict()
    return {"format": TRANSFORM_FORMAT, "version": 1,
            "num_features": int(dataset.num_total_features),
            "mappers": mappers}


def save_transform(spec: dict, path: str) -> str:
    # default json (allow_nan=True): bin_upper_bound legitimately holds
    # Infinity and, for MISSING_NAN features, a trailing NaN
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh, sort_keys=True)
    return path


def load_transform(path: str) -> Optional[dict]:
    """Sidecar load: None (not an error) on missing/unreadable/foreign
    files, so discovery can probe paths freely."""
    try:
        with open(path, encoding="utf-8") as fh:
            spec = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(spec, dict) or spec.get("format") != TRANSFORM_FORMAT:
        return None
    return spec


class EdgeTransform:
    """Raw-row front end over a captured transform spec."""

    def __init__(self, spec: dict):
        if spec.get("format") != TRANSFORM_FORMAT:
            raise ValueError("not an edge-transform spec")
        self.num_features = int(spec["num_features"])
        self.mappers: Dict[int, BinMapper] = {
            int(f): BinMapper.from_dict(d)
            for f, d in (spec.get("mappers") or {}).items()}

    # -- ingestion ------------------------------------------------------
    def parse_rows(self, rows) -> np.ndarray:
        """JSON rows -> float32 matrix; None (JSON null) and missing
        tokens become NaN for the mappers' missing handling."""
        out = np.empty((len(rows), self.num_features), dtype=np.float32)
        for i, row in enumerate(rows):
            if len(row) != self.num_features:
                raise ValueError(
                    f"row {i} has {len(row)} values, model expects "
                    f"{self.num_features}")
            out[i] = [self._scalar(v) for v in row]
        return out

    def parse_csv(self, text: str, sep: Optional[str] = None) -> np.ndarray:
        """CSV text -> float32 matrix. Separator auto-detected
        (comma/tab/semicolon) from the first line when not given; blank
        lines are skipped; missing tokens become NaN."""
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty csv body")
        if sep is None:
            sep = max(",\t;", key=lines[0].count)
        rows: List[List[str]] = [ln.split(sep) for ln in lines]
        return self.parse_rows(rows)

    @staticmethod
    def _scalar(v) -> float:
        if v is None:
            return float("nan")
        if isinstance(v, str):
            if v.strip().lower() in _MISSING_TOKENS:
                return float("nan")
            return float(v)
        return float(v)

    # -- binning --------------------------------------------------------
    def bin_rows(self, x: np.ndarray) -> np.ndarray:
        """Raw matrix -> int32 bin codes (columns without a mapper code
        to 0 — they carry no signal the model can read)."""
        x = np.asarray(x, dtype=np.float64)
        codes = np.zeros(x.shape, dtype=np.int32)
        for f, mapper in self.mappers.items():
            codes[:, f] = mapper.values_to_bins(x[:, f])
        return codes

    def representative(self, codes: np.ndarray) -> np.ndarray:
        """Bin codes -> the representative raw value of each bin (the
        bin upper bound for numerical features, the category value for
        categorical) — the values `bin_to_value` would return, so every
        tree threshold comparison matches the raw value's."""
        out = np.zeros(codes.shape, dtype=np.float32)
        for f, mapper in self.mappers.items():
            if mapper.bin_type == BIN_NUMERICAL:
                table = np.asarray(mapper.bin_upper_bound,
                                   dtype=np.float64)
            else:
                table = np.asarray(
                    [float(c) for c in mapper.bin_2_categorical]
                    + [-1.0], dtype=np.float64)
            out[:, f] = table[np.clip(codes[:, f], 0, len(table) - 1)]
        return out

    def prebin_rows(self, x: np.ndarray) -> np.ndarray:
        """Raw matrix -> bin-representative matrix: what a pre-binning
        client would send. Unmapped columns pass through unchanged."""
        x = np.asarray(x, dtype=np.float32)
        pre = self.representative(self.bin_rows(x))
        for f in range(self.num_features):
            if f not in self.mappers:
                pre[:, f] = x[:, f]
        return pre

    def describe(self) -> dict:
        return {"num_features": self.num_features,
                "mapped_features": sorted(self.mappers)}
