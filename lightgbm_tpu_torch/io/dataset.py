"""Dataset: binned feature matrix + metadata, host and device views.

Port of lightgbm_tpu/io/dataset.py (reference: include/LightGBM/dataset.h,
src/io/dataset_loader.cpp). Binning and EFB planning are the JAX package's
host numpy code, copied; the device views (codes, feature metadata,
bundle maps) are host arrays that the learner copies to its device.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log
from ..utils.log import LightGBMError
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper,
                      load_forced_bounds, mapper_from_sample_column,
                      resolve_ignore_set)


def resolve_categorical_set(spec, feature_names) -> set:
    """categorical_feature spec (indices / names / 'name:x') -> column
    index set — the one copy shared by the in-memory, sparse and
    two-round loaders."""
    cats = set()
    for c in (spec or []):
        if isinstance(c, str):
            if c.startswith("name:"):
                c = c[5:]
            if c in feature_names:
                cats.add(feature_names.index(c))
        else:
            cats.add(int(c))
    return cats


def query_slots(query_boundaries, width: Optional[int] = None):
    """(Q, L) per-query layout of the rows: (idx, mask, counts), where
    idx[q, i] is row start_q + i while mask[q, i] (i below the query's
    count) and 0 past its end. L is `width`, by default the longest
    query's count (at least 1)."""
    qb = np.asarray(query_boundaries, dtype=np.int64)
    counts = np.diff(qb)
    if width is None:
        width = max(int(counts.max(initial=0)), 1)
    pos = np.arange(width)
    mask = pos[None, :] < counts[:, None]
    idx = np.where(mask, qb[:-1, None] + pos[None, :], 0)
    return idx, mask, counts


class Metadata:
    """Labels, weights, query boundaries, init scores
    (reference: dataset.h:41-250, src/io/metadata.cpp)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float64).reshape(-1)
        log.check(len(label) == self.num_data, "label length mismatch")
        self.label = label

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float64).reshape(-1)
        log.check(len(weight) == self.num_data, "weight length mismatch")
        self.weight = weight

    def set_group(self, group) -> None:
        """group = per-query row counts -> cumulative boundaries."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        log.check(int(group.sum()) == self.num_data,
                  "sum of group counts != num_data")
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(group)]).astype(np.int32)

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64)

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None \
            else len(self.query_boundaries) - 1


class Dataset:
    """Binned training data.

    Core construction flow mirrors DatasetLoader::LoadFromFile/
    ConstructFromSampleData (reference: dataset_loader.cpp:168-722): sample
    rows -> per-feature BinMapper::FindBin -> bin every value.
    """

    def __init__(self, data: np.ndarray, config: Optional[Config] = None,
                 label=None, weight=None, group=None, init_score=None,
                 feature_names: Optional[List[str]] = None,
                 categorical_feature: Optional[Sequence] = None,
                 reference: Optional["Dataset"] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.config = config or Config(params or {})
        data, sparse = self._prep_data(data)
        self.num_data, self.num_total_features = (
            sparse.shape if sparse is not None else data.shape)
        self.metadata = Metadata(self.num_data)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(self.num_total_features)])
        self.reference = reference
        if reference is not None:
            # a validation set: the reference's mappers bin it, so that its
            # codes mean what the training codes mean
            self.bin_mappers = reference.bin_mappers
            self.used_features = reference.used_features
            self.max_num_bins = reference.max_num_bins
            self.feature_names = reference.feature_names
        else:
            cat_idx = self._resolve_categorical(categorical_feature)
            self.bin_mappers = (
                self._build_mappers_sparse(sparse, cat_idx)
                if sparse is not None
                else self._build_mappers(data, cat_idx))
            self.used_features = [i for i, m in enumerate(self.bin_mappers)
                                  if not m.is_trivial]
            if not self.used_features:
                log.warning("All features are trivial (constant); nothing "
                            "to train on")
            self.max_num_bins = max(
                [self.bin_mappers[i].num_bin for i in self.used_features],
                default=1)

        self.binned = (self._bin_data_sparse(sparse) if sparse is not None
                       else self._bin_data(data))
        # EFB: plan storage columns and encode the bundled matrix
        # (reference: dataset.cpp:69-225 FindGroups/FastFeatureBundling).
        # self.binned stays the logical per-feature view for generic
        # consumers; the device learner trains on the narrower bundle view.
        self.columns = (reference.columns if reference is not None
                        else self._plan_bundles())
        self.bundled = self._encode_bundles() if self.columns else None
        # derived arrays, built on first use
        self._cache: Dict[str, Any] = {}

    @classmethod
    def from_binned(cls, binned: np.ndarray, bin_mappers, config,
                    label=None, weight=None, group=None, init_score=None,
                    feature_names=None, row_shard=None) -> "Dataset":
        """A Dataset from an already-binned code matrix and its mappers
        (the JAX package's from_binned): the two-round loader's entry
        (io/two_round.py bins chunks of the file straight into `binned`;
        the float matrix never exists). `binned` holds the non-trivial
        features' columns, in mapper order. A rank-partitioned block
        (`row_shard`) waits for the multi-GPU slice and raises."""
        if row_shard is not None:
            raise LightGBMError(
                "Dataset.from_binned(row_shard=...) is not supported by "
                "lightgbm_tpu_torch yet: row-sharded datasets come with "
                "the multi-GPU slice (ROADMAP.md item 5)")
        self = cls.__new__(cls)
        self.config = config
        self.num_data = int(binned.shape[0])
        self.num_total_features = len(bin_mappers)
        self.metadata = Metadata(self.num_data)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        self.feature_names = (list(feature_names) if feature_names else
                              [f"Column_{i}"
                               for i in range(self.num_total_features)])
        self.reference = None
        self.bin_mappers = list(bin_mappers)
        self.used_features = [i for i, m in enumerate(self.bin_mappers)
                              if not m.is_trivial]
        if not self.used_features:
            log.warning("All features are trivial (constant); "
                        "nothing to train on")
        self.max_num_bins = max(
            [self.bin_mappers[i].num_bin for i in self.used_features],
            default=1)
        if binned.shape[1] != max(len(self.used_features), 1):
            raise LightGBMError("binned width %d must match the %d "
                                "non-trivial features"
                                % (binned.shape[1], len(self.used_features)))
        self.binned = binned
        self.columns = self._plan_bundles()
        self.bundled = self._encode_bundles() if self.columns else None
        self._cache: Dict[str, Any] = {}
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def _prep_data(data):
        """Returns (dense, csc): exactly one is non-None. Sparse input is
        NEVER densified to a float matrix (the reference bins sparse
        input directly, src/io/sparse_bin.hpp:73 Push); it is canonical
        CSC for per-column nonzero iteration, and the only dense
        materialization downstream is the (N, F) uint8/16 code matrix —
        the designed post-bin storage."""
        try:
            import scipy.sparse as sp
            if sp.issparse(data):
                csc = data.tocsc().astype(np.float64)
                csc.sum_duplicates()
                csc.sort_indices()
                return None, csc
        except ImportError:
            pass
        if hasattr(data, "values"):  # pandas
            data = data.values
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        return arr, None

    def _resolve_categorical(self, categorical_feature) -> set:
        return resolve_categorical_set(
            categorical_feature or self.config.categorical_feature,
            self.feature_names)

    def _build_mappers(self, data: np.ndarray, cat_idx: set) -> List[BinMapper]:
        cfg = self.config
        n = self.num_data
        sample_cnt = min(n, cfg.bin_construct_sample_cnt)
        rng = np.random.RandomState(cfg.data_random_seed)
        if sample_cnt < n:
            sample_rows = np.sort(rng.choice(n, sample_cnt, replace=False))
        else:
            sample_rows = np.arange(n)
        forced_bounds = load_forced_bounds(cfg.forcedbins_filename)
        ignore = resolve_ignore_set(cfg.ignore_column, self.feature_names)
        mappers = []
        for f in range(self.num_total_features):
            if f in ignore:
                mappers.append(BinMapper.trivial())
                continue
            mappers.append(mapper_from_sample_column(
                data[sample_rows, f], len(sample_rows), cfg, f, cat_idx,
                forced_bounds))
        return mappers

    def _bin_data(self, data: np.ndarray) -> np.ndarray:
        n_used = len(self.used_features)
        dtype = np.uint8 if self.max_num_bins <= 256 else np.uint16
        out = np.zeros((self.num_data, max(n_used, 1)), dtype=dtype)
        for j, f in enumerate(self.used_features):
            out[:, j] = self.bin_mappers[f].values_to_bins(data[:, f]).astype(dtype)
        return out

    def _build_mappers_sparse(self, csc, cat_idx: set) -> List[BinMapper]:
        """Per-column find-bin straight off the CSC structure: only each
        column's sampled NONZERO values are handed to the mapper (zeros
        implied by the sample count — find_bin's sparse contract, the
        reference's DatasetLoader sampling + sparse_bin.hpp ingestion
        semantics). Peak extra memory is O(nnz of one column)."""
        cfg = self.config
        n = self.num_data
        sample_cnt = min(n, cfg.bin_construct_sample_cnt)
        rng = np.random.RandomState(cfg.data_random_seed)
        if sample_cnt < n:
            sample_rows = np.sort(rng.choice(n, sample_cnt, replace=False))
        else:
            sample_rows = None
        forced_bounds = load_forced_bounds(cfg.forcedbins_filename)
        ignore = resolve_ignore_set(cfg.ignore_column, self.feature_names)
        indptr, indices, values = csc.indptr, csc.indices, csc.data
        mappers = []
        for f in range(self.num_total_features):
            if f in ignore:
                mappers.append(BinMapper.trivial())
                continue
            lo, hi = int(indptr[f]), int(indptr[f + 1])
            vals = values[lo:hi]
            if sample_rows is not None:
                rows = indices[lo:hi]
                at = np.searchsorted(sample_rows, rows)
                at[at >= len(sample_rows)] = 0
                vals = vals[sample_rows[at] == rows]
                total = len(sample_rows)
            else:
                total = n
            mappers.append(mapper_from_sample_column(
                vals, total, cfg, f, cat_idx, forced_bounds))
        return mappers

    def _bin_data_sparse(self, csc) -> np.ndarray:
        """Fill the dense code matrix column-by-column from CSC: each
        column starts at its zero-value bin and only the nonzero entries
        are scattered — no dense float matrix ever exists."""
        n_used = len(self.used_features)
        dtype = np.uint8 if self.max_num_bins <= 256 else np.uint16
        out = np.zeros((self.num_data, max(n_used, 1)), dtype=dtype)
        indptr, indices, values = csc.indptr, csc.indices, csc.data
        for j, f in enumerate(self.used_features):
            m = self.bin_mappers[f]
            zero_bin = m.value_to_bin(0.0)
            if zero_bin:
                out[:, j] = dtype(zero_bin)
            lo, hi = int(indptr[f]), int(indptr[f + 1])
            if hi > lo:
                out[indices[lo:hi], j] = m.values_to_bins(
                    values[lo:hi]).astype(dtype)
        return out

    # ------------------------------------------------------------------
    def _plan_bundles(self):
        """EFB column plan from a sample of the binned matrix."""
        from .bundling import plan_columns
        cfg = self.config
        if (not cfg.enable_bundle or self.num_features <= 1
                or self.num_data == 0):
            return None
        sample = min(self.num_data, 50_000)
        rows = (np.linspace(0, self.num_data - 1, sample).astype(np.int64)
                if sample < self.num_data else np.arange(self.num_data))
        sample_bins = [self.binned[rows, j].astype(np.int32)
                       for j in range(self.num_features)]
        cols = plan_columns(self.used_features, self.bin_mappers, sample_bins,
                            cfg.max_conflict_rate, cfg.sparse_threshold)
        if all(len(c.features) == 1 for c in cols):
            return None
        return cols

    def _encode_bundles(self) -> np.ndarray:
        from .bundling import encode_bundle
        col_bins = max(c.num_bins for c in self.columns)
        dtype = np.uint8 if col_bins <= 256 else np.uint16
        out = np.zeros((self.num_data, len(self.columns)), dtype=dtype)
        for ci, col in enumerate(self.columns):
            if not col.is_bundle:
                out[:, ci] = self.binned[:, col.features[0]].astype(dtype)
                continue
            for j, base in zip(col.features, col.bases):
                m = self.bin_mappers[self.used_features[j]]
                encode_bundle(out[:, ci], self.binned[:, j].astype(np.int32),
                              base, m.default_bin)
        return out

    def bundle_arrays(self):
        """Maps of the bundled view (None when unbundled): (bundled codes
        (N, C), f_col, f_base, f_elide, hist_idx, col_bins) as host
        arrays; the learner makes the device copies it needs."""
        if self.bundled is None:
            return None
        if "bundle" not in self._cache:
            from .bundling import expansion_arrays
            self._cache["bundle"] = (self.bundled,) + tuple(
                expansion_arrays(self.columns, self.used_features,
                                 self.bin_mappers, self.num_features,
                                 self.max_num_bins))
        return self._cache["bundle"]

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    @property
    def label(self):
        return self.metadata.label

    def feature_meta_arrays(self):
        """(num_bins, missing_type, default_bin, is_categorical, monotone)
        int32 host arrays over *inner* (used) features."""
        if "meta" not in self._cache:
            nb = np.array([self.bin_mappers[f].num_bin for f in self.used_features],
                          dtype=np.int32)
            mt = np.array([self.bin_mappers[f].missing_type for f in self.used_features],
                          dtype=np.int32)
            db = np.array([self.bin_mappers[f].default_bin for f in self.used_features],
                          dtype=np.int32)
            cat = np.array([self.bin_mappers[f].bin_type == BIN_CATEGORICAL
                            for f in self.used_features], dtype=np.int32)
            mono_all = self.config.monotone_constraints or []
            mono = np.array([mono_all[f] if f < len(mono_all) else 0
                             for f in self.used_features], dtype=np.int32)
            self._cache["meta"] = (nb, mt, db, cat, mono)
        return self._cache["meta"]

    def inner_to_real(self, inner: int) -> int:
        return self.used_features[inner]

    def real_threshold(self, inner_feature: int, bin_thr: int) -> float:
        """Bin threshold -> stored real threshold (reference
        Dataset::RealThreshold -> BinMapper::BinToValue)."""
        return self.bin_mappers[self.used_features[inner_feature]].bin_to_value(bin_thr)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None) -> "Dataset":
        """Validation set binned with this dataset's mappers
        (reference: Dataset::CreateValid / CheckAlign)."""
        return Dataset(data, config=self.config, label=label, weight=weight,
                       group=group, init_score=init_score, reference=self)

    def subset(self, rows: np.ndarray) -> "Dataset":
        """The dataset of the given (sorted) rows: the same mappers and
        bundles, the rows' codes and metadata, a config of its own. Query
        groups become the per-query counts of the kept rows, empty
        queries dropped (group-aware cv folds keep whole queries)."""
        sub = copy.copy(self)
        sub.config = copy.deepcopy(self.config)
        sub.binned = self.binned[rows]
        if self.bundled is not None:
            sub.bundled = self.bundled[rows]
        sub.num_data = len(rows)
        md = Metadata(sub.num_data)
        src = self.metadata
        if src.label is not None:
            md.label = src.label[rows]
        if src.weight is not None:
            md.weight = src.weight[rows]
        if src.init_score is not None:
            isc = np.asarray(src.init_score)
            # a flat multiclass layout is class-major (K, N)
            md.init_score = (isc[rows] if isc.size == self.num_data else
                             isc.reshape(-1, self.num_data)[:, rows]
                             .reshape(-1))
        if src.query_boundaries is not None:
            qb = np.asarray(src.query_boundaries)
            qidx = np.searchsorted(qb, rows, side="right") - 1
            counts = np.bincount(qidx, minlength=len(qb) - 1)
            md.set_group(counts[counts > 0])
        sub.metadata = md
        sub.reference = self
        sub._cache = {}
        return sub

    def feature_infos(self) -> List[str]:
        return [m.feature_info() for m in self.bin_mappers]

    def save_binary(self, path: str) -> None:
        """The binned dataset as an npz (the JAX package's layout, so each
        package reads the other's file; np.savez_compressed adds ".npz"
        to a path without it): codes, mappers as JSON, used features,
        names and the metadata (empty arrays for the absent fields)."""
        import json
        md = self.metadata
        np.savez_compressed(
            path, binned=self.binned,
            mappers=json.dumps([m.to_dict() for m in self.bin_mappers]),
            used_features=np.asarray(self.used_features, dtype=np.int64),
            feature_names=np.asarray(self.feature_names, dtype=object),
            label=md.label if md.label is not None else np.zeros(0),
            weight=md.weight if md.weight is not None else np.zeros(0),
            query_boundaries=(md.query_boundaries
                              if md.query_boundaries is not None
                              else np.zeros(0, dtype=np.int32)),
            init_score=(md.init_score if md.init_score is not None
                        else np.zeros(0)))

    @classmethod
    def load_binary(cls, path: str,
                    params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """A dataset from save_binary's npz (or the JAX package's); the
        bundles are planned anew from `params`."""
        import json
        z = np.load(path, allow_pickle=True)
        obj = cls.__new__(cls)
        obj.config = Config(params or {})
        obj.binned = z["binned"]
        obj.num_data = obj.binned.shape[0]
        obj.bin_mappers = [BinMapper.from_dict(d)
                           for d in json.loads(str(z["mappers"]))]
        obj.num_total_features = len(obj.bin_mappers)
        obj.used_features = [int(i) for i in z["used_features"]]
        obj.feature_names = [str(s) for s in z["feature_names"]]
        obj.max_num_bins = max(
            [obj.bin_mappers[i].num_bin for i in obj.used_features],
            default=1)
        obj.metadata = Metadata(obj.num_data)
        if len(z["label"]):
            obj.metadata.label = z["label"]
        if len(z["weight"]):
            obj.metadata.weight = z["weight"]
        if len(z["query_boundaries"]):
            obj.metadata.query_boundaries = z["query_boundaries"]
        if len(z["init_score"]):
            obj.metadata.init_score = z["init_score"]
        obj.reference = None
        obj._cache = {}
        obj.columns = obj._plan_bundles()
        obj.bundled = obj._encode_bundles() if obj.columns else None
        return obj
