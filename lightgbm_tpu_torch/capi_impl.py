"""Python side of the port's C ABI (csrc/c_api.cpp).

Port of lightgbm_tpu/capi_impl.py: the handle tables and buffer
marshalling of the LGBM_* entry points over the port's Booster and
Dataset. The reference implements this layer in C++ (reference:
src/c_api.cpp Booster wrapper class + dataset constructors); here the
native shim runs inside a Python interpreter and calls these functions
with zero-copy memoryviews.

Device: a Booster trains and predicts on the card unless the call's
parameter string names the CPU (``device_type=cpu`` or ``device=cpu``, as
the CLI reads it); a call that carries no parameter string (a model file
or string load) takes ``LGBM_TPU_DEVICE_TYPE`` (``cpu`` or ``cuda``), else
the card. Without a card, a call that does not ask for the CPU fails.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np

from .basic import Booster, Dataset
from .cli import cli_device
from .config import parse_config_str
from .utils.envs import capi_device_env

_handles: Dict[int, object] = {}
_handle_counter = itertools.count(1)
_field_cache: Dict[tuple, np.ndarray] = {}

C_DTYPE = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}


def _new_handle(obj) -> int:
    h = next(_handle_counter)
    _handles[h] = obj
    return h


def _get(h: int):
    return _handles[int(h)]


def _device(params=None):
    """The device a call's parameter string names, else None (the
    card)."""
    return cli_device(dict(params or {}))


def _load_device():
    """The device of a model file or string load, which carries no
    parameter string: LGBM_TPU_DEVICE_TYPE, else None (the card)."""
    env = capi_device_env()
    return cli_device({"device_type": env}) if env else None


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

def dataset_create_from_file(filename: str, parameters: str, reference: int):
    params = parse_config_str(parameters or "")
    ref = _get(reference) if reference else None
    ds = Dataset(filename, reference=ref, params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_create_from_mat(mv, data_type, nrow, ncol, is_row_major,
                            parameters, reference):
    arr = np.frombuffer(mv, dtype=C_DTYPE[data_type])
    if is_row_major:
        mat = arr.reshape(nrow, ncol)
    else:
        mat = arr.reshape(ncol, nrow).T
    params = parse_config_str(parameters or "")
    ref = _get(reference) if reference else None
    ds = Dataset(np.asarray(mat, dtype=np.float64), reference=ref,
                 params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_create_from_csr(indptr_mv, indptr_type, indices_mv, data_mv,
                            data_type, nindptr, nelem, num_col, parameters,
                            reference):
    # the matrix stays sparse end-to-end: io/dataset.py bins straight
    # off the CSC structure (reference: src/io/sparse_bin.hpp:73)
    mat = _csr_view(indptr_mv, indptr_type, indices_mv, data_mv,
                    data_type, nindptr, nelem, num_col)
    params = parse_config_str(parameters or "")
    ref = _get(reference) if reference else None
    ds = Dataset(mat, reference=ref, params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_free(h):
    _handles.pop(int(h), None)
    for k in [k for k in _field_cache if k[0] == int(h)]:
        del _field_cache[k]


def dataset_get_num_data(h):
    return _get(h).num_data()


def dataset_get_num_feature(h):
    return _get(h).num_feature()


def dataset_set_field(h, field_name, mv, num_element, type_):
    arr = np.frombuffer(mv, dtype=C_DTYPE[type_])[:num_element].copy()
    ds = _get(h)
    if field_name == "group":
        ds.set_group(arr.astype(np.int64))
    else:
        ds.set_field(field_name, arr.astype(np.float64))
    return 0


def dataset_get_field(h, field_name):
    ds = _get(h)
    val = ds.get_field(field_name)
    if val is None:
        raise ValueError(f"field {field_name} not set")
    if field_name == "group":
        arr = np.ascontiguousarray(val, dtype=np.int32)
        type_ = 2
    else:
        arr = np.ascontiguousarray(val, dtype=np.float32)
        type_ = 0
    _field_cache[(int(h), field_name)] = arr  # keep buffer alive
    return (arr.ctypes.data, len(arr), type_)


# ---------------------------------------------------------------------------
# Booster
# ---------------------------------------------------------------------------

def _as_dataset(obj):
    """Materialize streaming datasets into real Dataset instances."""
    if isinstance(obj, _StreamingDataset):
        return obj._materialize()
    return obj


def booster_create(train_h, parameters):
    params = parse_config_str(parameters or "")
    train_set = _as_dataset(_get(train_h))
    device = _device(params)
    if device is None and any(k in train_set.params
                              for k in ("device_type", "device")):
        device = _device(train_set.params)
    bst = Booster(params=params, train_set=train_set, device=device)
    return _new_handle(bst)


def booster_create_from_modelfile(filename):
    bst = Booster(model_file=filename, device=_load_device())
    return (_new_handle(bst), bst.current_iteration())


def booster_load_from_string(model_str):
    bst = Booster(model_str=model_str, device=_load_device())
    return (_new_handle(bst), bst.current_iteration())


def booster_free(h):
    _handles.pop(int(h), None)


def booster_add_valid(h, valid_h):
    bst = _get(h)
    bst.add_valid(_get(valid_h), f"valid_{len(bst.name_valid_sets)}")


def booster_update_one_iter(h):
    return 1 if _get(h).update() else 0


def booster_num_total_rows(h):
    bst = _get(h)
    return bst._gbdt.num_data * bst._gbdt.num_tree_per_iteration


def booster_update_one_iter_custom(h, grad_mv, hess_mv):
    bst = _get(h)
    grad = np.frombuffer(grad_mv, dtype=np.float32)
    hess = np.frombuffer(hess_mv, dtype=np.float32)
    return 1 if bst._gbdt.train_one_iter(grad, hess) else 0


def booster_rollback_one_iter(h):
    _get(h).rollback_one_iter()


def booster_current_iteration(h):
    return _get(h).current_iteration()


def booster_num_classes(h):
    return _get(h)._gbdt.num_class


def booster_num_feature(h):
    return _get(h).num_feature()


def booster_eval_counts(h):
    bst = _get(h)
    return sum(len(m.names) for m in bst._gbdt.train_metrics)


def booster_eval_names(h):
    """Metric display names, order-aligned with booster_get_eval results
    (reference: LGBM_BoosterGetEvalNames, c_api.cpp)."""
    bst = _get(h)
    names = []
    for m in bst._gbdt.train_metrics:
        names.extend(m.names)
    return [str(n) for n in names]


def booster_eval_higher_better(h):
    """1/0 per eval slot: whether larger metric values are better."""
    bst = _get(h)
    out = []
    for m in bst._gbdt.train_metrics:
        out.extend([1 if m.higher_better else 0] * len(m.names))
    return out


def booster_get_eval(h, data_idx):
    """data_idx 0 = train, i>0 = valid i-1 (reference c_api semantics)."""
    bst = _get(h)
    if data_idx == 0:
        results = bst.eval_train()
    else:
        name = bst.name_valid_sets[data_idx - 1]
        results = [r for r in bst.eval_valid() if r[0] == name]
    return [float(r[2]) for r in results]


def booster_predict_for_mat(h, mv, data_type, nrow, ncol, is_row_major,
                            predict_type, num_iteration, parameter):
    bst = _get(h)
    arr = np.frombuffer(mv, dtype=C_DTYPE[data_type])
    mat = arr.reshape(nrow, ncol) if is_row_major else arr.reshape(ncol, nrow).T
    kwargs = {}
    if predict_type == 1:
        kwargs["raw_score"] = True
    elif predict_type == 2:
        kwargs["pred_leaf"] = True
    elif predict_type == 3:
        kwargs["pred_contrib"] = True
    preds = bst.predict(np.asarray(mat, dtype=np.float64),
                        num_iteration=num_iteration if num_iteration > 0 else None,
                        **kwargs)
    return np.ascontiguousarray(preds, dtype=np.float64).tobytes()


def booster_save_model(h, start_iteration, num_iteration, filename):
    _get(h)._gbdt.save_model(filename, num_iteration, start_iteration)


def booster_save_model_to_string(h, start_iteration, num_iteration):
    return _get(h)._gbdt.save_model_to_string(start_iteration, num_iteration)


def booster_feature_importance(h, num_iteration, importance_type):
    itype = "split" if importance_type == 0 else "gain"
    imp = _get(h)._gbdt.feature_importance(
        itype, num_iteration if num_iteration > 0 else None)
    return [float(v) for v in imp]


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------

def network_init(machines, local_listen_port, listen_time_out, num_machines):
    from .parallel import network
    network.init_from_params(machines, local_listen_port, num_machines)
    return 0


def network_free():
    from .parallel import network
    network.free()


# ---------------------------------------------------------------------------
# Extended dataset constructors (reference: src/c_api.cpp dataset section)
# ---------------------------------------------------------------------------

def _csc_view(col_ptr_mv, col_ptr_type, indices_mv, data_mv,
              data_type, ncol_ptr, nelem, num_row):
    """scipy CSC over the caller's buffers — no dense materialization."""
    import scipy.sparse as sp
    col_ptr = np.frombuffer(col_ptr_mv, dtype=C_DTYPE[col_ptr_type])[:ncol_ptr]
    indices = np.frombuffer(indices_mv, dtype=np.int32)[:nelem]
    data = np.frombuffer(data_mv, dtype=C_DTYPE[data_type])[:nelem]
    return sp.csc_matrix((data, indices, col_ptr),
                         shape=(num_row, ncol_ptr - 1), copy=True)


def dataset_create_from_csc(col_ptr_mv, col_ptr_type, indices_mv, data_mv,
                            data_type, ncol_ptr, nelem, num_row, parameters,
                            reference):
    """reference: LGBM_DatasetCreateFromCSC (c_api.h:191)."""
    mat = _csc_view(col_ptr_mv, col_ptr_type, indices_mv, data_mv,
                    data_type, ncol_ptr, nelem, num_row)
    params = parse_config_str(parameters or "")
    ref = _get(reference) if reference else None
    ds = Dataset(mat, reference=ref, params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_create_from_mats(mats, data_type, nrows, ncol, is_row_major,
                             parameters, reference):
    """reference: LGBM_DatasetCreateFromMats — vertically stacked chunks."""
    parts = []
    for mv, nrow in zip(mats, nrows):
        arr = np.frombuffer(mv, dtype=C_DTYPE[data_type])
        parts.append(arr.reshape(nrow, ncol) if is_row_major
                     else arr.reshape(ncol, nrow).T)
    params = parse_config_str(parameters or "")
    ref = _get(reference) if reference else None
    ds = Dataset(np.vstack(parts).astype(np.float64), reference=ref,
                 params=params)
    ds.construct()
    return _new_handle(ds)


class _StreamingDataset:
    """Pre-allocated dataset filled by PushRows (reference streaming path:
    LGBM_DatasetCreateFromSampledColumn / CreateByReference + PushRows,
    c_api.cpp). Constructs lazily on first real use; fields set before or
    between pushes are buffered and re-applied on every materialization
    (the reference allows SetField and PushRows in any order)."""

    def __init__(self, num_row: int, num_col: int, params: str,
                 reference=None):
        self.shape = (num_row, num_col)
        self.buf = None                       # dense buffer, lazy
        self._sparse_chunks = []              # [(start_row, csr)]
        self.params = parse_config_str(params or "")
        self.reference = reference
        self.filled = 0
        self._ds = None
        self._pending_fields: Dict[str, np.ndarray] = {}
        self._pending_names = None

    def _dense_buf(self) -> np.ndarray:
        if self.buf is None:
            self.buf = np.zeros(self.shape, dtype=np.float64)
            for start, chunk in self._sparse_chunks:
                co = chunk.tocoo()
                self.buf[co.row + start, co.col] = co.data
            self._sparse_chunks = []
        return self.buf

    def push_rows(self, arr: np.ndarray, start_row: int) -> None:
        self._dense_buf()[start_row:start_row + arr.shape[0], :] = arr
        self.filled = max(self.filled, start_row + arr.shape[0])
        self._ds = None

    def push_rows_sparse(self, csr, start_row: int) -> None:
        """CSR push that never densifies: chunks accumulate and assemble
        into ONE sparse matrix at materialization (unless a dense
        push_rows already forced the dense buffer, then they scatter into
        it). The reference's PushRowsByCSR feeds sparse bins the same
        way (c_api.cpp PushRowsByCSR -> sparse_bin.hpp Push)."""
        if self.buf is not None:
            co = csr.tocoo()
            self.buf[co.row + start_row, co.col] = co.data
        else:
            self._sparse_chunks.append((start_row, csr))
        self.filled = max(self.filled, start_row + csr.shape[0])
        self._ds = None

    def _assembled(self):
        """The pushed data in its cheapest faithful form."""
        if self.buf is not None:
            return self.buf
        if self._sparse_chunks:
            import scipy.sparse as sp
            rows, cols, vals = [], [], []
            for start, c in self._sparse_chunks:
                co = c.tocoo()
                rows.append(co.row.astype(np.int64) + start)
                cols.append(co.col)
                vals.append(co.data)
            return sp.csr_matrix(
                (np.concatenate(vals),
                 (np.concatenate(rows), np.concatenate(cols))),
                shape=self.shape)
        return self._dense_buf()

    def set_field(self, name, data):
        self._pending_fields[name] = np.asarray(data)
        if self._ds is not None:
            self._ds.set_field(name, data)
        return self

    def set_group(self, data):
        self._pending_fields["group"] = np.asarray(data)
        if self._ds is not None:
            self._ds.set_group(data)
        return self

    def _update_params(self, params):
        self.params.update(params or {})
        self._ds = None
        return self

    def set_feature_name(self, names):
        self._pending_names = list(names)
        if self._ds is not None:
            self._ds.set_feature_name(self._pending_names)
            # already constructed: the wrapper attr alone won't reach the
            # binned dataset, rename it in place like the C API does
            inner = getattr(self._ds, "_inner", None)
            if inner is not None:
                inner.feature_names = list(names)
        return self

    def _materialize(self) -> Dataset:
        if self._ds is None:
            ds = Dataset(self._assembled(), reference=self.reference,
                         params=self.params)
            if getattr(self, "_pending_names", None):
                ds.set_feature_name(self._pending_names)
            for name, data in self._pending_fields.items():
                if name == "group":
                    ds.set_group(data)
                else:
                    ds.set_field(name, data)
            ds.construct()
            if getattr(self, "_pending_names", None):
                ds._inner.feature_names = list(self._pending_names)
            self._ds = ds
        return self._ds

    # duck-typed Dataset surface used by the other entry points
    def construct(self):
        return self._materialize().construct()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._materialize(), name)


def dataset_create_from_sampled_column(num_row, num_col, parameters):
    return _new_handle(_StreamingDataset(num_row, num_col, parameters))


def dataset_create_by_reference(ref_h, num_row):
    ref = _get(ref_h)
    return _new_handle(_StreamingDataset(
        num_row, ref.num_feature(), "", reference=ref))


def dataset_push_rows(h, mv, data_type, nrow, ncol, start_row):
    ds = _get(h)
    arr = np.frombuffer(mv, dtype=C_DTYPE[data_type]).reshape(nrow, ncol)
    if not isinstance(ds, _StreamingDataset):
        raise ValueError("PushRows requires a dataset created by "
                         "CreateFromSampledColumn/CreateByReference")
    ds.push_rows(np.asarray(arr, dtype=np.float64), start_row)
    return 0


def dataset_push_rows_by_csr(h, indptr_mv, indptr_type, indices_mv, data_mv,
                             data_type, nindptr, nelem, num_col, start_row):
    ds = _get(h)
    mat = _csr_view(indptr_mv, indptr_type, indices_mv, data_mv,
                    data_type, nindptr, nelem, num_col)
    if not isinstance(ds, _StreamingDataset):
        raise ValueError("PushRowsByCSR requires a streaming dataset")
    ds.push_rows_sparse(mat, start_row)
    return 0


def dataset_get_subset(h, indices_mv, num_indices, parameters):
    ds = _as_dataset(_get(h))
    idx = np.frombuffer(indices_mv, dtype=np.int32)[:num_indices]
    sub = ds.subset(idx.astype(np.int64),
                    parse_config_str(parameters or "") or None)
    sub.construct()
    return _new_handle(sub)


def dataset_save_binary(h, filename):
    _get(h).save_binary(filename)
    return 0


def dataset_dump_text(h, filename):
    ds = _as_dataset(_get(h))
    ds.construct()
    inner = ds._inner
    with open(filename, "w") as fh:
        fh.write("num_data: %d\n" % inner.num_data)
        fh.write("num_feature: %d\n" % inner.num_features)
        for fi, m in enumerate(inner.bin_mappers):
            fh.write("feature %d: num_bin=%d missing=%d\n"
                     % (fi, m.num_bin, m.missing_type))
        binned = np.asarray(inner.binned)
        for i in range(min(inner.num_data, 1000)):
            fh.write(" ".join(str(int(v)) for v in binned[i]) + "\n")
    return 0


def dataset_set_feature_names(h, names):
    ds = _get(h)
    names = list(names)
    ds.set_feature_name(names)
    # C-API datasets are already constructed; rename in place
    inner = getattr(ds, "_inner", None)
    if inner is not None:
        inner.feature_names = list(names)
    return 0


def dataset_get_feature_names(h):
    return [str(n) for n in _get(h).get_feature_name()]


def dataset_update_param(h, parameters):
    # note: a constructed (non-streaming) dataset is already binned; like
    # the reference, updates then only affect params consumed later
    _get(h)._update_params(parse_config_str(parameters or ""))
    return 0


def dataset_add_features_from(h, other_h):
    ds, other = _as_dataset(_get(h)), _as_dataset(_get(other_h))
    ds.construct()
    other.construct()
    ds.add_features_from(other)
    return 0


# ---------------------------------------------------------------------------
# Extended booster entry points
# ---------------------------------------------------------------------------

def booster_merge(h, other_h):
    """reference: LGBM_BoosterMerge (c_api.h:437) — PREPEND the other
    booster's models (GBDT::MergeFrom, reference gbdt.h:60: other first,
    then own). When the target is a freshly-created training booster with
    no trees yet (the R bindings' init_model flow: BoosterCreate +
    BoosterMerge, reference R lgb.Booster.R:65), the merged trees are
    also replayed into the score updaters so continued training sees the
    previous model — the role the reference fills by seeding the train
    set's init_score from a Predictor."""
    import copy as _copy
    bst, other = _get(h), _get(other_h)
    g = bst._gbdt
    merged = [_copy.deepcopy(t) for t in other._gbdt.models]
    continuation = (not g.models
                    and getattr(g, "score_updater", None) is not None)
    g.models = merged + g.models
    g.num_init_iteration = len(merged) // max(g.num_tree_per_iteration, 1)
    if continuation:
        for k in range(g.num_tree_per_iteration):
            for it in range(g.num_init_iteration):
                tree = merged[it * g.num_tree_per_iteration + k]
                g.score_updater.add_tree(tree, k)
                for vu in g.valid_updaters:
                    vu.add_tree(tree, k)
    return 0


def booster_reset_parameter(h, parameters):
    _get(h).reset_parameter(parse_config_str(parameters or ""))
    return 0


def booster_reset_training_data(h, train_h):
    """reference: LGBM_BoosterResetTrainingData — swap the train set,
    keeping the model."""
    bst = _get(h)
    new_set = _as_dataset(_get(train_h))
    new_set.construct()
    old = bst._gbdt
    # trees store bin-space thresholds: the new data must be binned with
    # the same mappers (reference fatals on misaligned bin mappers)
    old_m = old.train_set.bin_mappers
    new_m = new_set._inner.bin_mappers
    def _mappers_equal(a, b):
        if a.num_bin != b.num_bin or a.bin_type != b.bin_type:
            return False
        ua, ub = np.asarray(a.bin_upper_bound, np.float64), \
            np.asarray(b.bin_upper_bound, np.float64)
        if ua.shape != ub.shape or not np.array_equal(ua, ub,
                                                      equal_nan=True):
            return False
        return getattr(a, "categorical_2_bin", None) == \
            getattr(b, "categorical_2_bin", None)

    same = (new_m is old_m) or (
        len(new_m) == len(old_m)
        and all(_mappers_equal(a, b) for a, b in zip(new_m, old_m)))
    if not same:
        raise ValueError(
            "ResetTrainingData requires a dataset binned against the "
            "booster's training data (create it with reference=)")
    import copy as _copy
    from .models.gbdt import create_boosting
    cfg = _copy.deepcopy(new_set._inner.config)
    cfg.update(bst.params)
    g = create_boosting(cfg, new_set._inner, device=bst.device)
    g.models = old.models
    g.iter = old.iter
    # registered validation sets survive the train-set swap (reference
    # ResetTrainingData keeps valid data)
    g.valid_sets = old.valid_sets
    g.valid_names = old.valid_names
    g.valid_updaters = old.valid_updaters
    g.valid_metrics = old.valid_metrics
    # rebuild training scores from the carried model over the new binned
    # data (the reference re-scores via the score updater the same way)
    k = max(g.num_tree_per_iteration, 1)
    for i, tree in enumerate(g.models):
        g.score_updater.add_tree(tree, i % k)
    bst._gbdt = g
    bst.train_set = new_set
    return 0


def booster_shuffle_models(h, start_iter, end_iter):
    _get(h).shuffle_models(start_iter, end_iter)
    return 0


def booster_refit(h, leaf_preds_mv, nrow, ncol):
    """reference: LGBM_BoosterRefit — refit leaf values with the given
    leaf predictions over the CURRENT training data."""
    bst = _get(h)
    leaf = np.frombuffer(leaf_preds_mv, dtype=np.int32).reshape(nrow, ncol)
    decay = float(bst.params.get("refit_decay_rate", 0.9))
    bst._gbdt.refit_leaves(leaf, decay)
    return 0


def booster_get_leaf_value(h, tree_idx, leaf_idx):
    return float(_get(h)._gbdt.models[tree_idx].leaf_value[leaf_idx])


def booster_set_leaf_value(h, tree_idx, leaf_idx, val):
    gbdt = _get(h)._gbdt
    gbdt.models[tree_idx].set_leaf_output(leaf_idx, float(val))
    gbdt.invalidate_ensemble_cache()   # in-place edit: drop tensorized cache
    return 0


def booster_number_of_total_model(h):
    return _get(h).num_trees()


def booster_num_model_per_iteration(h):
    return _get(h).num_model_per_iteration()


def booster_get_num_predict(h, data_idx):
    bst = _get(h)
    g = bst._gbdt
    n = (g.num_data if data_idx == 0
         else g.valid_sets[data_idx - 1].num_data)
    return n * g.num_class


def booster_get_predict(h, data_idx):
    """Raw converted predictions for train (0) / valid i (i>0) — the
    reference's GetPredict over the internal score (c_api.cpp)."""
    bst = _get(h)
    g = bst._gbdt
    updater = (g.score_updater if data_idx == 0
               else g.valid_updaters[data_idx - 1])
    scores = updater.host_scores()           # (K, N)
    if g.objective is not None:
        import torch
        conv = g.objective.convert_output(
            torch.as_tensor(scores.T)).numpy()
    else:
        conv = scores.T
    return np.ascontiguousarray(conv, dtype=np.float64).tobytes()


def booster_dump_model(h, start_iteration, num_iteration):
    import json
    d = _get(h).dump_model(
        num_iteration if num_iteration > 0 else None, start_iteration)
    return json.dumps(d)


def booster_get_feature_names(h):
    return [str(n) for n in _get(h).feature_name()]


def booster_calc_num_predict(h, num_row, predict_type, num_iteration):
    bst = _get(h)
    g = bst._gbdt
    iters = g.current_iteration
    if num_iteration > 0:
        iters = min(iters, num_iteration)
    if predict_type == 2:        # leaf index
        return num_row * g.num_tree_per_iteration * iters
    if predict_type == 3:        # contrib
        return num_row * g.num_class * (g.max_feature_idx + 2)
    return num_row * g.num_class


def booster_predict_for_file(h, data_filename, data_has_header,
                             predict_type, num_iteration, parameter,
                             result_filename):
    bst = _get(h)
    kwargs = {}
    if predict_type == 1:
        kwargs["raw_score"] = True
    elif predict_type == 2:
        kwargs["pred_leaf"] = True
    elif predict_type == 3:
        kwargs["pred_contrib"] = True
    # honor parser overrides from the parameter string (reference passes
    # them into the Predictor's parser config)
    pconf = parse_config_str(parameter or "")
    label_col = pconf.get("label_column", 0)
    if isinstance(label_col, str):
        if label_col.startswith("name:"):
            # name: form resolves against the file header (reference
            # config.h label_column doc: names require has_header)
            name = label_col[5:]
            # same first-line rule as parse_file: skip comments/blanks
            from .io.file_io import open_file
            with open_file(data_filename) as fh:
                first = fh.readline()
                while first and (first.startswith("#")
                                 or not first.strip()):
                    first = fh.readline()
            if not first:
                raise ValueError(f"data file is empty: {data_filename}")
            first = first.strip()
            delim = "," if "," in first else "\t" if "\t" in first else None
            cols = [c.strip() for c in first.split(delim)]
            if name not in cols:
                raise ValueError(
                    f"label_column name '{name}' not in file header")
            label_col = cols.index(name)
            data_has_header = 1
        else:
            label_col = int(label_col.split(":")[-1])
    from .io.parser import parse_file
    x, _, _ = parse_file(data_filename, label_column=int(label_col),
                         has_header=bool(data_has_header) or None)
    preds = bst.predict(
        x, num_iteration=num_iteration if num_iteration > 0 else None,
        **kwargs)
    preds = np.asarray(preds, dtype=np.float64)
    rows = preds[:, None] if preds.ndim == 1 else preds
    from .io.file_io import open_file
    with open_file(result_filename, "w") as fh:
        for row in rows:
            fh.write("\t".join(repr(float(v)) for v in row) + "\n")
    return 0


def _csr_view(indptr_mv, indptr_type, indices_mv, data_mv, data_type,
              nindptr, nelem, num_col):
    """scipy CSR over the caller's buffers — no dense materialization."""
    import scipy.sparse as sp
    indptr = np.frombuffer(indptr_mv, dtype=C_DTYPE[indptr_type])[:nindptr]
    indices = np.frombuffer(indices_mv, dtype=np.int32)[:nelem]
    data = np.frombuffer(data_mv, dtype=C_DTYPE[data_type])[:nelem]
    return sp.csr_matrix((data, indices, indptr),
                         shape=(nindptr - 1, num_col), copy=True)


def booster_predict_for_csr(h, indptr_mv, indptr_type, indices_mv, data_mv,
                            data_type, nindptr, nelem, num_col,
                            predict_type, num_iteration, parameter):
    # basic.Booster.predict row-batches sparse input; memory stays
    # bounded by the batch, not the matrix
    mat = _csr_view(indptr_mv, indptr_type, indices_mv, data_mv,
                    data_type, nindptr, nelem, num_col)
    return _predict_dense(_get(h), mat, predict_type, num_iteration)


def booster_predict_for_csc(h, col_ptr_mv, col_ptr_type, indices_mv, data_mv,
                            data_type, ncol_ptr, nelem, num_row,
                            predict_type, num_iteration, parameter):
    mat = _csc_view(col_ptr_mv, col_ptr_type, indices_mv, data_mv,
                    data_type, ncol_ptr, nelem, num_row).tocsr()
    return _predict_dense(_get(h), mat, predict_type, num_iteration)


def _predict_dense(bst, mat, predict_type, num_iteration):
    kwargs = {}
    if predict_type == 1:
        kwargs["raw_score"] = True
    elif predict_type == 2:
        kwargs["pred_leaf"] = True
    elif predict_type == 3:
        kwargs["pred_contrib"] = True
    preds = bst.predict(mat, num_iteration=num_iteration
                        if num_iteration > 0 else None, **kwargs)
    return np.ascontiguousarray(preds, dtype=np.float64).tobytes()


def booster_predict_for_mat_single_row(h, mv, data_type, ncol, is_row_major,
                                       predict_type, num_iteration,
                                       parameter):
    arr = np.frombuffer(mv, dtype=C_DTYPE[data_type])[:ncol]
    return _predict_dense(_get(h), arr.reshape(1, ncol), predict_type,
                          num_iteration)


def booster_predict_for_csr_single_row(h, indptr_mv, indptr_type, indices_mv,
                                       data_mv, data_type, nindptr, nelem,
                                       num_col, predict_type, num_iteration,
                                       parameter):
    mat = _csr_view(indptr_mv, indptr_type, indices_mv, data_mv,
                    data_type, nindptr, nelem, num_col)
    return _predict_dense(_get(h), mat, predict_type, num_iteration)


def network_init_with_functions(num_machines, rank):
    """reference: LGBM_NetworkInitWithFunctions (c_api.h:1018). The
    reference lets hosts inject reduce-scatter/allgather callbacks; here
    collectives run on torch.distributed, so the injected functions are
    recorded for the host-side coordination paths only."""
    from .parallel import network
    network.init_external(int(num_machines), int(rank))
    return 0
