"""User-facing Dataset and Booster of the port.

Port of lightgbm_tpu/basic.py for the slices this package covers: GBDT,
GOSS, DART and random forest (``boosting=rf``: a bag is mandatory, and
predict averages the trees) with every objective of the JAX package (the
pointwise ones, multiclass and multiclassova with ``num_class`` trees per
iteration: ``predict`` gives (N, K); lambdarank over query groups,
``group=`` or ``set_group``), the serial learner or the data-parallel one
across processes (``tree_learner=data``: float gradients, no row
sampling; ``set_network`` joins the process group), float or quantized
gradients (``quantized_grad``, ``grad_bits``, ``quant_renew``), the
compact and masked growth strategies, row sampling (``bagging_fraction``
with ``bagging_freq``, ``pos_bagging_fraction`` / ``neg_bagging_fraction``,
``boosting=goss``), feature sampling per tree and per node
(``feature_fraction``, ``feature_fraction_bynode``), a capped histogram
pool (``histogram_pool_size``), forced splits (``forcedsplits_filename``)
and the CEGB penalties (the last two on the host-loop learner),
categorical features (``categorical_feature``: indices, names or the
``name:`` form); validation sets binned by reference, their
evaluation with the pointwise and ranking metrics (ndcg, map), rollback,
parameter resets and custom objectives (``objective=none``,
``update(fobj=...)``). Every parameter outside that slice raises
LightGBMError naming its key. Both classes run on the card unless the
caller passes ``device="cpu"``.

Data comes as an array, a scipy sparse matrix, a pandas frame (category
columns become their codes; the category lists ride in the model text's
``pandas_categorical`` trailer) or a text file (CSV / TSV / space /
LibSVM, with ``.weight`` and ``.query`` side files). The Booster predicts
leaf indices, TreeSHAP contributions and early-stopped scores, refits
its leaves on new rows, pickles and copies through its model text, and
dumps, saves and loads it (io/file_io.py, any registered scheme).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .io.dataset import Dataset as _InnerDataset
from .io.dataset import Metadata
from .io.parser import parse_file
from .metrics import METRIC_NAMES
from .models.gbdt import GBDT, create_boosting
from .objectives import OBJECTIVE_NAMES
from .utils import log
from .utils.device import resolve_device
from .utils.log import LightGBMError

# row batch of a sparse (CSR) prediction: the dense form of one batch is
# the most a predict holds at once (tests shrink it)
_SPARSE_PREDICT_BATCH = 65536


def _data_from_pandas(df, categorical_feature, pandas_categorical):
    """A frame as an f64 matrix, its category columns as their codes
    (reference: basic.py:312 _data_from_pandas; the JAX package's
    basic.py:37-70). A training frame captures the category lists; a
    validation or predict frame's columns are set to the stored lists
    first, so that codes agree with training.

    Returns (matrix, feature_names, categorical_feature, pandas_categorical).
    """
    cat_cols = [c for c in df.columns if str(df[c].dtype) == "category"]
    realign = pandas_categorical is not None
    if not realign:                       # a training frame
        pandas_categorical = [list(df[c].cat.categories) for c in cat_cols]
    elif len(cat_cols) != len(pandas_categorical):
        # also a frame whose categorical column lost its dtype (its raw
        # values would be read as codes)
        raise ValueError(
            "train and valid dataset categorical_feature do not match")
    if categorical_feature == "auto":
        # positions, not labels: a column labelled with an int must not be
        # read as a feature index
        categorical_feature = [int(df.columns.get_loc(c)) for c in cat_cols]
    feature_names = [str(c) for c in df.columns]
    if cat_cols:
        df = df.copy()
        if realign:
            for c, cats in zip(cat_cols, pandas_categorical):
                df[c] = df[c].cat.set_categories(cats)
        for c in cat_cols:
            codes = df[c].cat.codes.values.astype(np.float64)
            codes[codes == -1] = np.nan    # unseen or missing categories
            df[c] = codes
    x = df.astype(np.float64).values
    return x, feature_names, categorical_feature, pandas_categorical


_PANDAS_CAT_PREFIX = "\npandas_categorical:"


def _json_default_with_numpy(obj):
    """numpy scalars as JSON types: int categories must stay ints, or a
    predict frame's set_categories matches nothing (reference: basic.py
    json_default_with_numpy); anything else fails at save time."""
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(
        f"pandas category values of type {type(obj).__name__} cannot be "
        "recorded in the model file; use str/int/float categories")


def _dump_pandas_categorical(pandas_categorical) -> str:
    """The model text's trailer of category lists (reference:
    basic.py:366)."""
    import json
    return _PANDAS_CAT_PREFIX + json.dumps(
        pandas_categorical, default=_json_default_with_numpy) + "\n"


def _split_pandas_categorical(model_str: str):
    """(model text without the trailer, pandas_categorical or None)."""
    import json
    i = model_str.rfind(_PANDAS_CAT_PREFIX)
    if i < 0:
        return model_str, None
    line = model_str[i + len(_PANDAS_CAT_PREFIX):].strip()
    try:
        return model_str[:i] + "\n", json.loads(line)
    except ValueError:
        return model_str, None


def _not_yet(what: str, item: str) -> LightGBMError:
    return LightGBMError("%s is not supported by lightgbm_tpu_torch yet "
                         "(ROADMAP.md %s)" % (what, item))


def check_supported(cfg: Config) -> None:
    """Raise LightGBMError for the first parameter outside the slice."""
    bad = None
    multi = cfg.objective in ("multiclass", "multiclassova")
    if cfg.objective not in OBJECTIVE_NAMES + ["none"]:
        bad = "objective=%s" % cfg.objective
    elif multi and cfg.num_class < 2:
        # the reference: "Number of classes should be specified and
        # greater than 1 for multiclass training"
        raise LightGBMError("objective=%s needs num_class > 1, got %d"
                            % (cfg.objective, cfg.num_class))
    elif cfg.boosting not in ("gbdt", "gbrt", "plain", "goss", "dart",
                              "rf"):
        bad = "boosting=%s" % cfg.boosting
    elif cfg.num_class > 1 and not multi:
        bad = "num_class=%d with objective=%s" % (cfg.num_class,
                                                  cfg.objective)
    elif cfg.tree_learner in ("data", "data_parallel"):
        _check_data_parallel(cfg)
    elif cfg.tree_learner != "serial":
        raise _not_yet("tree_learner=%s" % cfg.tree_learner,
                       "section 1, item 5 (%s)" % (
                           "voting" if "voting" in cfg.tree_learner
                           else "feature-parallel"))
    if bad is None:
        unknown = [m for m in cfg.metric
                   if m not in METRIC_NAMES + ["none"]]
        if unknown:
            bad = "metric=%s" % unknown[0]
    if bad is not None:
        raise LightGBMError("%s is not supported by lightgbm_tpu_torch yet "
                            "(GBDT, GOSS, DART or RF with any objective, "
                            "tree_learner=serial or data, float or "
                            "quantized gradients, resident or streamed "
                            "rows)" % bad)


def _check_data_parallel(cfg: Config) -> None:
    """tree_learner=data trains with float gradients, without row
    sampling, on resident rows replicated on every process; the rest of
    ROADMAP.md section 1, item 5 raises naming its part."""
    learner = "tree_learner=%s" % cfg.tree_learner
    if cfg.quantized_grad:
        what, part = "quantized_grad with " + learner, \
            "quantized data-parallel"
    elif cfg.boosting in ("goss", "rf") or (
            cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0) \
            or cfg.pos_bagging_fraction < 1.0 \
            or cfg.neg_bagging_fraction < 1.0:
        what, part = "bagging or GOSS (boosting=%s) with %s" % (
            cfg.boosting, learner), "bagging and GOSS on data-parallel"
    elif cfg.stream_mode != "off":
        what, part = "stream_mode=%s with %s" % (cfg.stream_mode, learner), \
            "streamed data-parallel"
    elif getattr(cfg, "dist_shard_mode", "replicated") != "replicated":
        what, part = "dist_shard_mode=%s" % cfg.dist_shard_mode, \
            "rows mode"
    else:
        return
    raise _not_yet(what, "section 1, item 5 (%s)" % part)


class Dataset:
    """Lazily constructed training data (reference: basic.py:711). The
    binning runs on the host; its device views are made on the device of
    the Booster that trains on it (``device``, if given, is the default
    for that Booster). `data`: an array, a scipy sparse matrix, a pandas
    frame (category columns become their codes) or the path of a CSV /
    TSV / space / LibSVM file, whose label is its first column and whose
    ``<path>.weight`` and ``<path>.query`` side files give weights and
    query groups. A dataset with a `reference` (a validation set) is
    binned with the reference's mappers. `categorical_feature`: column
    indices or names (a name may carry the ``name:`` prefix); "auto"
    takes a frame's category columns, or the params'
    ``categorical_feature`` (indices)."""

    def __init__(self, data, label=None, reference=None, weight=None,
                 group=None, init_score=None, silent=False,
                 feature_name="auto", categorical_feature="auto",
                 params=None, free_raw_data=True, device=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) or {}
        self.free_raw_data = free_raw_data
        self.device = device
        self.pandas_categorical = None
        self._inner: Optional[_InnerDataset] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        check_supported(cfg)
        data, label, names = self.data, self.label, None
        if isinstance(data, str) and cfg.two_round \
                and self.reference is None:
            # out of core: two sequential passes over the file, no float
            # matrix (io/two_round.py; reference dataset_loader.cpp:168)
            from .io.two_round import load_two_round
            cats = self.categorical_feature
            inner, _ = load_two_round(
                data, cfg, categorical_feature=(
                    cats if isinstance(cats, (list, tuple)) else None))
            self._load_side_files(data)
            for field, value in (("label", self.label),
                                 ("weight", self.weight),
                                 ("group", self.group),
                                 ("init_score", self.init_score)):
                if value is not None:
                    getattr(inner.metadata, "set_" + field)(value)
            if isinstance(self.feature_name, (list, tuple)):
                inner.feature_names = list(self.feature_name)
            self._inner = inner
            return self
        if isinstance(data, str):
            data, y, qb = parse_file(data)
            if label is None and y is not None:
                label = y
            if self.group is None and qb is not None:
                self.group = np.diff(qb)
            self._load_side_files(self.data)
        cat_spec = self.categorical_feature
        if hasattr(data, "columns"):  # pandas: category dtypes -> codes
            ref_pc = None
            if self.reference is not None:
                # the reference's category lists align this frame's codes
                ref_pc = self.reference.construct().pandas_categorical
            data, names, cat_spec, self.pandas_categorical = \
                _data_from_pandas(data, cat_spec, ref_pc)
        if isinstance(self.feature_name, (list, tuple)):
            names = list(self.feature_name)
        cats = None
        if isinstance(cat_spec, (list, tuple)):
            # names -> column indices, as the JAX package resolves them
            cats = []
            for c in cat_spec:
                if isinstance(c, str):
                    c = c[5:] if c.startswith("name:") else c
                    if names is None or c not in names:
                        raise LightGBMError("categorical_feature %r not in "
                                            "features" % c)
                    cats.append(names.index(c))
                else:
                    cats.append(int(c))
        ref_inner = None
        if self.reference is not None:
            ref_inner = self.reference.construct()._inner
        self._inner = _InnerDataset(
            data, config=cfg, label=label, weight=self.weight,
            group=self.group, init_score=self.init_score,
            feature_names=names,
            categorical_feature=cats, reference=ref_inner)
        if self.free_raw_data and not isinstance(self.data, str):
            self.data = None
        return self

    def _load_side_files(self, path: str) -> None:
        """``<path>.weight`` / ``<path>.query`` of a file dataset
        (reference: Metadata::LoadWeights / LoadQueryBoundaries)."""
        from .io.file_io import exists, open_file
        if self.weight is None and exists(path + ".weight"):
            with open_file(path + ".weight") as f:
                self.weight = np.loadtxt(f, ndmin=1)
        if self.group is None and exists(path + ".query"):
            with open_file(path + ".query") as f:
                self.group = np.loadtxt(f, ndmin=1).astype(np.int64)

    def _update_params(self, params: Dict[str, Any]) -> None:
        if self._inner is None:
            self.params.update(params or {})

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent=False,
                     params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, device=self.device)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The dataset of some rows (sorted, as the reference sorts them):
        this dataset's binning and bundles, the rows' codes and metadata;
        its groups are the per-query counts of the kept rows."""
        self.construct()
        sub = Dataset.__new__(Dataset)
        sub.__dict__.update(self.__dict__)
        sub.params = params or self.params
        sub.data = None
        sub.reference = self
        sub._inner = self._inner.subset(np.sort(np.asarray(used_indices)))
        md = sub._inner.metadata
        sub.label, sub.weight, sub.init_score = (md.label, md.weight,
                                                 md.init_score)
        sub.group = (None if md.query_boundaries is None
                     else np.diff(md.query_boundaries))
        return sub

    def save_binary(self, filename: str) -> "Dataset":
        """The binned dataset as an npz (io/dataset.py save_binary; the
        JAX package reads it, and io.dataset.Dataset.load_binary reads
        the JAX package's)."""
        self.construct()._inner.save_binary(filename)
        return self

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append another dataset's columns at the binned level, without
        rebinning (reference: Dataset::addFeaturesFrom); the bundles are
        planned again over all the features."""
        self.construct()
        other.construct()
        if self.num_data() != other.num_data():
            raise ValueError("datasets must have the same number of rows")
        a, b = self._inner, other._inner
        offset = a.num_total_features
        # an all-trivial dataset holds one dummy zero column: drop dummies
        # so that the codes stay aligned with used_features
        a_cols = a.binned if a.used_features else a.binned[:, :0]
        b_cols = b.binned if b.used_features else b.binned[:, :0]
        a.bin_mappers = list(a.bin_mappers) + list(b.bin_mappers)
        a.used_features = list(a.used_features) + [
            offset + f for f in b.used_features]
        a.max_num_bins = max(a.max_num_bins, b.max_num_bins)
        dt = (np.uint16 if max(a_cols.dtype.itemsize,
                               b_cols.dtype.itemsize) == 2 else np.uint8)
        merged = np.hstack([a_cols.astype(dt), b_cols.astype(dt)])
        if merged.shape[1] == 0:
            merged = np.zeros((a.num_data, 1), dtype=dt)
        a.binned = merged
        a.num_total_features += b.num_total_features
        a.feature_names = list(a.feature_names) + list(b.feature_names)
        a._cache = {}
        a.columns = a._plan_bundles()
        a.bundled = a._encode_bundles() if a.columns else None
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Set the categorical columns; the dataset must not be
        constructed yet (LightGBM's rebinning is not ported)."""
        if categorical_feature == self.categorical_feature:
            return self
        if self._inner is not None:
            raise LightGBMError("Cannot set categorical feature after the "
                                "Dataset was constructed")
        self.categorical_feature = categorical_feature
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        """Name the columns (a list as long as the columns); a constructed
        dataset is renamed in place."""
        self.feature_name = feature_name
        if self._inner is not None and isinstance(feature_name,
                                                  (list, tuple)):
            if len(feature_name) != self._inner.num_total_features:
                raise ValueError("Length of feature_name(%d) and num_feature"
                                 "(%d) don't match"
                                 % (len(feature_name),
                                    self._inner.num_total_features))
            self._inner.feature_names = [str(n) for n in feature_name]
        return self

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """The ids of this dataset and of its chain of references
        (reference: basic.py:1295)."""
        head, chain = self, set()
        while len(chain) < ref_limit and isinstance(head, Dataset):
            chain.add(id(head))
            if head.reference is None or id(head.reference) in chain:
                break
            head = head.reference
        return chain

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this dataset with `reference`'s mappers (reference:
        basic.py:1319); it must not be constructed yet."""
        if not isinstance(reference, Dataset):
            raise TypeError("Reference should be Dataset instance")
        if reference is self.reference:
            return self
        if self._inner is not None:
            raise LightGBMError("Cannot set reference after the Dataset was "
                                "constructed")
        self.reference = reference
        return self

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(weight)
        return self

    def set_group(self, group) -> "Dataset":
        """Per-query row counts, in row order (learning to rank)."""
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(init_score)
        return self

    def set_field(self, field_name: str, data) -> "Dataset":
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group,
                  "init_score": self.set_init_score}.get(field_name)
        if setter is None:
            raise LightGBMError("Unknown field %s" % field_name)
        return setter(data)

    def get_field(self, field_name: str):
        md = self.construct()._inner.metadata
        if field_name == "group":
            return (None if md.query_boundaries is None
                    else np.diff(md.query_boundaries))
        if field_name not in ("label", "weight", "init_score"):
            raise LightGBMError("Unknown field %s" % field_name)
        return getattr(md, field_name)

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_group(self):
        return self.get_field("group")

    def get_init_score(self):
        return self.get_field("init_score")

    def get_data(self):
        """The raw data the dataset was built from (reference:
        basic.py:1512); None once free_raw_data dropped it."""
        if self._inner is None:
            raise LightGBMError("Cannot get data before construct Dataset")
        return self.data

    def get_feature_name(self) -> List[str]:
        return list(self.construct()._inner.feature_names)

    def get_feature_penalty(self):
        """Per-feature gain penalty (feature_contri), None when unset
        (reference: basic.py:1476)."""
        contri = self.construct()._inner.config.feature_contri
        return np.asarray(contri, dtype=np.float64) if contri else None

    def get_monotone_constraints(self):
        """Per-feature monotone constraints, None when unset (reference:
        basic.py:1488)."""
        mono = self.construct()._inner.config.monotone_constraints
        return np.asarray(mono, dtype=np.int8) if mono else None

    def num_data(self) -> int:
        return self.construct()._inner.num_data

    def num_feature(self) -> int:
        return self.construct()._inner.num_total_features


class Booster:
    """Training / prediction handle (reference: basic.py:1658)."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_file=None, model_str=None, silent=False,
                 device=None):
        self.params = copy.deepcopy(params) or {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_data_name = "training"
        self.name_valid_sets: List[str] = []
        self.valid_sets: List[Dataset] = []
        self._attr: Dict[str, str] = {}
        self.pandas_categorical = None
        self.train_set: Optional[Dataset] = None
        if device is None and train_set is not None:
            device = train_set.device
        self.device = resolve_device(device)
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            train_set._update_params(self.params)
            train_set.construct()
            self.pandas_categorical = train_set.pandas_categorical
            cfg = train_set._inner.config
            cfg.update(self.params)
            check_supported(cfg)
            self._gbdt = create_boosting(cfg, train_set._inner,
                                         device=self.device)
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                from .io.file_io import read_text
                model_str = read_text(model_file)
            self.model_from_string(model_str, verbose=False)
        else:
            raise TypeError("need at least one of train_set, model_file, "
                            "model_str")

    # pickling and copying go through the model text (reference: basic.py
    # Booster.__getstate__ / __deepcopy__): a copy predicts, and continues
    # as an init_model, without the training state; it keeps the device,
    # and unpickling where that device is absent raises
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_gbdt"] = None
        state["train_set"] = None
        state["valid_sets"] = []
        state["name_valid_sets"] = []
        state["_model_str"] = self.model_to_string(num_iteration=-1)
        return state

    def __setstate__(self, state):
        model_str = state.pop("_model_str")
        self.__dict__.update(state)
        try:
            self.device = resolve_device(state["device"])
        except LightGBMError as e:
            raise LightGBMError(
                "this Booster was pickled on %s, which this machine lacks "
                "(%s); rebuild it from its model text with "
                "Booster(model_str=..., device=\"cpu\")"
                % (state["device"], e)) from e
        self.model_from_string(model_str, verbose=False)

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, _):
        out = Booster(params=self.params,
                      model_str=self.model_to_string(num_iteration=-1),
                      device=self.device)
        out.best_iteration = self.best_iteration
        out.best_score = copy.deepcopy(self.best_score)
        out._attr = dict(self._attr)
        return out

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate `data` every iteration under `name`; it is binned with
        the training set's mappers unless it already has a reference."""
        if data.reference is None and data._inner is None:
            data.set_reference(self.train_set)
        data.construct()
        self._gbdt.add_valid(data._inner, name)
        self.name_valid_sets.append(name)
        self.valid_sets.append(data)
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when training stopped early. With
        `fobj`, its (grad, hess) at the current training scores drive the
        iteration (reference Booster.update)."""
        if self._gbdt.train_set is None:
            raise LightGBMError("this Booster has no training data (it was "
                                "loaded from model text, or free_dataset "
                                "dropped it)")
        if fobj is not None:
            grad, hess = fobj(self.__inner_predict_raw(), self.train_set)
            return self.__boost(grad, hess)
        return self._gbdt.train_one_iter()

    def __boost(self, grad, hess) -> bool:
        return self._gbdt.train_one_iter(np.asarray(grad, dtype=np.float32),
                                         np.asarray(hess, dtype=np.float32))

    def __inner_predict_raw(self) -> np.ndarray:
        scores = self._gbdt.score_updater.host_scores()
        return scores[0] if self._gbdt.num_class == 1 else scores.reshape(-1)

    def rollback_one_iter(self) -> "Booster":
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params) -> "Booster":
        """Change parameters between iterations (reference basic.py
        reset_parameter): learning_rate only sets the shrinkage; any other
        key also drops the fused steps and the learner's split scan and
        captured loops, which are remade from the new values at the next
        tree."""
        self._gbdt.config.update(params)
        self.params.update(params)
        self._gbdt.shrinkage_rate = self._gbdt.config.learning_rate
        if any(k != "learning_rate" for k in params):
            self._gbdt._fused_step = None
            self._gbdt.learner.reset_config()
        return self

    def save_checkpoint(self, directory: str, keep_last: int = 3,
                        history=None) -> str:
        """Write a full training checkpoint -- the trees PLUS the live
        training state (scores, bagging RNG, iteration counter, DART's
        weights, the stream state) -- into `directory` with
        keep-last-`keep_last` rotation; returns the path. Unlike
        save_model, a checkpoint resumes training bit for bit, in this
        package or the JAX one (the same file format)."""
        from .resilience.checkpoint import CheckpointManager
        return CheckpointManager(directory, keep_last).save(
            self, history=history)

    def restore_checkpoint(self, path: str) -> "Booster":
        """Restore the model and training state from a checkpoint file (or
        the newest valid one in a directory) into this booster, which must
        have been constructed with the same training and validation
        datasets and parameters as the checkpointed run."""
        from .resilience.checkpoint import restore_checkpoint
        restore_checkpoint(self, path)
        return self

    def set_network(self, machines, local_listen_port=12400,
                    listen_time_out=120, num_machines=1) -> "Booster":
        """Join the process group of `machines` ('host:port,...'; rank by
        this host's place in the list, the LGBM_TPU_* env trio wins):
        parallel/network.py over torch.distributed."""
        from .parallel import network
        network.init_from_params(machines, local_listen_port, num_machines)
        return self

    def free_network(self) -> "Booster":
        from .parallel import network
        network.free()
        return self

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def eval_train(self, feval=None):
        return self.__eval(self._train_data_name, feval)

    def eval_valid(self, feval=None):
        out = []
        for name in self.name_valid_sets:
            out.extend(self.__eval(name, feval))
        return out

    def eval(self, data=None, name=None, feval=None):
        return self.eval_train(feval) + self.eval_valid(feval)

    def __eval(self, dataset_name, feval=None):
        """(dataset, metric, value, higher_better) of one dataset: its
        configured metrics, then `feval`'s (its raw scores and Dataset)."""
        inner = ("training" if dataset_name == self._train_data_name
                 else dataset_name)
        results = [(dataset_name, mname, val, hb) for _, mname, val, hb
                   in self._gbdt.eval_metrics(only=inner)]
        if feval is not None:
            if dataset_name == self._train_data_name:
                ds, updater = self.train_set, self._gbdt.score_updater
            else:
                idx = self.name_valid_sets.index(dataset_name)
                ds = self.valid_sets[idx]
                updater = self._gbdt.valid_updaters[idx]
            preds = updater.host_scores()
            preds = preds[0] if self._gbdt.num_class == 1 \
                else preds.reshape(-1)
            ret = feval(preds, ds)
            for (n, v, hb) in (ret if isinstance(ret, list) else [ret]):
                results.append((dataset_name, n, v, hb))
        return results

    def predict(self, data, num_iteration=None, raw_score=False,
                pred_leaf=False, pred_contrib=False, data_has_header=False,
                is_reshape=True, start_iteration=0, pred_early_stop=False,
                pred_early_stop_freq=10, pred_early_stop_margin=10.0,
                **kwargs):
        """Predictions of the first `num_iteration` iterations (None: the
        best iteration of early stopping, if any, else all) from
        `start_iteration`: scores (raw_score: untransformed), leaf indices
        (pred_leaf), TreeSHAP contributions (pred_contrib, on the host)
        or early-stopped scores (pred_early_stop: every
        pred_early_stop_freq iterations, rows whose margin exceeds
        pred_early_stop_margin stop). `data`: an array, a scipy sparse
        matrix (predicted in row batches of _SPARSE_PREDICT_BATCH), a
        pandas frame (category columns aligned to the training lists) or
        a data file (data_has_header: its first line is a header)."""
        x = data
        if isinstance(data, str):
            x, _, _ = parse_file(
                data, has_header=True if data_has_header else None)
        if hasattr(x, "columns"):
            x, _, _, _ = _data_from_pandas(x, "auto",
                                           self.pandas_categorical)
        elif hasattr(x, "values"):
            x = x.values
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else None)

        def run(mat):
            return self._gbdt.predict(
                mat, num_iteration=num_iteration, raw_score=raw_score,
                pred_leaf=pred_leaf, pred_contrib=pred_contrib,
                start_iteration=start_iteration,
                pred_early_stop=pred_early_stop,
                pred_early_stop_freq=pred_early_stop_freq,
                pred_early_stop_margin=pred_early_stop_margin)
        try:
            import scipy.sparse as sp
            is_sparse = sp.issparse(x)
        except ImportError:
            is_sparse = False
        if is_sparse:
            # the dense form of one row batch at a time (the reference
            # walks sparse rows directly, c_api.cpp PredictForCSR)
            x = x.tocsr()
            batch = _SPARSE_PREDICT_BATCH
            parts = [run(np.asarray(x[i:i + batch].todense()))
                     for i in range(0, max(x.shape[0], 1), batch)]
            return np.concatenate(parts, axis=0)
        return run(np.asarray(x))

    def refit(self, data, label, decay_rate=0.9, **kwargs) -> "Booster":
        """Refit the leaf values on new rows in place (reference
        Booster.refit; task=refit): each leaf becomes decay_rate x its
        value + (1 - decay_rate) x the leaf output of the new rows'
        gradients at a zero score, the structure kept. The rows' leaves
        come from pred_leaf; the gradients need only the rows' labels."""
        self.params["refit_decay_rate"] = decay_rate
        leaf_preds = self.predict(data, pred_leaf=True)
        md = Metadata(leaf_preds.shape[0])
        md.set_label(label)
        self._gbdt.refit_leaves_on(md, leaf_preds, decay_rate)
        return self

    def model_to_string(self, num_iteration=None, start_iteration=0) -> str:
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        s = self._gbdt.save_model_to_string(start_iteration, num_iteration)
        if self.pandas_categorical:
            s += _dump_pandas_categorical(self.pandas_categorical)
        return s

    def save_model(self, filename, num_iteration=None,
                   start_iteration=0) -> "Booster":
        """The model text (with the pandas_categorical trailer) written
        through io/file_io.py in one write."""
        from .io.file_io import write_text
        write_text(filename, self.model_to_string(num_iteration,
                                                  start_iteration))
        return self

    def dump_model(self, num_iteration=None, start_iteration=0) -> dict:
        return self._gbdt.dump_model(num_iteration, start_iteration)

    def model_from_string(self, model_str: str, verbose=True) -> "Booster":
        """Replace this Booster's model with one read from model text
        (reference: basic.py:2241), on this Booster's device."""
        model_str, self.pandas_categorical = _split_pandas_categorical(
            model_str)
        self._gbdt = GBDT.load_model_from_string(
            model_str, Config(self.params), device=self.device)
        if verbose:
            log.info("Finished loading model, total used %d iterations",
                     self._gbdt.current_iteration)
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """The output of one leaf (reference: basic.py:2463)."""
        return float(self._gbdt.models[tree_id].leaf_value[leaf_id])

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style=False):
        """Histogram of the thresholds that split on `feature` (an index,
        or a name) (reference: basic.py:2565); a categorical feature is
        refused. xgboost_style: the (upper edge, count) rows of the
        non-empty bins, as a pandas frame where pandas is installed."""
        def add(root):
            if "split_index" in root:     # not a leaf
                if feature_names is not None and isinstance(feature, str):
                    split_feature = feature_names[root["split_feature"]]
                else:
                    split_feature = root["split_feature"]
                if split_feature == feature:
                    if isinstance(root["threshold"], str):
                        raise LightGBMError(
                            "Cannot compute split value histogram for the "
                            "categorical feature")
                    values.append(root["threshold"])
                add(root["left_child"])
                add(root["right_child"])

        model = self.dump_model()
        feature_names = model.get("feature_names")
        values: List[float] = []
        for tree_info in model["tree_info"]:
            add(tree_info["tree_structure"])

        if bins is None or isinstance(bins, int) and xgboost_style:
            n_unique = len(np.unique(values))
            bins = max(min(n_unique, bins) if bins is not None
                       else n_unique, 1)
        hist, bin_edges = np.histogram(values, bins=bins)
        if xgboost_style:
            ret = np.column_stack((bin_edges[1:], hist))
            ret = ret[ret[:, 1] > 0]
            try:
                from pandas import DataFrame
                return DataFrame(ret, columns=["SplitValue", "Count"])
            except ImportError:
                return ret
        return hist, bin_edges

    def attr(self, key: str) -> Optional[str]:
        """A Booster attribute string (reference: basic.py:2717)."""
        return self._attr.get(key, None)

    def set_attr(self, **kwargs) -> "Booster":
        """Set Booster attributes; None deletes (reference: basic.py:2733)."""
        for key, value in kwargs.items():
            if value is not None:
                if not isinstance(value, str):
                    raise ValueError("Only string values are accepted")
                self._attr[key] = value
            else:
                self._attr.pop(key, None)
        return self

    def feature_importance(self, importance_type="split",
                           iteration=None) -> np.ndarray:
        """Splits per feature (int64), or their total gain (f64)."""
        imp = self._gbdt.feature_importance(importance_type, iteration)
        return imp.astype(np.int64) if importance_type == "split" else imp

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def free_dataset(self) -> "Booster":
        """Drop the training and validation data (reference:
        basic.py:1799): the learner with its device copies of the rows,
        its carries and captured graphs, the fused steps and every score
        tensor, so the card's memory falls; predict still works, update
        raises."""
        self.train_set = None
        self.valid_sets = []
        self.name_valid_sets = []
        g = self._gbdt
        if g.train_set is not None:
            # the model text's feature_infos came from the training set
            g._feature_infos = g.train_set.feature_infos()
        g.train_set = None
        g.valid_names, g.valid_updaters, g.valid_metrics = [], [], []
        g.learner = None
        g.score_updater = None
        g._fused_step = None
        g._last_leaf_ids = {}
        for attr in ("_rf_grad", "_rf_hess"):
            if hasattr(g, attr):
                setattr(g, attr, None)
        return self

    def shuffle_models(self, start_iteration=0,
                       end_iteration=-1) -> "Booster":
        """Shuffle the trees of [start, end) with Python's random module
        (reference: basic.py shuffle_models); the cached ensemble is
        dropped."""
        import random
        models = self._gbdt.models
        end = len(models) if end_iteration < 0 else end_iteration
        seg = models[start_iteration:end]
        random.shuffle(seg)
        models[start_iteration:end] = seg
        self._gbdt.invalidate_ensemble_cache()
        return self
