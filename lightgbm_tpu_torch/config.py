"""Config: typed parameter container with alias resolution and validation.

Equivalent surface to the reference's ``struct Config`` + ``ParameterAlias``
(reference: include/LightGBM/config.h:31-969, src/io/config.cpp:209-347).
The parameter table itself lives in ``params_schema.py`` (generated, single
source of truth, like the reference's helpers/parameter_generator.py flow).
"""
from __future__ import annotations

import copy
import operator as _operator
from typing import Any, Dict, Iterable, Optional

from .params_schema import PARAMS
from .utils import log

# name -> schema entry
_SCHEMA: Dict[str, dict] = {p["name"]: p for p in PARAMS}

# alias -> canonical name (reference: config.h:927 KeyAliasTransform)
_ALIASES: Dict[str, str] = {}
for _p in PARAMS:
    for _a in _p["aliases"]:
        _ALIASES.setdefault(_a, _p["name"])

# defaults that the extractor kept as C++ expressions
_DEFAULT_FIXUPS: Dict[str, Any] = {
    "label_gain": [],          # filled at use time: 2^i - 1
    "eval_at": [1, 2, 3, 4, 5],
    "metric": [],
    "snapshot_freq": -1,
    "valid": [],
    "categorical_feature": [],
    "ignore_column": [],
    "interaction_constraints": [],
    "max_bin_by_feature": [],
    "cegb_penalty_feature_lazy": [],
    "cegb_penalty_feature_coupled": [],
    "monotone_constraints": [],
    "feature_contri": [],
}

# objective aliases (reference: config.cpp ParseObjectiveAlias semantics)
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "l2_root": "regression", "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

# metric aliases (reference: metric.cpp:16-61 + config metric parsing)
_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair", "poisson": "poisson",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}


def _coerce(name: str, value: Any, ptype: str) -> Any:
    if ptype == "bool":
        if isinstance(value, str):
            return value.lower() in ("true", "1", "+", "yes")
        return bool(value)
    if ptype == "int":
        return int(float(value)) if not isinstance(value, bool) else int(value)
    if ptype == "float":
        return float(value)
    if ptype in ("vec_int", "vec_float", "vec_str", "multi-enum", "multi-int", "multi-double"):
        if value is None or value == "":
            return []
        if isinstance(value, str):
            parts = [v for v in value.replace(",", " ").split() if v]
        elif isinstance(value, Iterable) and not isinstance(value, str):
            parts = list(value)
        else:
            parts = [value]
        if ptype in ("vec_int", "multi-int"):
            return [int(float(v)) for v in parts]
        if ptype in ("vec_float", "multi-double"):
            return [float(v) for v in parts]
        return [str(v) for v in parts]
    return str(value)


def resolve_aliases(params: Dict[str, Any]) -> Dict[str, Any]:
    """Map alias keys to canonical names.

    Conflict resolution matches the reference (config.h:927): when several
    aliases of one parameter are given, the shortest (then alphabetically
    first) name wins; an explicitly-set canonical name always wins.
    """
    out: Dict[str, Any] = {}
    pending: Dict[str, tuple] = {}
    for key, value in params.items():
        canonical = _ALIASES.get(key)
        if canonical is None:
            if key not in _SCHEMA:
                log.warning("Unknown parameter: %s", key)
                continue
            out[key] = value
        else:
            prev = pending.get(canonical)
            if prev is None or (len(key), key) < (len(prev[0]), prev[0]):
                pending[canonical] = (key, value)
    for canonical, (src, value) in pending.items():
        if canonical in out:
            log.warning(
                "%s is set, %s=%s will be ignored", canonical, src, value)
        else:
            out[canonical] = value
    return out


_CHECK_OPS = {">": _operator.gt, ">=": _operator.ge,
              "<": _operator.lt, "<=": _operator.le}


def _check_constraints(name: str, value, schema: dict) -> None:
    """Enforce the schema's range constraints (the reference's CHECK
    macros on Config members, include/LightGBM/config.h doc tags)."""
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return
    for chk in schema.get("check", ()):
        for op in (">=", "<=", ">", "<"):    # longest match first
            if chk.startswith(op):
                if not _CHECK_OPS[op](float(value), float(chk[len(op):])):
                    log.fatal("Parameter %s=%s should be %s %s",
                              name, value, op, chk[len(op):])
                break


class Config:
    """All training/IO/prediction parameters as attributes."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        for p in PARAMS:
            default = _DEFAULT_FIXUPS.get(p["name"], p["default"])
            setattr(self, p["name"], copy.copy(default))
        self.raw: Dict[str, Any] = {}
        if params:
            self.update(params)

    def update(self, params: Dict[str, Any]) -> None:
        resolved = resolve_aliases(params)
        # two-phase + rollback: coerce/range-check everything first; if
        # anything (including _post_process conflict checks) rejects, the
        # config is restored exactly — no partially-applied params, no
        # skipped post-processing.
        coerced_all = []
        for name, value in resolved.items():
            schema = _SCHEMA[name]
            coerced = _coerce(name, value, schema["type"])
            _check_constraints(name, coerced, schema)
            coerced_all.append((name, coerced))
        snapshot = {p["name"]: copy.copy(getattr(self, p["name"]))
                    for p in PARAMS}
        raw_snapshot = dict(self.raw)
        try:
            for name, coerced in coerced_all:
                setattr(self, name, coerced)
            self.raw.update(resolved)
            self._post_process(resolved)
        except Exception:
            for name, old in snapshot.items():
                setattr(self, name, old)
            self.raw = raw_snapshot
            raise

    def _post_process(self, resolved: Dict[str, Any]) -> None:
        self.objective = _OBJECTIVE_ALIASES.get(
            str(self.objective).lower(), str(self.objective).lower())
        metrics = []
        for m in (self.metric if isinstance(self.metric, list) else [self.metric]):
            mname = str(m).lower()
            if mname == "":
                continue
            metrics.append(_METRIC_ALIASES.get(mname, mname))
        # dedup keeping order (reference keeps a set)
        seen = set()
        self.metric = [m for m in metrics if not (m in seen or seen.add(m))]
        if not self.label_gain:
            self.label_gain = [float((1 << i) - 1) for i in range(31)]
        self._check_conflicts(resolved)

    def _check_conflicts(self, resolved: Dict[str, Any]) -> None:
        """Parameter-conflict checks (reference: config.cpp:268 CheckParamConflict)."""
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the same time")
        # num_leaves / bagging_fraction ranges are owned by the schema
        # constraint checks (_check_constraints)
        if self.boosting in ("rf", "random_forest"):
            self.boosting = "rf"
            if self.bagging_freq <= 0 or self.bagging_fraction >= 1.0 or self.bagging_fraction <= 0.0:
                log.fatal("Random forest needs bagging_freq > 0 and bagging_fraction in (0, 1)")
        if self.boosting == "goss":
            if self.top_rate + self.other_rate > 1.0:
                log.fatal("top_rate + other_rate must be <= 1.0 for GOSS")
        if self.on_nonfinite not in ("off", "raise", "skip_iter", "rollback"):
            log.fatal("on_nonfinite must be one of off/raise/skip_iter/"
                      "rollback, got %s", self.on_nonfinite)
        if self.telemetry not in ("off", "summary", "trace"):
            log.fatal("telemetry must be one of off/summary/trace, got %s",
                      self.telemetry)
        if self.grow_program not in ("per_split", "fused_tree"):
            log.fatal("grow_program must be one of per_split/fused_tree, "
                      "got %s", self.grow_program)
        if self.stream_mode not in ("off", "chunked", "goss"):
            log.fatal("stream_mode must be one of off/chunked/goss, got %s",
                      self.stream_mode)
        if self.stream_mode == "goss" and self.boosting != "goss":
            log.fatal("stream_mode=goss reuses GOSS sampling as the "
                      "working-set policy and needs boosting=goss "
                      "(got boosting=%s); use stream_mode=chunked for "
                      "plain streaming", self.boosting)
        if self.continual_policy not in ("refit", "continue", "auto"):
            log.fatal("continual_policy must be one of refit/continue/auto, "
                      "got %s", self.continual_policy)
        if self.on_rank_failure not in ("raise", "shrink"):
            log.fatal("on_rank_failure must be one of raise/shrink, "
                      "got %s", self.on_rank_failure)
        if self.dist_shard_mode not in ("replicated", "rows"):
            log.fatal("dist_shard_mode must be one of replicated/rows, "
                      "got %s", self.dist_shard_mode)
        if self.dist_shard_mode == "rows" and self.tree_learner in (
                "feature", "voting"):
            log.fatal(
                "dist_shard_mode=rows keeps each host only its own row "
                "block, which only the data-parallel learner can train "
                "on (histograms are the cross-host exchange); "
                "tree_learner=%s needs every rank to hold all rows. Use "
                "tree_learner=data or dist_shard_mode=replicated",
                self.tree_learner)

    # -- helpers used by the trainer -------------------------------------
    @property
    def is_parallel(self) -> bool:
        return self.tree_learner not in ("serial",)

    @property
    def quant_bits(self) -> int:
        """The ONE resolution point of the quantized-gradient knobs:
        grad_bits when quantized_grad is on, else 0 (float histograms).
        Learners key their jit caches on this static."""
        return int(self.grad_bits) if self.quantized_grad else 0

    def to_dict(self) -> Dict[str, Any]:
        return {p["name"]: getattr(self, p["name"]) for p in PARAMS}

    def to_string(self) -> str:
        """Save non-default parameters (model-file 'parameters:' section)."""
        lines = []
        for p in PARAMS:
            name = p["name"]
            if name in ("task", "machines", "config"):
                continue
            val = getattr(self, name)
            if isinstance(val, list):
                sval = ",".join(str(v) for v in val)
            else:
                sval = str(val).lower() if isinstance(val, bool) else str(val)
            lines.append(f"[{name}: {sval}]")
        return "\n".join(lines)


def param_dict_to_str(params: Dict[str, Any]) -> str:
    """Python-dict -> 'k=v k2=v2' string (reference: basic.py param_dict_to_str)."""
    pairs = []
    for key, val in params.items():
        if isinstance(val, (list, tuple)):
            pairs.append(f"{key}={','.join(map(str, val))}")
        elif isinstance(val, bool):
            pairs.append(f"{key}={'true' if val else 'false'}")
        elif val is None:
            continue
        else:
            pairs.append(f"{key}={val}")
    return " ".join(pairs)


def parse_config_str(text: str) -> Dict[str, Any]:
    """Parse 'k=v' lines / CLI args (reference: config.cpp KV2Map)."""
    out: Dict[str, Any] = {}
    for token in text.replace("\n", " ").split():
        token = token.strip()
        if not token or token.startswith("#"):
            continue
        if "=" in token:
            k, v = token.split("=", 1)
            out[k.strip()] = v.strip()
    return out
