"""Training callbacks (reference: python-package/lightgbm/callback.py).

Port of lightgbm_tpu/callback.py: callables taking a CallbackEnv
namedtuple, ordered by an ``order`` attribute (``before_iteration`` ones
run before the update), raising EarlyStopException to halt training.
``record_telemetry`` logs the recorder's phases, ``checkpoint`` writes
full training checkpoints (resilience/checkpoint.py).
"""
from __future__ import annotations

import collections
from typing import Callable, List

from .utils import log


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv=True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dict")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to 'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are supported "
                                 "as a mapping from boosting round index to new parameter value.")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def record_telemetry(period: int = 1) -> Callable:
    """Log each iteration's telemetry phase summary (one line per `period`
    iterations). Needs ``telemetry=summary`` or ``trace`` — with telemetry
    off nothing is recorded and the callback stays silent.

    Runs at order 15: after print_evaluation (10), before
    record_evaluation (20), so the phase line lands next to the metric
    line of the same iteration."""
    from .telemetry import recorder as _recorder

    def _callback(env: CallbackEnv) -> None:
        if period <= 0 or (env.iteration + 1) % period != 0:
            return
        info = _recorder.last_iteration()
        if info is None:
            return
        phases = " ".join(
            f"{name}={secs * 1e3:.1f}ms"
            for name, secs in sorted(info["phases"].items()))
        log.info("[%d]\ttelemetry wall=%.1fms %s", env.iteration + 1,
                 info["wall_s"] * 1e3, phases)
    _callback.order = 15
    return _callback


def checkpoint(directory: str, checkpoint_freq: int = 1, keep_last: int = 3,
               prefix: str = "ckpt") -> Callable:
    """Write a full training checkpoint every `checkpoint_freq`
    iterations (atomic file, checksum manifest, keep-last-`keep_last`
    rotation — see resilience/checkpoint.py). The callback accumulates
    the run's eval history so a resumed run (engine.train
    ``resume_from=``) restores `evals_result` and early-stopping state;
    on resume the engine re-seeds that history.

    Runs at order 25: after record_evaluation (20) and the loss-spike
    guard (22), before early stopping (30), so the iteration that trips
    early stopping is still captured.
    """
    if checkpoint_freq <= 0:
        raise ValueError("checkpoint_freq must be positive")
    history: List = []
    state = {"mgr": None}

    def _callback(env: CallbackEnv) -> None:
        if env.evaluation_result_list:
            history.append([env.iteration,
                            [[r[0], r[1], float(r[2]), bool(r[3])]
                             for r in env.evaluation_result_list]])
        if (env.iteration + 1) % checkpoint_freq == 0:
            if state["mgr"] is None:
                from .resilience.checkpoint import CheckpointManager
                state["mgr"] = CheckpointManager(directory, keep_last,
                                                 prefix)
            # target_rounds rides every checkpoint so a preempted process
            # can resume with num_boost_round=None and still finish the
            # run's ORIGINAL budget
            path = state["mgr"].save(
                env.model, history=history,
                extra_meta={"target_rounds": int(env.end_iteration)})
            from .telemetry import events as telem_events
            telem_events.emit("checkpoint", iteration=env.iteration,
                              path=path)
            log.debug("checkpoint written: %s", path)
    _callback.order = 25
    _callback._ckpt_history = history
    # graceful preemption writes its emergency checkpoint here
    # (engine._preempt_exit finds it by attribute)
    _callback._ckpt_dir = directory
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log.info("Training until validation scores don't improve for %d rounds",
                     stopping_rounds)
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # higher better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _final_iteration_check(env, eval_name_splitted, i) -> None:
        if env.iteration == env.end_iteration - 1:
            if verbose:
                log.info("Did not meet early stopping. Best iteration is: [%d]\t%s",
                         best_iter[i] + 1,
                         "\t".join(_format_eval_result(x) for x in best_score_list[i]))
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = env.evaluation_result_list[i][1].split(" ")
            if first_metric_only and first_metric[0] != eval_name_splitted[-1]:
                continue
            if env.evaluation_result_list[i][0] == env.model._train_data_name:
                _final_iteration_check(env, eval_name_splitted, i)
                continue
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is: [%d]\t%s",
                             best_iter[i] + 1,
                             "\t".join(_format_eval_result(x) for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)
    _callback.order = 30
    return _callback
