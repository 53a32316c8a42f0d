"""Training callbacks.

The port of the JAX package's ``callback.py`` (reference
``python-package/lightgbm/callback.py``), line for line: the
``CallbackEnv`` protocol, ``EarlyStopException``, ``log_evaluation``,
``record_evaluation``, ``reset_parameter`` and ``early_stopping``, with
their ``order`` / ``eval_period`` / ``before_iteration`` attributes, which
``engine.train`` reads to order the callbacks and to skip metrics on
rounds nothing consumes.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"],
)


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                f"{name}'s {metric}: {value:g}"
                for name, metric, value, _ in env.evaluation_result_list)
            print(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    # Eval-cadence contract: this callback only consumes metrics on
    # iterations where (it + 1) % eval_period == 0; the engine skips metric
    # computation (and the host sync it costs) on the other iterations.
    # Callbacks without the attribute default to period 1; period <= 0
    # (logging disabled) never consumes any metric.
    _callback.eval_period = period if period > 0 else 0
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _callback(env: CallbackEnv) -> None:
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])
            eval_result[name][metric].append(value)
    _callback.order = 20
    _callback.eval_period = 1   # records every round (cadence contract)
    return _callback


def reset_parameter(**kwargs: Any) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to be {env.end_iteration - env.begin_iteration}")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values supported")
        if new_params:
            env.model.reset_parameter(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """reference ``_EarlyStoppingCallback`` (``callback.py:278``)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[Any] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]
    inited = [False]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            return
        best_score.clear(); best_iter.clear(); best_score_list.clear()
        cmp_op.clear()
        first_metric[0] = env.evaluation_result_list[0][1].split("@")[0]
        for _, metric, _, higher_better in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if higher_better:
                best_score.append(float("-inf"))
                cmp_op.append(lambda new, best: new > best + min_delta)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda new, best: new < best - min_delta)

    def _callback(env: CallbackEnv) -> None:
        # init at the run's first round, or on this callback's first
        # firing (a run that starts mid-stream keeps begin_iteration 0)
        if env.iteration == env.begin_iteration or not inited[0]:
            inited[0] = True
            _init(env)
        if not enabled[0]:
            return
        for i, (name, metric, value, _) in enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](value, best_score[i]):
                best_score[i] = value
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and metric.split("@")[0] != first_metric[0]:
                continue
            if name == "training":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    print(f"Early stopping, best iteration is:\n"
                          f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    print(f"Did not meet early stopping. Best iteration is:\n"
                          f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    _callback.eval_period = 1   # the no-improvement counter ticks per round
    return _callback
