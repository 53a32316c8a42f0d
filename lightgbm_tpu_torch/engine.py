"""Training entry points: ``train`` and ``cv``.

The port of the JAX package's ``engine.py::train`` (reference
``python-package/lightgbm/engine.py``): ``params``, ``train_set``,
``num_boost_round``, ``valid_sets`` / ``valid_names``, ``feval``,
``callbacks`` and the port's ``device``.  ``num_iterations`` /
``num_boost_round`` in ``params`` win over the argument; the
early-stopping params (``early_stopping_round`` and its aliases,
``first_metric_only``, ``early_stopping_min_delta``) add an
``early_stopping`` callback when there is a valid set, as in the JAX
package.  Metrics are computed only on rounds a callback consumes
(``eval_period``), and an early stop sets ``best_iteration`` and
``best_score``.  A callable ``objective`` trains through
``Booster.update(fobj=...)``.  ``init_model`` (a model file's path, a
``Booster`` or a ``LoadedModel``) continues training: the base model's
raw scores are folded into every dataset's init score, on shallow copies
that keep the constructed bins (the caller's datasets keep their own),
and its trees come first in the new booster's predictions and model
text.  ``resume_from`` (ROADMAP A11) is later work and raises.

``cv`` is the port of the JAX package's ``engine.py::cv`` (reference
``engine.cv``): ``nfold`` folds (stratified by label for the binary and
multiclass objectives, whole queries for a grouped dataset) or the
caller's ``folds``, each trained by ``train`` on ``device`` with its
held-out rows as the valid set ``"valid"``; the result maps ``"valid
<metric>-mean"`` / ``"-stdv"`` to per-round lists over the folds.  A
text file is parsed once, before the folds are cut, and each fold bins
its own rows.  A fold's booster (and its device bins) is dropped before
the next fold trains unless ``return_cv_booster`` keeps them all.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .serialization import LoadedModel, load_model_string
from .utils.device import resolve_device
from .utils.timer import FunctionTimer


def _base_model(init_model, device) -> LoadedModel:
    """``init_model`` as a :class:`LoadedModel` on ``device``."""
    if isinstance(init_model, LoadedModel):
        return init_model
    if isinstance(init_model, Booster):
        text = init_model.model_to_string()
    else:
        with open(init_model) as fh:
            text = fh.read()
    return load_model_string(text, device=device)


def _fold_init_score(ds: Dataset, base: LoadedModel,
                     params: Dict[str, Any]) -> Dataset:
    """A shallow copy of ``ds`` whose init score adds the base model's raw
    scores (f64) to its own; a constructed dataset's bins are kept."""
    ds.load_rows(params)
    pred = np.asarray(base.predict_raw(ds.data), np.float64)
    if ds.init_score is not None:
        pred = pred + np.asarray(ds.init_score,
                                 np.float64).reshape(pred.shape)
    return ds.with_init_score(pred)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          feval: Optional[Callable] = None,
          init_model=None, keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          resume_from: Optional[str] = None, *, device=None) -> Booster:
    """Train a booster on ``device`` (the CUDA card unless ``"cpu"``)."""
    if resume_from is not None:
        raise NotImplementedError(
            "resume_from (checkpoints) is not ported to lightgbm_tpu_torch "
            "yet (ROADMAP A11)")
    fobj = None
    if callable(params.get("objective")):
        fobj = params["objective"]
        params = {**params, "objective": "custom"}
    params = copy.deepcopy(params)
    if "num_iterations" in params or "num_boost_round" in params:
        num_boost_round = int(params.pop("num_boost_round",
                              params.pop("num_iterations", num_boost_round)))
    early_stopping_rounds = None
    for alias in ("early_stopping_round", "early_stopping_rounds",
                  "early_stopping", "n_iter_no_change"):
        if params.get(alias):
            early_stopping_rounds = int(params[alias])
    first_metric_only = bool(params.get("first_metric_only", False))
    es_min_delta = float(params.get("early_stopping_min_delta", 0.0))

    names = list(valid_names or [])
    valid_pairs = []
    for i, vs in enumerate(valid_sets or []):
        if vs is train_set:
            continue
        valid_pairs.append((names[i] if i < len(names) else f"valid_{i}",
                            vs))
    base = None
    if init_model is not None:
        with FunctionTimer("train/fold_init_score"):
            base = _base_model(init_model, resolve_device(device))
            folded = _fold_init_score(train_set, base, params)
            pairs = []
            for nm, vs in valid_pairs:
                vc = _fold_init_score(vs, base, params)
                if vc.reference is train_set:
                    vc.reference = folded
                pairs.append((nm, vc))
        train_set, valid_pairs = folded, pairs
    booster = Booster(params=params, train_set=train_set,
                      valid_sets=valid_pairs, device=device,
                      base_model=base)
    # best_iteration counts the combined model's iterations
    n_base = base.iter_ if base is not None else 0

    cbs = list(callbacks or [])
    if early_stopping_rounds is not None and valid_pairs:
        cbs.append(callback_mod.early_stopping(
            early_stopping_rounds, first_metric_only=first_metric_only,
            verbose=params.get("verbosity", 1) > 0, min_delta=es_min_delta))
    cbs_before = sorted((cb for cb in cbs
                         if getattr(cb, "before_iteration", False)),
                        key=lambda cb: getattr(cb, "order", 0))
    cbs_after = sorted((cb for cb in cbs
                        if not getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))
    # eval cadence: metrics only on rounds a callback (or feval) consumes;
    # eval_period <= 0 marks a callback that consumes none
    periods = [p for p in (int(getattr(cb, "eval_period", 1))
                           for cb in cbs_after) if p > 0]
    if feval is not None:
        periods.append(1)

    def fire_after(it: int) -> bool:
        """Metrics and after-callbacks of round ``it``; True = stop."""
        if not any((it + 1) % p == 0 for p in periods):
            return False
        evals = booster._evals(feval)
        try:
            for cb in cbs_after:
                cb(CallbackEnv(booster, params, it, 0, num_boost_round,
                               evals))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1 + n_base
            booster.best_score = e.best_score
            return True
        return False

    for it in range(num_boost_round):
        for cb in cbs_before:
            cb(CallbackEnv(booster, params, it, 0, num_boost_round, None))
        finished = booster.update(fobj=fobj)
        if fire_after(it) or finished:
            break
    return booster


def _query_folds(group, nfold: int, shuffle: bool, rng):
    """Folds of whole queries: (train rows, valid rows, train group,
    valid group) for each fold (reference ``_make_n_folds``)."""
    nq = len(group)
    bounds = np.concatenate([[0], np.cumsum(group)])
    q_idx = np.arange(nq)
    if shuffle:
        rng.shuffle(q_idx)
    q_parts = np.array_split(q_idx, nfold)
    rows = lambda qs: np.concatenate([np.arange(bounds[q], bounds[q + 1])
                                      for q in qs])
    folds = []
    for i in range(nfold):
        va_q = np.sort(q_parts[i])
        tr_q = np.sort(np.concatenate(
            [p for j, p in enumerate(q_parts) if j != i]))
        folds.append((rows(tr_q), rows(va_q), group[tr_q], group[va_q]))
    return folds


def _row_folds(y, nfold: int, stratified: bool, shuffle: bool, rng):
    """(train rows, valid rows) for each fold, stratified by label."""
    idx = np.arange(len(y))
    if stratified:
        folds_idx = [[] for _ in range(nfold)]
        for cls in np.unique(y):
            cls_idx = idx[y == cls]
            if shuffle:
                rng.shuffle(cls_idx)
            for i, part in enumerate(np.array_split(cls_idx, nfold)):
                folds_idx[i].extend(part)
        return [(np.setdiff1d(idx, np.array(f)), np.array(sorted(f)))
                for f in folds_idx]
    if shuffle:
        rng.shuffle(idx)
    parts = np.array_split(idx, nfold)
    return [(np.concatenate([p for j, p in enumerate(parts) if j != i]),
             parts[i]) for i in range(nfold)]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True, metrics=None,
       seed: int = 0, callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False, return_cv_booster: bool = False,
       *, device=None) -> Dict[str, Any]:
    """K-fold cross-validation on ``device`` (the CUDA card unless
    ``"cpu"``).  ``eval_train_metric`` is accepted and, as in the JAX
    package, adds nothing."""
    params = copy.deepcopy(params)
    if metrics is not None:
        params["metric"] = metrics
    train_set.load_rows(params)
    X, y = train_set.data, np.asarray(train_set.label)
    w = train_set.weight
    rng = np.random.RandomState(seed)
    group = train_set.group
    if folds is None and group is not None:
        folds = _query_folds(np.asarray(group), nfold, shuffle, rng)
    elif folds is None:
        folds = _row_folds(y, nfold, stratified and params.get("objective")
                           in ("binary", "multiclass", "multiclassova"),
                           shuffle, rng)
    boosters, fold_histories = [], []
    for fold in folds:
        tr_idx, va_idx = fold[0], fold[1]
        tr_g, va_g = (fold[2], fold[3]) if len(fold) == 4 else (None, None)
        dtr = Dataset(X[tr_idx], label=y[tr_idx], group=tr_g,
                      weight=None if w is None else w[tr_idx],
                      params=params)
        dva = Dataset(X[va_idx], label=y[va_idx], group=va_g,
                      weight=None if w is None else w[va_idx],
                      reference=dtr, params=params)
        history: Dict[str, Dict[str, List[float]]] = {}
        cbs = list(callbacks or []) + [
            callback_mod.record_evaluation(history)]
        bst = train(params, dtr, num_boost_round, valid_sets=[dva],
                    valid_names=["valid"], callbacks=cbs, device=device)
        fold_histories.append(history.get("valid", {}))
        if return_cv_booster:
            boosters.append(bst)
        # one fold's device bins alive at a time
        del bst, dtr, dva
    return _collect_cv(fold_histories, boosters, return_cv_booster)


def _collect_cv(fold_histories, boosters, return_cv_booster):
    """Per-round means and standard deviations over the folds."""
    results: Dict[str, Any] = {}
    metric_names = sorted({m for h in fold_histories for m in h})
    for m in metric_names:
        rounds = min(len(h[m]) for h in fold_histories if m in h)
        vals = np.array([h[m][:rounds] for h in fold_histories if m in h])
        results[f"valid {m}-mean"] = list(vals.mean(axis=0))
        results[f"valid {m}-stdv"] = list(vals.std(axis=0))
    if return_cv_booster:
        results["cvbooster"] = boosters
    return results
