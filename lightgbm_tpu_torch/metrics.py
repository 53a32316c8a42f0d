"""Evaluation metrics, host numpy float64.

The port of the JAX package's ``metrics.py`` (reference factory
``src/metric/metric.cpp:19`` and the per-family headers): the regression
family, ``binary_logloss`` / ``binary_error`` / ``auc`` /
``average_precision``, ``multi_logloss`` / ``multi_error`` / ``auc_mu``,
the cross-entropy pair, and the ranking metrics ``ndcg@k`` / ``map@k``
(one metric per ``eval_at`` position, over the query groups).  Each
:class:`Metric` maps ``(label, raw_score, weight, group)`` to a float and
says whether higher is better (what early stopping compares).  Metrics
run at iteration boundaries on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from .config import Config


@dataclasses.dataclass
class Metric:
    name: str
    higher_better: bool
    fn: Callable[..., float]

    def __call__(self, label, score, weight=None, group=None) -> float:
        return self.fn(label, score, weight, group)


def _avg(values: np.ndarray, weight: Optional[np.ndarray]) -> float:
    if weight is None:
        return float(np.mean(values))
    return float(np.sum(values * weight) / np.sum(weight))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# ------------------------------------------------------------- regression
def _l2(label, score, weight, group):
    return _avg((label - score) ** 2, weight)


def _rmse(label, score, weight, group):
    return float(np.sqrt(_l2(label, score, weight, group)))


def _l1(label, score, weight, group):
    return _avg(np.abs(label - score), weight)


def _quantile(alpha):
    def fn(label, score, weight, group):
        delta = label - score
        loss = np.where(delta >= 0, alpha * delta, (alpha - 1.0) * delta)
        return _avg(loss, weight)
    return fn


def _huber(alpha):
    def fn(label, score, weight, group):
        diff = np.abs(label - score)
        loss = np.where(diff <= alpha, 0.5 * diff ** 2,
                        alpha * (diff - 0.5 * alpha))
        return _avg(loss, weight)
    return fn


def _fair(c):
    def fn(label, score, weight, group):
        x = np.abs(label - score)
        loss = c * c * (x / c - np.log1p(x / c))
        return _avg(loss, weight)
    return fn


def _poisson(label, score, weight, group):
    # score is raw (log): the reference evaluates on the link scale
    return _avg(np.exp(score) - label * score, weight)


def _mape(label, score, weight, group):
    return _avg(np.abs(label - score) / np.maximum(1.0, np.abs(label)),
                weight)


def _gamma(label, score, weight, group):
    # negative log-likelihood of a log-link gamma (reference GammaMetric)
    psi = label * np.exp(-score) + score
    return _avg(psi, weight)


def _gamma_deviance(label, score, weight, group):
    mu = np.exp(score)
    eps = 1e-9
    dev = 2.0 * (np.log(np.maximum(mu, eps) / np.maximum(label, eps))
                 + label / np.maximum(mu, eps) - 1.0)
    return _avg(dev, weight)


def _tweedie(rho):
    def fn(label, score, weight, group):
        mu = np.exp(score)
        a = label * np.power(mu, 1.0 - rho) / (1.0 - rho)
        b = np.power(mu, 2.0 - rho) / (2.0 - rho)
        return _avg(-a + b, weight)
    return fn


# ----------------------------------------------------------------- binary
def _binary_logloss(sigmoid_scale):
    def fn(label, score, weight, group):
        p = np.clip(_sigmoid(sigmoid_scale * score), 1e-15, 1 - 1e-15)
        y = (label > 0).astype(np.float64)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return _avg(loss, weight)
    return fn


def _binary_error(label, score, weight, group):
    pred = (score > 0).astype(np.float64)
    y = (label > 0).astype(np.float64)
    return _avg((pred != y).astype(np.float64), weight)


def _auc(label, score, weight, group):
    y = (label > 0).astype(np.float64)
    w = np.ones_like(y) if weight is None else np.asarray(weight, np.float64)
    order = np.argsort(score, kind="mergesort")
    y, w, s = y[order], w[order], np.asarray(score)[order]
    pos_w = y * w
    neg_w = (1 - y) * w
    # equal-score runs share their rank: ascending scan, each positive
    # beats the negatives strictly below it and ties count half
    boundaries = np.nonzero(np.diff(s))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(s)]])
    cum_neg = 0.0
    total = 0.0
    for st, en in zip(starts, ends):
        p = pos_w[st:en].sum()
        n = neg_w[st:en].sum()
        total += p * (cum_neg + n / 2.0)
        cum_neg += n
    total_pos = pos_w.sum()
    total_neg = neg_w.sum()
    if total_pos == 0 or total_neg == 0:
        return 1.0
    return float(total / (total_pos * total_neg))


def _average_precision(label, score, weight, group):
    y = (label > 0).astype(np.float64)
    w = np.ones_like(y) if weight is None else np.asarray(weight, np.float64)
    order = np.argsort(-np.asarray(score), kind="mergesort")
    y, w = y[order], w[order]
    tp = np.cumsum(y * w)
    alls = np.cumsum(w)
    precision = tp / alls
    total_pos = (y * w).sum()
    if total_pos == 0:
        return 1.0
    return float(np.sum(precision * y * w) / total_pos)


def binary_logloss(label, score, weight=None, sigmoid: float = 1.0) -> float:
    """``binary_logloss`` of raw scores."""
    return _binary_logloss(sigmoid)(np.asarray(label),
                                    np.asarray(score, np.float64), weight,
                                    None)


def auc(label, score, weight=None) -> float:
    """``auc`` of scores (tied scores count half)."""
    return _auc(np.asarray(label), score, weight, None)


# ------------------------------------------------------------- multiclass
def _multi_logloss(label, score, weight, group):
    # score: (N, K) raw; softmax here (reference MultiSoftmaxLoglossMetric)
    s = score - score.max(axis=1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=1, keepdims=True)
    idx = np.asarray(label, np.int64)
    lp = -np.log(np.clip(p[np.arange(len(idx)), idx], 1e-15, None))
    return _avg(lp, weight)


def _multi_error(top_k):
    def fn(label, score, weight, group):
        idx = np.asarray(label, np.int64)
        if top_k <= 1:
            pred = score.argmax(axis=1)
            err = (pred != idx).astype(np.float64)
        else:
            rank = np.argsort(-score, axis=1)[:, :top_k]
            err = 1.0 - (rank == idx[:, None]).any(axis=1).astype(np.float64)
        return _avg(err, weight)
    return fn


def _auc_mu(num_class, weights_list=None):
    """AUC-mu (reference ``AucMuMetric``, ``multiclass_metric.hpp:183``):
    the mean over class pairs (i < j) of the AUC separating the two
    classes along v = W[i] - W[j], ranked by t1 * (score . v)."""
    K = num_class
    if weights_list:
        W = np.asarray(weights_list, np.float64).reshape(K, K)
    else:
        W = np.ones((K, K)) - np.eye(K)

    def fn(label, score, weight, group):
        score = np.asarray(score, np.float64).reshape(-1, K)
        y = np.asarray(label, np.int64)
        total, pairs = 0.0, 0
        for i in range(K):
            for j in range(i + 1, K):
                v = W[i] - W[j]
                t1 = v[i] - v[j]
                idx = np.where((y == i) | (y == j))[0]
                pos = y[idx] == i
                if not pos.any() or pos.all():
                    continue
                d = t1 * (score[idx] @ v)
                w = None if weight is None else np.asarray(weight)[idx]
                total += _auc(pos.astype(np.float64), d, w, None)
                pairs += 1
        return total / max(pairs, 1)
    return fn


# ---------------------------------------------------------------- ranking
def _group_bounds(group: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.asarray(group, np.int64))])


def _dcg_at_k(labels_sorted: np.ndarray, k: int, gains: np.ndarray) -> float:
    top = labels_sorted[:k]
    g = gains[np.minimum(top.astype(np.int64), len(gains) - 1)]
    disc = 1.0 / np.log2(np.arange(len(top)) + 2.0)
    return float((g * disc).sum())


def _ndcg_multi(label, score, group, ks, gains) -> List[float]:
    """Mean NDCG@k over the queries for each k of ``ks``; a query
    without relevant documents counts 1 (reference ``NDCGMetric``)."""
    bounds = _group_bounds(group)
    res = np.zeros(len(ks))
    nq = len(bounds) - 1
    for qi in range(nq):
        lab = np.asarray(label[bounds[qi]: bounds[qi + 1]])
        sc = np.asarray(score[bounds[qi]: bounds[qi + 1]])
        order = np.argsort(-sc, kind="mergesort")
        ideal = np.sort(lab)[::-1]
        for j, k in enumerate(ks):
            idcg = _dcg_at_k(ideal, k, gains)
            if idcg <= 0:
                res[j] += 1.0
            else:
                res[j] += _dcg_at_k(lab[order], k, gains) / idcg
    return list(res / max(nq, 1))


def _ndcg_at(k: int, gains: np.ndarray):
    def fn(label, score, weight, group):
        return _ndcg_multi(label, score, group, [k], gains)[0]
    return fn


def _map_at(k: int):
    """Mean average precision at k over the queries (labels > 0 are
    relevant; a query without relevant documents in its top k adds 0)."""
    def fn(label, score, weight, group):
        bounds = _group_bounds(group)
        nq = len(bounds) - 1
        total = 0.0
        for qi in range(nq):
            lab = (np.asarray(label[bounds[qi]: bounds[qi + 1]]) > 0)
            sc = np.asarray(score[bounds[qi]: bounds[qi + 1]])
            order = np.argsort(-sc, kind="mergesort")
            rel = lab[order][:k]
            if rel.sum() == 0:
                continue
            prec = np.cumsum(rel) / (np.arange(len(rel)) + 1.0)
            total += (prec * rel).sum() / min(lab.sum(), k)
        return float(total / max(nq, 1))
    return fn


# ---------------------------------------------------------- cross entropy
def _xentropy(label, score, weight, group):
    p = np.clip(_sigmoid(score), 1e-15, 1 - 1e-15)
    loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
    return _avg(loss, weight)


def _xentlambda(label, score, weight, group):
    hhat = np.log1p(np.exp(score))
    w = np.ones_like(label) if weight is None else weight
    z = 1.0 - np.exp(-w * hhat)
    z = np.clip(z, 1e-15, 1 - 1e-15)
    loss = (-(label * np.log(z) + (1 - label) * np.log(1 - z))
            / np.maximum(w, 1e-15))
    return _avg(loss, None)


_METRIC_ALIASES = {
    "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "mean_absolute_error": "l1", "regression_l1": "l1", "mae": "l1",
    "mean_absolute_percentage_error": "mape",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "softmax": "multi_logloss",
    "multiclassova": "multi_logloss", "multiclass_ova": "multi_logloss",
    "ova": "multi_logloss", "ovr": "multi_logloss",
    "xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda",
    "mean_average_precision": "map",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg",
}


def create_metric(name: str, cfg: Config) -> List[Metric]:
    """Reference ``Metric::CreateMetric`` (``metric.cpp:19``): the
    metrics of one name, as a list (ndcg and map: one per ``eval_at``
    position)."""
    name = _METRIC_ALIASES.get(name, name)
    gains = (np.asarray(cfg.label_gain, np.float64) if cfg.label_gain
             else (np.power(2.0, np.arange(32)) - 1.0))
    eval_at = cfg.eval_at or [1, 2, 3, 4, 5]
    table: Dict[str, Metric] = {
        "l2": Metric("l2", False, _l2),
        "rmse": Metric("rmse", False, _rmse),
        "l1": Metric("l1", False, _l1),
        "quantile": Metric("quantile", False, _quantile(cfg.alpha)),
        "huber": Metric("huber", False, _huber(cfg.alpha)),
        "fair": Metric("fair", False, _fair(cfg.fair_c)),
        "poisson": Metric("poisson", False, _poisson),
        "mape": Metric("mape", False, _mape),
        "gamma": Metric("gamma", False, _gamma),
        "gamma_deviance": Metric("gamma_deviance", False, _gamma_deviance),
        "tweedie": Metric("tweedie", False,
                          _tweedie(cfg.tweedie_variance_power)),
        "binary_logloss": Metric("binary_logloss", False,
                                 _binary_logloss(cfg.sigmoid)),
        "binary_error": Metric("binary_error", False, _binary_error),
        "auc": Metric("auc", True, _auc),
        "average_precision": Metric("average_precision", True,
                                    _average_precision),
        "multi_logloss": Metric("multi_logloss", False, _multi_logloss),
        "multi_error": Metric("multi_error", False,
                              _multi_error(cfg.multi_error_top_k)),
        "auc_mu": Metric("auc_mu", True,
                         _auc_mu(cfg.num_class, cfg.auc_mu_weights)),
        "cross_entropy": Metric("cross_entropy", False, _xentropy),
        "cross_entropy_lambda": Metric("cross_entropy_lambda", False,
                                       _xentlambda),
    }
    if name in table:
        return [table[name]]
    if name == "ndcg":
        return [Metric(f"ndcg@{k}", True, _ndcg_at(k, gains))
                for k in eval_at]
    if name == "map":
        return [Metric(f"map@{k}", True, _map_at(k)) for k in eval_at]
    raise ValueError(f"unknown metric: {name}")


def default_metric_for_objective(objective: str) -> str:
    """The objective's default metric (reference ``config.cpp``)."""
    return {
        "regression": "l2", "regression_l1": "l1", "huber": "huber",
        "fair": "fair", "poisson": "poisson", "quantile": "quantile",
        "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
        "binary": "binary_logloss",
        "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
        "cross_entropy": "cross_entropy",
        "cross_entropy_lambda": "cross_entropy_lambda",
        "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    }.get(objective, "l2")


def metrics_for_config(cfg: Config) -> List[Metric]:
    """``cfg.metric`` (or the objective's default) as Metric objects,
    skipping the none / custom placeholders."""
    names = cfg.metric or [default_metric_for_objective(cfg.objective)]
    out: List[Metric] = []
    for nm in names:
        if nm in ("", "none", "null", "na", "custom"):
            continue
        out.extend(create_metric(nm, cfg))
    return out
