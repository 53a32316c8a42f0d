"""Metric parity: ``lightgbm_tpu_torch.metrics`` against
``lightgbm_tpu.metrics`` on the same numpy labels, scores and weights.

- Every non-ranking metric (and ``multi_error`` at top-2, ``auc_mu`` with
  a weight matrix), unweighted and weighted: ``create_metric``'s value is
  the JAX package's within 1e-12 relative, and its name and direction
  (``higher_better``, what early stopping compares) are the same.
- ``default_metric_for_objective`` for every objective, and
  ``metrics_for_config`` over metric lists, aliases and placeholders,
  give the JAX package's metrics.
- ``ndcg`` and ``map`` (and their aliases) resolve to the JAX package's
  metrics, one per ``eval_at`` position (tests/test_torch_ranking.py
  holds their values)."""

import numpy as np
import pytest

from lightgbm_tpu_torch import metrics as PM
from lightgbm_tpu_torch.config import Config as PConfig
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jm():
    return pytest.importorskip("lightgbm_tpu.metrics")


N = 500
K = 3
CFG = {"alpha": 0.7, "fair_c": 1.3, "tweedie_variance_power": 1.3,
       "num_class": K, "objective": "multiclass", "sigmoid": 1.5}


def _inputs(kind, rng):
    """(label, raw score) of one metric family."""
    if kind == "real":
        return rng.randn(N) * 2.0, rng.randn(N)
    if kind == "positive":
        return np.exp(rng.randn(N)), rng.randn(N) * 0.5
    if kind == "count":
        return np.floor(np.exp(rng.randn(N))), rng.randn(N) * 0.5
    if kind == "binary":
        # one-decimal scores: ties for the rank metrics
        return ((rng.rand(N) > 0.6).astype(np.float64),
                np.round(rng.randn(N), 1))
    if kind == "class":
        return (rng.randint(0, K, N).astype(np.float64),
                np.round(rng.randn(N, K), 1))
    return rng.rand(N), rng.randn(N)


#: (case, metric name, extra params, input family)
METRICS = [
    ("l2", "l2", {}, "real"),
    ("rmse", "rmse", {}, "real"),
    ("l1", "l1", {}, "real"),
    ("quantile", "quantile", {}, "real"),
    ("huber", "huber", {}, "real"),
    ("fair", "fair", {}, "real"),
    ("poisson", "poisson", {}, "count"),
    ("mape", "mape", {}, "real"),
    ("gamma", "gamma", {}, "positive"),
    ("gamma_deviance", "gamma_deviance", {}, "positive"),
    ("tweedie", "tweedie", {}, "count"),
    ("binary_logloss", "binary_logloss", {}, "binary"),
    ("binary_error", "binary_error", {}, "binary"),
    ("auc", "auc", {}, "binary"),
    ("average_precision", "average_precision", {}, "binary"),
    ("multi_logloss", "multi_logloss", {}, "class"),
    ("multi_error", "multi_error", {}, "class"),
    ("multi_error_top2", "multi_error", {"multi_error_top_k": 2}, "class"),
    ("auc_mu", "auc_mu", {}, "class"),
    ("auc_mu_weights", "auc_mu",
     {"auc_mu_weights": [0, 1, 2, 1, 0, 1, 2, 1, 0]}, "class"),
    ("cross_entropy", "cross_entropy", {}, "probability"),
    ("cross_entropy_lambda", "cross_entropy_lambda", {}, "probability"),
]


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("case,name,extra,kind", METRICS,
                         ids=[m[0] for m in METRICS])
def test_metric_matches_jax(jm, case, name, extra, kind, weighted):
    from lightgbm_tpu.config import Config as JConfig
    rng = np.random.RandomState(len(case) + 3 * weighted)
    label, score = _inputs(kind, rng)
    weight = (rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted
              else None)
    params = dict(CFG, **extra)
    (want,) = jm.create_metric(name, JConfig(params))
    (got,) = PM.create_metric(name, PConfig(params))
    assert (got.name, got.higher_better) == (want.name, want.higher_better)
    w, g = want(label, score, weight), got(label, score, weight)
    assert np.isfinite(g)
    assert g == pytest.approx(w, rel=1e-12, abs=0.0)


OBJECTIVES = ["regression", "regression_l1", "huber", "fair", "poisson",
              "quantile", "mape", "gamma", "tweedie", "binary",
              "multiclass", "multiclassova", "cross_entropy",
              "cross_entropy_lambda", "lambdarank", "rank_xendcg", "custom"]


def test_default_metric_for_objective_matches_jax(jm):
    for obj in OBJECTIVES:
        assert (PM.default_metric_for_objective(obj)
                == jm.default_metric_for_objective(obj)), obj


@pytest.mark.parametrize("params", [
    {"objective": "regression"},
    {"objective": "regression_l1", "metric": ["l2", "mae", "rmse"]},
    {"objective": "binary", "metric": "auc,binary_error,binary"},
    {"objective": "multiclass", "num_class": 3,
     "metric": ["multiclass", "multi_error", "auc_mu"]},
    {"objective": "multiclassova", "num_class": 3},
    {"objective": "cross_entropy", "metric": ["xentropy", "xentlambda"]},
    {"objective": "huber", "metric": ["none"]},
    {"objective": "quantile", "metrics": ["quantile", "custom", "mape"]},
], ids=["default", "list", "string", "multiclass", "ova", "aliases",
        "none", "placeholder"])
def test_metrics_for_config_matches_jax(jm, params):
    from lightgbm_tpu.config import Config as JConfig
    want = jm.metrics_for_config(JConfig(params))
    got = PM.metrics_for_config(PConfig(params))
    assert ([(m.name, m.higher_better) for m in got]
            == [(m.name, m.higher_better) for m in want])


def test_ranking_metrics_raise_naming_a82(jm):
    """The ranking metrics, which raised naming A8.2 until slice 13, now
    resolve as the JAX package's do: one metric per eval_at position
    (tests/test_torch_ranking.py holds their values)."""
    from lightgbm_tpu.config import Config as JConfig
    for name in ("ndcg", "map", "lambdarank", "mean_average_precision"):
        for params in ({}, {"eval_at": [2, 7]}):
            got = PM.create_metric(name, PConfig(params))
            want = jm.create_metric(name, JConfig(params))
            assert ([(m.name, m.higher_better) for m in got]
                    == [(m.name, m.higher_better) for m in want])
    with pytest.raises(ValueError, match="unknown metric"):
        PM.create_metric("no_such_metric", PConfig({}))
