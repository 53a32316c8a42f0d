"""``lightgbm_tpu_torch.cv`` against the JAX package's ``cv`` on the CPU.

- The same keys (``"valid <metric>-mean"`` / ``"-stdv"``) and per-round
  values within 1e-3 (means) and 2e-3 (standard deviations) of the JAX
  package's: regression (shuffled folds), stratified binary, and
  query-aware lambdarank folds (whole queries, ``ndcg@k``); the folds are
  cut by the same numpy stream, so each fold holds the same rows.
- ``folds=`` (the caller's index pairs) and ``return_cv_booster``
  (``"cvbooster"``, one trained booster a fold, on the given device).
- A text file is parsed once, before the folds are cut, and never
  binned whole; no fold booster outlives ``cv`` unless
  ``return_cv_booster`` asks for them.
- ``Dataset.subset`` bins its rows with the parent's mappers."""

import gc
import os
import weakref

import numpy as np
import pytest

from torch_port_util import higgs_like

import lightgbm_tpu_torch as lgt
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

MEAN_TOL, STDV_TOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


def _ranking_rows(seed=0, nq=40):
    rng = np.random.RandomState(seed)
    group = rng.randint(5, 25, nq)
    n = int(group.sum())
    X = rng.randn(n, 5)
    y = np.clip(np.round(X[:, 0] + 0.7 * rng.randn(n) + 1.5), 0, 4)
    return X, y, group


def _cases():
    X, y = higgs_like(1200, 6, seed=4)
    reg = X[:, 0] + 0.5 * X[:, 1] ** 2
    Xr, yr, group = _ranking_rows()
    base = {"num_leaves": 7, "verbosity": -1, "min_data_in_leaf": 10}
    return {
        "regression": (dict(base, objective="regression"), X, reg, None,
                       {"stratified": False}),
        "binary": (dict(base, objective="binary", metric="auc"), X, y, None,
                   {}),
        "lambdarank": (dict(base, objective="lambdarank", eval_at=[1, 3]),
                       Xr, yr, group, {}),
    }


@pytest.mark.parametrize("case", ["regression", "binary", "lambdarank"])
def test_cv_matches_jax(lgb, case):
    params, X, y, group, kw = _cases()[case]
    want = lgb.cv(params, lgb.Dataset(X, label=y, group=group), 4,
                  nfold=3, seed=7, **kw)
    got = lgt.cv(params, lgt.Dataset(X, label=y, group=group), 4,
                 nfold=3, seed=7, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert len(got[key]) == len(want[key]) == 4
        tol = STDV_TOL if key.endswith("-stdv") else MEAN_TOL
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=key)
    if case == "lambdarank":
        assert sorted(got) == ["valid ndcg@1-mean", "valid ndcg@1-stdv",
                               "valid ndcg@3-mean", "valid ndcg@3-stdv"]


def test_cv_folds_and_boosters(lgb):
    X, y = higgs_like(900, 5, seed=2)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "metric": ["auc", "binary_logloss"]}
    idx = np.arange(900)
    folds = [(idx[idx % 3 != i], idx[idx % 3 == i]) for i in range(3)]
    want = lgb.cv(params, lgb.Dataset(X, label=y), 3, folds=folds)
    got = lgt.cv(params, lgt.Dataset(X, label=y), 3, folds=folds,
                 return_cv_booster=True, device="cpu")
    boosters = got.pop("cvbooster")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=MEAN_TOL)
    assert len(boosters) == 3
    for b, (_tr, va) in zip(boosters, folds):
        assert isinstance(b, lgt.Booster) and b.num_trees() == 3
        assert str(b._gbdt.device) == "cpu"
        assert b._gbdt.valids[0][1].num_data == len(va)


def test_cv_text_file_and_no_kept_boosters(tmp_path):
    """A text file is parsed once (``load_rows``), never binned whole,
    and no fold booster outlives ``cv`` without ``return_cv_booster``."""
    X, y = higgs_like(600, 4, seed=5)
    path = str(tmp_path / "rows.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    seen = []

    def keep_ref(env):
        if env.iteration == 0:
            seen.append(weakref.ref(env.model))

    ds = lgt.Dataset(path)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    res = lgt.cv(params, ds, 2, nfold=2, callbacks=[keep_ref], device="cpu")
    assert sorted(res) == ["valid binary_logloss-mean",
                           "valid binary_logloss-stdv"]
    assert ds._train_data is None and ds.num_data() == 600
    gc.collect()
    assert len(seen) == 2 and all(r() is None for r in seen)
    assert os.path.exists(path)


def test_subset_bins_with_the_parent_mappers():
    """``Dataset.subset``: the rows, labels and weights at the indices,
    binned with the parent's mappers (the parent's bin rows)."""
    X, y = higgs_like(500, 4, seed=6)
    w = np.linspace(0.5, 1.5, 500)
    ds = lgt.Dataset(X, label=y, weight=w)
    idx = np.arange(0, 500, 7)
    sub = ds.subset(idx)
    full, part = ds.construct(), sub.construct()
    np.testing.assert_array_equal(part.binned.bins, full.binned.bins[idx])
    np.testing.assert_array_equal(sub.get_label(), y[idx])
    np.testing.assert_array_equal(sub.get_weight(), w[idx])
    assert part.binned.mappers is full.binned.mappers
