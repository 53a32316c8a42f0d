"""Model text loading (``Booster(model_file=...)`` / ``model_str``) and
continued training (``train(init_model=...)``) against the JAX package.

- ``tests/fixtures/ref_model.txt`` (genuine LightGBM: binary, 20 trees of
  15 leaves, 28 features) loads in both packages: the raw scores on
  ``ref_rows.tsv`` are bitwise equal, the probabilities within 1e-6 of
  the genuine binary's ``ref_preds_50.txt``, and ``to_string()`` is byte
  for byte the JAX ``LoadedModel.to_string``'s.
- Texts the JAX package trains here at small size load and predict
  bitwise like its loader: 3-class multiclass, a one-hot categorical
  split, NaN and zero missing types, slices by ``start_iteration`` /
  ``num_iteration`` and ``pred_early_stop``.  A linear tree is held to
  1e-12 absolute: its leaves' ``x . coeff`` sums over at most the tree's
  features in another order than numpy's dot.
- A loaded ``Booster`` predicts (``raw_score``, slices,
  ``predict_disable_shape_check``), evaluates with its config's metrics,
  reports its trees, features and importances, saves and reloads to the
  same bits; ``serving_predictor`` raises ``ValueError`` for a loaded and
  a continuation booster, as the JAX package's ``Predictor`` does, and
  refit / ``pred_leaf`` / ``pred_contrib`` name A8.9 / A8.10.
- Continued training: the folded init scores are bitwise JAX's (binary,
  and 3-class in their (N, K) layout); one exact-sum iteration (L2,
  dyadic labels, ``boost_from_average=false``, a hand-written base text
  with dyadic leaves: every gradient sum exact in float32) gives the JAX
  package's model text byte for byte; five ordinary iterations, binary
  and 3-class, predict within 1e-4 of the JAX continuation (the
  ten-iteration bar of test_torch_train.py); the caller's Dataset keeps
  its init score, and the constructed bins are kept, equal to a fresh
  construct's; the saved text holds the base trees verbatim first.

On the card (``cuda`` marker) the loaded walk gives the CPU walk's bits,
and the exact-sum continuation gives the CPU model text byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, higgs_like  # noqa: F401

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.serialization import load_model_string
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
REF_MODEL = os.path.join(FIX, "ref_model.txt")


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


@pytest.fixture(scope="module")
def JS(lgb):
    from lightgbm_tpu import serialization
    return serialization


def _ref_rows():
    data = np.loadtxt(os.path.join(FIX, "ref_rows.tsv"), delimiter="\t")
    return data[:, 1:], data[:, 0]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def test_genuine_model_loads_bitwise_like_jax(JS):
    X, _y = _ref_rows()
    with open(REF_MODEL) as fh:
        text = fh.read()
    jm = JS.load_model_string(text)
    bst = lgt.Booster(model_file=REF_MODEL, device="cpu")
    assert bst.num_trees() == 20 and bst.num_feature() == 28
    assert bst.current_iteration == 20
    assert _bits_equal(bst.predict(X, raw_score=True), jm.predict_raw(X))
    ref = np.loadtxt(os.path.join(FIX, "ref_preds_50.txt"))
    np.testing.assert_allclose(bst.predict(X), ref, rtol=0, atol=1e-6)
    assert bst.model_to_string() == jm.to_string()
    np.testing.assert_array_equal(bst.feature_importance("split"),
                                  jm.feature_importance("split"))
    np.testing.assert_array_equal(bst.feature_importance("gain"),
                                  jm.feature_importance("gain"))
    again = lgt.Booster(model_str=bst.model_to_string(), device="cpu")
    assert _bits_equal(again.predict(X, raw_score=True),
                       bst.predict(X, raw_score=True))
    for kw in ({"num_iteration": 7}, {"start_iteration": 5},
               {"start_iteration": 3, "num_iteration": 4},
               {"pred_early_stop": True, "pred_early_stop_freq": 2,
                "pred_early_stop_margin": 0.3}):
        want = jm.predict_raw(X, **kw)
        assert _bits_equal(bst.predict(X, raw_score=True, **kw), want), kw


def test_loading_without_device_raises_here(monkeypatch):
    """``Booster(model_file=...)`` runs on the card unless given
    ``device="cpu"``: with no card it raises, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lgt.Booster(model_file=REF_MODEL)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model_string("tree\nnum_class=1\nend of trees\n")


def _messy(n=2000, seed=0):
    """NaNs, zeros, a categorical column (3) and a numerical one."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n) < 0.15, 0] = np.nan
    X[rng.rand(n) < 0.3, 1] = 0.0
    X[:, 3] = rng.randint(0, 4, n)
    y = ((X[:, 3] == 2) ^ (np.nan_to_num(X[:, 0]) > 0.3)
         ^ (X[:, 1] > 0.5)).astype(np.float64)
    return X, y


#: JAX-trained models: name -> (params, rounds, labels)
JAX_MODELS = {
    "multiclass": ({"objective": "multiclass", "num_class": 3}, 3, "3"),
    "categorical": ({"objective": "binary", "categorical_feature": "3",
                     "max_cat_to_onehot": 8}, 4, "2"),
    "nan_missing": ({"objective": "binary"}, 4, "2"),
    "zero_missing": ({"objective": "binary", "zero_as_missing": True}, 4,
                     "2"),
    "regression_sqrt": ({"objective": "regression", "reg_sqrt": True}, 3,
                        "r"),
}


def _jax_model(lgb, name):
    params, rounds, labels = JAX_MODELS[name]
    X, y = _messy()
    if labels == "3":
        y = (y + (X[:, 2] > 0.7)).astype(np.float64)
    elif labels == "r":
        y = np.abs(X[:, 2]) * 3 + y
    params = dict(params, num_leaves=15, verbosity=-1, min_data_in_leaf=5)
    return lgb.train(params, lgb.Dataset(X, label=y), rounds), X


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_jax_trained_text_loads_bitwise(lgb, JS, name):
    jb, X = _jax_model(lgb, name)
    text = jb.model_to_string()
    jm = JS.load_model_string(text)
    pm = load_model_string(text, device="cpu")
    Xt = X[:700].copy()
    Xt[::7, 2] = np.nan
    Xt[::11, 3] = 9.0                     # unseen category
    Xt[::13, 1] = -0.0
    assert _bits_equal(pm.predict_raw(Xt), jm.predict_raw(Xt))
    assert _bits_equal(pm.predict_raw(Xt, start_iteration=1,
                                      num_iteration=1),
                       jm.predict_raw(Xt, start_iteration=1,
                                      num_iteration=1))
    es = {"pred_early_stop": True, "pred_early_stop_freq": 1,
          "pred_early_stop_margin": 0.2}
    assert _bits_equal(pm.predict_raw(Xt, **es), jm.predict_raw(Xt, **es))
    assert pm.to_string() == jm.to_string()
    if name == "zero_missing":
        dt = np.concatenate([t.decision_type for t in pm.trees])
        assert ((dt >> 2) & 3 == 1).any()
    if name == "categorical":
        assert any(t.cat_boundaries is not None for t in pm.trees)
    if name != "regression_sqrt":
        # the objective's transform in float32 on the loaded raw scores
        np.testing.assert_allclose(pm.predict(Xt), jb.predict(Xt),
                                   rtol=0, atol=2e-7)
    else:
        np.testing.assert_allclose(pm.predict(Xt), jb.predict(Xt),
                                   rtol=1e-6)


def test_linear_tree_text_loads_within_tolerance(lgb, JS):
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 4)
    X[rng.rand(2000) < 0.05, 1] = np.nan
    y = 2 * X[:, 0] - np.nan_to_num(X[:, 1]) + 0.1 * rng.randn(2000)
    jb = lgb.train({"objective": "regression", "num_leaves": 7,
                    "linear_tree": True, "verbosity": -1,
                    "min_data_in_leaf": 20}, lgb.Dataset(X, label=y), 3)
    text = jb.model_to_string()
    assert "is_linear=1" in text
    jm = JS.load_model_string(text)
    pm = load_model_string(text, device="cpu")
    want = jm.predict_raw(X)
    got = pm.predict_raw(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert pm.to_string() == jm.to_string()


def test_loaded_booster_surface(lgb, tmp_path):
    X, y = _messy(2000, seed=1)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "metric": "auc,binary_logloss"}
    jb = lgb.train(params, lgb.Dataset(X, label=y), 5)
    path = str(tmp_path / "model.txt")
    jb.save_model(path)
    bst = lgt.Booster(model_file=path, device="cpu")
    assert (bst.num_trees(), bst.current_iteration) == (5, 5)
    assert bst.num_model_per_iteration() == 1
    assert bst.feature_name() == [f"Column_{i}" for i in range(5)]
    raw = bst.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, jb.predict(X, raw_score=True),
                               rtol=0, atol=1e-6)
    # extra columns are dropped, missing ones padded with NaN on request
    with pytest.raises(ValueError, match="features"):
        bst.predict(X[:, :4])
    wide = np.column_stack([X, np.ones(len(X))])
    assert _bits_equal(bst.predict(wide, predict_disable_shape_check=True),
                       bst.predict(X))
    short = bst.predict(X[:, :4], raw_score=True,
                        predict_disable_shape_check=True)
    padded = np.column_stack([X[:, :4], np.full(len(X), np.nan)])
    assert _bits_equal(short, bst.predict(padded, raw_score=True))
    evals = dict((m, v) for _n, m, v, _hb in bst.eval(
        lgt.Dataset(X, label=y), "data"))
    want = dict((m, v) for _n, m, v, _hb in lgb.Booster(
        model_file=path).eval(lgb.Dataset(X, label=y), "data"))
    assert evals.keys() == want.keys()
    for m in want:
        assert abs(evals[m] - want[m]) < 1e-6, m
    out = str(tmp_path / "again.txt")
    bst.save_model(out)
    again = lgt.Booster(model_file=out, device="cpu")
    assert _bits_equal(again.predict(X, raw_score=True), raw)
    with pytest.raises(ValueError, match="bin mappers"):
        bst.serving_predictor()
    with pytest.raises(NotImplementedError, match="A8.9"):
        bst.refit(X, y)
    for kw, item in (({"pred_leaf": True}, "A8.10"),
                     ({"pred_contrib": True}, "A8.10")):
        with pytest.raises(NotImplementedError, match=item):
            bst.predict(X, **kw)
    with pytest.raises(ValueError, match="trained booster"):
        bst.update()


# ---------------------------------------------------------- continuation
#: a hand-written L2 base model with dyadic leaves (and one categorical
#: split on feature 3): with dyadic labels every gradient sum is exact
BASE_TEXT = """tree
version=v4
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=3
objective=regression
feature_names=Column_0 Column_1 Column_2 Column_3
feature_infos=none none none none

Tree=0
num_leaves=4
num_cat=1
split_feature=0 1 3
split_gain=4 2 1
threshold=0 0.5 0
decision_type=2 2 1
left_child=-1 2 -3
right_child=1 -2 -4
leaf_value=0.25 -0.5 0.75 -0.125
leaf_weight=1 1 1 1
leaf_count=1 1 1 1
internal_value=0 0 0
internal_count=4 3 2
cat_boundaries=0 1
cat_threshold=10
is_linear=0
shrinkage=1


end of trees
"""


def _dyadic(n=3 * 2560, seed=11):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    X[:, 3] = rng.randint(0, 5, n)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = rng.randint(-8, 9, n) / 4.0
    return X, y


EXACT_L2 = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
            "boost_from_average": False, "tpu_leaf_batch": 4,
            "min_data_in_leaf": 20}


def test_exact_sum_continuation_text_byte_equal(lgb, JS, tmp_path):
    X, y = _dyadic()
    path = str(tmp_path / "base.txt")
    with open(path, "w") as fh:
        fh.write(BASE_TEXT)
    jb = lgb.train(EXACT_L2, lgb.Dataset(X, label=y), 1, init_model=path)
    ds = lgt.Dataset(X, label=y)
    pb = lgt.train(EXACT_L2, ds, 1, init_model=path, device="cpu")
    assert ds.init_score is None
    assert _bits_equal(pb._gbdt.train_data.init_score,
                       jb._gbdt.train_data.init_score)
    text = pb.model_to_string()
    assert text == jb.model_to_string()
    assert pb.num_trees() == 2 and pb.current_iteration == 2
    assert text.split("Tree=1")[0].split("Tree=0")[1] == (
        BASE_TEXT.split("Tree=0")[1].split("end of trees")[0]
        .replace("leaf_weight=1 1 1 1\nleaf_count=1 1 1 1\n", "")
        .replace("is_linear=0\n", "").rstrip("\n") + "\n\n")
    # continuation of a loaded model object and of a Booster, alike
    for init in (load_model_string(BASE_TEXT, device="cpu"),
                 lgt.Booster(model_str=BASE_TEXT, device="cpu")):
        again = lgt.train(EXACT_L2, lgt.Dataset(X, label=y), 1,
                          init_model=init, device="cpu")
        assert again.model_to_string() == text


def test_continuation_keeps_bins_and_caller_init_score():
    X, y = _dyadic(4000, seed=2)
    base = lgt.train(EXACT_L2, lgt.Dataset(X, label=y), 2, device="cpu")
    own = np.full(len(y), 0.5)
    ds = lgt.Dataset(X, label=y, init_score=own)
    td = ds.construct(EXACT_L2)
    dv = lgt.Dataset(X[:500], label=y[:500], reference=ds)
    bst = lgt.train(EXACT_L2, ds, 2, init_model=base, valid_sets=[dv],
                    device="cpu")
    assert ds.init_score is own and ds._train_data is td
    assert dv.init_score is None
    folded = bst._gbdt.train_data
    assert folded.binned is td.binned          # the bins were kept
    fresh = lgt.Dataset(X, label=y).construct(EXACT_L2)
    assert _bits_equal(folded.binned.bins, fresh.binned.bins)
    # the base model's text walked in float64, added to the caller's
    walked = load_model_string(base.model_to_string(), device="cpu")
    assert _bits_equal(folded.init_score, own + walked.predict_raw(X))
    # the valid set binned with the copy's mappers, scored from its own
    # folded init score
    assert bst._gbdt.valids[0][1].binned.mappers is td.binned.mappers
    np.testing.assert_allclose(
        bst._gbdt.valid_scores[0].numpy(),
        bst.predict(X[:500], raw_score=True), rtol=0, atol=1e-5)


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_five_continued_iterations_track_jax(lgb, objective):
    X, y = higgs_like(2000, 8, seed=5)
    # min_gain_to_split and min_data_in_leaf keep every split's gain clear
    # of float32 noise (pure-class leaves), so near-ties cannot flip
    # between the packages' summation orders
    params = {"objective": objective, "num_leaves": 15, "verbosity": -1,
              "tpu_leaf_batch": 4, "min_gain_to_split": 1.0,
              "min_data_in_leaf": 40}
    if objective == "multiclass":
        y = (y + (X[:, 2] > 0.5)).astype(np.float64)
        params["num_class"] = 3
    jbase = lgb.train(params, lgb.Dataset(X, label=y), 3)
    text = jbase.model_to_string()
    jb = lgb.train(params, lgb.Dataset(X, label=y), 5,
                   init_model=lgb.Booster(model_str=text))
    pb = lgt.train(params, lgt.Dataset(X, label=y), 5,
                   init_model=lgt.Booster(model_str=text, device="cpu"),
                   device="cpu")
    # (N, K) folded scores in the JAX package's layout, bit for bit
    assert _bits_equal(pb._gbdt.train_data.init_score,
                       jb._gbdt.train_data.init_score)
    assert pb.num_trees() == jb.num_trees() == 8 * (
        3 if objective == "multiclass" else 1)
    assert pb.current_iteration == jb.current_iteration == 8
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pb.predict(X, num_iteration=3,
                                          raw_score=True),
                               jbase.predict(X, raw_score=True), rtol=0,
                               atol=1e-12)
    text_p = pb.model_to_string()
    k = 3 if objective == "multiclass" else 1
    head = text_p.split(f"Tree={3 * k}\n")[0]
    assert head.split("Tree=0\n")[1] == jb.model_to_string().split(
        f"Tree={3 * k}\n")[0].split("Tree=0\n")[1]
    reloaded = lgt.Booster(model_str=text_p, device="cpu")
    np.testing.assert_allclose(reloaded.predict(X, raw_score=True),
                               pb.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(
        pb.feature_importance(),
        jbase.feature_importance() + pb._gbdt.feature_importance()
        - jbase.feature_importance())
    with pytest.raises(ValueError, match="continuation"):
        pb.serving_predictor()


def test_continuation_early_stopping_counts_combined_iterations():
    X, y = higgs_like(3000, 6, seed=8)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "learning_rate": 0.5, "metric": "binary_logloss"}
    base = lgt.train(params, lgt.Dataset(X[:2000], label=y[:2000]), 4,
                     device="cpu")
    ds = lgt.Dataset(X[:2000], label=y[:2000])
    dv = lgt.Dataset(X[2000:], label=y[2000:], reference=ds)
    bst = lgt.train(dict(params, early_stopping_round=2), ds, 60,
                    valid_sets=[dv], init_model=base, device="cpu")
    own = bst._gbdt.iter_
    assert own < 60
    assert bst.best_iteration == 4 + own - 2
    assert bst.current_iteration == 4 + own


@pytest.mark.cuda
def test_card_loaded_walk_matches_cpu(cuda_device):
    X, _y = _ref_rows()
    rows = np.concatenate([X] * 40)
    rows[::5, 3] = np.nan
    want = lgt.Booster(model_file=REF_MODEL, device="cpu")
    got = lgt.Booster(model_file=REF_MODEL, device=cuda_device)
    assert _bits_equal(got.predict(rows, raw_score=True),
                       want.predict(rows, raw_score=True))
    es = {"pred_early_stop": True, "pred_early_stop_freq": 3}
    assert _bits_equal(got.predict(rows, raw_score=True, **es),
                       want.predict(rows, raw_score=True, **es))


@pytest.mark.cuda
def test_card_exact_sum_continuation_matches_cpu(cuda_device):
    X, y = _dyadic()
    want = lgt.train(EXACT_L2, lgt.Dataset(X, label=y), 1,
                     init_model=load_model_string(BASE_TEXT, device="cpu"),
                     device="cpu")
    got = lgt.train(EXACT_L2, lgt.Dataset(X, label=y), 1,
                    init_model=load_model_string(BASE_TEXT,
                                                 device=cuda_device),
                    device=cuda_device)
    assert got.model_to_string() == want.model_to_string()
    assert torch.equal(got._gbdt.scores.cpu(), want._gbdt.scores)
