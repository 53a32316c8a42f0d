"""Callback and evaluation parity: ``lightgbm_tpu_torch.callback`` and
``train(valid_sets=..., callbacks=..., feval=...)`` against the JAX
package's on the same numpy inputs from a seed.

- ``early_stopping``: the JAX and port callbacks, fed the same evaluation
  lists, raise the same ``EarlyStopException`` (best iteration and score
  list) at the same round and print the same lines, for lower- and
  higher-is-better metrics, ``first_metric_only``, ``min_delta``, a
  training entry, and a run that ends without a stop;
  ``log_evaluation``, ``record_evaluation`` and ``reset_parameter`` give
  the same output, record and parameter stream, with the same ``order``
  and ``eval_period`` attributes.
- ``train`` with a valid set and ``early_stopping_round`` in params
  (L2, and 3-class multiclass with two metrics and
  ``first_metric_only``): the recorded eval history is within 1e-6
  of the JAX package's, ``best_iteration`` and the history's length are
  equal, ``predict`` stops at ``best_iteration`` (bit for bit
  ``predict(num_iteration=best_iteration)``) and predicts within 1e-4
  of the JAX package's booster.
- ``Dataset(reference=...)`` (and ``create_valid``) bins the valid rows
  byte for byte like the JAX package's; a valid set built without a
  reference is binned with the training mappers all the same (a
  deliberate difference: the JAX package bins it with its own).
- ``feval``, ``eval_train`` (``is_provide_training_metric``),
  ``eval_valid``, ``Booster.eval`` and ``add_valid`` agree with each
  other and with the JAX package; a callable ``objective`` trains like
  ``Booster.update(fobj=...)``, which takes (N, K) gradients for K
  classes; ``resume_from``, checkpoint params and refit raise, naming
  their ROADMAP items, ``init_model`` continues training and ``cv``
  trains."""

import contextlib
import io

import numpy as np
import pytest

from torch_port_util import higgs_like

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import callback as PC


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


def _eval_lists(rng, rounds, metrics, names=("valid_0",)):
    """Per-round evaluation lists: a noisy trend per (set, metric)."""
    out = []
    for it in range(rounds):
        res = []
        for nm in names:
            for metric, hb in metrics:
                trend = (it if hb else -it) * 0.01
                dip = 0.05 if (it > rounds // 3 and not hb) else 0.0
                res.append((nm, metric,
                            float(np.round(trend + dip + rng.rand() * 0.02,
                                           3)), hb))
        out.append(res)
    return out


def _run_callback(cb, model, lists):
    """Feed ``lists`` round by round; (stop round, best iteration, best
    score list, printed text), stop round None when none raised."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for it, evals in enumerate(lists):
            try:
                cb(model.CallbackEnv(None, {}, it, 0, len(lists), evals))
            except model.EarlyStopException as e:
                return it, e.best_iteration, e.best_score, buf.getvalue()
    return None, None, None, buf.getvalue()


ES_CASES = [
    ("l2", dict(stopping_rounds=5), [("l2", False)], ("valid_0",)),
    ("auc", dict(stopping_rounds=3), [("auc", True)], ("valid_0",)),
    ("two_metrics", dict(stopping_rounds=4),
     [("l2", False), ("auc", True)], ("valid_0",)),
    ("first_metric_only", dict(stopping_rounds=4, first_metric_only=True),
     [("l2", False), ("auc", True)], ("valid_0",)),
    ("min_delta", dict(stopping_rounds=3, min_delta=0.01),
     [("l1", False)], ("valid_0",)),
    ("training_entry", dict(stopping_rounds=3), [("l2", False)],
     ("training", "valid_0")),
    ("no_stop", dict(stopping_rounds=100), [("l2", False)], ("valid_0",)),
]


@pytest.mark.parametrize("case,kwargs,metrics,names", ES_CASES,
                         ids=[c[0] for c in ES_CASES])
def test_early_stopping_matches_jax(lgb, case, kwargs, metrics, names):
    from lightgbm_tpu import callback as JCB
    lists = _eval_lists(np.random.RandomState(len(case)), 30, metrics,
                        names)
    want = _run_callback(JCB.early_stopping(**kwargs), JCB, lists)
    got = _run_callback(PC.early_stopping(**kwargs), PC, lists)
    assert got == want
    assert want[0] is not None      # every case ends with the exception


def test_log_record_and_reset_callbacks_match_jax(lgb):
    from lightgbm_tpu import callback as JCB
    lists = _eval_lists(np.random.RandomState(3), 6,
                        [("l2", False), ("auc", True)])
    for mod_j, mod_p in ((JCB.log_evaluation(2), PC.log_evaluation(2)),
                         (JCB.log_evaluation(0), PC.log_evaluation(0))):
        assert (mod_p.order, mod_p.eval_period) == (mod_j.order,
                                                    mod_j.eval_period)
        assert _run_callback(mod_p, PC, lists) == _run_callback(
            mod_j, JCB, lists)
    rec_j, rec_p = {}, {}
    _run_callback(JCB.record_evaluation(rec_j), JCB, lists)
    _run_callback(PC.record_evaluation(rec_p), PC, lists)
    assert rec_p == rec_j
    with pytest.raises(TypeError):
        PC.record_evaluation([])

    class Model:
        def __init__(self):
            self.seen = []

        def reset_parameter(self, params):
            self.seen.append(params)

    lr = [0.1 * 0.9 ** i for i in range(6)]
    seen = []
    for mod in (JCB, PC):
        cb = mod.reset_parameter(learning_rate=lr,
                                 num_leaves=lambda i: 10 + i)
        assert cb.before_iteration and cb.order == 10
        model = Model()
        for it in range(6):
            cb(mod.CallbackEnv(model, {}, it, 0, 6, None))
        seen.append(model.seen)
    assert seen[0] == seen[1]


def _train_data(case):
    X, _ = higgs_like(2500, 8, seed=2)
    Xv, _ = higgs_like(800, 8, seed=9)
    rng = np.random.RandomState(1)
    t = X[:, :3].sum(1) + rng.randn(len(X))
    tv = Xv[:, :3].sum(1) + rng.randn(len(Xv))
    if case == "l2":
        return X, t, Xv, tv, {"objective": "regression"}
    y = np.digitize(t, [-0.7, 0.7]).astype(np.float64)
    yv = np.digitize(tv, [-0.7, 0.7]).astype(np.float64)
    return X, y, Xv, yv, {"objective": "multiclass", "num_class": 3,
                          "metric": ["multi_logloss", "multi_error"],
                          "first_metric_only": True}


@pytest.mark.parametrize("case", ["l2", "multiclass"])
def test_train_valid_set_early_stopping_matches_jax(lgb, case):
    X, y, Xv, yv, obj = _train_data(case)
    # min_gain_to_split and min_data_in_leaf keep every split's gain
    # clear of float32 noise, so near-ties cannot flip between the
    # packages' summation orders
    params = dict(obj, num_leaves=15, learning_rate=0.5, verbosity=-1,
                  tpu_leaf_batch=4, early_stopping_round=3,
                  min_gain_to_split=1.0, min_data_in_leaf=40)
    runs = []
    for mod, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        ds = mod.Dataset(X, label=y)
        hist = {}
        bst = mod.train(params, ds, 60,
                        valid_sets=[mod.Dataset(Xv, label=yv, reference=ds)],
                        valid_names=["holdout"],
                        callbacks=[mod.record_evaluation(hist)], **kw)
        runs.append((bst, hist))
    (jb, jh), (pb, ph) = runs
    assert pb.best_iteration == jb.best_iteration
    assert 0 < pb.best_iteration < pb.current_iteration < 60
    assert list(ph["holdout"]) == list(jh["holdout"])
    for metric, values in jh["holdout"].items():
        assert len(ph["holdout"][metric]) == len(values)
        np.testing.assert_allclose(ph["holdout"][metric], values,
                                   rtol=1e-6, atol=1e-6)
    first = list(jh["holdout"])[0]
    assert pb.best_iteration == 1 + int(np.argmin(ph["holdout"][first]))
    assert [e[:2] for e in pb.best_score] == [e[:2] for e in jb.best_score]
    raw = pb.predict(Xv, raw_score=True)
    np.testing.assert_array_equal(
        raw, pb.predict(Xv, raw_score=True,
                        num_iteration=pb.best_iteration))
    assert not np.array_equal(raw, pb.predict(
        Xv, raw_score=True, num_iteration=pb.current_iteration))
    np.testing.assert_allclose(raw, jb.predict(Xv, raw_score=True),
                               atol=1e-4)
    np.testing.assert_allclose(pb.predict(Xv), jb.predict(Xv), atol=1e-4)


def test_reference_dataset_bins_match_jax(lgb):
    X, y, Xv, yv, _ = _train_data("l2")
    Xv = Xv.astype(np.float64)
    Xv[::7, 2] = np.nan
    Xv[::5, 3] = 50.0          # beyond every training bound
    params = {"max_bin": 63, "verbosity": -1}
    jd, pd = lgb.Dataset(X, label=y), lgt.Dataset(X, label=y)
    jv = lgb.Dataset(Xv, label=yv, reference=jd).construct(params)
    pv = lgt.Dataset(Xv, label=yv, reference=pd).construct(params)
    assert pv.binned.bins.dtype == jv.binned.bins.dtype
    np.testing.assert_array_equal(pv.binned.bins, jv.binned.bins)
    assert pv.binned.mappers is pd.construct(params).binned.mappers
    pc = pd.create_valid(Xv, label=yv).construct(params)
    np.testing.assert_array_equal(pc.binned.bins, jv.binned.bins)


def test_set_label_keeps_bins_and_trains_like_a_fresh_dataset():
    """``set_label`` on a constructed dataset keeps its bins and device
    copies (binning does not read the label) and trains the model a fresh
    dataset of the new labels trains; a valid set keeps its reference."""
    X, y, Xv, yv, obj = _train_data("l2")
    params = dict(obj, num_leaves=7, verbosity=-1)
    ds = lgt.Dataset(X, label=np.zeros(len(y)))
    dv = lgt.Dataset(Xv, label=np.zeros(len(yv)), reference=ds)
    lgt.train(params, ds, 1, valid_sets=[dv], device="cpu")
    bins = ds.construct().binned
    ds.set_label(y)
    dv.set_label(yv)
    assert ds.construct().binned is bins
    hist, fresh_hist = {}, {}
    got = lgt.train(params, ds, 3, valid_sets=[dv], device="cpu",
                    callbacks=[lgt.record_evaluation(hist)])
    fresh = lgt.Dataset(X, label=y)
    want = lgt.train(params, fresh, 3, device="cpu",
                     valid_sets=[lgt.Dataset(Xv, label=yv, reference=fresh)],
                     callbacks=[lgt.record_evaluation(fresh_hist)])
    assert got.model_to_string() == want.model_to_string()
    assert hist == fresh_hist
    with pytest.raises(ValueError, match="finite"):
        ds.set_label(np.full(len(y), np.nan))


def test_valid_set_without_reference_uses_training_mappers():
    X, y, Xv, yv, obj = _train_data("l2")
    params = dict(obj, num_leaves=7, verbosity=-1)
    hists = []
    for ref in (True, False):
        ds = lgt.Dataset(X, label=y)
        vs = lgt.Dataset(Xv, label=yv, reference=ds if ref else None)
        hist = {}
        lgt.train(params, ds, 4, valid_sets=[vs], device="cpu",
                  callbacks=[lgt.record_evaluation(hist)])
        hists.append(hist)
    assert hists[0] == hists[1]
    ds = lgt.Dataset(X, label=y)
    built = lgt.Dataset(Xv, label=yv)
    built.construct(params)      # binned with its own mappers already
    with pytest.raises(ValueError, match="reference"):
        lgt.train(params, ds, 1, valid_sets=[built], device="cpu")


def test_feval_eval_methods_and_add_valid(lgb):
    X, y, Xv, yv, obj = _train_data("l2")
    params = dict(obj, num_leaves=7, verbosity=-1, metric=["l2", "l1"],
                  is_provide_training_metric=True)

    def feval(raw, data):
        return ("max_err", float(np.abs(raw - data.label).max()), False)

    runs = []
    for mod, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        ds = mod.Dataset(X, label=y)
        vs = mod.Dataset(Xv, label=yv, reference=ds)
        hist = {}
        bst = mod.train(params, ds, 5, valid_sets=[ds, vs], feval=feval,
                        callbacks=[mod.record_evaluation(hist)], **kw)
        runs.append((bst, hist, vs))
    (jb, jh, jv), (pb, ph, pv) = runs
    assert list(ph) == list(jh) == ["training", "valid_1"]
    for name in jh:
        assert list(ph[name]) == list(jh[name]) == ["l2", "l1", "max_err"]
        for metric in jh[name]:
            np.testing.assert_allclose(ph[name][metric], jh[name][metric],
                                       rtol=1e-6, atol=1e-6)
    train_evals = pb.eval_train(feval)
    assert [e[:2] for e in train_evals] == [("training", "l2"),
                                           ("training", "l1"),
                                           ("training", "max_err")]
    valid = pb.eval_valid()
    assert [e[1] for e in valid] == ["l2", "l1"]
    # Booster.eval recomputes the scores from the rows (f64 sums)
    direct = pb.eval(pv, "again")
    for (_, m, v, hb), (_, m2, v2, hb2) in zip(valid, direct):
        assert (m, hb) == (m2, hb2) and v2 == pytest.approx(v, rel=1e-6)
    jdirect = jb.eval(jv, "again")
    for got, want in zip(direct, jdirect):
        assert got[:2] == want[:2] and got[2] == pytest.approx(want[2],
                                                               rel=1e-6)
    # a valid set added after training starts from the model's scores
    pb.add_valid(lgt.Dataset(Xv, label=yv, reference=pb.train_set),
                 "added")
    np.testing.assert_array_equal(pb._gbdt.valid_scores[-1].numpy(),
                                  pb._gbdt.valid_scores[0].numpy())
    assert [e[2] for e in pb.eval_valid() if e[0] == "added"] == [
        e[2] for e in pb.eval_valid() if e[0] == "valid_1"]


def test_callable_objective_trains_like_fobj():
    X, y, _, _, _ = _train_data("l2")

    def l2(preds, data):
        return preds - data.get_label(), np.ones_like(preds)

    params = {"num_leaves": 7, "verbosity": -1}
    a = lgt.train(dict(params, objective=l2), lgt.Dataset(X, label=y), 3,
                  device="cpu")
    ds = lgt.Dataset(X, label=y)
    b = lgt.Booster(dict(params, objective="custom"), ds, device="cpu")
    for _ in range(3):
        b.update(fobj=l2)
    assert a.model_to_string() == b.model_to_string()
    np.testing.assert_array_equal(a.predict(X), a.predict(X,
                                                          raw_score=True))


def test_multiclass_fobj_on_class_columns():
    """``update(fobj=...)`` hands a K-class objective (N, K) raw scores and
    takes (N, K) gradients: the softmax objective's own gradients through
    fobj grow the built-in objective's trees."""
    import torch
    X, y, _, _, obj = _train_data("multiclass")
    params = dict(obj, num_leaves=7, verbosity=-1, boost_from_average=False)
    want = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    softmax = want._gbdt.objective

    def fobj(preds, data):
        assert preds.shape == (len(X), 3)
        g, h = softmax.get_gradients(torch.from_numpy(preds))
        return g.numpy(), h.numpy()

    got = lgt.Booster(dict(params, objective="custom"),
                      lgt.Dataset(X, label=y), device="cpu")
    for _ in range(3):
        got.update(fobj=fobj)
    trees = lambda b: b.model_to_string().split("end of trees")[0].split(
        "Tree=0", 1)[1]
    assert got.num_model_per_iteration() == 3
    assert trees(got) == trees(want)


def test_later_train_options_raise():
    X, y, _, _, obj = _train_data("l2")
    params = dict(obj, verbosity=-1)
    with pytest.raises(NotImplementedError, match="A11"):
        lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu",
                  resume_from="ckpt")
    # init_model continues training (slice 12); refit stays later work
    base = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    cont = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu",
                     init_model=base)
    assert cont.current_iteration == 2
    with pytest.raises(NotImplementedError, match="A8.9"):
        cont.refit(X, y)
    with pytest.raises(NotImplementedError, match="A11"):
        lgt.train(dict(params, checkpoint_interval=5),
                  lgt.Dataset(X, label=y), 1, device="cpu")
    # cv trains (slice 13; tests/test_torch_cv.py holds it to the JAX
    # package's)
    res = lgt.cv(params, lgt.Dataset(X, label=y), 2, nfold=2, device="cpu")
    assert sorted(res) == ["valid l2-mean", "valid l2-stdv"]
    assert len(res["valid l2-mean"]) == 2
