"""Learning-to-rank parity: ``lightgbm_tpu_torch.ranking`` and the ranking
metrics against the JAX package on the CPU.

- LambdaRank gradients and hessians equal the JAX package's
  ``LambdaRankNDCG`` within 2e-6 absolute plus 1e-5 relative (float32:
  ``exp`` and ``log2`` differ in their last bit between the libraries,
  and the pair sums run in another order): ragged queries, tied scores,
  truncation below the longest query, ``lambdarank_norm`` on and off, a
  custom ``label_gain``, sample weights, and position bias over five
  iterations (the bias vector to the same tolerance).
- XE-NDCG on the same injected gammas, to the same tolerance; the port's
  own gammas (a CPU generator's, copied to the scores' device) repeat for
  one ``objective_seed``.
- ``ndcg@k`` and ``map@k`` within 1e-12 of the JAX package's metrics.
- ``examples/lambdarank`` (``rank.train`` with its ``.query`` file)
  trains 20 iterations to ``ndcg@1,3,5`` on ``rank.test`` within 0.03
  of the JAX package's run; a ``.position`` file loads with the data
  (``tests/test_ranking.py::test_position_side_file_autoload``).
- A port ranker's model text loads in ``lightgbm_tpu.Booster`` and
  predicts its raw scores within 1e-6; a JAX ranker carried across with
  ``model_from_arrays`` predicts the JAX package's raw scores within 1e-6.
- Two runs of each objective give one model text.

On the card (``cuda`` marker), each objective's gradients repeat bit for
bit and stay within the CPU tolerance of the CPU's (XE-NDCG draws the
same gammas on both), and two lambdarank trainings give one model
text."""

import os
import shutil

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, state_from_booster  # noqa: F401

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import metrics as PM
from lightgbm_tpu_torch.config import Config as PConfig
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ranking import xendcg_grads
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "lambdarank")
ATOL, RTOL = 2e-6, 1e-5


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


def ranking_data(seed=0, nq=23, max_size=12, f=5):
    """Ragged queries (1 to max_size documents), graded labels 0-4."""
    rng = np.random.RandomState(seed)
    group = rng.randint(1, max_size + 1, nq)
    n = int(group.sum())
    X = rng.randn(n, f)
    y = np.clip(np.round(X[:, 0] + rng.randn(n) * 0.7 + 1.5), 0, 4)
    return X, y.astype(np.float64), group


def _pair(lgb, params, label, weight, group, position=None):
    """(JAX objective, port objective), both initialised."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective
    jo = jax_objective(JConfig(params))
    jo.init(label, weight, group, JConfig(params), position=position)
    po = create_objective(PConfig(params))
    po.init(label, weight, torch.device("cpu"), group=group,
            position=position)
    return jo, po


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


LAMBDARANK = {
    "default": {},
    "truncated": {"lambdarank_truncation_level": 3},
    "no_norm": {"lambdarank_norm": False},
    "label_gain": {"label_gain": [0, 1, 3, 7, 20]},
    "weighted": {"sigmoid": 1.7},
}


@pytest.mark.parametrize("case", sorted(LAMBDARANK))
def test_lambdarank_gradients_match_jax(lgb, case):
    X, y, group = ranking_data()
    rng = np.random.RandomState(1)
    weight = (rng.rand(len(y)) + 0.5).astype(np.float32) if (
        case == "weighted") else None
    params = {"objective": "lambdarank", **LAMBDARANK[case]}
    jo, po = _pair(lgb, params, y, weight, group)
    for score in (np.zeros(len(y), np.float32),          # all tied
                  np.round(rng.randn(len(y)), 1).astype(np.float32)):
        jg, jh = jo.get_gradients(score)
        pg, ph = po.get_gradients(torch.from_numpy(score))
        _close(pg.numpy(), np.asarray(jg))
        _close(ph.numpy(), np.asarray(jh))
        assert pg.dtype == torch.float32


def test_lambdarank_position_bias_matches_jax(lgb):
    X, y, group = ranking_data(seed=3)
    position = np.concatenate([np.arange(s) for s in group]) % 6
    params = {"objective": "lambdarank",
              "lambdarank_position_bias_regularization": 0.1}
    jo, po = _pair(lgb, params, y, None, group, position)
    assert po.stochastic_gradients
    rng = np.random.RandomState(2)
    score = np.zeros(len(y), np.float32)
    for _ in range(5):
        jg, jh = jo.get_gradients(score)
        pg, ph = po.get_gradients(torch.from_numpy(score))
        _close(pg.numpy(), np.asarray(jg))
        _close(ph.numpy(), np.asarray(jh))
        _close(po.pos_bias, np.asarray(jo.pos_bias))
        score = (score - 0.3 * np.asarray(jg)
                 + 0.01 * rng.randn(len(y))).astype(np.float32)
    assert np.abs(po.pos_bias).max() > 0


def test_xendcg_gradients_on_injected_gammas(lgb):
    from lightgbm_tpu.ranking import _xendcg_grads
    X, y, group = ranking_data(seed=4)
    jo, po = _pair(lgb, {"objective": "rank_xendcg"}, y, None, group)
    rng = np.random.RandomState(5)
    gammas = rng.rand(*po.phi_base.shape).astype(np.float32)
    for score in (np.zeros(len(y), np.float32),
                  rng.randn(len(y)).astype(np.float32)):
        jg, jh = _xendcg_grads(score, gammas, jo.doc_idx, jo.valid,
                               jo.phi_base)
        pg, ph = xendcg_grads(torch.from_numpy(score),
                              torch.from_numpy(gammas), po.doc_idx,
                              po.valid, po.phi_base)
        _close(pg.numpy(), np.asarray(jg))
        _close(ph.numpy(), np.asarray(jh))
    # the port's gammas: one seed, one stream
    again = create_objective(PConfig({"objective": "rank_xendcg"}))
    again.init(y, None, torch.device("cpu"), group=group)
    s = torch.from_numpy(rng.randn(len(y)).astype(np.float32))
    for _ in range(2):
        a, b = po.get_gradients(s), again.get_gradients(s)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="query/group"):
        create_objective(PConfig({"objective": "rank_xendcg"})).init(
            y, None, torch.device("cpu"))


@pytest.mark.parametrize("metric", ["ndcg", "map"])
def test_ranking_metrics_match_jax(lgb, metric):
    from lightgbm_tpu import metrics as JM
    from lightgbm_tpu.config import Config as JConfig
    X, y, group = ranking_data(seed=6, nq=40)
    rng = np.random.RandomState(7)
    for params in ({}, {"eval_at": [1, 4, 10]},
                   {"label_gain": [0, 2, 3, 9, 11]}):
        want = JM.create_metric(metric, JConfig(params))
        got = PM.create_metric(metric, PConfig(params))
        assert [m.name for m in got] == [m.name for m in want]
        for score in (np.zeros(len(y)), np.round(rng.randn(len(y)), 1)):
            for mg, mw in zip(got, want):
                assert abs(mg(y, score, None, group)
                           - mw(y, score, None, group)) <= 1e-12


def _example_run(pkg, **kw):
    params = {"objective": "lambdarank", "num_leaves": 15,
              "learning_rate": 0.1, "min_data_in_leaf": 5, "metric": "ndcg",
              "eval_at": [1, 3, 5], "lambdarank_truncation_level": 30,
              "verbosity": -1}
    ds = pkg.Dataset(os.path.join(EXAMPLE, "rank.train"))
    dv = pkg.Dataset(os.path.join(EXAMPLE, "rank.test"), reference=ds)
    hist = {}
    bst = pkg.train(params, ds, 20, valid_sets=[dv], valid_names=["test"],
                    callbacks=[pkg.record_evaluation(hist)], **kw)
    return bst, {k: v[-1] for k, v in hist["test"].items()}


def test_example_lambdarank_near_jax(lgb):
    jb, want = _example_run(lgb)
    pb, got = _example_run(lgt, device="cpu")
    assert sorted(got) == ["ndcg@1", "ndcg@3", "ndcg@5"]
    for k in got:
        assert abs(got[k] - want[k]) <= 0.03, (k, got[k], want[k])
    assert got["ndcg@5"] > 0.6
    assert pb.train_set.get_group().sum() == 640
    # model text: a ranker loads in the JAX package
    text = pb.model_to_string()
    assert "objective=lambdarank" in text and "[eval_at: " in text
    X = np.loadtxt(os.path.join(EXAMPLE, "rank.test"))[:, 1:]
    loaded = lgb.Booster(model_str=text)
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               pb.predict(X, raw_score=True), atol=1e-6)
    # and a JAX ranker carried across predicts the JAX package's scores
    carried = lgt.model_from_arrays(state_from_booster(jb))
    np.testing.assert_allclose(carried.predict_raw(X, device="cpu"),
                               jb.predict(X, raw_score=True), atol=1e-6)


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_training_repeats(objective):
    X, y, group = ranking_data(seed=8, nq=60, max_size=20)
    params = {"objective": objective, "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 3}
    texts = [lgt.train(params, lgt.Dataset(X, label=y, group=group), 4,
                       device="cpu").model_to_string() for _ in range(2)]
    assert texts[0] == texts[1]
    assert f"objective={objective}" in texts[0]


def test_position_side_file_autoload(tmp_path):
    """``<data>.position`` loads with the data and drives unbiased
    LambdaRank; constructor positions win over it."""
    from lightgbm_tpu_torch.io.parser import position_side_file
    rng = np.random.RandomState(0)
    n_q, per_q = 120, 10
    n = n_q * per_q
    X = rng.randn(n, 5)
    y = np.clip((X[:, 0] * 2 + rng.randn(n) * 0.3).astype(int) % 5, 0, 4)
    path = tmp_path / "tr.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.8g")
    np.savetxt(str(path) + ".query", np.full(n_q, per_q), fmt="%d")
    pos = np.tile(np.arange(per_q), n_q)
    np.savetxt(str(path) + ".position", pos, fmt="%d")
    np.testing.assert_array_equal(position_side_file(str(path)), pos)
    ds = lgt.Dataset(str(path))
    bst = lgt.train({"objective": "lambdarank", "verbosity": -1,
                     "num_leaves": 7,
                     "lambdarank_position_bias_regularization": 0.1},
                    ds, 5, device="cpu")
    assert bst.num_trees() == 5
    np.testing.assert_array_equal(ds.position, pos)
    assert bst._gbdt.objective.pos_ids is not None
    own = np.zeros(n, np.int32)
    ds2 = lgt.Dataset(str(path), position=own)
    ds2.construct()
    np.testing.assert_array_equal(ds2.position, own)
    shutil.copy(path, tmp_path / "bad.csv")
    np.savetxt(str(tmp_path / "bad.csv") + ".position", pos[:-1], fmt="%d")
    with pytest.raises(ValueError, match="position"):
        lgt.Dataset(str(tmp_path / "bad.csv")).construct()


@pytest.mark.cuda
def test_ranking_gradients_repeat_on_card(cuda_device):
    X, y, group = ranking_data(seed=9, nq=300, max_size=120)
    rng = np.random.RandomState(3)
    score = np.round(rng.randn(len(y)), 1).astype(np.float32)
    for objective in ("lambdarank", "rank_xendcg"):
        grads = {}
        for dev in (torch.device("cpu"), cuda_device, cuda_device):
            obj = create_objective(PConfig({"objective": objective}))
            obj.init(y, None, dev, group=group)
            g, h = obj.get_gradients(torch.from_numpy(score).to(dev))
            grads.setdefault(str(dev), []).append((g.cpu(), h.cpu()))
        (g1, h1), (g2, h2) = grads["cuda"]
        assert torch.equal(g1, g2) and torch.equal(h1, h2)
        gc, hc = grads["cpu"][0]            # XE-NDCG: the same gammas
        _close(g1.numpy(), gc.numpy())
        _close(h1.numpy(), hc.numpy())
    params = {"objective": "lambdarank", "num_leaves": 31, "verbosity": -1}
    texts = [lgt.train(params, lgt.Dataset(X, label=y, group=group), 5,
                       device=cuda_device).model_to_string()
             for _ in range(2)]
    assert texts[0] == texts[1]
