"""Objective parity: ``lightgbm_tpu_torch.objectives`` against
``lightgbm_tpu.objectives``, and training with each family against
``lightgbm_tpu.train``, on the same numpy inputs from a seed.

- Per objective (the 13 non-ranking objectives besides ``binary``, and
  ``regression`` with ``reg_sqrt``), unweighted and weighted: gradients
  and hessians equal the JAX package's jitted ``get_gradients`` bit for
  bit where no ``exp`` or ``sqrt`` is involved and within 1e-6 relative
  otherwise (their last bit differs between the libraries: XLA's CPU
  ``sqrt`` is not always correctly rounded);
  ``boost_from_score`` of every class (within 1e-6 relative under
  ``reg_sqrt``, whose labels go through ``sqrt``), ``renew_leaf_values``
  and the flags bit for bit; ``convert_output`` within 3e-7 relative
  (two float32 ulps: ``exp``, then a division); the label checks raise
  the JAX package's errors.
- Quantized gradients on constant hessians: deterministic
  ``discretize_gradients`` equals the JAX package's bit for bit; each
  class of a K-tree iteration draws stochastic rounding from its own
  generator, and ``class_id=None`` keeps the one-tree generator's bits.
- One exact-sum iteration (``boost_from_average=false``, 31 leaves): the
  model text is byte for byte the JAX package's for L2 and L1 on integer
  labels (grad = -label or its sign, hess = 1) and for 4-class multiclass
  (p = 0.25: grad 0.25 or -0.75, hess 0.25), and for one quantized L2
  iteration with deterministic rounding on labels in [-4, 4] (power-of-
  two scales).
- Ten ordinary iterations for L2, Poisson and multiclass: raw
  predictions within 1e-4 of the JAX package's, and the port's model
  text loads in ``lightgbm_tpu.Booster(model_str=...)`` and predicts
  within 1e-6.
- Serving: a multiclass and a one-vs-all model's ``Predictor`` output
  follows the objective's transform: through the fp32 pack it equals
  ``Booster.predict``; through the int16 pack it is the float32 transform
  of the served raw scores, within 1e-6.

On the card (``cuda`` marker), one exact-sum iteration of L2, L1 and
4-class multiclass gives the CPU model text byte for byte."""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, grown_data  # noqa: F401

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import objectives as PO
from lightgbm_tpu_torch.config import Config as PConfig
from lightgbm_tpu_torch.ops.quantize import (discretize_gradients,
                                             gradient_scales,
                                             quant_generator)
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


N = 600
K = 3


def _labels(kind, rng, n=N):
    if kind == "real":
        return rng.randn(n) * 2.0
    if kind == "count":
        return np.floor(np.exp(rng.randn(n)))
    if kind == "positive":
        return np.exp(rng.randn(n))
    if kind == "class":
        return rng.randint(0, K, n).astype(np.float64)
    return rng.rand(n)


#: (case, params, label kind, gradients through exp or sqrt)
OBJECTIVES = [
    ("regression", {"objective": "regression"}, "real", False),
    ("regression_sqrt", {"objective": "regression", "reg_sqrt": True},
     "real", True),
    ("regression_l1", {"objective": "regression_l1"}, "real", False),
    ("huber", {"objective": "huber", "alpha": 0.7}, "real", False),
    ("fair", {"objective": "fair", "fair_c": 1.3}, "real", False),
    ("poisson", {"objective": "poisson"}, "count", True),
    ("quantile", {"objective": "quantile", "alpha": 0.3}, "real", False),
    ("mape", {"objective": "mape"}, "real", False),
    ("gamma", {"objective": "gamma"}, "positive", True),
    ("tweedie", {"objective": "tweedie", "tweedie_variance_power": 1.3},
     "count", True),
    ("multiclass", {"objective": "multiclass", "num_class": K}, "class",
     True),
    ("multiclassova", {"objective": "multiclassova", "num_class": K,
                       "sigmoid": 1.5}, "class", True),
    ("cross_entropy", {"objective": "cross_entropy"}, "probability", True),
    ("cross_entropy_lambda", {"objective": "cross_entropy_lambda"},
     "probability", True),
]


def _pair(params, label, weight):
    """(JAX objective, port objective), both initialised on the rows."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective
    jcfg, pcfg = JConfig(params), PConfig(params)
    jo, po = jax_objective(jcfg), PO.create_objective(pcfg)
    jo.init(label, weight, None, jcfg)
    po.init(label, weight, torch.device("cpu"))
    return jo, po


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "weighted"])
@pytest.mark.parametrize("case,params,kind,uses_exp", OBJECTIVES,
                         ids=[o[0] for o in OBJECTIVES])
def test_objective_matches_jax(lgb, case, params, kind, uses_exp,
                               weighted):
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(len(case) + 7 * weighted)
    label = _labels(kind, rng)
    weight = rng.uniform(0.5, 2.0, N) if weighted else None
    jo, po = _pair(params, label, weight)
    k = params.get("num_class", 1)
    shape = (N, k) if k > 1 else (N,)
    score = rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    assert po.num_model_per_iteration == jo.num_model_per_iteration == k
    assert po.is_constant_hessian == jo.is_constant_hessian
    assert po.need_renew_tree_output == jo.need_renew_tree_output
    jg, jh = jax.jit(jo.get_gradients)(jnp.asarray(score))
    pg, ph = po.get_gradients(torch.from_numpy(score))
    for got, want in ((pg, jg), (ph, jh)):
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        if uses_exp:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for c in range(k):
        if case == "regression_sqrt":   # the mean of sqrt-ed labels
            assert po.boost_from_score(c) == pytest.approx(
                jo.boost_from_score(c), rel=1e-6)
        else:
            assert po.boost_from_score(c) == jo.boost_from_score(c)
    np.testing.assert_allclose(
        po.convert_output(torch.from_numpy(score)).numpy(),
        np.asarray(jo.convert_output(jnp.asarray(score))), rtol=3e-7)
    row_leaf = rng.randint(0, 7, N).astype(np.int32)
    s1 = score if k == 1 else score[:, 0]
    want = jo.renew_leaf_values(s1, row_leaf, 7)
    got = po.renew_leaf_values(s1, row_leaf, 7)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params,label", [
    ({"objective": "poisson"}, -1.0),
    ({"objective": "tweedie"}, -0.5),
    ({"objective": "gamma"}, 0.0),
    ({"objective": "multiclass", "num_class": 3}, 3.0),
    ({"objective": "multiclassova", "num_class": 3}, -1.0),
    ({"objective": "binary"}, 2.0),
], ids=["poisson", "tweedie", "gamma", "multiclass", "multiclassova",
        "binary"])
def test_label_checks_match_jax(lgb, params, label):
    y = np.array([0.0, 1.0, 2.0, label])
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective
    with pytest.raises(ValueError) as want:
        jax_objective(JConfig(params)).init(y, None, None, JConfig(params))
    with pytest.raises(ValueError) as got:
        PO.create_objective(PConfig(params)).init(y, None,
                                                  torch.device("cpu"))
    assert str(got.value) == str(want.value)


def test_ranking_objectives_raise_naming_a82(lgb):
    """The ranking objectives, which raised naming A8.2 until slice 13,
    now build; without query groups their init raises the JAX package's
    ValueError (tests/test_torch_ranking.py holds their gradients)."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective
    y = np.array([0.0, 1.0, 2.0, 1.0])
    for name in ("lambdarank", "rank_xendcg"):
        obj = PO.create_objective(PConfig({"objective": name}))
        assert obj.name == name and obj.num_model_per_iteration == 1
        with pytest.raises(ValueError) as want:
            jax_objective(JConfig({"objective": name})).init(
                y, None, None, JConfig({"objective": name}))
        with pytest.raises(ValueError) as got:
            obj.init(y, None, torch.device("cpu"))
        assert str(got.value) == str(want.value)
        obj.init(y, None, torch.device("cpu"), group=np.array([4]))


def test_constant_hessian_quantization_matches_jax(lgb):
    """Constant hessians (hess = 1 or the weight) quantize to the JAX
    package's levels: the hessian scale comes from max|h|."""
    from lightgbm_tpu.ops import quantize as JQ
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    for weight in (None, rng.uniform(0.5, 2.0, N)):
        jo, po = _pair({"objective": "regression_l1"}, rng.randn(N), weight)
        score = rng.randn(N).astype(np.float32)
        g, h = po.get_gradients(torch.from_numpy(score))
        gs, hs = gradient_scales(g, h, 4)
        pq = discretize_gradients(g, h, gs, hs, stochastic=False)
        jg, jh = jo.get_gradients(jnp.asarray(score))
        jgs, jhs = JQ.gradient_scales(jg, jh, 4)
        jq = JQ.discretize_gradients(jg, jh, jgs, jhs, None,
                                     stochastic=False)
        assert float(gs) == float(jgs) and float(hs) == float(jhs)
        for got, want in zip(pq, jq):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_class_quant_generators():
    """``class_id=None`` keeps the one-tree stream (quantized binary
    trees keep their bits); each class of a K-tree iteration draws its
    own stream, repeatably."""
    dev = torch.device("cpu")
    x = (7 << 32) | 3
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    assert quant_generator(7, 3, dev).initial_seed() == x
    draws = [torch.rand(64, generator=quant_generator(7, 3, dev, k))
             for k in range(4)]
    assert all(not torch.equal(draws[0], d) for d in draws[1:])
    assert not torch.equal(draws[0], torch.rand(
        64, generator=quant_generator(7, 3, dev)))
    assert torch.equal(draws[2], torch.rand(
        64, generator=quant_generator(7, 3, dev, 2)))


# ------------------------------------------------------------- training
EXACT = {"num_leaves": 31, "verbosity": -1, "boost_from_average": False,
         "tpu_leaf_batch": 4}


def _exact_case(case):
    """(params, X, y) of one exact-sum iteration."""
    X, _ = grown_data()
    rng = np.random.RandomState(11)
    if case == "multiclass":
        return (dict(EXACT, objective="multiclass", num_class=4), X,
                rng.randint(0, 4, len(X)).astype(np.float64))
    y = rng.randint(-4, 5, len(X)).astype(np.float64)
    if case == "l2_quantized":
        return (dict(EXACT, objective="regression", use_quantized_grad=True,
                     stochastic_rounding=False), X, y)
    return dict(EXACT, objective={"l2": "regression",
                                  "l1": "regression_l1"}[case]), X, y


@pytest.mark.parametrize("case", ["l2", "l1", "multiclass", "l2_quantized"])
def test_one_iteration_model_text_byte_equal(lgb, case):
    params, X, y = _exact_case(case)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 1)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    assert pb.model_to_string() == jb.model_to_string()
    np.testing.assert_array_equal(pb._gbdt.scores.numpy(),
                                  np.asarray(jb._gbdt.scores))
    k = 4 if case == "multiclass" else 1
    assert pb.num_trees() == k and pb.num_model_per_iteration() == k


def _ordinary_case(case):
    rng = np.random.RandomState(4)
    X = rng.randn(3000, 10).astype(np.float32)
    t = X[:, :4].sum(axis=1) / 2.0
    if case == "l2":
        return {"objective": "regression"}, X, t + rng.rand(3000)
    if case == "poisson":
        return ({"objective": "poisson"}, X,
                np.floor(np.exp(t / 2.0) * rng.exponential(size=3000)))
    return ({"objective": "multiclass", "num_class": 3}, X,
            np.digitize(t + rng.randn(3000) / 2.0, [-0.5, 0.5]).astype(
                np.float64))


@pytest.mark.parametrize("case", ["l2", "poisson", "multiclass"])
def test_ten_iterations_track_jax_and_load_in_jax(lgb, case):
    params, X, y = _ordinary_case(case)
    params = dict(params, num_leaves=15, verbosity=-1, tpu_leaf_batch=4)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 10)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 10, device="cpu")
    raw = pb.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, jb.predict(X, raw_score=True),
                               atol=1e-4)
    loaded = lgb.Booster(model_str=pb.model_to_string())
    np.testing.assert_allclose(loaded.predict(X, raw_score=True), raw,
                               atol=1e-6)


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_predictor_follows_the_objective_transform(objective):
    params, X, y = _ordinary_case("multiclass")
    params = dict(params, objective=objective, num_leaves=15,
                  verbosity=-1)
    bst = lgt.train(params, lgt.Dataset(X, label=y), 5, device="cpu")
    rows = X[:500]
    got = bst.serving_predictor(quantize="off").predict(rows)
    assert got.shape == (500, 3)
    np.testing.assert_array_equal(got, bst.predict(rows))
    raw16 = bst.serving_predictor(quantize="int16",
                                  raw_score=True).predict(rows)
    got16 = bst.serving_predictor(quantize="int16").predict(rows)
    want16 = bst._gbdt.objective.convert_output(
        torch.from_numpy(raw16).to(torch.float32)).numpy()
    np.testing.assert_allclose(got16, want16, atol=1e-6)
    if objective == "multiclass":
        np.testing.assert_allclose(got16.sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["l2", "l1", "multiclass"])
def test_card_iteration_matches_cpu_model_text(cuda_device, case):
    params, X, y = _exact_case(case)
    want = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    got = lgt.train(params, lgt.Dataset(X, label=y), 1, device=cuda_device)
    assert got.model_to_string() == want.model_to_string()
    assert torch.equal(got._gbdt.scores.cpu(), want._gbdt.scores)
