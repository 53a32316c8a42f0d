"""Row and feature sampling parity: ``lightgbm_tpu_torch.sampling`` and
the port's bagging / GOSS / ``feature_fraction`` training against the JAX
package on the CPU.

- Host masks bit for bit the JAX package's, iteration by iteration:
  plain bagging over several ``bagging_freq`` epochs, balanced
  positive / negative bagging, by-query bagging, and host GOSS; each
  tree's ``feature_fraction`` subset; GOSS's constants (the default
  amplification is exactly 8 in float32, so exact-sum gradients stay
  exact after GOSS).
- Device GOSS (``goss_mask_device``) keeps exactly top_k rows at 1 and
  about other_k amplified (``tests/test_engine.py::
  test_goss_device_mask_semantics``), its top set is the JAX package's
  ``lax.top_k`` set on tied scores, and one seed repeats; its draws are a
  ``torch.Generator``'s, so they are the JAX package's in law only.
- Trees: ``Booster.update(fobj=...)`` with exact-sum gradients under
  bagging + ``feature_fraction``, balanced bagging and host GOSS gives the
  JAX package's model text byte for byte, above and below the wave
  layout's row threshold; one GOSS iteration on the objective's own
  (exact) first gradients with ``tpu_device_goss=off`` too.
- Mirrors of ``test_bagging_child_counts_consistent`` and
  ``test_wave_with_bagging_goss_quantized``.
- At ``other_rate=0`` the port grows trees where the JAX package grows
  none (its first GOSS mask keeps one label only): a deliberate
  difference, pinned here with its cause.

On the card (``cuda`` marker), device GOSS repeats for one seed, its top
set equals the CPU's, and two device-GOSS runs give one model text."""

import numpy as np
import pytest
import torch

from torch_port_util import (assert_same_tree, cuda_device,  # noqa: F401
                             exact_grads, grown_data, higgs_like, jax_grow,
                             port_grow, pow2_scale_grads)

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config as PConfig
from lightgbm_tpu_torch.metrics import auc
from lightgbm_tpu_torch.sampling import (FeatureSampler, SampleStrategy,
                                         goss_generator, goss_mask_device)
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


#: host-sampled configs: (params, with query boundaries)
HOST_MASKS = {
    "bagging": ({"bagging_fraction": 0.6, "bagging_freq": 3}, False),
    "balanced": ({"pos_bagging_fraction": 0.5,
                  "neg_bagging_fraction": 0.8}, False),
    "by_query": ({"bagging_fraction": 0.5, "bagging_freq": 2,
                  "bagging_by_query": True}, True),
    "goss": ({"data_sample_strategy": "goss", "top_rate": 0.25,
              "other_rate": 0.15}, False),
}


@pytest.mark.parametrize("case", sorted(HOST_MASKS))
def test_host_masks_match_jax(lgb, case):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.sampling import SampleStrategy as JStrategy
    params, by_query = HOST_MASKS[case]
    rng = np.random.RandomState(5)
    bounds = (np.concatenate([[0], np.cumsum(rng.randint(1, 30, 60))])
              if by_query else None)
    n = int(bounds[-1]) if by_query else 997
    label = (rng.rand(n) > 0.6).astype(np.float64)
    want = JStrategy(JConfig(params), n, label, bounds)
    got = SampleStrategy(PConfig(params), n, label, bounds)
    for it in range(7):
        g = rng.randn(n).astype(np.float32)
        h = rng.rand(n).astype(np.float32)
        assert got.needs_resample(it) == want.needs_resample(it)
        mw, mg = want.mask(it, g, h), got.mask(it, g, h)
        assert (mw is None) == (mg is None)
        if mw is not None:
            assert mg.dtype == np.float32
            np.testing.assert_array_equal(mg, mw)
    assert got.goss_constants() == want.goss_constants()


@pytest.mark.parametrize("frac", [0.6, 1.0])
def test_feature_sampler_matches_jax(lgb, frac):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.sampling import FeatureSampler as JSampler
    params = {"feature_fraction": frac, "feature_fraction_seed": 4}
    want, got = JSampler(JConfig(params), 13), FeatureSampler(
        PConfig(params), 13)
    for it in range(6):
        np.testing.assert_array_equal(got.tree_mask(it), want.tree_mask(it))


def test_goss_default_amplification_is_exact():
    """(1 - 0.2) / 0.1 rounds to 8.0 in float32: GOSS scales exact-sum
    gradients (+-0.5, 0.25) to +-4 and 2, still exact in any order."""
    top_k, other_k, amp = SampleStrategy(
        PConfig({"data_sample_strategy": "goss"}), 1000).goss_constants()
    assert (top_k, other_k) == (200, 100)
    assert np.float32(amp) == np.float32(8.0)


def test_goss_device_mask_semantics(lgb):
    """The port's device sampler on the JAX test's inputs: exactly top_k
    rows at 1, other_k amplified, the rest 0, the top set the top |g*h|;
    and the top set is ``lax.top_k``'s on tied scores."""
    import jax

    from lightgbm_tpu.sampling import goss_mask_device as jax_goss
    rng = np.random.RandomState(0)
    n = 5000
    g = rng.randn(n).astype(np.float32)
    h = np.full(n, 0.25, np.float32)
    top_k, other_k = 500, 750
    amp = (1.0 - 0.1) / 0.15
    mask = goss_mask_device(torch.from_numpy(g), torch.from_numpy(h),
                            goss_generator(0, 0, torch.device("cpu")),
                            top_k, other_k, amp).numpy()
    assert mask.dtype == np.float32
    assert (mask == 1.0).sum() == top_k
    assert (mask == np.float32(amp)).sum() == other_k
    score = np.abs(g * h)
    thr = np.sort(score)[-top_k]
    assert score[mask == 1.0].min() >= thr - 1e-7
    assert (mask == 0.0).sum() == n - top_k - other_k
    # ties: scores on a coarse grid; the lower row wins, as in lax.top_k
    gt = np.round(g * 2) / 2
    want = np.asarray(jax_goss(gt, h, jax.random.PRNGKey(0), top_k, 0, amp))
    got = goss_mask_device(torch.from_numpy(gt), torch.from_numpy(h),
                           goss_generator(0, 0, torch.device("cpu")),
                           top_k, 0, amp).numpy()
    np.testing.assert_array_equal(got, want)
    # a rest smaller than other_k: every rest row amplified, none dropped
    small = goss_mask_device(torch.from_numpy(g[:50]),
                             torch.from_numpy(h[:50]),
                             goss_generator(0, 0, torch.device("cpu")),
                             10, 75, amp).numpy()
    assert (small == 1.0).sum() == 10
    assert (small == np.float32(amp)).sum() == 40


def test_goss_device_seed_repeats():
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(3000).astype(np.float32))
    h = torch.from_numpy(rng.rand(3000).astype(np.float32))
    cpu = torch.device("cpu")
    mask = lambda seed, it: goss_mask_device(
        g, h, goss_generator(seed, it, cpu), 300, 200, 4.0)
    assert torch.equal(mask(3, 7), mask(3, 7))
    assert not torch.equal(mask(3, 7), mask(3, 8))
    assert not torch.equal(mask(3, 7), mask(4, 7))
    # the top set does not depend on the draws
    assert torch.equal(mask(3, 7) == 1.0, mask(4, 8) == 1.0)


SAMPLED = {
    "bagging_ff": {"bagging_fraction": 0.7, "bagging_freq": 2,
                   "feature_fraction": 0.6},
    "balanced": {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.9},
    "goss": {"data_sample_strategy": "goss"},
}


@pytest.mark.parametrize("layout", ["wave", "mask"])
@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_sampled_trees_byte_equal(lgb, case, layout):
    """Four ``update(fobj=...)`` steps on exact-sum gradients: the masks,
    the trees and the model text are the JAX package's byte for byte (the
    wave layout above 2,048 rows, the mask layout below)."""
    n = 3 * 2560 if layout == "wave" else 1500
    X, y = grown_data(n=n)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "tpu_leaf_batch": 4, "min_data_in_leaf": 5, **SAMPLED[case]}
    g, h = exact_grads(n)
    fobj = lambda _score, _data: (g, h)
    jb = lgb.Booster(params=params, train_set=lgb.Dataset(X, label=y))
    pb = lgt.Booster(params=params, train_set=lgt.Dataset(X, label=y),
                     device="cpu")
    for _ in range(4):
        jb.update(fobj=fobj)
        pb.update(fobj=fobj)
    text = pb.model_to_string()
    assert text == jb.model_to_string()
    assert all(t.num_leaves > 1 for t in pb._gbdt.models[0])


@pytest.mark.parametrize("layout", ["wave", "mask"])
@pytest.mark.parametrize("quantized", [False, True])
def test_grower_masked_rows_match_jax(lgb, layout, quantized):
    """The grower under a GOSS-style mask (rows at 0, 1 and 8): out-of-bag
    rows leave every count, and the tree and row_leaf are the JAX
    package's bit for bit, f32 on exact sums and quantized (deterministic
    rounding, power-of-two scales) with ``quant_train_renew_leaf`` on the
    masked gradients."""
    n = 3 * 2560 if layout == "wave" else 1800
    X, y = grown_data(n=n)
    rng = np.random.RandomState(11)
    mask = np.where(rng.rand(n) < 0.3, 1.0,
                    np.where(rng.rand(n) < 0.2, 8.0, 0.0)).astype(np.float32)
    # rows 0 and 1 carry pow2_scale_grads' -1 and 1: amplified by 8, the
    # masked maxima stay powers of two
    mask[:2] = 8.0
    g, h = pow2_scale_grads(n) if quantized else exact_grads(n)
    kw = dict(quantized=True, num_grad_quant_bins=4,
              stochastic_rounding=False, quant_renew_leaf=True) if (
                  quantized) else {}
    params = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5}
    want, rl_want = jax_grow(X, y, params, g, h, sample_mask=mask,
                             leaf_batch=4, **kw)
    got, rl_got = port_grow(X, y, params, g, h, sample_mask=mask,
                            leaf_batch=4, **kw)
    assert got["num_leaves"] > 2
    assert_same_tree(want, got, rl_want, rl_got)
    assert got["leaf_count"][: got["num_leaves"]].sum() == (mask > 0).sum()


def test_goss_host_objective_iteration_byte_equal(lgb):
    """One GOSS iteration under ``tpu_device_goss=off`` on the binary
    objective's own first gradients (exactly +-0.5 and 0.25 without boost
    from average): the JAX package's model text."""
    X, y = grown_data()
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "boost_from_average": False, "tpu_leaf_batch": 4,
              "data_sample_strategy": "goss", "tpu_device_goss": "off"}
    jb = lgb.train(params, lgb.Dataset(X, label=y), 1)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    assert pb.model_to_string() == jb.model_to_string()


def test_device_goss_trains_near_host(lgb):
    """Device GOSS (``auto`` on the binary objective, and ``on``) trains
    to the host sampler's quality; ``auto`` under a leaf-renewing
    objective keeps the host sampler, as the JAX package does."""
    X, y = higgs_like(4000, 8)
    base = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
            "data_sample_strategy": "goss"}
    aucs = {}
    for mode in ("auto", "on", "off"):
        b = lgt.train(dict(base, tpu_device_goss=mode),
                      lgt.Dataset(X, label=y), 8, device="cpu")
        assert b._gbdt.goss_on_device() == (mode != "off")
        aucs[mode] = auc(y, b.predict(X, raw_score=True))
    assert abs(aucs["auto"] - aucs["off"]) < 0.02
    assert aucs["auto"] == aucs["on"]
    l1 = lgt.Booster(params={"objective": "regression_l1", "verbosity": -1,
                             "data_sample_strategy": "goss"},
                     train_set=lgt.Dataset(X, label=y), device="cpu")
    assert not l1._gbdt.goss_on_device()
    with pytest.raises(ValueError, match="tpu_device_goss"):
        lgt.train(dict(base, tpu_device_goss="maybe"),
                  lgt.Dataset(X, label=y), 1, device="cpu")


def test_bagging_child_counts_consistent():
    """tests/test_engine.py's pin on the port: out-of-bag rows leave every
    child count, so each leaf holds min_data_in_leaf bagged rows."""
    rng = np.random.RandomState(17)
    X = rng.randn(1000, 4)
    y = (X[:, 0] > 0).astype(float)
    bst = lgt.train({"objective": "binary", "bagging_fraction": 0.5,
                     "bagging_freq": 1, "min_data_in_leaf": 30,
                     "verbosity": -1}, lgt.Dataset(X, label=y), 20,
                    device="cpu")
    pred = bst.predict(X)
    assert np.isfinite(pred).all()
    assert ((pred > 0.5) == y).mean() > 0.9
    for tree in bst._gbdt.models[0]:
        if tree.num_leaves > 1:
            assert (tree.leaf_count[: tree.num_leaves] >= 30).all()


def test_wave_with_bagging_goss_quantized():
    """tests/test_wave_grower.py's pin on the port."""
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 10)
    logits = (X[:, 0] * 2 - X[:, 1] + np.sin(X[:, 2] * 2)
              + 0.3 * rng.randn(5000))
    y = (logits > 0).astype(np.float64)
    base = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.1,
            "min_data_in_leaf": 10, "verbosity": -1, "metric": "none",
            "deterministic": True, "tpu_leaf_batch": 4}
    for extra in ({"bagging_fraction": 0.7, "bagging_freq": 1},
                  {"data_sample_strategy": "goss"},
                  {"use_quantized_grad": True},
                  {"data_sample_strategy": "goss",
                   "use_quantized_grad": True}):
        bst = lgt.train(dict(base, **extra), lgt.Dataset(X, label=y), 8,
                        device="cpu")
        assert auc(y, bst.predict(X, raw_score=True)) > 0.8, extra


def test_goss_other_rate_zero_grows_trees(lgb):
    """tests/test_engine.py::test_goss_other_rate_zero on the port: trees
    grow.  The JAX package's first GOSS mask keeps one label only (every
    |g*h| is one of two values, and the top 30% are all negatives), so
    its first tree cannot split; the port keeps every row for the first
    int(1 / learning_rate) iterations at other_rate 0, as reference
    LightGBM's GOSS does."""
    from sklearn.datasets import make_classification

    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.sampling import SampleStrategy as JStrategy
    X, y = make_classification(n_samples=500, n_features=6, random_state=0)
    params = {"objective": "binary", "data_sample_strategy": "goss",
              "other_rate": 0.0, "top_rate": 0.3, "num_leaves": 7,
              "verbosity": -1}
    bst = lgt.train(params, lgt.Dataset(X, label=y), 5, device="cpu")
    assert bst.num_trees() == 5
    assert all(t.num_leaves > 1 for t in bst._gbdt.models[0])
    # the cause, on the JAX package's sampler: iteration 0's gradients
    p = np.float32(y.mean())
    g = (p - y).astype(np.float32)
    h = np.full(len(y), p * (1 - p), np.float32)
    jmask = JStrategy(JConfig(params), len(y), y).mask(0, g, h)
    assert len(np.unique(y[jmask > 0])) == 1
    port = SampleStrategy(PConfig(params), len(y), y)
    assert port.mask(0, g, h) is None and port.goss_warmup(9)
    assert port.mask(10, g, h) is not None
    # at other rates the port samples from iteration 0, as the JAX package
    other = SampleStrategy(PConfig(dict(params, other_rate=0.1)), len(y), y)
    assert not other.goss_warmup(0)


@pytest.mark.cuda
def test_device_goss_on_card(cuda_device):
    rng = np.random.RandomState(2)
    n = 200_003
    g = rng.randn(n).astype(np.float32)
    g[::7] = 0.5                       # ties across the top set's border
    h = rng.rand(n).astype(np.float32)
    gd, hd = torch.from_numpy(g).to(cuda_device), torch.from_numpy(h).to(
        cuda_device)
    one = goss_mask_device(gd, hd, goss_generator(1, 4, cuda_device),
                           40_000, 20_000, 8.0)
    two = goss_mask_device(gd, hd, goss_generator(1, 4, cuda_device),
                           40_000, 20_000, 8.0)
    assert torch.equal(one, two)
    cpu = goss_mask_device(torch.from_numpy(g), torch.from_numpy(h),
                           goss_generator(1, 4, torch.device("cpu")),
                           40_000, 20_000, 8.0)
    assert torch.equal((one == 1.0).cpu(), cpu == 1.0)
    assert int((one == 8.0).sum()) == 20_000
    X, y = higgs_like(20_000, 8)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "data_sample_strategy": "goss"}
    texts = [lgt.train(params, lgt.Dataset(X, label=y), 5,
                       device=cuda_device).model_to_string()
             for _ in range(2)]
    assert texts[0] == texts[1]
