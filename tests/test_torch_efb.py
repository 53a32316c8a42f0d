"""Exclusive feature bundling (EFB) in the port, held to the JAX package
(``lightgbm_tpu/binning.py::build_bundles``, ``models/grower.py`` with
``bundled=True``; its own tests are tests/test_efb.py):

- Bundles: ``build_bundles`` gives the JAX package's ``feat_group``,
  ``feat_offset``, ``group_bins`` and bundled matrix byte for byte, on
  one-hot data (conflict rates 0 and 0.05), on dense data (None), with a
  sample smaller than N (the full-matrix eviction path), on binary
  one-hot columns (uint8) and on eight exclusive 60-bin columns (a
  473-bin column: uint16);
  ``bundle_row_matrix`` reproduces the stored matrix.
- The grower on exact-sum gradients (+-0.5, hessian 0.25: every sum is
  exact in any order, so a bundled feature's bin 0, rebuilt as the leaf
  total minus its other bins, is the unbundled bin 0): trees and
  ``row_leaf`` bit for bit the JAX package's bundled grower, on the wave
  layout (the port's fused step, the plain version of the CUDA wave
  kernel, and its unfused step) at leaf_batch 1 and 16, on the mask
  layout, quantized on power-of-two scales, over uint8 bundles (binary
  one-hot columns) and uint16 ones (continuous one-hot values, and a
  473-bin column), with conflicts, and with a sorted categorical
  feature beside the bundles; the port's unbundled grower gives the
  same trees.
- Training: on the data of tests/test_efb.py the port bundles 54
  features into 10 columns and its train AUC is within 1e-3 of the
  unbundled run's and of the JAX package's; the model text round trip
  predicts within 1e-6; the conflict budget bundles near-exclusive
  columns; the bundles are decided anew when ``enable_bundle`` changes;
  scipy CSR rows train the dense rows' model text; a 3-class model with
  a valid set trains bundled, its valid logloss within 1e-3 relative of
  the JAX package's and of the unbundled run's.

On the card (``cuda`` marker) the bundled grower through the histogram
and wave kernels gives the CPU plain version's trees bit for bit, f32
and quantized, over uint8 and uint16 bundles, fused and unfused.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (assert_same_tree, cuda_device,  # noqa: F401
                             exact_grads, jax_grow, port_grow,
                             pow2_scale_grads)

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import binning as PB
from lightgbm_tpu_torch.metrics import auc
from lightgbm_tpu_torch.ops import histogram_flat as HF
from lightgbm_tpu_torch.ops import wave as WV

P = {"objective": "binary", "num_leaves": 31}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one host thread: a grower is thousands of
    small ops, which several threads a process only slow down when the
    suite's workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _onehot_data(n=6000, blocks=4, card=12, dense=6, seed=0):
    """tests/test_efb.py::_onehot_data: ``blocks`` one-hot blocks of
    ``card`` columns (values in [0.5, 1.5)) and ``dense`` normal
    columns."""
    rng = np.random.RandomState(seed)
    parts = []
    for _ in range(blocks):
        cat = rng.randint(0, card, n)
        oh = np.zeros((n, card))
        oh[np.arange(n), cat] = rng.rand(n) + 0.5
        parts.append(oh)
    parts.append(rng.randn(n, dense))
    X = np.concatenate(parts, axis=1)
    logits = X[:, 0] * 2 - X[:, 5] + X[:, blocks * card] \
        + 0.5 * X[:, blocks * card + 1]
    y = (rng.rand(n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return X, y


def _binary_onehot_data(n=3 * 2560, seed=0):
    """_onehot_data with its one-hot cells set to 1: two bins a one-hot
    column, so a block bundles into a 13-bin column and the bundled
    matrix is uint8 (continuous one-hot values take up to 255 bins a
    column, and a block's bundle passes 256: uint16)."""
    X, y = _onehot_data(n=n, seed=seed)
    X[:, :48] = (X[:, :48] > 0).astype(np.float64)
    return X, y


def _conflict_data(n=5000, f=24, seed=1):
    """tests/test_efb.py::test_efb_conflict_budget's columns: each
    non-zero on n/30 random rows, so pairs of them conflict a little."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, f))
    for j in range(f):
        rows = rng.choice(n, size=n // 30, replace=False)
        X[rows, j] = rng.rand(len(rows)) + 0.1
    y = (X[:, :6].sum(axis=1) + 0.3 * rng.randn(n) > 0.1).astype(np.float64)
    return X, y


def _sampled_conflict_data(n=6000, seed=0):
    """_onehot_data with seven rows where the first block's columns 0 and
    1 are both non-zero: a 300-row sample misses those conflicts, the
    full matrix does not."""
    X, y = _onehot_data(n=n, seed=seed)
    rows = np.random.RandomState(seed + 1).choice(n, 7, replace=False)
    X[rows, 0] = 1.0
    X[rows, 1] = 1.0
    return X, y


def _wide_data(n=3 * 2560, seed=2):
    """Eight mutually exclusive columns of 60 bins each (0 and 59 levels)
    and two normal ones: the eight bundle into one column of 1 + 8 * 59 =
    473 bins, so the bundled matrix is uint16."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 8, n)
    level = rng.randint(1, 60, n).astype(np.float64)
    X = np.zeros((n, 10))
    X[np.arange(n), base] = level
    X[:, 8:] = rng.randn(n, 2)
    y = ((base % 3 == 0) ^ (level > 30) ^ (X[:, 8] > 0.8)).astype(np.float64)
    return X, y


def _sorted_cat_data(n=3 * 2560, seed=13):
    """_onehot_data plus a 40-category column whose label signal is a
    hidden set of its categories (taking the sorted many-vs-many scan)."""
    X, y = _onehot_data(n=n, seed=seed)
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, 40, n).astype(np.float64)
    lift = ((np.arange(40) * 7 % 5) < 2)[cat.astype(int)]
    return np.column_stack([X, cat]), (lift ^ (y > 0.5)).astype(np.float64)


# ---------------------------------------------------------------- bundles
def _jax_bundles(X, rate, **kw):
    from lightgbm_tpu.binning import bin_dataset, build_bundles
    return build_bundles(bin_dataset(X), max_conflict_rate=rate, **kw)


BUNDLE_CASES = {
    "onehot": (_onehot_data, 0.0, {}),
    "onehot_conflict_rate": (_onehot_data, 0.05, {}),
    "conflicts": (_conflict_data, 0.05, {}),
    "sampled": (_sampled_conflict_data, 0.0, {"sample_cnt": 300}),
    "uint16": (_wide_data, 0.0, {}),
    "binary_onehot": (_binary_onehot_data, 0.0, {}),
}


@pytest.mark.parametrize("case", sorted(BUNDLE_CASES))
def test_bundles_bytewise_vs_jax(case, monkeypatch):
    make, rate, kw = BUNDLE_CASES[case]
    X, _y = make()
    evicted = []
    real = PB._evict_conflicts

    def counted(*args):
        out = real(*args)
        evicted.extend(out)
        return out

    monkeypatch.setattr(PB, "_evict_conflicts", counted)
    binned = PB.bin_dataset(X)
    got = PB.build_bundles(binned, max_conflict_rate=rate, **kw)
    want = _jax_bundles(X, rate, **kw)
    assert got is not None and want is not None
    for k in ("feat_group", "feat_offset", "group_bins", "bins"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(got.bundle_row_matrix(binned.bins),
                                  got.bins)
    assert got.num_groups < X.shape[1]
    if case == "sampled":
        assert evicted, "the full-matrix re-check evicted nothing"
    if case == "uint16":
        assert got.bins.dtype == np.uint16 and got.max_group_bins == 473
    if case == "binary_onehot":
        assert got.bins.dtype == np.uint8


def test_bundles_none_for_dense_data():
    X = np.random.RandomState(0).randn(3000, 20)
    assert PB.build_bundles(PB.bin_dataset(X)) is None
    assert _jax_bundles(X, 0.0) is None


def test_bundle_columns_decode_to_the_feature_bins():
    """Every bundled feature's bins come back from its column
    (``ops/bundle.py::decode_bins``, the partitions' decode)."""
    from lightgbm_tpu_torch.ops.bundle import decode_bins
    X, _y = _onehot_data()
    binned = PB.bin_dataset(X)
    fb = PB.build_bundles(binned)
    assert fb.num_groups == 10
    for f in range(X.shape[1]):
        g, off = int(fb.feat_group[f]), int(fb.feat_offset[f])
        raw = torch.from_numpy(fb.bins[:, g].astype(np.int64))
        col = binned.bins[:, f].astype(np.int64)
        if off < 0:
            np.testing.assert_array_equal(raw.numpy(), col)
            continue
        nb = int(binned.num_bins_per_feature[f])
        dec = decode_bins(raw, off, nb).numpy()
        np.testing.assert_array_equal(dec, col)


# -------------------------------------------------------------- the grower
@pytest.fixture(scope="module")
def onehot():
    X, y = _onehot_data(n=3 * 2560)
    g, h = exact_grads(len(y))
    return X, y, g, h


@pytest.mark.parametrize("kernel,leaf_batch",
                         [("fused", 1), ("fused", 16), ("unfused", 1),
                          ("unfused", 16)])
def test_grower_wave_bitwise_vs_jax(onehot, kernel, leaf_batch):
    X, y, g, h = onehot
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=leaf_batch, bundled=True)
    assert want["num_leaves"] == 31
    got, prl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                         wave_kernel=kernel, bundled=True)
    assert_same_tree(want, got, rl, prl)


def test_bundled_grower_equals_unbundled(onehot):
    """The same rows bundled and unbundled: equal trees and ``row_leaf``
    on the wave layout (and bundled features do split)."""
    X, y, g, h = onehot
    want, rl = port_grow(X, y, P, g, h, leaf_batch=16)
    got, prl = port_grow(X, y, P, g, h, leaf_batch=16, bundled=True)
    assert_same_tree(want, got, rl, prl)
    m = want["num_leaves"] - 1
    assert (want["split_feature"][:m] < 48).any()


def test_grower_mask_layout_bitwise_vs_jax(onehot):
    X, y, _, _ = onehot
    n = 2000
    g, h = exact_grads(n, seed=4)
    params = dict(P, min_data_in_leaf=5)
    want, rl = jax_grow(X[:n], y[:n], params, g, h, bundled=True)
    assert want["num_leaves"] > 8
    got, prl = port_grow(X[:n], y[:n], params, g, h, leaf_batch=4,
                         bundled=True)
    assert_same_tree(want, got, rl, prl)
    plain, prl2 = port_grow(X[:n], y[:n], params, g, h)
    assert_same_tree(want, plain, rl, prl2)


@pytest.mark.parametrize("kernel", ["fused", "unfused"])
def test_grower_quantized_bitwise_vs_jax(onehot, kernel):
    X, y, _, _ = onehot
    g, h = pow2_scale_grads(len(y))
    q = dict(quantized=True, stochastic_rounding=False, leaf_batch=16)
    want, rl = jax_grow(X, y, P, g, h, bundled=True, **q)
    got, prl = port_grow(X, y, P, g, h, wave_kernel=kernel, bundled=True,
                         **q)
    assert_same_tree(want, got, rl, prl)


def test_grower_quantized_mask_layout_bitwise_vs_jax(onehot):
    X, y, _, _ = onehot
    n = 2000
    g, h = pow2_scale_grads(n, seed=5)
    params = dict(P, min_data_in_leaf=5)
    q = dict(quantized=True, stochastic_rounding=False)
    want, rl = jax_grow(X[:n], y[:n], params, g, h, bundled=True, **q)
    got, prl = port_grow(X[:n], y[:n], params, g, h, bundled=True, **q)
    assert_same_tree(want, got, rl, prl)


def test_grower_uint8_bundles_bitwise_vs_jax():
    """Binary one-hot columns: 13-bin bundle columns, a uint8 bundled
    matrix (the other one-hot cases bundle to uint16)."""
    X, y = _binary_onehot_data()
    g, h = exact_grads(len(y))
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=16, bundled=True)
    got, prl = port_grow(X, y, P, g, h, leaf_batch=16, bundled=True)
    assert_same_tree(want, got, rl, prl)
    m = want["num_leaves"] - 1
    assert (want["split_feature"][:m] < 48).any()


@pytest.mark.parametrize("kernel", ["fused", "unfused"])
def test_grower_uint16_bundles_bitwise_vs_jax(kernel):
    X, y = _wide_data()
    g, h = exact_grads(len(y))
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=16, bundled=True)
    got, prl = port_grow(X, y, P, g, h, leaf_batch=16, wave_kernel=kernel,
                         bundled=True)
    assert_same_tree(want, got, rl, prl)
    m = want["num_leaves"] - 1
    assert (want["split_feature"][:m] < 8).any()
    plain, prl2 = port_grow(X, y, P, g, h, leaf_batch=16)
    assert_same_tree(want, plain, rl, prl2)


def test_grower_conflicts_bitwise_vs_jax():
    """Near-exclusive columns bundled under ``max_conflict_rate`` 0.05:
    a conflicting row decodes the overwritten member as its bin 0 (the
    last writer wins), in both packages alike."""
    X, y = _conflict_data()
    g, h = exact_grads(len(y))
    params = dict(P, max_conflict_rate=0.05, min_data_in_leaf=5)
    want, rl = jax_grow(X, y, params, g, h, leaf_batch=4, bundled=True)
    got, prl = port_grow(X, y, params, g, h, leaf_batch=4, bundled=True)
    assert_same_tree(want, got, rl, prl)


def test_grower_sorted_categorical_beside_bundles():
    """A 40-category feature (an identity column taking the sorted scan)
    beside the bundles: the merge reads the rebuilt per-feature
    histograms."""
    X, y = _sorted_cat_data()
    g, h = exact_grads(len(y))
    cat = [X.shape[1] - 1]
    want, rl = jax_grow(X, y, P, g, h, categorical=cat, leaf_batch=16,
                        bundled=True)
    m = want["num_leaves"] - 1
    sets = want["cat_mask"][:m][want["is_cat"][:m]].sum(axis=1)
    assert (sets > 1).any()
    got, prl = port_grow(X, y, P, g, h, categorical=cat, leaf_batch=16,
                         bundled=True)
    assert_same_tree(want, got, rl, prl)


# ---------------------------------------------------------------- training
BASE = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 20,
        "verbosity": -1, "tpu_leaf_batch": 16}


def test_training_parity_and_engagement():
    """Mirrors tests/test_efb.py::test_efb_training_parity_and_engagement:
    bundled training trains the unbundled model's quality (train AUC
    within 1e-3, and within 1e-3 of the JAX package's bundled run), and
    the model text round trip predicts within 1e-6."""
    import lightgbm_tpu as lgb
    X, y = _onehot_data()
    off = lgt.train(dict(BASE, enable_bundle=False), lgt.Dataset(X, label=y),
                    8, device="cpu")
    on = lgt.train(dict(BASE, enable_bundle=True), lgt.Dataset(X, label=y),
                   8, device="cpu")
    assert off._gbdt.bundles is None
    assert on._gbdt.bundles is not None
    assert on._gbdt.bundles.num_groups == 10
    assert on._gbdt._bundle_args["bundle"].meta.shape[0] == 10
    assert tuple(on._gbdt.bins_dev.shape) == (len(y), 10)
    jb = lgb.train(BASE, lgb.Dataset(X, label=y), 8)
    auc_off = auc(y, off.predict(X, raw_score=True))
    auc_on = auc(y, on.predict(X, raw_score=True))
    auc_jax = auc(y, jb.predict(X, raw_score=True))
    assert abs(auc_off - auc_on) < 1e-3
    assert abs(auc_jax - auc_on) < 1e-3
    reloaded = lgt.Booster(model_str=on.model_to_string(), device="cpu")
    np.testing.assert_allclose(reloaded.predict(X[:100]), on.predict(X[:100]),
                               rtol=1e-6, atol=1e-6)


def test_bundle_tables_built_once_a_training(monkeypatch):
    """GBDT builds the bundles' tables once, and every tree of every
    iteration reads those same tables; the grower refuses bundled bins
    without their tables, and tables of another bin axis."""
    import dataclasses

    from lightgbm_tpu_torch.models import gbdt as GB
    from lightgbm_tpu_torch.models.grower import make_grower
    built = []
    real = GB.bundle_tables

    def counting(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]
    monkeypatch.setattr(GB, "bundle_tables", counting)
    X, y = _onehot_data(n=3000)
    seen = []
    bst = lgt.train(dict(BASE, num_leaves=7), lgt.Dataset(X, label=y), 1,
                    device="cpu")
    grow = bst._gbdt.grow
    bst._gbdt.grow = lambda *a, **kw: (seen.append(kw["bundle"]),
                                       grow(*a, **kw))[1]
    for _ in range(3):
        bst.update()
    assert len(built) == 1 and len(seen) == 3
    assert all(t is built[0] for t in seen)
    tables = built[0]
    assert tables.hist_bins == bst._gbdt.bundles.max_group_bins
    np.testing.assert_array_equal(tables.meta[:, 0].numpy(),
                                  bst._gbdt.bundles.group_bins)
    g = bst._gbdt
    args = (g.bins_dev, torch.zeros(len(y)), torch.ones(len(y)),
            torch.ones(len(y)), torch.ones(X.shape[1], dtype=torch.bool),
            g.meta_dev["num_bins_per_feature"], g.meta_dev["nan_bins"],
            g.meta_dev["is_categorical"])
    with pytest.raises(ValueError, match="bundle tables"):
        make_grower(g.grower_cfg)(*args)
    with pytest.raises(ValueError, match="bundle tables"):
        make_grower(dataclasses.replace(
            g.grower_cfg, num_bins=g.grower_cfg.num_bins + 1))(
                *args, bundle=tables)


def test_conflict_budget():
    """max_conflict_rate > 0 merges near-exclusive features (the EFB
    paper's gamma), in ``build_bundles`` and in training."""
    X, y = _conflict_data()
    b = PB.bin_dataset(X)
    assert PB.build_bundles(b, max_conflict_rate=0.0) is None
    fb = PB.build_bundles(b, max_conflict_rate=0.05)
    assert fb is not None and fb.num_groups < X.shape[1]
    params = dict(BASE, num_leaves=15, max_conflict_rate=0.05)
    bst = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    assert bst._gbdt.bundles.num_groups == fb.num_groups
    assert bst.num_trees() == 3
    assert auc(y, bst.predict(X, raw_score=True)) > 0.6


def test_enable_bundle_not_sticky_across_trainings():
    """Training again on one Dataset with another ``enable_bundle``
    decides the bundles anew."""
    X, y = _onehot_data(n=3000)
    ds = lgt.Dataset(X, label=y)
    params = dict(BASE, num_leaves=15)
    b_on = lgt.train(dict(params, enable_bundle=True), ds, 2, device="cpu")
    assert b_on._gbdt.bundles is not None
    b_off = lgt.train(dict(params, enable_bundle=False), ds, 2, device="cpu")
    assert b_off._gbdt.bundles is None
    assert tuple(b_off._gbdt.bins_dev.shape) == X.shape
    b_on2 = lgt.train(dict(params, enable_bundle=True), ds, 2, device="cpu")
    assert b_on2._gbdt.bundles is not None
    assert b_on2.model_to_string() == b_on.model_to_string()


def test_csr_input_trains_the_dense_model():
    """scipy CSR rows bin and bundle to the dense rows' bins and train
    their model text."""
    import scipy.sparse as sp
    X, y = _onehot_data(n=4000)
    dense = lgt.train(BASE, lgt.Dataset(X, label=y), 3, device="cpu")
    sparse = lgt.train(BASE, lgt.Dataset(sp.csr_matrix(X), label=y), 3,
                       device="cpu")
    assert sparse._gbdt.bundles.num_groups == 10
    np.testing.assert_array_equal(sparse._gbdt.bundles.bins,
                                  dense._gbdt.bundles.bins)
    assert sparse.model_to_string() == dense.model_to_string()


def test_multiclass_with_valid_set_trains_bundled():
    """Three classes and a valid set, bundled in both packages: the valid
    multi_logloss within 1e-3 relative of the JAX package's and of the
    port's unbundled run, probabilities within 1e-2.  On this data the
    two packages' unbundled runs already take other near-tie splits
    (softmax gradients go through ``exp``, whose last bit differs
    between the libraries): 3.0e-3 apart in a probability."""
    import lightgbm_tpu as lgb
    X, y = _onehot_data(n=3000)
    label = np.digitize(X[:, 48] + X[:, 0], [-0.5, 0.7]).astype(np.float64)
    params = dict(BASE, objective="multiclass", num_class=3,
                  metric="multi_logloss")
    n = 2400
    hist_j, hist_p, hist_u = {}, {}, {}
    dj = lgb.Dataset(X[:n], label=label[:n])
    jb = lgb.train(params, dj, 4, valid_sets=[lgb.Dataset(
        X[n:], label=label[n:], reference=dj)],
        callbacks=[lgb.record_evaluation(hist_j)])
    runs = []
    for extra, hist in (({}, hist_p), ({"enable_bundle": False}, hist_u)):
        dp = lgt.Dataset(X[:n], label=label[:n])
        runs.append(lgt.train(dict(params, **extra), dp, 4, valid_sets=[
            lgt.Dataset(X[n:], label=label[n:], reference=dp)],
            callbacks=[lgt.record_evaluation(hist)], device="cpu"))
    pb, ub = runs
    assert pb._gbdt.bundles is not None and jb._gbdt.bundles is not None
    assert ub._gbdt.bundles is None
    for other in (jb, ub):
        np.testing.assert_allclose(pb.predict(X), other.predict(X), rtol=0,
                                   atol=1e-2)
    (got,), (want,), (unb,) = (list(h.values())
                               for h in (hist_p, hist_j, hist_u))
    for ref in (want, unb):
        np.testing.assert_allclose(got["multi_logloss"], ref["multi_logloss"],
                                   rtol=1e-3)


# ----------------------------------------------------------------- the card
CARD_CASES = {"f32": (_binary_onehot_data, False),
              "quantized": (_binary_onehot_data, True),
              "f32_uint16": (_wide_data, False),
              "quantized_uint16": (_wide_data, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_bundled_kernel_path_matches_plain(cuda_device, case):
    """The bundled grower on the card (the histogram kernel for the root,
    the wave kernel for every wave, or the histogram kernel for every
    smaller sibling when unfused) gives the CPU plain version's trees bit
    for bit."""
    make, quant = CARD_CASES[case]
    X, y = make()
    g, h = pow2_scale_grads(len(y)) if quant else exact_grads(len(y))
    kw = dict(leaf_batch=16, bundled=True,
              **(dict(quantized=True, stochastic_rounding=False)
                 if quant else {}))
    want, rl = port_grow(X, y, P, g, h, wave_kernel="fused", **kw)
    mode = ("int8" if quant else "f32") + (
        "_uint16" if "uint16" in case else "")
    h0, w0 = HF.launches[mode], WV.launches[mode]
    got, prl = port_grow(X, y, P, g, h, device=cuda_device, **kw)
    assert HF.launches[mode] == h0 + 1 and WV.launches[mode] > w0
    assert_same_tree(want, got, rl, prl)
    h1, w1 = HF.launches[mode], WV.launches[mode]
    got, prl = port_grow(X, y, P, g, h, device=cuda_device,
                         wave_kernel="unfused", **kw)
    assert HF.launches[mode] > h1 + 1 and WV.launches[mode] == w1
    assert_same_tree(want, got, rl, prl)
