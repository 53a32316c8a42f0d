"""Sorted many-vs-many categorical splits: the port's
``ops/split.py::sorted_categorical`` / ``merge_sorted_categorical``, its
grower and its training against the JAX package's (``_sorted_categorical``,
``best_split``, ``make_grower``, ``train``) on the CPU.

- The scan, on random exact-sum histograms (gradients in halves,
  hessians in quarters, integer counts: every sum is exact in any order)
  of three leaves at once: gain, set, left sums and counts bit for bit,
  over ``max_cat_threshold`` 1, 4, 32 x ``cat_smooth`` 0, 1, 10 x
  ``min_data_per_group`` 1, 5, 100, with a rest bin in use, a feature
  whose bins are all invalid and features with 1 and 2 usable bins.
- The merge: ``best_split`` and ``best_split_batch`` over numeric,
  one-hot and sorted features bit for bit; a sorted gain equal to a
  numeric one loses to it (sorted wins only strictly).
- The grower, on exact-sum gradients with a 40-category feature at the
  default ``max_cat_to_onehot``: the wave layout through the fused
  step's plain version (leaf_batch 1 and 4) and the unfused step, the
  mask layout, and quantized training on power-of-two scales: trees and
  ``row_leaf`` bit for bit (the JAX package grows unfused: its fused
  gate excludes sorted categoricals).
- Training: one exact-sum iteration gives the JAX package's model text
  byte for byte; eight ordinary iterations give its tree structure line
  for line and predictions within 1e-5 (the gradients after the first
  iteration are not exact sums); the sorted scan beats one-hot on a
  many-category feature and writes multi-category sets;
  ``max_cat_threshold`` caps their size; ``cat_smooth`` and
  ``min_data_per_group`` change the candidates as in the JAX package's
  tests; multiclass and a valid set train with a sorted feature.
- The rest bin (rare, unseen and negative categories and NaN): where the
  sorted scan puts it in a left set, those rows go left in memory and in
  the int16 pack, but right after a model-text round trip (the text's
  bitsets hold category values only), and writing the text warns of it.
  The JAX package predicts the same in memory and writes the same text;
  its loader cannot read most such texts (a set holding a category of 31
  modulo 32 overflows its int32 parse), so the round trip is held to it
  on even category values, where both loaders read the text alike."""

import itertools

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import split as S
from torch_port_util import (assert_same_tree, exact_grads, jax_grow,
                             port_grow, pow2_scale_grads)
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

# the reference; absent where the card runs (its cuda tests live in
# files that do not import JAX)
jnp = pytest.importorskip("jax.numpy")
lgb = pytest.importorskip("lightgbm_tpu")
JS = pytest.importorskip("lightgbm_tpu.ops.split")

# ---------------------------------------------------------------- the scan
#: features: a rest bin in use (24 bins), 12 bins, 2, 1, none valid (all
#: counts 0), 20 bins
NBPF = np.array([24, 12, 2, 1, 6, 20], np.int32)
LEAVES, B = 3, 24


def _scan_hists(seed):
    """(LEAVES, F, B) exact-sum G, H, C: a third of the bins hold 0-3
    rows (below most cat_smooth values), the rest up to 40; zero outside
    each feature's bins and in feature 4."""
    rng = np.random.RandomState(seed)
    shape = (LEAVES, len(NBPF), B)
    cnt = rng.randint(0, 40, shape).astype(np.float32)
    small = rng.rand(*shape) < 0.3
    cnt[small] = rng.randint(0, 4, int(small.sum()))
    cnt[:, np.arange(B)[None, :] >= NBPF[:, None]] = 0.0
    cnt[:, 4] = 0.0
    g = rng.randint(-20, 21, shape).astype(np.float32) * 0.5
    g[cnt == 0] = 0.0
    return g, cnt * 0.25, cnt


@pytest.mark.parametrize(
    "mct,smooth,mdpg", list(itertools.product([1, 4, 32], [0.0, 1.0, 10.0],
                                              [1, 5, 100])))
def test_sorted_scan_bitwise_vs_jax(mct, smooth, mdpg):
    """Tolerance: none (bit for bit on exact sums)."""
    G, H, C = _scan_hists(mct * 100 + int(smooth) * 10 + mdpg)
    pg, ph, pc = (a[:, 0].sum(-1) for a in (G, H, C))
    pout = (-pg / (ph + np.float32(0.5))).astype(np.float32)
    in_feature = np.arange(B)[None, :] < NBPF[:, None]
    kw = dict(max_cat_threshold=mct, cat_smooth=smooth,
              min_data_per_group=mdpg, min_data_in_leaf=1, lambda_l2=0.5,
              cat_l2=1.0)
    got = S.sorted_categorical(
        torch.from_numpy(np.stack([G, H, C], axis=-1)),
        *(torch.from_numpy(a) for a in (pg, ph, pc, pout)),
        torch.from_numpy(in_feature), S.SplitConfig(**kw))
    finite = 0
    for k in range(LEAVES):
        want = JS._sorted_categorical(
            jnp.asarray(G[k]), jnp.asarray(H[k]), jnp.asarray(C[k]), pg[k],
            ph[k], pc[k], pout[k], jnp.asarray(in_feature),
            JS.SplitConfig(**kw), 1.0)
        for name, a, b in zip(("gain", "mask", "gl", "hl", "cl"), got, want):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b),
                                          err_msg=f"{name} leaf {k}")
        finite += int(np.isfinite(np.asarray(want[0])).sum())
        # a feature with no usable bin never has a candidate
        assert got[0][k, 4] == float("-inf")
    if mdpg < 100:
        assert finite > 0


# --------------------------------------------------------------- the merge
#: numeric with a NaN bin, numeric, one-hot (4 bins), sorted with a rest
#: bin (24), sorted (12) masked out, sorted (20)
M_NBPF = np.array([16, 12, 4, 24, 12, 20], np.int32)
M_NAN = np.array([15, 24, 24, 24, 24, 24], np.int32)
M_CAT = np.array([0, 0, 1, 1, 1, 1], bool)
M_FMASK = np.array([1, 1, 1, 1, 0, 1], bool)
MERGE_CASES = {
    "default": dict(min_data_in_leaf=1, min_data_per_group=5, cat_smooth=1.0),
    "cat_l2_0": dict(min_data_in_leaf=2, min_data_per_group=1,
                     cat_smooth=0.0, cat_l2=0.0),
    "path_smooth_l1": dict(min_data_in_leaf=1, min_data_per_group=5,
                           path_smooth=3.0, lambda_l1=0.5, lambda_l2=1.0),
    "min_gain": dict(min_data_in_leaf=1, min_data_per_group=10,
                     min_gain_to_split=2.0, max_cat_threshold=4),
}


def _merge_hist(seed):
    """(F, B, 3) exact-sum histogram of one row set (every feature sums to
    the same totals); the sorted features carry a strong set signal."""
    rng = np.random.RandomState(seed)
    f = len(M_NBPF)
    cnt = rng.randint(0, 30, (f, B)).astype(np.float32)
    g = rng.randint(-10, 11, (f, B)).astype(np.float32) * 0.5
    g[3:] *= 4.0
    hist = np.stack([g, cnt * 0.25, cnt], axis=-1)
    hist[np.arange(B)[None, :] >= M_NBPF[:, None]] = 0.0
    tot = hist[0].sum(axis=0)
    for j in range(1, f):
        hist[j, 0] += tot - hist[j].sum(axis=0)
    return hist, tot


def _jax_best(hist, tot, kw, pout=None):
    return JS.best_split(
        jnp.asarray(hist), *(jnp.float32(v) for v in tot),
        num_bins_per_feature=jnp.asarray(M_NBPF),
        nan_bins=jnp.asarray(M_NAN), is_categorical=jnp.asarray(M_CAT),
        monotone=None, feature_mask=jnp.asarray(M_FMASK),
        cfg=JS.SplitConfig(has_monotone=False, **kw),
        parent_output=None if pout is None else jnp.float32(pout))


def _port_meta():
    return dict(num_bins_per_feature=torch.from_numpy(M_NBPF),
                nan_bins=torch.from_numpy(M_NAN),
                is_categorical=torch.from_numpy(M_CAT),
                feature_mask=torch.from_numpy(M_FMASK))


def _assert_best_equal(got, want, k=None):
    for name in S.BestSplit._fields:
        a = getattr(got, name)
        np.testing.assert_array_equal(
            (a if k is None else a[k]).numpy(),
            np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_bitwise_vs_jax(case):
    """``best_split`` and ``best_split_batch`` (one merge for three
    leaves) against JAX ``best_split``; tolerance: none."""
    kw = MERGE_CASES[case]
    cfg = S.SplitConfig(**kw)
    hists, tots, wins = [], [], 0
    for seed in range(3):
        hist, tot = _merge_hist(seed)
        want = _jax_best(hist, tot, kw)
        got = S.best_split(torch.from_numpy(hist),
                           *(torch.tensor(v) for v in tot), cfg=cfg,
                           **_port_meta())
        _assert_best_equal(got, want)
        wins += int(bool(want.is_cat) and int(want.feature) >= 3)
        hists.append(hist)
        tots.append(tot)
    pout = torch.tensor([0.25, -0.5, 0.0])
    t = [torch.tensor(np.array(v)) for v in zip(*tots)]
    batch = S.best_split_batch(torch.from_numpy(np.stack(hists)), *t, pout,
                               cfg=cfg, **_port_meta())
    for k in range(3):
        _assert_best_equal(batch, _jax_best(hists[k], tots[k], kw,
                                            float(pout[k])), k)
    if case != "min_gain":
        assert wins > 0       # the sorted scan won somewhere


def test_sorted_tie_goes_to_numeric():
    """A sorted categorical feature (0) whose best set is exactly the
    numeric feature (1)'s best threshold split: equal gains, and the
    numeric split wins although its index is higher (the sorted winner
    replaces only a strictly lower gain), as in the JAX package."""
    g = np.array([-6, -4, -2, 2, 4, 6], np.float32)
    cnt = np.full(6, 8.0, np.float32)
    one = np.stack([g, cnt * 0.25, cnt], axis=-1)
    hist = np.zeros((2, 8, 3), np.float32)
    hist[:, :6] = one
    tot = one.sum(axis=0)
    kw = dict(min_data_in_leaf=1, min_data_per_group=1, cat_smooth=0.0,
              cat_l2=0.0, max_cat_to_onehot=4)
    meta = dict(num_bins_per_feature=np.array([6, 6], np.int32),
                nan_bins=np.array([8, 8], np.int32),
                is_categorical=np.array([True, False]),
                feature_mask=np.array([True, True]))
    want = JS.best_split(jnp.asarray(hist), *(jnp.float32(v) for v in tot),
                         monotone=None, cfg=JS.SplitConfig(
                             has_monotone=False, **kw),
                         **{k: jnp.asarray(v) for k, v in meta.items()})
    got = S.best_split(torch.from_numpy(hist),
                       *(torch.tensor(v) for v in tot),
                       cfg=S.SplitConfig(**kw),
                       **{k: torch.from_numpy(v) for k, v in meta.items()})
    _assert_best_equal(got, want)
    assert int(got.feature) == 1 and not bool(got.is_cat)
    assert int(got.bin) == 2
    # the sorted scan alone finds the same gain
    s_gain = S.sorted_categorical(
        torch.from_numpy(hist[None]), *(torch.tensor([v]) for v in tot),
        torch.zeros(1),
        torch.arange(8)[None, :] < torch.tensor([[6], [6]]),
        S.SplitConfig(**kw))[0]
    pgain = S.leaf_gain(torch.tensor(tot[0]), torch.tensor(tot[1]),
                        S.SplitConfig(**kw))
    assert float(s_gain[0, 0] - pgain) == float(got.gain)


# -------------------------------------------------------------- the grower
P = {"objective": "binary", "num_leaves": 31}


@pytest.fixture(scope="module")
def cat40():
    """3 x 2560 rows: a 40-category feature whose label signal is a
    hidden set of categories, and three numeric columns."""
    rng = np.random.RandomState(13)
    n = 3 * 2560
    cat = rng.randint(0, 40, n).astype(np.float64)
    X = np.column_stack([cat, rng.randn(n, 3)])
    lift = (np.arange(40) * 7 % 5) < 2
    y = (lift[cat.astype(int)] ^ (X[:, 1] > 1.0)).astype(np.float64)
    return X, y


def _sets(tree):
    m = tree["num_leaves"] - 1
    return tree["cat_mask"][:m][tree["is_cat"][:m]].sum(axis=1)


@pytest.mark.parametrize("kernel,leaf_batch",
                         [("fused", 1), ("fused", 4), ("unfused", 4)])
def test_grower_wave_bitwise_vs_jax(cat40, kernel, leaf_batch):
    X, y = cat40
    g, h = exact_grads(len(y))
    want, rl = jax_grow(X, y, P, g, h, categorical=[0],
                        leaf_batch=leaf_batch)
    assert (_sets(want) > 1).any()
    got, prl = port_grow(X, y, P, g, h, categorical=[0],
                         leaf_batch=leaf_batch, wave_kernel=kernel)
    assert_same_tree(want, got, rl, prl)


def test_grower_mask_layout_bitwise_vs_jax(cat40):
    X, y = cat40
    n = 2000
    g, h = exact_grads(n, seed=4)
    params = dict(P, min_data_in_leaf=5)
    want, rl = jax_grow(X[:n], y[:n], params, g, h, categorical=[0])
    assert (_sets(want) > 1).any()
    got, prl = port_grow(X[:n], y[:n], params, g, h, categorical=[0],
                         leaf_batch=4)
    assert_same_tree(want, got, rl, prl)


def test_grower_quantized_bitwise_vs_jax(cat40):
    X, y = cat40
    g, h = pow2_scale_grads(len(y))
    q = dict(quantized=True, stochastic_rounding=False, leaf_batch=4)
    want, rl = jax_grow(X, y, P, g, h, categorical=[0], **q)
    assert (_sets(want) > 1).any()
    for kernel in ("fused", "unfused"):
        got, prl = port_grow(X, y, P, g, h, categorical=[0],
                             wave_kernel=kernel, **q)
        assert_same_tree(want, got, rl, prl)


# ---------------------------------------------------------------- training
def _cat_data(n=4000, n_cat=40, seed=5):
    """tests/test_categorical_sorted.py's data: a half of the categories
    lift the label by +2, the rest by -2."""
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, n_cat, size=n)
    lift = np.where((np.arange(n_cat) * 2654435761 % 97) % 2 == 0, 2.0, -2.0)
    y = lift[cat] + 0.3 * rng.randn(n)
    X = np.column_stack([cat.astype(np.float64), rng.randn(n, 2)])
    return X, y


BASE = {"objective": "regression", "num_leaves": 8, "learning_rate": 0.5,
        "min_data_in_leaf": 5, "min_data_per_group": 5, "cat_smooth": 1.0,
        "verbosity": -1, "metric": "l2", "deterministic": True}
STRUCTURE = ("split_feature=", "threshold=", "decision_type=", "left_child=",
             "right_child=", "num_cat=", "cat_boundaries=", "cat_threshold=")


def _structure(text):
    return [ln for ln in text.splitlines() if ln.startswith(STRUCTURE)]


def set_sizes(text):
    """The category count of every categorical node in a model text."""
    sizes = []
    for block in text.split("Tree=")[1:]:
        kv = dict(ln.split("=", 1) for ln in block.splitlines() if "=" in ln)
        if "cat_boundaries" not in kv:
            continue
        bounds = [int(v) for v in kv["cat_boundaries"].split()]
        words = [int(v) for v in kv["cat_threshold"].split()]
        sizes += [sum(bin(w).count("1") for w in words[a:b])
                  for a, b in zip(bounds[:-1], bounds[1:])]
    return sizes


def _both(params, X, y, rounds, **ds_kw):
    jb = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=[0],
                                       **ds_kw), rounds)
    pb = lgt.train(params, lgt.Dataset(X, label=y, categorical_feature=[0],
                                       **ds_kw), rounds, device="cpu")
    return jb, pb


def _assert_tracks_jax(jb, pb, X):
    """Tree structure line for line; predictions within 1e-5."""
    assert _structure(pb.model_to_string()) == _structure(
        jb.model_to_string())
    np.testing.assert_allclose(pb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_one_iteration_model_text_byte_equal(objective):
    """Exact-sum first gradients (boost_from_average off; binary labels,
    or regression labels in halves): the model text byte for byte."""
    X, y = _cat_data()
    label = ((y > 0).astype(np.float64) if objective == "binary"
             else np.round(y * 2) / 2)
    params = dict(BASE, objective=objective, boost_from_average=False,
                  num_leaves=15, max_cat_threshold=16)
    jb, pb = _both(params, X, label, 1)
    text = pb.model_to_string()
    assert text == jb.model_to_string()
    assert max(set_sizes(text)) > 1


def test_sorted_beats_onehot_and_writes_sets():
    X, y = _cat_data()
    jb, pb = _both(dict(BASE, max_cat_to_onehot=1, max_cat_threshold=32),
                   X, y, 8)
    _assert_tracks_jax(jb, pb, X)
    _jo, onehot = _both(dict(BASE, max_cat_to_onehot=256), X, y, 8)
    _assert_tracks_jax(_jo, onehot, X)
    mse = lambda b: float(np.mean((b.predict(X) - y) ** 2))
    assert mse(pb) < 0.7 * mse(onehot), (mse(pb), mse(onehot))
    assert max(set_sizes(pb.model_to_string())) > 1


def test_max_cat_threshold_caps_set_size():
    X, y = _cat_data()
    jb, pb = _both(dict(BASE, max_cat_to_onehot=1, max_cat_threshold=3),
                   X, y, 8)
    _assert_tracks_jax(jb, pb, X)
    sizes = set_sizes(pb.model_to_string())
    assert sizes and max(sizes) <= 3


def test_sorted_cat_text_round_trip():
    X, y = _cat_data(n=2000, n_cat=25)
    _jb, pb = _both(dict(BASE, max_cat_to_onehot=1), X, y, 5)
    loaded = lgt.Booster(model_str=pb.model_to_string(), device="cpu")
    np.testing.assert_allclose(loaded.predict(X), pb.predict(X), rtol=0,
                               atol=1e-6)


def _toy(b=16):
    G = np.linspace(-5, 5, b)[None, :].astype(np.float32)
    H = np.full((1, b), 10.0, np.float32)
    C = np.full((1, b), 20.0, np.float32)
    return G, H, C


def _toy_split(G, H, C, kw, n_bins=16):
    """The root split of a one-feature categorical histogram, by both
    packages (tests/test_categorical_sorted.py::_root_split)."""
    hist = np.stack([G, H, C], axis=-1)
    f, b = G.shape
    meta = dict(num_bins_per_feature=np.full(f, n_bins, np.int32),
                nan_bins=np.full(f, b, np.int32),
                is_categorical=np.ones(f, bool), feature_mask=np.ones(f, bool))
    tot = [hist[..., c].sum(dtype=np.float32) for c in range(3)]
    want = JS.best_split(jnp.asarray(hist), *(jnp.float32(v) for v in tot),
                         monotone=None, cfg=JS.SplitConfig(**kw),
                         **{k: jnp.asarray(v) for k, v in meta.items()})
    got = S.best_split(torch.from_numpy(hist), *(torch.tensor(v) for v in tot),
                       cfg=S.SplitConfig(**kw),
                       **{k: torch.from_numpy(v) for k, v in meta.items()})
    _assert_best_equal(got, want)
    return got


def test_cat_smooth_filters_small_bins():
    base = dict(min_data_in_leaf=1, min_sum_hessian_in_leaf=1e-3,
                max_cat_to_onehot=1, min_data_per_group=1, cat_l2=0.0)
    G, H, C = _toy()
    lo = _toy_split(G, H, C, dict(base, cat_smooth=1.0))
    hi = _toy_split(G, H, C, dict(base, cat_smooth=1000.0))
    assert float(lo.gain) > 0
    assert float(hi.gain) == float("-inf")
    C2 = C.copy()
    C2[0, :4] = 3.0
    mid = _toy_split(G, H, C2, dict(base, cat_smooth=5.0))
    assert not mid.cat_mask[:4].any()


def test_min_data_per_group_changes_candidates():
    base = dict(min_data_in_leaf=1, min_sum_hessian_in_leaf=1e-3,
                max_cat_to_onehot=1, cat_smooth=1.0, cat_l2=0.0)
    G, H, C = _toy()
    small = _toy_split(G, H, C, dict(base, min_data_per_group=1))
    big = _toy_split(G, H, C, dict(base, min_data_per_group=60))
    n_small, n_big = int(small.cat_mask.sum()), int(big.cat_mask.sum())
    assert n_small == 8
    assert n_big != n_small and n_big % 3 == 0
    assert float(big.gain) <= float(small.gain)


def test_multiclass_and_valid_set_train_with_a_sorted_feature():
    """Three classes and a valid set: the JAX package's tree structure;
    probabilities within 1e-4 and the valid logloss within 1e-5 relative
    (softmax gradients go through ``exp``, whose last bit differs between
    the libraries, and small multiclass hessians magnify it in the leaf
    values)."""
    X, y = _cat_data(n=3000)
    label = np.digitize(y + 0.3 * X[:, 1], [-1.0, 1.0]).astype(np.float64)
    params = dict(BASE, objective="multiclass", num_class=3,
                  metric="multi_logloss", max_cat_threshold=8)
    n = 2400
    hist_j, hist_p = {}, {}
    dj = lgb.Dataset(X[:n], label=label[:n], categorical_feature=[0])
    jb = lgb.train(params, dj, 4, valid_sets=[lgb.Dataset(
        X[n:], label=label[n:], reference=dj)],
        callbacks=[lgb.record_evaluation(hist_j)])
    dp = lgt.Dataset(X[:n], label=label[:n], categorical_feature=[0])
    pb = lgt.train(params, dp, 4, valid_sets=[lgt.Dataset(
        X[n:], label=label[n:], reference=dp)],
        callbacks=[lgt.record_evaluation(hist_p)], device="cpu")
    assert _structure(pb.model_to_string()) == _structure(
        jb.model_to_string())
    np.testing.assert_allclose(pb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-4)
    assert max(set_sizes(pb.model_to_string())) > 1
    (want,), (got,) = (list(h.values()) for h in (hist_j, hist_p))
    np.testing.assert_allclose(got["multi_logloss"], want["multi_logloss"],
                               rtol=1e-5)


# -------------------------------------------------------------- the rest bin
def _rest_data(n=20_000, seed=0):
    """300 Zipf-like categories at max_bin 63: the rarest 238 share the
    rest bin, and every one of them carries a positive label, so the
    sorted scan sends the rest bin left."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, 301) ** 1.1
    cat = rng.choice(300, n, p=p / p.sum())
    lift = rng.rand(300) < 0.5
    y = (lift[cat] ^ (rng.rand(n) < 0.2)).astype(np.float64)
    y[cat >= 62] = 1.0
    return np.column_stack([cat.astype(np.float64), rng.randn(n)]), y


REST_PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
               "verbosity": -1, "min_data_per_group": 20, "cat_smooth": 5.0,
               "boost_from_average": False}


def test_rest_bin_goes_right_after_a_text_round_trip():
    """Rows in the rest bin (a rare category, an unseen one, a negative
    one, NaN) follow the rest bin's side in memory and in the int16 pack,
    and go right once the model is read back from text, whose bitsets
    hold category values only: the JAX package's behaviour, which the
    port keeps.  One exact-sum iteration: the texts are byte for byte."""
    X, y = _rest_data()
    jb, pb = _both(REST_PARAMS, X, y, 1)
    with pytest.warns(UserWarning, match="rest bin"):
        text = pb.model_to_string()
    assert text == jb.model_to_string()
    binned = pb._gbdt.train_data.binned
    rest = binned.mappers[0].num_bins - 1
    tree = pb._gbdt.models[0][0]
    m = tree.num_leaves - 1
    assert tree.cat_mask[:m][tree.is_cat[:m], rest].any()
    rows = np.column_stack([[299.0, 250.0, 1000.0, -3.0, np.nan, 0.0],
                            np.zeros(6)])
    mem = pb.predict(rows, raw_score=True)
    np.testing.assert_array_equal(mem, jb.predict(rows, raw_score=True))
    served = pb.serving_predictor(quantize="int16", raw_score=True).predict(
        rows)
    assert np.abs(served - mem).max() < 1e-2      # the int16 pack's bound
    loaded = lgt.Booster(model_str=text, device="cpu").predict(
        rows, raw_score=True)
    # category 0 has its own bin: the same leaf; the rest-bin rows differ
    assert loaded[5] == pytest.approx(mem[5], abs=1e-6)
    assert (np.abs(loaded[:5] - mem[:5]) > 1e-3).all()
    assert np.unique(loaded[:5]).size == 1


def test_rest_bin_round_trip_matches_the_jax_loader():
    """The rest-bin data with even category values, whose sets the JAX
    package's loader parses (bit 31 of a word is an odd value): the port's
    text byte for byte the JAX package's, and both loaders read it alike,
    the rest-bin rows right where memory sends them left.  Tolerance: the
    loaded predictions within 1e-6."""
    X, y = _rest_data()
    X[:, 0] *= 2.0
    jb, pb = _both(REST_PARAMS, X, y, 1)
    with pytest.warns(UserWarning, match="rest bin"):
        text = pb.model_to_string()
    assert text == jb.model_to_string()
    rows = np.column_stack([[598.0, 500.0, 2000.0, -6.0, np.nan, 0.0],
                            np.zeros(6)])
    mem = pb.predict(rows, raw_score=True)
    j_loaded = lgb.Booster(model_str=text).predict(rows, raw_score=True)
    p_loaded = lgt.Booster(model_str=text, device="cpu").predict(
        rows, raw_score=True)
    np.testing.assert_allclose(p_loaded, j_loaded, rtol=0, atol=1e-6)
    assert (np.abs(j_loaded[:5] - mem[:5]) > 1e-3).all()
    assert j_loaded[5] == pytest.approx(mem[5], abs=1e-6)
