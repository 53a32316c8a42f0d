"""The feature-tiled split scan in the port (``tpu_split_tile``,
``ops/split.py::_resolve_tile`` and the blocks of ``best_split`` /
``best_split_batch``; the JAX package's own tests are
tests/test_split_tile.py):

- ``_resolve_tile`` is the JAX package's over widths and feature counts;
- on the JAX test's F = 300, B = 32 histograms with one-hot and sorted
  categorical features, the tiled scan gives every field of the untiled
  one bit for bit, at widths that do not divide F (7 and 128), batched
  and alone, at ``{}`` and at ``lambda_l1`` + ``path_smooth`` (where the
  JAX package's tiled scan parts from its untiled one, a known failure of
  its own test); the untiled scan is the JAX package's bit for bit;
- a tie across blocks between a sorted categorical winner and a numeric
  one goes where the untiled scan sends it;
- the grower at 4-wide blocks grows the untiled grower's trees and the
  JAX package's, and a one-hot dataset of more than 256 features trains
  the same model text under auto (128-wide blocks over its scans in
  feature space) as untiled.

``block_width`` is ``_resolve_tile`` on the CPU; on a CUDA device auto
tiles only past ``AUTO_TILE_BYTES`` of untiled stats.  On the card
(``cuda`` marker) the 128-wide tiled scan of random histograms at the
EFB wave's shape gives the untiled fields bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (assert_same_tree, cuda_device,  # noqa: F401
                             jax_grow, port_grow)

import lightgbm_tpu_torch as lgt
import lightgbm_tpu_torch.ops.split as S
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

F, B, K = 300, 32, 6

BASE = dict(min_data_in_leaf=1, min_data_per_group=5, cat_smooth=1.0,
            max_cat_to_onehot=8)
CFGS = {"default": {}, "l1_path_smooth": {"lambda_l1": 0.5,
                                          "path_smooth": 2.0}}


def _meta(seed=0):
    """tests/test_split_tile.py's meta: 5 to 31 bins a feature, NaN bins
    on 30%, 20% categorical (one-hot up to 8 bins, sorted above), 10%
    masked out."""
    rng = np.random.RandomState(seed)
    nbpf = rng.randint(5, B, F).astype(np.int32)
    nanb = np.where(rng.rand(F) < 0.3, nbpf - 1, B).astype(np.int32)
    iscat = rng.rand(F) < 0.2
    fmask = rng.rand(F) < 0.9
    return {"num_bins_per_feature": nbpf, "nan_bins": nanb,
            "is_categorical": iscat, "feature_mask": fmask}


def _hists(meta, seed=1):
    """(K, F, B, 3) exact-sum histograms of K row sets, each feature
    summing to its row set's totals; the categorical features carry a
    strong signal, so sorted and one-hot winners occur."""
    rng = np.random.RandomState(seed)
    cnt = rng.randint(0, 30, (K, F, B)).astype(np.float32)
    g = rng.randint(-10, 11, (K, F, B)).astype(np.float32) * 0.5
    g[:, meta["is_categorical"]] *= 4.0
    h = np.stack([g, cnt * 0.25, cnt], axis=-1)
    h[:, np.arange(B)[None, :] >= meta["num_bins_per_feature"][:, None]] = 0
    tot = h[:, 0].sum(axis=1)                                  # (K, 3)
    h[:, :, 0] += tot[:, None, :] - h.sum(axis=2)
    return h, tot


def _port(meta):
    return {k: torch.from_numpy(v) for k, v in meta.items()}


def _assert_best_equal(got, want):
    for name in S.BestSplit._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("tile", [0, 1, 2, 4, 64, 128, 256, 300, 4096])
def test_resolve_tile_matches_jax(tile):
    from lightgbm_tpu.ops.split import _resolve_tile
    for f in (1, 2, 28, 256, 257, 300, 660, 2000):
        assert S._resolve_tile(tile, f) == _resolve_tile(tile, f), f


@pytest.mark.parametrize("width", [7, 128])
@pytest.mark.parametrize("case", sorted(CFGS))
def test_tiled_matches_untiled(case, width):
    meta = _meta()
    hist, tot = _hists(meta)
    kw = dict(BASE, **CFGS[case])
    untiled, tiled = S.SplitConfig(scan_tile=1, **kw), S.SplitConfig(
        scan_tile=width, **kw)
    assert S._resolve_tile(width, F) == width
    hists = torch.from_numpy(hist)
    t = [torch.from_numpy(tot[:, c].copy()) for c in range(3)]
    pout = torch.linspace(-0.5, 0.5, K)
    want = S.best_split_batch(hists, *t, pout, cfg=untiled, **_port(meta))
    got = S.best_split_batch(hists, *t, pout, cfg=tiled, **_port(meta))
    for name in S.BestSplit._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for k in range(K):
        one = S.best_split(hists[k], *(v[k] for v in t), cfg=tiled,
                           parent_output=pout[k], **_port(meta))
        for name in S.BestSplit._fields:
            assert torch.equal(getattr(one, name), getattr(want, name)[k])
    sorted_win = want.is_cat & (want.cat_mask.sum(dim=1) > 1)
    assert bool(sorted_win.any()) and bool((~want.is_cat).any())


@pytest.mark.parametrize("case", sorted(CFGS))
def test_untiled_matches_jax(case):
    import jax.numpy as jnp

    from lightgbm_tpu.ops import split as JS
    meta = _meta()
    hist, tot = _hists(meta)
    kw = dict(BASE, **CFGS[case])
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    for k in range(3):
        want = JS.best_split(
            jnp.asarray(hist[k]), *(jnp.float32(v) for v in tot[k]),
            monotone=None, cfg=JS.SplitConfig(has_monotone=False,
                                              scan_tile=1, **kw), **jmeta)
        got = S.best_split(torch.from_numpy(hist[k]),
                           *(torch.tensor(v) for v in tot[k]),
                           cfg=S.SplitConfig(scan_tile=1, **kw),
                           **_port(meta))
        _assert_best_equal(got, want)


@pytest.mark.parametrize("order,winner", [
    (("cat", "num"), 2), (("num", "cat"), 0), (("cat", "cat"), 0)])
def test_tie_across_blocks(order, winner):
    """Blocks of 2: a sorted categorical feature whose best set is a
    numeric feature's best threshold split (tests/
    test_torch_categorical.py::test_sorted_tie_goes_to_numeric), each
    beside a feature with no split.  On the equal gain the numeric winner
    beats the sorted one whatever its block, else the lower block wins,
    as the untiled scan chooses."""
    g = np.array([-6, -4, -2, 2, 4, 6], np.float32)
    cnt = np.full(6, 8.0, np.float32)
    one = np.stack([g, cnt * 0.25, cnt], axis=-1)
    tot = one.sum(axis=0)
    hist = np.zeros((4, 8, 3), np.float32)
    hist[:, 0] = tot                       # features 1 and 3: one bin
    hist[0, :] = 0
    hist[2, :] = 0
    hist[0, :6] = hist[2, :6] = one
    is_cat = np.array([order[0] == "cat", False, order[1] == "cat", False])
    meta = {"num_bins_per_feature": torch.tensor([6, 1, 6, 1],
                                                 dtype=torch.int32),
            "nan_bins": torch.full((4,), 8, dtype=torch.int32),
            "is_categorical": torch.from_numpy(is_cat),
            "feature_mask": torch.ones(4, dtype=torch.bool)}
    kw = dict(min_data_in_leaf=1, min_data_per_group=1, cat_smooth=0.0,
              cat_l2=0.0, max_cat_to_onehot=4)
    args = (torch.from_numpy(hist), *(torch.tensor(v) for v in tot))
    want = S.best_split(*args, cfg=S.SplitConfig(scan_tile=1, **kw), **meta)
    got = S.best_split(*args, cfg=S.SplitConfig(scan_tile=2, **kw), **meta)
    for name in S.BestSplit._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.feature) == winner and np.isfinite(float(got.gain))
    assert bool(got.is_cat) == (order[winner // 2] == "cat")


@pytest.mark.parametrize("n", [6000, 2000], ids=["wave", "mask"])
def test_tiled_grower_matches_untiled_and_jax(n):
    rng = np.random.RandomState(7)
    X = rng.randn(n, 12)
    X[rng.rand(n) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n) > 0
         ).astype(np.float64)
    g, h = (0.5 - y).astype(np.float32), np.full(n, 0.25, np.float32)
    params = {"objective": "binary", "num_leaves": 31}
    want, rl_want = port_grow(X, y, dict(params, tpu_split_tile=1), g, h,
                              leaf_batch=4)
    got, rl = port_grow(X, y, dict(params, tpu_split_tile=4), g, h,
                        leaf_batch=4)
    jax, rl_jax = jax_grow(X, y, dict(params, tpu_split_tile=4), g, h,
                           leaf_batch=4)
    assert want["num_leaves"] == 31
    assert_same_tree(want, got, rl_want, rl)
    assert_same_tree(want, jax, rl_want, rl_jax)


def test_efb_auto_tiles_same_text():
    """286 one-hot and dense features bundle; their scans in feature
    space take 128-wide blocks at the default (auto) tile, and train the
    untiled run's model text."""
    rng = np.random.RandomState(0)
    n = 4000
    cats = rng.randint(0, 70, (n, 4))
    onehot = [(cats[:, [b]] == np.arange(70)[None, :]) * rng.uniform(
        0.5, 1.5, (n, 70)) for b in range(4)]
    dense = rng.randn(n, 6)
    X = np.hstack(onehot + [dense])
    y = ((cats[:, 0] % 3 == 0) ^ (dense[:, 0] > 0.3)).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "tpu_leaf_batch": 4}
    auto = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    assert auto._gbdt.bundles is not None
    assert S._resolve_tile(auto._gbdt.grower_cfg.split.scan_tile,
                           X.shape[1]) == 128
    untiled = lgt.train(dict(params, tpu_split_tile=1),
                        lgt.Dataset(X, label=y), 3, device="cpu")
    assert untiled.model_to_string().replace(
        "\n[tpu_split_tile: 1]\n", "\n") == auto.model_to_string()


@pytest.mark.parametrize("k,f,b,has_nan,want", [
    (32, 660, 256, True, 0),      # 32 children at 660 features: 371 MiB
    (1, 2000, 256, False, 0),     # a root scan at 2,000 features: 12 MiB
    (32, 2000, 256, True, 128),   # 1,125 MiB
    (128, 660, 256, True, 128),   # 1,485 MiB
])
def test_block_width_budget(k, f, b, has_nan, want):
    """On the CPU ``block_width`` is ``_resolve_tile``; on a CUDA device
    auto tiles only where the untiled (6, D, K, F, B) float32 stats table
    passes AUTO_TILE_BYTES, and an explicit width always tiles."""
    cfg = S.SplitConfig(has_nan=has_nan, has_categorical=has_nan)
    d = 1 + 2 * int(has_nan)
    assert (want != 0) == (6 * d * k * f * b * 4 > S.AUTO_TILE_BYTES)
    assert S.block_width(cfg, k, f, b, cuda=True) == want
    assert S.block_width(cfg, k, f, b, cuda=False) == S._resolve_tile(0, f)
    for tile in (1, 7, 128, 4096):
        explicit = S.SplitConfig(scan_tile=tile, has_nan=has_nan)
        for cuda in (False, True):
            assert S.block_width(explicit, k, f, b, cuda) == \
                S._resolve_tile(tile, f)


@pytest.mark.cuda
def test_tiled_matches_untiled_on_the_card(cuda_device):
    """On the card, random (order-sensitive) histograms at the EFB
    wave's shape (32 children, 660 features) and one child alone: the
    scan in 128-wide blocks (6 blocks) gives the untiled one's fields
    bit for bit (the bins' cumulative sums are taken once over every
    feature, by the untiled scan's own call)."""
    from torch_port_util import order_sensitive_vals
    f, b = 660, 255
    rng = np.random.RandomState(5)
    vals = order_sensitive_vals(32 * f * b, 11).reshape(32, f, b, 3)
    vals[..., 2] = rng.randint(0, 40, (32, f, b))
    meta = {"num_bins_per_feature": torch.full((f,), b, dtype=torch.int32),
            "nan_bins": torch.full((f,), b - 1, dtype=torch.int32),
            "is_categorical": torch.zeros(f, dtype=torch.bool),
            "feature_mask": torch.ones(f, dtype=torch.bool)}
    meta = {key: v.to(cuda_device) for key, v in meta.items()}
    kw = dict(min_data_in_leaf=1, min_sum_hessian_in_leaf=0.0)
    for k in (32, 1):
        hists = torch.from_numpy(vals[:k]).to(cuda_device)
        tot = [hists[:, 0, :, c].sum(dim=1) for c in range(3)]
        pout = torch.zeros(k, device=cuda_device)
        want = S.best_split_batch(hists, *tot, pout, cfg=S.SplitConfig(
            scan_tile=1, **kw), **meta)
        got = S.best_split_batch(hists, *tot, pout, cfg=S.SplitConfig(
            scan_tile=128, **kw), **meta)
        for name in S.BestSplit._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
