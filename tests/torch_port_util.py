"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
data made with numpy from a seed, and a JAX booster carried across into the
port as plain arrays."""

import numpy as np
import pytest
import torch


def messy_data(n=1600, f=6, seed=0):
    """NaNs, a categorical column (4) with the unseen value 777, and columns
    at scales from 1e-3 to 1e5 (tests/test_serve_quantize.py's data)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f) * np.array([1.0, 50.0, 1e-3, 1e5, 1.0, 1.0])[:f]
    X[rng.rand(n, f) < 0.08] = np.nan
    if f > 4:
        X[:, 4] = rng.randint(0, 9, n)
        X[rng.rand(n) < 0.04, 4] = 777
    y = (X[:, 0] + np.nan_to_num(X[:, 1]) / 50.0 > 0).astype(np.float64)
    return X, y


def higgs_like(n, f, seed=0):
    """bench.make_higgs_like's generator, without its disk cache."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    logits = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    p = 1 / (1 + np.exp(-logits))
    y = (rng.rand(n) < p).astype(np.float64)
    return X, y


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Autouse in every tests/test_torch_*.py (imported there): each test
    runs torch on one host thread.  A grower is thousands of small ops,
    which several threads a process only slow down when the suite's
    workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: tests/test_serve_quantize.py's booster parameters
P = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
     "verbosity": -1, "categorical_feature": "4"}


def state_from_booster(bst):
    """The JAX booster as the plain arrays ``model_from_arrays`` takes."""
    from lightgbm_tpu.binning import mappers_to_arrays
    g = bst._gbdt
    fields = ("split_feature", "split_bin", "default_left", "is_cat",
              "cat_mask", "left_child", "right_child", "leaf_value")
    trees = [[{**{k: np.asarray(getattr(tr, k)) for k in fields},
               "num_leaves": int(tr.num_leaves)} for tr in cls]
             for cls in g.host_trees()]
    return {
        "mappers": mappers_to_arrays(g.train_data.binned.mappers),
        "trees": trees,
        "init_scores": np.asarray(g.init_scores, np.float64),
        "num_class": int(g.num_class),
        "objective": g.cfg.objective,
        "sigmoid": float(g.cfg.sigmoid),
        "num_leaves": int(g.cfg.num_leaves),
    }


#: TreeArrays fields compared bit for bit between the packages
TREE_FIELDS = ("split_feature", "split_bin", "default_left", "is_cat",
               "cat_mask", "left_child", "right_child", "split_gain",
               "internal_value", "internal_count", "leaf_value",
               "leaf_count", "leaf_weight")


def grown_data(n=3 * 2560, f=12, seed=7):
    """tests/test_wave_fused.py::grown's data: > 2048 rows, NaNs in one
    column, one low-cardinality integer column kept numerical."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.05, 3] = np.nan
    X[:, 5] = rng.randint(0, 6, n)
    y = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n) > 0)
    return X, y.astype(np.float64)


def exact_grads(n, seed=3):
    """test_wave_fused.py::_exact_grow_args' gradients: +-0.5 and 0.25, so
    every histogram sum is exact in any order."""
    rng = np.random.RandomState(seed)
    sign = (rng.rand(n) > 0.5).astype(np.float32)
    return sign - np.float32(0.5), np.full(n, 0.25, np.float32)


def pow2_scale_grads(n, seed=3):
    """Gradients in [-1, 1] with one row at exactly -1 and hessians in
    (0, 1] with one row at exactly 1: quantized training's scales are then
    powers of two (0.5 and 0.25 at num_grad_quant_bins 4), so deterministic
    rounding still rounds, and every scaled histogram sum is exact."""
    rng = np.random.RandomState(seed)
    g = rng.uniform(-1, 1, n).astype(np.float32)
    h = rng.uniform(0.01, 1, n).astype(np.float32)
    g[0] = -1.0
    h[1] = 1.0
    return g, h


def jax_grow(X, y, params, grad, hess, categorical=(), sample_mask=None,
             **grower_kw):
    """The JAX package's ``make_grower`` on the binned ``X`` -> (tree
    fields as numpy, row_leaf); ``sample_mask`` (N,) f32 row weights
    (bagging / GOSS), every row at 1 by default.  ``bundled=True``: on
    the JAX package's EFB bundles of the bins (``max_conflict_rate`` from
    ``params``), ``hist_bins`` their widest column."""
    import dataclasses

    import jax.numpy as jnp

    import lightgbm_tpu.models.grower as G
    from lightgbm_tpu.config import Config
    from lightgbm_tpu.dataset import TrainData
    from lightgbm_tpu.models.gbdt import _split_config
    cfg = Config(dict(params, verbosity=-1))
    td = TrainData.build(X, y, cfg, categorical_features=list(categorical))
    base = G.GrowerConfig(num_leaves=cfg.num_leaves,
                          num_bins=td.binned.max_num_bins,
                          split=_split_config(cfg, td))
    meta = td.feature_meta_device()
    n, f = td.binned.bins.shape
    bins = jnp.asarray(td.binned.bins)
    efb = {}
    if grower_kw.get("bundled"):
        from lightgbm_tpu.binning import build_bundles
        fb = build_bundles(td.binned,
                           max_conflict_rate=cfg.max_conflict_rate)
        assert fb is not None, "the data does not bundle"
        bins = jnp.asarray(fb.bins)
        grower_kw = dict(grower_kw, hist_bins=fb.max_group_bins)
        efb = {"feat_group": jnp.asarray(fb.feat_group),
               "feat_offset": jnp.asarray(fb.feat_offset)}
    grow = G.make_grower(dataclasses.replace(base, **grower_kw))
    if grower_kw.get("packed4"):
        from lightgbm_tpu.ops.histogram import pack_bins4
        bins = pack_bins4(bins)
    mask = (jnp.ones(n, jnp.float32) if sample_mask is None
            else jnp.asarray(sample_mask, jnp.float32))
    tree, row_leaf = grow(
        bins, jnp.asarray(grad), jnp.asarray(hess), mask, jnp.ones(f, bool),
        meta["num_bins_per_feature"], meta["nan_bins"],
        meta["is_categorical"], meta["monotone"], **efb)
    fields = {k: np.asarray(getattr(tree, k)) for k in TREE_FIELDS}
    fields["num_leaves"] = int(tree.num_leaves)
    return fields, np.asarray(row_leaf)


def port_grow(X, y, params, grad, hess, categorical=(), device="cpu",
              sample_mask=None, pool_counts=None, **grower_kw):
    """The port's grower on the same rows -> (tree fields as numpy,
    row_leaf); ``bundled=True`` as in :func:`jax_grow`, on the port's
    bundles; a ``pool_counts`` dict gets the grower's histogram pool
    counts."""
    import dataclasses

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import TrainData
    from lightgbm_tpu_torch.models.gbdt import _split_config
    from lightgbm_tpu_torch.models.grower import GrowerConfig, make_grower
    from lightgbm_tpu_torch.ops.bundle import bundle_tables
    cfg = Config(dict(params, verbosity=-1))
    td = TrainData.build(X, y, cfg, categorical_features=list(categorical))
    base = GrowerConfig(num_leaves=cfg.num_leaves,
                        num_bins=td.binned.max_num_bins,
                        split=_split_config(cfg, td))
    dev = torch.device(device)
    meta = td.feature_meta_device(dev)
    n, f = td.binned.bins.shape
    efb = {}
    grower_kw = dict(grower_kw)
    if grower_kw.pop("bundled", False):
        fb = td.build_bundles(cfg)
        assert fb is not None, "the data does not bundle"
        bins = td.bundled_bins_device(dev)
        efb = {"bundle": bundle_tables(fb, td.binned.num_bins_per_feature,
                                       base.num_bins, dev)}
    else:
        bins = td.bins_device(dev, packed4=grower_kw.get("packed4", False))
    grow = make_grower(dataclasses.replace(base, **grower_kw))
    mask = (torch.ones(n, device=dev) if sample_mask is None
            else torch.from_numpy(np.asarray(sample_mask, np.float32)).to(dev))
    tree, row_leaf = grow(
        bins, torch.from_numpy(grad).to(dev),
        torch.from_numpy(hess).to(dev), mask,
        torch.ones(f, dtype=torch.bool, device=dev),
        meta["num_bins_per_feature"], meta["nan_bins"],
        meta["is_categorical"], **efb)
    if pool_counts is not None:
        pool_counts.update(grow.pool_counts)
    fields = {k: getattr(tree, k).cpu().numpy() for k in TREE_FIELDS}
    fields["num_leaves"] = int(tree.num_leaves)
    return fields, row_leaf.cpu().numpy()


def sequential_chunk_hist(bins, vals, num_bins, chunk_rows):
    """The CUDA kernels' summation order written out as loops: the rows
    of (N, F) numpy bins and (N, 3) float32 values in chunks of
    ``chunk_rows``, each chunk summed cell by cell in row order from 0 in
    float32, then the chunk sums in chunk order from 0."""
    n, f = bins.shape
    total = np.zeros((f, num_bins, 3), np.float32)
    for c0 in range(0, n, chunk_rows):
        part = np.zeros((f, num_bins, 3), np.float32)
        for r in range(c0, min(n, c0 + chunk_rows)):
            for j in range(f):
                part[j, bins[r, j]] += vals[r]
        total = total + part
    return total


def order_sensitive_vals(n, seed):
    """(n, 3) float32 values whose float32 sums depend on their order:
    gradients and hessians across eight decades, counts 1."""
    rng = np.random.RandomState(seed)
    g = rng.randn(n) * 10.0 ** rng.uniform(-4, 4, n)
    h = rng.rand(n) * 10.0 ** rng.uniform(-4, 4, n)
    return np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)


def assert_same_tree(want, got, rl_want=None, rl_got=None):
    """Every TreeArrays field and row_leaf bit for bit."""
    assert got["num_leaves"] == want["num_leaves"]
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if rl_want is not None:
        np.testing.assert_array_equal(rl_got, rl_want, err_msg="row_leaf")


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    return torch.device("cuda")
