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


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    return torch.device("cuda")
