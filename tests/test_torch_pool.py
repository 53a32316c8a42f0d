"""The histogram pool in the port (``histogram_pool_size``, the JAX
package's P-slot pool: ``lightgbm_tpu/models/grower.py::_pool_ops``; its
own tests are tests/test_hist_pool.py), held to the JAX package:

- ``Grower.pool_slots`` / ``pool_active_for`` give the JAX package's slot
  counts over a grid of pool sizes, leaf counts, leaf batches and
  histogram widths;
- on exact-sum gradients (+-0.5, hessian 0.25) and on quantized ones
  (power-of-two scales: integer histograms), a pool far smaller than the
  leaf count (evictions and rebuilt parents) grows the unpooled trees
  and ``row_leaf`` bit for bit, and the JAX package's pooled trees, at
  leaf_batch 1 and 4, through the port's unfused step and the plain
  version of its fused wave;
- a quantized Booster under 4-bit bins and under EFB with a tiny pool:
  raw scores equal to the unpooled run's, and an iteration's model text
  equal to the JAX package's pooled run's;
- the mask layout (<= 2,048 rows) keeps every leaf's histogram at any
  pool size; the knob warns for no composition the port trains.

On the card (``cuda`` marker) the pooled grower through the histogram
and wave kernels grows the CPU unpooled grower's trees bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (assert_same_tree, cuda_device,  # noqa: F401
                             jax_grow, port_grow, pow2_scale_grads)

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.grower import (GrowerConfig, make_grower,
                                              pool_active_for)

P = {"objective": "binary", "num_leaves": 31}
QUANT = dict(quantized=True, stochastic_rounding=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one host thread (a grower is thousands of
    small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_data(n=4 * 2560, f=12):
    """tests/test_hist_pool.py::grow_args' rows: NaNs in one column, the
    label from three columns."""
    rng = np.random.RandomState(7)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n) > 0)
    return X, y.astype(np.float64)


def _grower(L, bins, W, mb):
    return make_grower(GrowerConfig(num_leaves=L, num_bins=bins,
                                    leaf_batch=W, histogram_pool_size=mb))


@pytest.mark.parametrize("mb", [-1.0, 0.0, 0.05, 0.5, 64.0, 1e6])
def test_pool_slots_match_jax(mb):
    import lightgbm_tpu.models.grower as G
    for L in (2, 31, 255):
        for W in (1, 4, 16):
            for bins, hist_bins in ((255, 0), (256, 0), (1023, 0),
                                    (255, 473)):
                port = _grower(L, bins, W, mb)
                jax_cfg = G.GrowerConfig(num_leaves=L, num_bins=bins,
                                         leaf_batch=W, hist_bins=hist_bins,
                                         histogram_pool_size=mb)
                jax = G.make_grower(jax_cfg)
                assert pool_active_for(port.cfg) == G.pool_active_for(
                    jax_cfg)
                for cols in (12, 28, 339, 2000):
                    assert port.pool_slots(cols, hist_bins) == \
                        jax.pool_slots(cols), (L, W, bins, cols)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "quantized"])
@pytest.mark.parametrize("leaf_batch,slots", [(1, 5), (4, 9)])
def test_pooled_grower_bitwise_vs_unpooled_and_jax(leaf_batch, slots,
                                                   quantized):
    X, y = _pool_data()
    if quantized:
        g, h = pow2_scale_grads(len(y))
        kw = dict(QUANT, leaf_batch=leaf_batch)
    else:
        g, h = (0.5 - y).astype(np.float32), np.full(len(y), 0.25,
                                                     np.float32)
        kw = dict(leaf_batch=leaf_batch)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import TrainData
    bins = TrainData.build(X, y, Config(dict(P, verbosity=-1))
                           ).binned.max_num_bins
    pool = slots * X.shape[1] * bins * 3 * 4 / (1 << 20)
    assert _grower(P["num_leaves"], bins, leaf_batch,
                   pool).pool_slots(X.shape[1]) == slots
    want, rl_want = port_grow(X, y, P, g, h, **kw)
    jax, rl_jax = jax_grow(X, y, P, g, h, histogram_pool_size=pool, **kw)
    assert want["num_leaves"] == P["num_leaves"]
    assert_same_tree(want, jax, rl_want, rl_jax)
    for kernel in ("auto", "fused"):
        counts = {}
        got, rl = port_grow(X, y, P, g, h, histogram_pool_size=pool,
                            wave_kernel=kernel, pool_counts=counts, **kw)
        assert_same_tree(want, got, rl_want, rl)
        assert counts["misses"] > 0 and counts["evictions"] > 0
        assert counts["hits"] + counts["misses"] == P["num_leaves"] - 1


def _onehot(n=6000, seed=0):
    """Four one-hot blocks of 12 columns and six normal ones
    (tests/test_torch_efb.py::_onehot_data)."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, 12, (n, 4))
    onehot = [(cats[:, [b]] == np.arange(12)[None, :]) * rng.uniform(
        0.5, 1.5, (n, 12)) for b in range(4)]
    dense = rng.randn(n, 6)
    X = np.hstack(onehot + [dense])
    y = ((cats[:, 0] % 3 == 0) ^ (dense[:, 0] > 0.3)).astype(np.float64)
    return X, y


@pytest.mark.parametrize("layout", ["packed4", "efb"])
def test_booster_pool_quantized(layout):
    """A tiny pool under quantized training (integer histograms: a
    rebuilt parent is the stored one): three iterations give the unpooled
    run's raw scores; one iteration's model text (exact first gradients)
    is the JAX package's pooled run's."""
    import lightgbm_tpu as lgb
    base = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
            "use_quantized_grad": True, "stochastic_rounding": False,
            "boost_from_average": False, "tpu_leaf_batch": 4}
    if layout == "packed4":
        rng = np.random.RandomState(0)
        X = rng.randn(6000, 10)
        y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
        params, pool = dict(base, max_bin=15), 0.005
    else:
        X, y = _onehot()
        params, pool = dict(base, enable_bundle=True), 0.02
    pooled = dict(params, histogram_pool_size=pool)
    off = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    on = lgt.train(pooled, lgt.Dataset(X, label=y), 3, device="cpu")
    g = on._gbdt
    assert (g.grower_cfg.packed4 if layout == "packed4"
            else g.bundles is not None)
    assert g.grow.pool_counts["misses"] > 0
    np.testing.assert_array_equal(on.predict(X, raw_score=True),
                                  off.predict(X, raw_score=True))
    one = lgt.train(pooled, lgt.Dataset(X, label=y), 1, device="cpu")
    jb = lgb.train(pooled, lgb.Dataset(X, label=y), 1)
    assert one.model_to_string() == jb.model_to_string()


def test_mask_layout_keeps_every_histogram():
    """At <= 2,048 rows the grower keeps the full carry whatever the
    pool size, as the JAX package does."""
    X, y = _pool_data(n=2000)
    g, h = (0.5 - y).astype(np.float32), np.full(len(y), 0.25, np.float32)
    want, rl_want = port_grow(X, y, P, g, h, leaf_batch=4)
    for pool in (0.0, 0.001):
        counts = {}
        got, rl = port_grow(X, y, P, g, h, leaf_batch=4,
                            histogram_pool_size=pool, pool_counts=counts)
        assert_same_tree(want, got, rl_want, rl)
        assert counts == dict.fromkeys(("hits", "misses", "evictions"), 0)


def test_pool_knob_never_warns(capsys):
    """The JAX package warns where its composition keeps full residency
    (the GSPMD mask layout, voting, the intermediate / advanced monotone
    refresh); the port trains none of them, so the knob never warns."""
    X, y = _pool_data(n=3000)
    bst = lgt.train({"objective": "binary", "num_leaves": 15,
                     "histogram_pool_size": 0, "verbosity": 1},
                    lgt.Dataset(X, label=y), 2, device="cpu")
    assert pool_active_for(bst._gbdt.grower_cfg)
    assert bst._gbdt.grow.pool_counts["misses"] > 0
    assert "histogram_pool_size" not in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "f32_unfused", "quantized", "bf16"])
def test_pooled_kernel_path_matches_plain(cuda_device, kind):
    """The pooled grower on the card (misses rebuilt by the histogram
    kernel, parents from their slots into the wave kernel) grows the CPU
    unpooled grower's trees and ``row_leaf`` bit for bit."""
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    X, y = _pool_data()
    g, h = (0.5 - y).astype(np.float32), np.full(len(y), 0.25, np.float32)
    kw = {"f32": {}, "f32_unfused": {"wave_kernel": "unfused"},
          "quantized": dict(QUANT),
          "bf16": {"histogram_impl": "flat_bf16",
                   "wave_kernel": "fused"}}[kind]
    if kind == "quantized":
        g, h = pow2_scale_grads(len(y))
    kw["leaf_batch"] = 4
    want, rl_want = port_grow(X, y, P, g, h, **kw)
    before = sum(HF.launches.values())
    counts = {}
    got, rl = port_grow(X, y, P, g, h, device=cuda_device,
                        histogram_pool_size=0.0, pool_counts=counts, **kw)
    assert_same_tree(want, got, rl_want, rl)
    assert counts["misses"] > 0
    assert sum(HF.launches.values()) - before >= 1 + counts["misses"]
