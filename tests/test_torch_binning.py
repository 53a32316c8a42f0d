"""Port parity: host binning (lightgbm_tpu_torch/binning.py) against the JAX
package's binning.py — mappers byte for byte (in the flat-array encoding a
model is carried across in) and bin matrices equal, dtype included; at
max_bin 511 and 1023 (with NaNs and a categorical column) the matrices
are uint16 in both.  Per-feature budgets (``max_bin_by_feature``) and
forced upper bounds (``forcedbins_filename``, read by ``load_forced_bins``)
give the JAX package's mappers too: the matrix is uint16 when any feature
passes 256 bins, uint8 otherwise.

The JAX package is imported inside the tests, never at module level, so the
file also collects on the card, where only the port is installed."""

import numpy as np
import pytest

from torch_port_util import higgs_like, messy_data

from lightgbm_tpu_torch import binning as tb


def _datasets():
    rng = np.random.RandomState(3)
    zeros = rng.randn(900, 4)
    zeros[rng.rand(900, 4) < 0.3] = 0.0
    zeros[rng.rand(900, 4) < 0.05] = np.nan
    const = np.column_stack([np.ones(300), rng.randn(300),
                             np.full(300, np.nan)])
    heavy = np.round(rng.randn(2000, 3) * 3)          # heavy hitters
    wide = higgs_like(4000, 6, seed=2)[0].astype(np.float64)
    wide[rng.rand(4000, 6) < 0.05] = np.nan
    return {
        "messy": (messy_data()[0], {"categorical_features": [4]}),
        "higgs": (higgs_like(3000, 8)[0], {}),
        "higgs_sampled": (higgs_like(3000, 5, seed=1)[0],
                          {"sample_cnt": 700, "random_state": 7}),
        "zero_as_missing": (zeros, {"zero_as_missing": True}),
        "no_missing": (zeros, {"use_missing": False}),
        "constant_and_all_nan": (const, {}),
        "heavy_hitters_small_max_bin": (heavy, {"max_bin": 15,
                                                "min_data_in_bin": 20}),
        "nan_max_bin_1023": (wide, {"max_bin": 1023}),
        "messy_max_bin_511": (messy_data()[0], {"categorical_features": [4],
                                                "max_bin": 511}),
        "by_feature_mixed": (wide, {"max_bin_by_feature":
                                    [15, 63, 255, 1023, 4, 300]}),
        "by_feature_narrow": (higgs_like(3000, 4, seed=4)[0],
                              {"max_bin_by_feature": [16, 8, 200, 3]}),
        "forced_bins": (wide, {"max_bin": 63, "forced_bins": {
            0: [-1.0, 0.0, 1e-40, 0.5, 2.0], 3: [0.25, 9.0, -0.7]}}),
        "forced_by_feature": (wide, {"max_bin_by_feature":
                                     [15, 63, 255, 1023, 16, 4],
                                     "forced_bins": {1: [-0.5, 0.5],
                                                     5: [0.1, 0.2, 0.3,
                                                         0.4, 0.5]}}),
    }


_DATA = _datasets()


def _jax_binning():
    return pytest.importorskip("lightgbm_tpu.binning")


def _assert_same_mappers(jmappers, tmappers, jb):
    ja, ta = jb.mappers_to_arrays(jmappers), tb.mappers_to_arrays(tmappers)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        assert ja[k].shape == ta[k].shape, k
        assert ja[k].tobytes() == ta[k].tobytes(), k


@pytest.mark.parametrize("name", sorted(_DATA))
def test_bin_dataset_matches_jax(name):
    jb = _jax_binning()
    X, kw = _DATA[name]
    kw = {"max_bin": 255, **kw}
    j = jb.bin_dataset(X, **kw)
    t = tb.bin_dataset(X, **kw)
    _assert_same_mappers(j.mappers, t.mappers, jb)
    assert j.bins.dtype == t.bins.dtype
    np.testing.assert_array_equal(j.bins, t.bins)
    np.testing.assert_array_equal(j.nan_bins, t.nan_bins)
    assert j.max_num_bins == t.max_num_bins
    np.testing.assert_array_equal(j.upper_bounds_padded,
                                  t.upper_bounds_padded)


def test_sparse_ingestion_matches_jax():
    sp = pytest.importorskip("scipy.sparse")
    jb = _jax_binning()
    rng = np.random.RandomState(5)
    X = rng.randn(800, 6) * (rng.rand(800, 6) < 0.3)
    j = jb.bin_dataset(sp.csr_matrix(X), 63)
    t = tb.bin_dataset(sp.csr_matrix(X), 63)
    _assert_same_mappers(j.mappers, t.mappers, jb)
    np.testing.assert_array_equal(j.bins, t.bins)
    # applying the mappers to new sparse rows: the CSC path
    Xn = sp.csr_matrix(rng.randn(50, 6) * (rng.rand(50, 6) < 0.5))
    np.testing.assert_array_equal(j.apply(Xn), t.apply(Xn))


def test_apply_edge_values_matches_jax():
    """New rows with NaN, +-0.0, bound values, +-inf and out-of-vocabulary
    categories bin identically (JAX's native fast path vs the port's numpy
    path)."""
    jb = _jax_binning()
    X, kw = _DATA["messy"]
    j = jb.bin_dataset(X, 255, **kw)
    t = tb.bin_dataset(X, 255, **kw)
    ub = t.mappers[0].upper_bounds
    rows = np.zeros((12, X.shape[1]))
    rows[:, 0] = [np.nan, 0.0, -0.0, ub[0], ub[3], ub[-2], np.inf, -np.inf,
                  1e300, -1e300, ub[5] + 1e-12, ub[5] - 1e-12]
    rows[:, 4] = [np.nan, 3.7, -0.5, -3.0, 777.0, 2.0 ** 31 + 5, 1e300,
                  np.inf, 8.0, 0.0, -0.0, 2.0]
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(j.apply(rows), t.apply(rows))


def test_mapper_arrays_round_trip():
    """The flat encoding decodes into the same mappers in both packages."""
    jb = _jax_binning()
    X, kw = _DATA["messy"]
    arrays = jb.mappers_to_arrays(jb.bin_dataset(X, 255, **kw).mappers)
    back = tb.mappers_to_arrays(tb.mappers_from_arrays(arrays))
    for k in arrays:
        assert arrays[k].tobytes() == back[k].tobytes(), k


@pytest.mark.parametrize("name", ["nan_max_bin_1023", "messy_max_bin_511",
                                  "by_feature_mixed"])
def test_wide_max_bin_bins_are_uint16(name):
    """Above 256 bins a feature, the bin matrix is uint16 (the JAX
    package's storage), with ids past 255 in use."""
    X, kw = _DATA[name]
    t = tb.bin_dataset(X, **kw)
    assert t.bins.dtype == np.uint16 and t.max_num_bins > 256
    assert int(t.bins.max()) > 255


def test_per_feature_budgets_and_forced_bounds():
    """Each feature keeps its own budget, the forced bounds stand among
    the boundaries (the lowest ones, as many as the feature's budget
    holds), and a matrix of features at <= 256 bins stays uint8."""
    X, kw = _DATA["forced_by_feature"]
    t = tb.bin_dataset(X, **kw)
    for j, m in enumerate(t.mappers):
        assert m.num_bins <= kw["max_bin_by_feature"][j], j
        assert t.num_bins_per_feature[j] == m.num_bins
    assert {-0.5, 0.5} <= set(t.mappers[1].upper_bounds.tolist())
    # budget 4 with a NaN bin: 3 value bins, so 2 of the 5 forced bounds
    assert t.mappers[5].upper_bounds.tolist() == [0.1, 0.2, np.inf]
    X, kw = _DATA["by_feature_narrow"]
    assert tb.bin_dataset(X, **kw).bins.dtype == np.uint8
    with pytest.raises(ValueError, match="exact match"):
        tb.bin_dataset(X, max_bin_by_feature=[16, 16])
    with pytest.raises(ValueError, match="> 1"):
        tb.bin_dataset(X, max_bin_by_feature=[16, 1, 16, 16])


def test_load_forced_bins_matches_jax(tmp_path):
    """The forced-bins JSON file reads alike: a categorical feature's
    entry is skipped, a missing file is ignored, and a feature out of
    range raises."""
    import json
    jb = _jax_binning()
    path = str(tmp_path / "forced.json")
    spec = [{"feature": 0, "bin_upper_bound": [0.5, -1, 2]},
            {"feature": 2, "bin_upper_bound": [3]},
            {"feature": 4, "bin_upper_bound": [1.5, 2.5]}]
    with open(path, "w") as fh:
        json.dump(spec, fh)
    for cats in ((), (2,)):
        assert (tb.load_forced_bins(path, 5, cats)
                == jb.load_forced_bins(path, 5, cats))
    assert tb.load_forced_bins(path, 5, (2,)) == {0: [0.5, -1.0, 2.0],
                                                  4: [1.5, 2.5]}
    missing = str(tmp_path / "none.json")
    assert tb.load_forced_bins(missing, 5) is None
    assert tb.load_forced_bins("", 5) is None
    with pytest.raises(ValueError, match="out of range"):
        tb.load_forced_bins(path, 3)


def test_two_bin_budget_with_nan_matches_jax_python_path(monkeypatch):
    """A budget of 2 bins on a feature with NaN leaves one value bin.  The
    JAX package's Python boundary search (and the port's copy) closes it
    with a bound and +inf (3 bins with the NaN bin); its C++ search
    (``native.find_boundaries``) returns the bound without the +inf (2
    bins).  The port follows the Python path, held here with the C++
    library switched off in this process (ROADMAP queue C records it)."""
    import lightgbm_tpu.native as native
    jb = _jax_binning()
    X = _DATA["by_feature_mixed"][0]
    kw = {"max_bin_by_feature": [15, 63, 255, 1023, 2, 300]}
    fast = jb.bin_dataset(X, **kw)
    monkeypatch.setattr(native, "_load", lambda: None)
    j = jb.bin_dataset(X, **kw)
    t = tb.bin_dataset(X, **kw)
    _assert_same_mappers(j.mappers, t.mappers, jb)
    np.testing.assert_array_equal(j.bins, t.bins)
    assert t.mappers[4].num_bins == 3 and fast.mappers[4].num_bins == 2
