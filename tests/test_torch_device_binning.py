"""Port parity: device binning (lightgbm_tpu_torch/serve/device_binning.py,
run here with device="cpu") against the JAX package's host
``BinnedData.apply`` — bitwise, on the edge cases of exact f64 binning:
NaN, zero-as-missing (the +-1e-35 window), -0.0, values equal to a bound,
categorical truncation toward zero, negative, unseen and >= 2^31
categories, and non-finite values."""

import numpy as np
import pytest
import torch

from torch_port_util import messy_data

from lightgbm_tpu_torch import binning as tb
from lightgbm_tpu_torch.serve import device_binning as tdb

_EDGE_NUM = [0.0, -0.0, np.nan, 1e-36, -1e-36, 1e-35, -1e-35, 9.99e-36,
             5e-324, -5e-324, 1e300, -1e300, np.inf, -np.inf]
_EDGE_CAT = [3.7, -0.5, -0.0, 0.0, -3.0, -1.0, 777.0, 2.0 ** 31 + 5,
             2.0 ** 31 - 1, 2.0 ** 31, 2.0 ** 63, 1e300, -1e300, np.nan,
             np.inf, -np.inf, 0.999, 8.0, 8.5]


def _edge_rows(binned, X, n, seed):
    """n rows drawn from X with edge values planted in 30% of the cells:
    the constants above, plus every feature's own bound values and
    categories."""
    rng = np.random.RandomState(seed)
    rows = X[rng.randint(0, X.shape[0], n)].astype(np.float64)
    for j, m in enumerate(binned.mappers):
        if m.is_categorical:
            pool = _EDGE_CAT + [float(c) for c in m.categories]
        else:
            pool = _EDGE_NUM + [float(b) for b in m.upper_bounds[:-1]]
        pool = np.asarray(pool, np.float64)
        pick = rng.rand(n) < 0.3
        rows[pick, j] = pool[rng.randint(0, len(pool), int(pick.sum()))]
    return rows


def _zero_data():
    rng = np.random.RandomState(1)
    X = rng.randn(1500, 4)
    X[rng.rand(1500, 4) < 0.3] = 0.0
    X[rng.rand(1500, 4) < 0.05] = np.nan
    return X


_CASES = {
    "messy_categorical": (messy_data, {"categorical_features": [4]}),
    "zero_as_missing": (_zero_data, {"zero_as_missing": True}),
    "no_missing": (_zero_data, {"use_missing": False}),
    "coarse_bins": (messy_data, {"categorical_features": [4],
                                 "max_bin": 7}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_device_bins_match_jax_host_bins(case):
    jb = pytest.importorskip("lightgbm_tpu.binning")
    make, kw = _CASES[case]
    X = make()
    if isinstance(X, tuple):
        X = X[0]
    kw = {"max_bin": 255, **kw}
    jbinned = jb.bin_dataset(X, **kw)
    tbinned = tb.bin_dataset(X, **kw)
    rows = _edge_rows(tbinned, X, 3000, seed=len(case))
    with np.errstate(invalid="ignore"):
        want = jbinned.apply(rows).astype(np.int32)
    tables = tdb.build_bin_tables(tbinned.mappers, "cpu")
    got = tdb.bin_rows_device(
        tables, torch.from_numpy(tdb.float_bits(rows))).numpy()
    assert got.dtype == np.int32 and got.shape == rows.shape
    np.testing.assert_array_equal(got, want)


def test_large_categories_refuse_device_binning():
    """Vocabularies with values >= 2^31 cannot be binned exactly on the
    device, as in the JAX package: build_bin_tables returns None."""
    m = tb.BinMapper(num_bins=3, missing_type=tb.MISSING_NONE,
                     is_categorical=True,
                     categories=np.array([2 ** 31, 5], np.int64))
    assert tdb.build_bin_tables([m]) is None
    assert tdb.build_bin_tables([]) is None


def test_sort_keys_order_like_jax_keys():
    """The port's int64 key orders values exactly as the JAX package's
    (hi, lo) uint32 key does, and float_bits carries the same bits."""
    dbj = pytest.importorskip("lightgbm_tpu.serve.device_binning")
    rng = np.random.RandomState(2)
    v = np.concatenate([rng.randn(500) * 10.0 ** rng.randint(-300, 300, 500),
                        [0.0, -0.0, 1e-35, -1e-35, 5e-324, -5e-324,
                         np.inf, -np.inf, 1.0, -1.0]])
    hi, lo = dbj.f64_sort_keys(v)
    jkey = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    tkey = tdb.f64_sort_keys(v)
    np.testing.assert_array_equal(np.argsort(jkey, kind="stable"),
                                  np.argsort(tkey, kind="stable"))
    fh, fl = dbj.float_bits(v.reshape(-1, 2))
    bits = tdb.float_bits(v.reshape(-1, 2)).view(np.uint64)
    np.testing.assert_array_equal((bits >> np.uint64(32)).astype(np.uint32),
                                  fh)
    np.testing.assert_array_equal(bits.astype(np.uint32), fl)
