"""Device-side binning: raw f64 rows -> bin indices, bitwise-equal to the
host :meth:`BinnedData.apply` path.

The port of the JAX package's ``serve/device_binning.py``.  That module
works in bit space because the TPU runs without 64-bit floats; the card
has them, but the bit-space compare is kept because it is exact and
integer-only: an IEEE-754 double's order equals the signed order of its
64-bit pattern after a monotone transform (``k = b`` for ``b >= 0``,
``k = b ^ 0x7FFF_FFFF_FFFF_FFFF`` otherwise), the same order as the JAX
package's (hi, lo) lexicographic key.  Each feature's bin is then the
count of its bound keys below the value's key (a batched
``torch.searchsorted`` over +inf-padded bound rows), with NaN and
zero-as-missing routing on top.

Categorical columns replicate the host LUT semantics (truncate toward
zero; unseen, negative and non-finite values -> last bin) on the f64
value itself; vocabularies with category values >= 2^31 are refused
(``build_bin_tables`` returns None), as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..binning import _KZERO_HI, _KZERO_LO, MISSING_ZERO, BinMapper

_FLIP = 0x7FFF_FFFF_FFFF_FFFF
#: category-axis padding: above every category value device binning accepts
_CAT_PAD = 1 << 62


def f64_sort_keys(values: np.ndarray) -> np.ndarray:
    """Host side: f64 array -> int64 monotone sort keys.

    For non-NaN a, b:  a < b  <=>  key(a) < key(b).  (The only widening is
    -0.0 < +0.0; bin boundaries are midpoints of distinct values and never
    -0.0, so binning decisions are unaffected.)"""
    b = np.ascontiguousarray(np.asarray(values, np.float64)).view(np.int64)
    return np.where(b >= 0, b, b ^ np.int64(_FLIP))


def float_bits(X: np.ndarray) -> np.ndarray:
    """Raw IEEE bits of a dense f64 matrix as an int64 array of X's shape:
    the only per-request host compute on the dense serve path (a
    reinterpreting view); the key transform runs on the device."""
    return np.ascontiguousarray(np.asarray(X, np.float64)).view(np.int64)


def _device_keys(bits: torch.Tensor) -> torch.Tensor:
    return torch.where(bits >= 0, bits, bits ^ _FLIP)


def build_bin_tables(mappers: List[BinMapper], device="cpu") -> Optional[dict]:
    """Flatten per-feature mappers into the tensors ``bin_rows_device``
    consumes.  Returns None when device binning cannot reproduce the host
    path exactly (categorical values >= 2^31)."""
    f = len(mappers)
    if f == 0:
        return None
    bv = 1    # padded bound axis
    cmax = 1  # padded categorical vocabulary axis
    for m in mappers:
        if m.is_categorical:
            if m.categories is not None and len(m.categories):
                if int(m.categories.max()) >= 2 ** 31:
                    return None
                cmax = max(cmax, len(m.categories))
        elif m.upper_bounds is not None:
            n_value_bins = m.num_bins - (1 if m.has_nan_bin else 0)
            bv = max(bv, n_value_bins - 1)
    ub = np.full((f, bv), np.inf, np.float64)
    nan_target = np.zeros(f, np.int64)  # bin of NaN rows (nan_bin or 0)
    last_bin = np.zeros(f, np.int64)
    zam = np.zeros(f, bool)
    is_cat = np.zeros(f, bool)
    cat_vals = np.full((f, cmax), _CAT_PAD, np.int64)
    cat_bins = np.zeros((f, cmax), np.int64)
    cat_n = np.zeros(f, np.int64)
    for j, m in enumerate(mappers):
        last_bin[j] = m.num_bins - 1
        if m.has_nan_bin:
            nan_target[j] = m.nan_bin
        if m.is_categorical:
            is_cat[j] = True
            cats = (np.asarray(m.categories, np.int64)
                    if m.categories is not None else np.zeros(0, np.int64))
            order = np.argsort(cats, kind="stable")
            cat_n[j] = len(cats)
            cat_vals[j, : len(cats)] = cats[order]
            cat_bins[j, : len(cats)] = order
            continue
        zam[j] = m.missing_type == MISSING_ZERO
        if m.upper_bounds is None:
            continue
        n_value_bins = m.num_bins - (1 if m.has_nan_bin else 0)
        k = max(n_value_bins - 1, 0)
        ub[j, :k] = np.asarray(m.upper_bounds[:k], np.float64)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "ub_key": dev(f64_sort_keys(ub)),
        "nan_target": dev(nan_target[:, None]),
        "last_bin": dev(last_bin[:, None]),
        "zam": dev(zam[:, None]), "is_cat": dev(is_cat[:, None]),
        "cat_vals": dev(cat_vals), "cat_bins": dev(cat_bins),
        "cat_n": dev(cat_n[:, None]),
        "kz_lo": int(f64_sort_keys(np.asarray([_KZERO_LO]))[0]),
        "kz_hi": int(f64_sort_keys(np.asarray([_KZERO_HI]))[0]),
    }


def tables_nbytes(tables: dict) -> int:
    return sum(v.numel() * v.element_size() for v in tables.values()
               if isinstance(v, torch.Tensor))


def bin_rows_device(tables: dict, bits: torch.Tensor) -> torch.Tensor:
    """(N, F) int32 bins from the (N, F) int64 raw f64 bits, computed on the
    tensors' device; no host sync."""
    if bits.dtype != torch.int64 or bits.dim() != 2:
        raise ValueError(f"bits must be (N, F) int64, got {tuple(bits.shape)} "
                         f"{bits.dtype}")
    bt = bits.t().contiguous()                   # (F, N): one row per feature
    x = bt.view(torch.float64)
    key = _device_keys(bt)
    isnan = torch.isnan(x)

    # ---- numeric: count of the feature's bound keys below the value's key
    nbin = torch.searchsorted(tables["ub_key"], key)
    in_zero = (key > tables["kz_lo"]) & (key < tables["kz_hi"])
    nbin = torch.where(tables["zam"] & in_zero & ~isnan,
                       tables["nan_target"], nbin)
    nbin = torch.where(isnan, tables["nan_target"], nbin)

    # ---- categorical: truncate toward zero, sorted-vocabulary lookup
    t = torch.trunc(x)
    seen = torch.isfinite(x) & (t > -1) & (t < 2.0 ** 31)
    vi = torch.where(seen, t, -1.0).to(torch.int64)
    cat_vals = tables["cat_vals"]
    pos = torch.searchsorted(cat_vals, vi)
    at = torch.clamp(pos, max=cat_vals.shape[1] - 1)
    match = ((pos < tables["cat_n"]) & (torch.gather(cat_vals, 1, at) == vi)
             & seen)
    cbin = torch.where(match, torch.gather(tables["cat_bins"], 1, at),
                       tables["last_bin"])

    out = torch.where(tables["is_cat"], cbin, nbin)
    return out.t().to(torch.int32).contiguous()
