"""Exclusive feature bundling on the device: bundle-space histograms back
to per-feature ones (the JAX package's ``models/grower.py::_expand_hist``
and ``_decode_col``).

Under EFB (``binning.py::FeatureBundles``) histograms and row partitions
run on the (N, G) bundled matrix over HB bins a column; every split scan
reads each original feature's (B,) histogram:

- an identity feature (``feat_offset < 0``) reads its column as it is;
- a bundled feature reads ``bh[g, off + b - 1]`` for ``1 <= b < nb``;
- its bin 0 is the leaf's total minus the sum of its other bins (bundle
  bin 0 is "every member at its default", so no column holds it).

The float32 ops are the JAX package's in its order: the gathered cells
times the 0/1 validity, their sum over bins, the total minus that sum.
Where sums are exact (the exact-sum tests) the trees are the unbundled
ones and the JAX package's bit for bit; elsewhere bin 0 rounds as a
difference, not as a sum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BundleTables(NamedTuple):
    """What the grower reads of the bundles, built once a training by
    :func:`bundle_tables` (the bundles never change between trees)."""

    index: torch.Tensor   # (F * B,) int64 flat ``g * HB + src_bin``
    valid: torch.Tensor   # (F, B, 1) f32 0/1: the cell reads its column
    ident: torch.Tensor   # (F, 1) bool: identity feature
    decode: np.ndarray    # (F, 3) int64 host: column, offset, bins
    meta: torch.Tensor    # (G, 4) int32 wave-kernel meta of the columns
    num_bins: int         # B, the feature-space bin axis
    hist_bins: int        # HB, the bundle-space bin axis


def bundle_tables(bundles, num_bins_per_feature, num_bins: int,
                  device) -> BundleTables:
    """The tables on ``device`` of a ``binning.py::FeatureBundles`` (its
    (F,) ``feat_group`` / ``feat_offset`` and (G,) ``group_bins``) and the
    features' (F,) numpy bins.  HB is the widest column.  The wave kernel's meta
    of the columns: their bins, no NaN bin, not categorical and masked,
    so its scan offers no candidate (its payload is not read)."""
    fg = np.asarray(bundles.feat_group, np.int64)
    fo = np.asarray(bundles.feat_offset, np.int64)
    nbpf = np.asarray(num_bins_per_feature, np.int64)
    gb = np.asarray(bundles.group_bins, np.int32)
    hist_bins = int(gb.max()) if len(gb) else 1
    b_iota = np.arange(num_bins)
    ident = fo < 0
    src_bin = np.where(ident[:, None], b_iota[None, :],
                       fo[:, None] + b_iota[None, :] - 1)
    valid = ident[:, None] | ((b_iota[None, :] >= 1)
                              & (b_iota[None, :] < nbpf[:, None]))
    src_bin = np.clip(src_bin, 0, hist_bins - 1)
    index = (fg[:, None] * hist_bins + src_bin).reshape(-1)
    zeros = np.zeros_like(gb)
    meta = np.stack([gb, np.full_like(gb, hist_bins), zeros, zeros], axis=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return BundleTables(index=t(index),
                        valid=t(valid.astype(np.float32)[..., None]),
                        ident=t(ident[:, None]),
                        decode=np.stack([fg, fo, nbpf], axis=1),
                        meta=t(meta), num_bins=num_bins,
                        hist_bins=hist_bins)


def expand_hist(bh: torch.Tensor, totals: torch.Tensor,
                tables: BundleTables) -> torch.Tensor:
    """(K, G, HB, 3) f32 bundle-space histograms (scaled, as the scan
    sees them) and (K, 3) f32 leaf totals (the grower's own sums: grad,
    hess, count) -> (K, F, B, 3) f32 per-feature histograms."""
    k = bh.shape[0]
    f = tables.ident.shape[0]
    flat = bh.reshape(k, -1, 3)
    hf = flat.index_select(1, tables.index).reshape(k, f, tables.num_bins, 3)
    hf = hf * tables.valid
    h0 = torch.where(tables.ident, hf[:, :, 0, :],
                     totals[:, None, :] - hf.sum(dim=2))
    hf[:, :, 0, :] = h0
    return hf


def decode_bins(raw: torch.Tensor, offset: torch.Tensor,
                num_bins: torch.Tensor) -> torch.Tensor:
    """Bundle-space bins -> the split feature's own bins (int64), per row:
    ``offset`` < 0 is an identity column; a bundled feature's bin is
    ``raw - offset + 1`` inside its range ``[offset, offset + nb - 2]``
    and 0 (its default) outside it.  ``offset`` and ``num_bins``: ints
    or tensors broadcasting against ``raw``."""
    offset = torch.as_tensor(offset, device=raw.device)
    num_bins = torch.as_tensor(num_bins, device=raw.device)
    inside = (raw >= offset) & (raw < offset + num_bins - 1)
    return torch.where(offset < 0, raw,
                       torch.where(inside, raw - offset + 1, 0))
