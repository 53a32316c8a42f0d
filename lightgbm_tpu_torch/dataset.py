"""Internal training dataset: binned features, label, weights, query
groups and positions, and their device tensors.

The port of the JAX package's ``dataset.py::TrainData``: ``build`` checks
the label and weights, bins the matrix on the host with the port's
``bin_dataset`` (the JAX package's mappers byte for byte), and
``bins_device`` / ``feature_meta_device`` put the bins and the
per-feature metadata on a device.  Each feature is binned to its own
budget under ``max_bin_by_feature`` and keeps the forced bounds of
``forcedbins_filename``; the matrix is uint16 when any feature passes 256
bins, and packs to 4 bits only when every feature stays at or below 16.  A valid set is built with
``reference=`` the training data: its rows are binned with the training
mappers, as in the JAX package.  The bins are the (N, F) uint8 matrix
(uint16 above 256 bins, as the JAX package stores them), or with
``packed4`` (every feature at <= 16 bins) its (N, ceil(F/2))
4-bit nibble pairs (``ops/histogram.py::pack_bins4``, packed on the
host).  One layout is resident per device: asking for the packed one
drops the unpacked copy, so the halving is real on the card (the JAX
package's ``gbdt.py`` drops its byte-per-bin matrix the same way).
Exclusive feature bundling (``build_bundles``, decided once per
``(enable_bundle, max_conflict_rate)``, as the JAX package decides it)
gives the (N, G) bundled matrix (``bundled_bins_device``); a bundled run
uploads only that one for training.
Ranking data carries its query sizes (``group``; ``query_boundaries``
gives the reference's ``Metadata::query_boundaries_``) and, for unbiased
learning to rank, a position id per row (``position``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import (BinnedData, FeatureBundles, _is_sparse, bin_dataset,
                      build_bundles, load_forced_bins)
from .config import Config
from .ops.histogram import pack_bins4


def query_boundaries(group) -> Optional[np.ndarray]:
    """Query sizes -> cumulative boundaries (num_queries + 1 entries),
    the reference's ``Metadata::query_boundaries_``."""
    if group is None:
        return None
    return np.concatenate([[0], np.cumsum(group)])


def _check_finite(arr: np.ndarray, what: str) -> None:
    if arr.size and not np.isfinite(arr).all():
        bad = np.nonzero(~np.isfinite(arr))[0]
        raise ValueError(
            f"{bad.size} non-finite {what}(s) (first at rows "
            f"{bad[:8].tolist()}); {what}s must be finite")


@dataclasses.dataclass
class TrainData:
    """Binned training rows and their metadata."""

    binned: BinnedData
    label: np.ndarray
    weight: Optional[np.ndarray] = None
    group: Optional[np.ndarray] = None          # query sizes (ranking)
    position: Optional[np.ndarray] = None       # per-row position ids
    init_score: Optional[np.ndarray] = None
    feature_names: Optional[List[str]] = None
    _dev: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)
    #: EFB: the bundles of the last ``build_bundles`` and its params
    bundles: Optional[FeatureBundles] = dataclasses.field(default=None,
                                                         repr=False)
    _bundles_key: Optional[tuple] = dataclasses.field(default=None,
                                                      repr=False)

    @classmethod
    def build(cls, X, label, cfg: Config, *, weight=None, group=None,
              position=None, init_score=None,
              categorical_features: Sequence[int] = (),
              feature_names: Optional[List[str]] = None,
              reference: Optional["TrainData"] = None) -> "TrainData":
        if not _is_sparse(X):
            X = np.asarray(X)
        _check_finite(np.asarray(label, np.float64).ravel(), "label")
        if weight is not None:
            _check_finite(np.asarray(weight, np.float64).ravel(),
                          "sample weight")
        if reference is not None:
            binned = dataclasses.replace(
                reference.binned, bins=reference.binned.apply(X))
        else:
            binned = bin_dataset(
                X, max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                categorical_features=categorical_features,
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing,
                sample_cnt=cfg.bin_construct_sample_cnt,
                random_state=cfg.data_random_seed,
                max_bin_by_feature=cfg.max_bin_by_feature,
                forced_bins=load_forced_bins(cfg.forcedbins_filename,
                                             X.shape[1],
                                             categorical_features))
        return cls(
            binned=binned, label=np.asarray(label),
            weight=None if weight is None else np.asarray(weight, np.float32),
            group=None if group is None else np.asarray(group, np.int64),
            position=None if position is None else np.asarray(position),
            init_score=None if init_score is None else np.asarray(init_score),
            feature_names=feature_names)

    @property
    def num_data(self) -> int:
        return self.binned.num_data

    @property
    def num_features(self) -> int:
        return self.binned.num_features

    def query_boundaries(self) -> Optional[np.ndarray]:
        return query_boundaries(self.group)

    def _on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._dev:
            b = self.binned
            self._dev[key] = {
                "num_bins_per_feature": torch.as_tensor(
                    b.num_bins_per_feature, dtype=torch.int32, device=device),
                "nan_bins": torch.as_tensor(b.nan_bins, dtype=torch.int32,
                                            device=device),
                "is_categorical": torch.as_tensor(b.is_categorical,
                                                  device=device),
            }
        return self._dev[key]

    def bins_device(self, device: torch.device,
                    packed4: bool = False) -> torch.Tensor:
        """The (N, F) uint8 (uint16 above 256 bins) bins on ``device``, or
        with ``packed4`` their (N, ceil(F/2)) nibble pairs; uploaded once,
        and the other layouts' copies on ``device`` are dropped."""
        d = self._on(device)
        key, other = ("bins4", "bins") if packed4 else ("bins", "bins4")
        if key not in d:
            d.pop(other, None)
            d.pop("bundled", None)
            host = torch.from_numpy(np.ascontiguousarray(self.binned.bins))
            d[key] = (pack_bins4(host) if packed4 else host).to(device)
        return d[key]

    def build_bundles(self, cfg: Config) -> Optional[FeatureBundles]:
        """EFB bundles of these bins (``binning.py::build_bundles``), or
        None when ``enable_bundle`` is off or the data does not bundle;
        decided anew whenever ``(enable_bundle, max_conflict_rate)``
        changes, and kept otherwise."""
        key = (bool(cfg.enable_bundle), float(cfg.max_conflict_rate))
        if self._bundles_key != key:
            self._bundles_key = key
            self.bundles = None
            for d in self._dev.values():
                d.pop("bundled", None)
            if cfg.enable_bundle:
                self.bundles = build_bundles(
                    self.binned, max_conflict_rate=cfg.max_conflict_rate)
        return self.bundles

    def bundled_bins_device(self, device: torch.device) -> torch.Tensor:
        """The (N, G) bundled matrix of :meth:`build_bundles` on
        ``device``, uploaded once; the (N, F) layouts' copies on
        ``device`` are dropped (the grower is their only reader)."""
        d = self._on(device)
        if "bundled" not in d:
            d.pop("bins", None)
            d.pop("bins4", None)
            d["bundled"] = torch.from_numpy(
                np.ascontiguousarray(self.bundles.bins)).to(device)
        return d["bundled"]

    def feature_meta_device(self, device: torch.device) -> dict:
        """``num_bins_per_feature``, ``nan_bins`` (int32) and
        ``is_categorical`` (bool) as (F,) tensors on ``device``."""
        d = self._on(device)
        return {k: d[k] for k in ("num_bins_per_feature", "nan_bins",
                                  "is_categorical")}
