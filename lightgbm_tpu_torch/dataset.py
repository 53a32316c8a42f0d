"""Internal training dataset: binned features, label, weights, and their
device tensors.

The port of the JAX package's ``dataset.py::TrainData``: ``build`` checks
the label and weights, bins the matrix on the host with the port's
``bin_dataset`` (the JAX package's mappers byte for byte), and
``bins_device`` / ``feature_meta_device`` put the (N, F) bins and the
per-feature metadata on a device.  Bins stay one unpacked uint8 (N, F)
tensor: the JAX package's 4-bit nibble packing is a storage layout that
gives the same trees and is not ported yet (ROADMAP B1b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import BinnedData, _is_sparse, bin_dataset
from .config import Config


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
    init_score: Optional[np.ndarray] = None
    feature_names: Optional[List[str]] = None
    _dev: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    @classmethod
    def build(cls, X, label, cfg: Config, *, weight=None, init_score=None,
              categorical_features: Sequence[int] = (),
              feature_names: Optional[List[str]] = None) -> "TrainData":
        if not _is_sparse(X):
            X = np.asarray(X)
        _check_finite(np.asarray(label, np.float64).ravel(), "label")
        if weight is not None:
            _check_finite(np.asarray(weight, np.float64).ravel(),
                          "sample weight")
        binned = bin_dataset(
            X, max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
            categorical_features=categorical_features,
            use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
            sample_cnt=cfg.bin_construct_sample_cnt,
            random_state=cfg.data_random_seed)
        return cls(
            binned=binned, label=np.asarray(label),
            weight=None if weight is None else np.asarray(weight, np.float32),
            init_score=None if init_score is None else np.asarray(init_score),
            feature_names=feature_names)

    @property
    def num_data(self) -> int:
        return self.binned.num_data

    @property
    def num_features(self) -> int:
        return self.binned.num_features

    def _on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._dev:
            b = self.binned
            self._dev[key] = {
                "bins": torch.from_numpy(np.ascontiguousarray(b.bins)).to(
                    device),
                "num_bins_per_feature": torch.as_tensor(
                    b.num_bins_per_feature, dtype=torch.int32, device=device),
                "nan_bins": torch.as_tensor(b.nan_bins, dtype=torch.int32,
                                            device=device),
                "is_categorical": torch.as_tensor(b.is_categorical,
                                                  device=device),
            }
        return self._dev[key]

    def bins_device(self, device: torch.device) -> torch.Tensor:
        """The (N, F) uint8 bins on ``device`` (uploaded once)."""
        return self._on(device)["bins"]

    def feature_meta_device(self, device: torch.device) -> dict:
        """``num_bins_per_feature``, ``nan_bins`` (int32) and
        ``is_categorical`` (bool) as (F,) tensors on ``device``."""
        d = self._on(device)
        return {k: d[k] for k in ("num_bins_per_feature", "nan_bins",
                                  "is_categorical")}
