"""The Python training API: :class:`Dataset` and :class:`Booster`.

The port of the JAX package's ``basic.py`` surface the binary-training
slice needs: a lazily constructed ``Dataset`` over numpy or scipy sparse
rows (categorical columns by index or name, feature names, weights, an
init score), and a ``Booster`` that trains one iteration per ``update``,
predicts through the fp32 pack, writes model text and hands out the
serving ``Predictor``.  Valid sets, query groups, reference datasets,
``pred_leaf`` / ``pred_contrib`` and loading model text are later work
and raise ``NotImplementedError`` naming their ROADMAP item.

Entry points run on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .binning import _is_sparse
from .config import Config
from .dataset import TrainData
from .models.gbdt import GBDT
from .utils.device import resolve_device

_CAT_KEYS = ("categorical_feature", "cat_feature", "categorical_column",
             "cat_column", "categorical_features")


def _as_2d(data) -> np.ndarray:
    arr = np.asarray(data)
    return arr.reshape(1, -1) if arr.ndim == 1 else arr


class Dataset:
    """Lazily constructed training rows (reference ``Dataset``)."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, Sequence] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 reference: Optional["Dataset"] = None, group=None):
        if reference is not None:
            raise NotImplementedError(
                "reference datasets (valid sets binned with the training "
                "mappers) are not ported yet (ROADMAP A5c)")
        if group is not None:
            raise NotImplementedError(
                "query groups (ranking) are not ported yet (ROADMAP A8.2)")
        if isinstance(data, str):
            raise NotImplementedError(
                "loading rows from a file is not ported yet (ROADMAP A1: "
                "io/parser.py); pass a numpy array")
        self.data = data.tocsr() if _is_sparse(data) else _as_2d(data)
        self.label = None if label is None else np.asarray(label)
        self.weight = (None if weight is None
                       else np.asarray(weight, np.float64))
        self.init_score = None if init_score is None else np.asarray(
            init_score)
        self.params = dict(params or {})
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self._train_data: Optional[TrainData] = None

    def _feature_names(self) -> List[str]:
        if isinstance(self.feature_name, list):
            return list(self.feature_name)
        return [f"Column_{i}" for i in range(self.data.shape[1])]

    def construct(self, params: Optional[Dict[str, Any]] = None
                  ) -> TrainData:
        """Bin the rows (once) with the merged params."""
        if self._train_data is not None:
            return self._train_data
        merged = dict(self.params)
        merged.update(params or {})
        cat_param = None
        for key in _CAT_KEYS:
            if key in merged:
                cat_param = merged.pop(key)
        cfg = Config(merged)
        given = self.categorical_feature
        deferred = (given is None
                    or (isinstance(given, str) and given in ("auto", ""))
                    or (isinstance(given, (list, tuple)) and len(given) == 0))
        cat_spec = cat_param if deferred else given
        if cat_spec == "auto":
            cat_spec = None
        force_names = False
        if isinstance(cat_spec, str) and cat_spec:
            if cat_spec.startswith("name:"):
                cat_spec = cat_spec[5:]
                force_names = True
            cat_spec = [t.strip() for t in cat_spec.split(",") if t.strip()]
        cats: Sequence[int] = ()
        if isinstance(cat_spec, (list, tuple)):
            names = self._feature_names()

            def cat_idx(c):
                if not force_names and (not isinstance(c, str)
                                        or c.lstrip("-").isdigit()):
                    return int(c)
                return names.index(c)

            cats = [cat_idx(c) for c in cat_spec]
        label = (self.label if self.label is not None
                 else np.zeros(self.data.shape[0]))
        self._train_data = TrainData.build(
            self.data, label, cfg, weight=self.weight,
            init_score=self.init_score, categorical_features=cats,
            feature_names=self._feature_names())
        return self._train_data

    def num_data(self) -> int:
        return self.data.shape[0]

    def num_feature(self) -> int:
        return self.data.shape[1]

    def get_label(self):
        return self.label


class Booster:
    """A model handle (reference ``Booster``): trains on its Dataset on
    ``device`` (the CUDA card by default)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None, model_file=None,
                 model_str=None, device=None):
        if model_file is not None or model_str is not None:
            raise NotImplementedError(
                "loading model text into the port is not ported yet "
                "(ROADMAP A5b); lightgbm_tpu.Booster(model_str=...) loads "
                "the port's models")
        if train_set is None:
            raise ValueError("Booster needs a train_set")
        self.params = dict(params or {})
        self.best_iteration = -1
        self.cfg = Config(self.params)
        dev = resolve_device(device)
        td = train_set.construct(self.params)
        self._gbdt = GBDT(self.cfg, td, device=dev)
        self.train_set = train_set

    # ------------------------------------------------------------- train
    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when training should stop.
        ``fobj(raw_scores, train_set) -> (grad, hess)`` replaces the
        objective's gradients."""
        if train_set is not None and train_set is not self.train_set:
            raise NotImplementedError(
                "switching the training set is not ported yet")
        if fobj is not None:
            score = self._gbdt.scores.cpu().numpy()
            grad, hess = fobj(score, self.train_set)
            return self._gbdt.train_one_iter(np.asarray(grad),
                                             np.asarray(hess))
        return self._gbdt.train_one_iter()

    # ----------------------------------------------------------- predict
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, **kwargs) -> np.ndarray:
        """Scores through the fp32 pack; probabilities unless
        ``raw_score`` (f64 raw -> float32 -> sigmoid in float32, as the
        JAX package computes them)."""
        if kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            raise NotImplementedError(
                "pred_leaf / pred_contrib are not ported yet (ROADMAP "
                "A8.10)")
        other = [k for k, v in kwargs.items()
                 if k not in ("pred_leaf", "pred_contrib") and v]
        if other:
            raise NotImplementedError(f"predict options {other} are not "
                                      "ported yet")
        if not _is_sparse(data):
            data = _as_2d(data)
        nf = self.num_feature()
        if data.shape[1] != nf:
            raise ValueError(f"data has {data.shape[1]} features, model "
                             f"expects {nf}")
        raw = self._gbdt.predict_raw(data, num_iteration, start_iteration)
        if raw_score:
            return raw
        score = torch.from_numpy(np.asarray(raw)).to(torch.float32).to(
            self._gbdt.device)
        return self._gbdt.objective.convert_output(score).cpu().numpy()

    def serving_predictor(self, **kwargs):
        """A long-lived :class:`~.serve.Predictor` over this booster (on
        the training device unless ``device`` is given)."""
        from .serve import Predictor
        kwargs.setdefault("device", self._gbdt.device)
        return Predictor(self._gbdt, **kwargs)

    # -------------------------------------------------------------- misc
    @property
    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def num_feature(self) -> int:
        return self._gbdt.train_data.num_features

    def feature_name(self) -> List[str]:
        td = self._gbdt.train_data
        return td.feature_names or [f"Column_{i}"
                                    for i in range(td.num_features)]

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from .serialization import model_to_string
        return model_to_string(self._gbdt, num_iteration=num_iteration,
                               start_iteration=start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        return self
