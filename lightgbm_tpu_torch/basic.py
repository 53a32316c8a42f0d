"""The Python training API: :class:`Dataset` and :class:`Booster`.

The port of the JAX package's ``basic.py`` surface: a lazily constructed
``Dataset`` over numpy or scipy sparse rows (categorical columns by index
or name, feature names, weights, an init score; a valid set binned with
its ``reference``'s mappers), and a ``Booster`` that trains one iteration
per ``update``, scores its valid sets with the config's metrics
(``eval_train`` / ``eval_valid`` / ``eval``), predicts through the fp32
pack (up to ``best_iteration`` once early stopping has set it), writes
model text and hands out the serving ``Predictor``.  Query groups,
``pred_leaf`` / ``pred_contrib`` and loading model text are later work
and raise ``NotImplementedError`` naming their ROADMAP item.

Entry points run on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .binning import _is_sparse
from .config import Config
from .dataset import TrainData, _check_finite
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
        if group is not None:
            raise NotImplementedError(
                "query groups (ranking) are not ported yet (ROADMAP A8.2)")
        if isinstance(data, str):
            raise NotImplementedError(
                "loading rows from a file is not ported yet (ROADMAP A1: "
                "io/parser.py); pass a numpy array")
        self.data = data.tocsr() if _is_sparse(data) else _as_2d(data)
        self.label = None if label is None else np.asarray(label)
        self.reference = reference
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
        ref_td = (self.reference.construct(params)
                  if self.reference is not None else None)
        self._train_data = TrainData.build(
            self.data, label, cfg, weight=self.weight,
            init_score=self.init_score, categorical_features=cats,
            feature_names=self._feature_names(), reference=ref_td)
        return self._train_data

    def num_data(self) -> int:
        return self.data.shape[0]

    def num_feature(self) -> int:
        return self.data.shape[1]

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def set_label(self, label) -> "Dataset":
        """New labels; a constructed dataset keeps its bins (binning does
        not read the label) and its device copies."""
        if self._train_data is not None:
            _check_finite(np.asarray(label, np.float64).ravel(), "label")
        self.label = np.asarray(label)
        if self._train_data is not None:
            self._train_data = dataclasses.replace(self._train_data,
                                                   label=self.label)
        return self

    def set_weight(self, weight) -> "Dataset":
        """New sample weights; a constructed dataset keeps its bins."""
        if self._train_data is not None and weight is not None:
            _check_finite(np.asarray(weight, np.float64).ravel(),
                          "sample weight")
        self.weight = (None if weight is None
                       else np.asarray(weight, np.float64))
        if self._train_data is not None:
            self._train_data = dataclasses.replace(
                self._train_data, weight=None if weight is None
                else self.weight.astype(np.float32))
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A valid set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)


class Booster:
    """A model handle (reference ``Booster``): trains on its Dataset on
    ``device`` (the CUDA card by default) and scores ``valid_sets``, a
    sequence of ``(name, Dataset)`` pairs."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None, model_file=None,
                 model_str=None,
                 valid_sets: Sequence[Tuple[str, Dataset]] = (),
                 device=None):
        if model_file is not None or model_str is not None:
            raise NotImplementedError(
                "loading model text into the port is not ported yet "
                "(ROADMAP A5b); lightgbm_tpu.Booster(model_str=...) loads "
                "the port's models")
        if train_set is None:
            raise ValueError("Booster needs a train_set")
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Any = {}
        self.cfg = Config(self.params)
        dev = resolve_device(device)
        td = train_set.construct(self.params)
        valid_td = [(nm, _valid_data(ds, train_set, self.params))
                    for nm, ds in valid_sets]
        self._gbdt = GBDT(self.cfg, td, valid_td, device=dev)
        self.train_set = train_set

    # ------------------------------------------------------------- train
    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when training should stop.
        ``fobj(raw_scores, train_set) -> (grad, hess)`` replaces the
        objective's gradients ((N,) or (N, K), like the scores)."""
        if train_set is not None and train_set is not self.train_set:
            raise NotImplementedError(
                "switching the training set is not ported yet")
        if fobj is not None:
            score = self._gbdt.scores.cpu().numpy()
            grad, hess = fobj(score, self.train_set)
            return self._gbdt.train_one_iter(np.asarray(grad),
                                             np.asarray(hess))
        return self._gbdt.train_one_iter()

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        self.params.update(params)
        self._gbdt.cfg.update(params)
        return self

    # -------------------------------------------------------- evaluation
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score ``data`` as a valid set from now on: its scores start at
        the current model's."""
        self._gbdt.add_valid(name, _valid_data(data, self.train_set,
                                               self.params))
        return self

    def _evals(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        """The metrics of the valid sets (and of the training set under
        ``is_provide_training_metric``), then ``feval``'s on every set:
        ``feval(raw_scores, data)`` returns ``(name, value,
        higher_better)`` or a list of them."""
        g = self._gbdt
        res = g.eval_set()
        if feval is not None:
            sets = [("training", g.train_data)] + list(g.valids)
            for i, (name, data) in enumerate(sets):
                scores = g.scores if i == 0 else g.valid_scores[i - 1]
                out = feval(scores.cpu().numpy(), data)
                if out is not None:
                    if not isinstance(out, list):
                        out = [out]
                    for metric, value, hb in out:
                        res.append((name, metric, value, hb))
        return res

    def eval(self, data: Dataset, name: str, feval=None):
        """Evaluate the current model on ``data`` (reference
        ``Booster.eval``): its raw scores are recomputed by each call."""
        raw = np.asarray(self._gbdt.predict_raw(data.data), np.float64)
        out = [(name, m.name, m(data.label, raw, data.weight, None),
                m.higher_better) for m in self._gbdt.metrics]
        if feval is not None:
            res = feval(raw, data)
            if res is not None:
                if not isinstance(res, list):
                    res = [res]
                for metric, value, hb in res:
                    out.append((name, metric, value, hb))
        return out

    def eval_train(self, feval=None):
        return [e for e in self._evals(feval) if e[0] == "training"]

    def eval_valid(self, feval=None):
        return [e for e in self._evals(feval) if e[0] != "training"]

    # ----------------------------------------------------------- predict
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, **kwargs) -> np.ndarray:
        """Scores through the fp32 pack, up to ``best_iteration`` unless
        ``num_iteration`` is given; transformed by the objective unless
        ``raw_score`` (f64 raw -> float32 -> the transform in float32, as
        the JAX package computes them)."""
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
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        raw = self._gbdt.predict_raw(data, num_iteration, start_iteration)
        if raw_score or self._gbdt.objective is None:
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

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_class

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


def _valid_data(data: Dataset, train_set: Dataset,
                params: Dict[str, Any]) -> TrainData:
    """A valid set's binned rows.  One built without a ``reference`` is
    binned with the training set's mappers all the same (reference
    LightGBM's ``train`` sets it), since trees route by training bins."""
    if data.reference is None and data._train_data is None:
        data.reference = train_set
    td = data.construct(params)
    if td.binned.mappers is not train_set.construct(params).binned.mappers:
        raise ValueError(
            "a valid set must be binned with the training set's mappers: "
            "build it with reference=<training Dataset>")
    return td
