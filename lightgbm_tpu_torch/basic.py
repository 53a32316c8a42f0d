"""The Python training API: :class:`Dataset` and :class:`Booster`.

The port of the JAX package's ``basic.py`` surface: a lazily constructed
``Dataset`` over numpy or scipy sparse rows, or over a CSV / TSV / LibSVM
text file parsed at ``construct`` with the merged params' ``header``,
``label_column`` and column specs (categorical columns by index or name,
feature names, weights, an init score; a valid set binned with its
``reference``'s mappers), and a ``Booster`` that trains one iteration
per ``update``, scores its valid sets with the config's metrics
(``eval_train`` / ``eval_valid`` / ``eval``), predicts through the fp32
pack (up to ``best_iteration`` once early stopping has set it), writes
model text and hands out the serving ``Predictor``.  ``Booster(
model_file=...)`` / ``Booster(model_str=...)`` loads model text (a
genuine LightGBM file, a JAX package file or the port's own) into a
:class:`~.serialization.LoadedModel` that predicts, evaluates and saves.
Ranking data carries query sizes (``group=``, ``set_group``, a
``<data>.query`` side file or ``group_column``) and per-row positions
(``position=``, ``set_position``, a ``<data>.position`` side file); valid
sets hand their groups to the ranking metrics, and ``subset`` refuses a
grouped dataset, as the JAX package does.  Binary dataset caches (ROADMAP
A1c), refit (A8.9) and ``pred_leaf`` / ``pred_contrib`` (A8.10) raise
``NotImplementedError`` naming their item.

Entry points run on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .binning import _is_sparse
from .config import Config
from .dataset import TrainData, _check_finite
from .metrics import metrics_for_config
from .models.gbdt import GBDT
from .serialization import LoadedModel, load_model_string
from .utils.device import resolve_device
from .utils.timer import FunctionTimer

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
                 reference: Optional["Dataset"] = None, group=None,
                 position=None):
        self._text_path = None
        if isinstance(data, str):
            if not os.path.exists(data):
                raise FileNotFoundError(f"no such data file: {data!r}")
            if zipfile.is_zipfile(data):
                raise NotImplementedError(
                    f"{data!r} is a binary dataset cache (a zip file): "
                    "binary caches are not ported to lightgbm_tpu_torch yet "
                    "(ROADMAP A1c); pass the text file or arrays")
            # parsed in construct(), with the params train() passes
            self._text_path = data
            data = np.zeros((0, 0))
        self.data = data.tocsr() if _is_sparse(data) else _as_2d(data)
        self.label = None if label is None else np.asarray(label)
        self.reference = reference
        self.weight = (None if weight is None
                       else np.asarray(weight, np.float64))
        self.init_score = None if init_score is None else np.asarray(
            init_score)
        self.group = None if group is None else np.asarray(group, np.int64)
        self.position = None if position is None else np.asarray(position)
        self.params = dict(params or {})
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self._train_data: Optional[TrainData] = None

    def _feature_names(self) -> List[str]:
        if isinstance(self.feature_name, list):
            return list(self.feature_name)
        return [f"Column_{i}" for i in range(self.data.shape[1])]

    def load_rows(self, params: Optional[Dict[str, Any]] = None) -> None:
        """Parse a text file's rows (once) with the merged params' column
        specs, without binning them; the file's labels, weights, query
        groups (``group_column`` or ``<data>.query``), positions
        (``<data>.position``) and header names fill what the caller did
        not pass."""
        if self._text_path is None:
            return
        from .io.parser import load_data_file, position_side_file
        merged = dict(self.params)
        merged.update(params or {})
        cfg = Config(merged)
        path = self._text_path
        with FunctionTimer("io/parse"):
            X, fy, fw, fg, names = load_data_file(
                path, cfg.label_column, cfg.header,
                weight_column=cfg.weight_column,
                group_column=cfg.group_column,
                ignore_column=cfg.ignore_column, with_feature_names=True)
        if self.position is None:
            self.position = position_side_file(path, expected_rows=len(X))
        self.data = X
        self._text_path = None
        if self.label is None:
            self.label = fy
        if self.weight is None and fw is not None:
            self.weight = np.asarray(fw, np.float64)
        if self.group is None and fg is not None:
            self.group = np.asarray(fg, np.int64)
        if self.feature_name == "auto" and names:
            self.feature_name = names

    def construct(self, params: Optional[Dict[str, Any]] = None
                  ) -> TrainData:
        """Bin the rows (once) with the merged params; a text file is
        parsed first."""
        if self._train_data is not None:
            return self._train_data
        merged = dict(self.params)
        merged.update(params or {})
        self.load_rows(params)
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
        with FunctionTimer("dataset/bin"):
            self._train_data = TrainData.build(
                self.data, label, cfg, weight=self.weight,
                group=self.group, position=self.position,
                init_score=self.init_score, categorical_features=cats,
                feature_names=self._feature_names(), reference=ref_td)
        return self._train_data

    def num_data(self) -> int:
        self.load_rows()
        return self.data.shape[0]

    def num_feature(self) -> int:
        self.load_rows()
        return self.data.shape[1]

    def get_label(self):
        return self.label

    def with_init_score(self, init_score) -> "Dataset":
        """A shallow copy whose rows start from ``init_score``: a
        constructed copy keeps the bins and device copies (binning does
        not read the init score), and this dataset keeps its own."""
        out = copy.copy(self)
        out.init_score = np.asarray(init_score)
        if self._train_data is not None:
            out._train_data = dataclasses.replace(self._train_data,
                                                  init_score=out.init_score)
        return out

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group

    def set_group(self, group) -> "Dataset":
        """New query sizes; a constructed dataset keeps its bins."""
        self.group = None if group is None else np.asarray(group, np.int64)
        if self._train_data is not None:
            self._train_data = dataclasses.replace(self._train_data,
                                                   group=self.group)
        return self

    def set_position(self, position) -> "Dataset":
        """Per-row positions for unbiased learning to rank (reference
        ``Dataset.set_position``); a constructed dataset keeps its bins."""
        self.position = None if position is None else np.asarray(position)
        if self._train_data is not None:
            self._train_data = dataclasses.replace(self._train_data,
                                                   position=self.position)
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices``, binned with this dataset's mappers
        (reference ``Dataset.subset``).  A dataset with query groups
        raises: slice whole queries and build a new Dataset."""
        self.load_rows(params)
        if self.group is not None:
            raise ValueError(
                "subset() cannot slice a Dataset with query groups; "
                "slice whole queries and rebuild the Dataset instead")
        idx = np.asarray(used_indices, np.int64)
        return Dataset(
            self.data[idx],
            label=None if self.label is None else self.label[idx],
            reference=self,
            weight=None if self.weight is None else self.weight[idx],
            position=None if self.position is None else self.position[idx],
            init_score=(None if self.init_score is None
                        else np.asarray(self.init_score)[idx]),
            feature_name=self.feature_name,
            categorical_feature=self.categorical_feature,
            params=dict(self.params, **(params or {})))

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
    sequence of ``(name, Dataset)`` pairs; or, from ``model_file`` /
    ``model_str``, a loaded model that predicts, evaluates and saves on
    ``device``.  ``base_model`` (a :class:`~.serialization.LoadedModel`)
    continues training from it: the caller has folded its raw scores into
    the datasets' init scores (``engine.train(init_model=...)``)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None, model_file=None,
                 model_str=None,
                 valid_sets: Sequence[Tuple[str, Dataset]] = (),
                 device=None, base_model: Optional[LoadedModel] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Any = {}
        dev = resolve_device(device)
        self.train_set = train_set
        if model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._gbdt = load_model_string(model_str, device=dev)
            self.cfg = self._gbdt.cfg
            return
        if train_set is None:
            raise ValueError("Booster needs a train_set or a model")
        self.cfg = Config(self.params)
        td = train_set.construct(self.params)
        valid_td = [(nm, _valid_data(ds, train_set, self.params))
                    for nm, ds in valid_sets]
        self._gbdt = GBDT(self.cfg, td, valid_td, device=dev,
                          base_model=base_model)

    @property
    def _loaded(self) -> bool:
        return isinstance(self._gbdt, LoadedModel)

    def _trained(self, what: str) -> GBDT:
        if self._loaded:
            raise ValueError(f"{what} needs a trained booster; a loaded "
                             "model only predicts, evaluates and saves")
        return self._gbdt

    # ------------------------------------------------------------- train
    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when training should stop.
        ``fobj(raw_scores, train_set) -> (grad, hess)`` replaces the
        objective's gradients ((N,) or (N, K), like the scores)."""
        self._trained("update")
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
        self._trained("reset_parameter")
        self.params.update(params)
        self._gbdt.cfg.update(params)
        return self

    # -------------------------------------------------------- evaluation
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score ``data`` as a valid set from now on: its scores start at
        the current model's."""
        self._trained("add_valid")
        self._gbdt.add_valid(name, _valid_data(data, self.train_set,
                                               self.params))
        return self

    def _evals(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        """The metrics of the valid sets (and of the training set under
        ``is_provide_training_metric``), then ``feval``'s on every set:
        ``feval(raw_scores, data)`` returns ``(name, value,
        higher_better)`` or a list of them."""
        g = self._trained("eval_train / eval_valid")
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
        ``Booster.eval``): its raw scores are recomputed by each call; a
        loaded model scores with its config's metrics."""
        data.load_rows(self.params)
        raw = np.asarray(self._gbdt.predict_raw(data.data), np.float64)
        metrics = (metrics_for_config(self.cfg) if self._loaded
                   else self._gbdt.metrics)
        out = [(name, m.name, m(data.label, raw, data.weight, data.group),
                m.higher_better) for m in metrics]
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
        """Scores up to ``best_iteration`` unless ``num_iteration`` is
        given, transformed by the objective unless ``raw_score`` (f64 raw
        -> float32 -> the transform in float32, as the JAX package computes
        them): a trained booster's through the fp32 pack (a continuation's
        base trees through its loaded walk), a loaded model's through that
        walk, which also takes ``pred_early_stop`` (with
        ``pred_early_stop_freq`` / ``_margin``), as the JAX package's
        does.  ``predict_disable_shape_check`` drops extra columns and pads
        missing ones with NaN."""
        if kwargs.pop("pred_leaf", False) or kwargs.pop("pred_contrib",
                                                        False):
            raise NotImplementedError(
                "pred_leaf / pred_contrib are not ported to "
                "lightgbm_tpu_torch yet (ROADMAP A8.10)")
        shape_check = not kwargs.pop("predict_disable_shape_check", False)
        early = ({k: kwargs.pop(k) for k in list(kwargs)
                  if k.startswith("pred_early_stop")} if self._loaded
                 else {})
        other = [k for k, v in kwargs.items() if v]
        if other:
            raise NotImplementedError(f"predict options {other} are not "
                                      "ported to lightgbm_tpu_torch yet")
        if not _is_sparse(data):
            data = _as_2d(data)
        nf = self.num_feature()
        if data.shape[1] != nf:
            if shape_check:
                raise ValueError(
                    f"data has {data.shape[1]} features, model expects "
                    f"{nf}; pass predict_disable_shape_check=True to "
                    "override")
            if data.shape[1] > nf:
                data = data[:, :nf]
            else:
                if _is_sparse(data):
                    data = np.asarray(data.todense(), np.float64)
                pad = np.full((data.shape[0], nf - data.shape[1]), np.nan)
                data = np.concatenate([data, pad], axis=1)
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        g = self._gbdt
        if self._loaded:
            return g.predict(data, raw_score=raw_score,
                             num_iteration=num_iteration,
                             start_iteration=start_iteration, **early)
        raw = g.predict_raw(data, num_iteration, start_iteration)
        if raw_score or g.objective is None:
            return raw
        score = torch.from_numpy(np.asarray(raw)).to(torch.float32).to(
            g.device)
        return g.objective.convert_output(score).cpu().numpy()

    def serving_predictor(self, **kwargs):
        """A long-lived :class:`~.serve.Predictor` over this booster (on
        the training device unless ``device`` is given).  A loaded model
        has no bin mappers, and a continuation's base trees walk raw
        values: both raise ``ValueError``, as in the JAX package."""
        from .serve import Predictor
        if self._loaded:
            raise ValueError(
                "serving_predictor needs a trained booster: a text-loaded "
                "model carries no bin mappers; use Booster.predict")
        kwargs.setdefault("device", self._gbdt.device)
        return Predictor(self._gbdt, **kwargs)

    def refit(self, *args, **kwargs):
        raise NotImplementedError(
            "refit is not ported to lightgbm_tpu_torch yet (ROADMAP A8.9)")

    # -------------------------------------------------------------- misc
    @property
    def current_iteration(self) -> int:
        """Iterations of the combined model (a continuation's base
        model's included)."""
        g = self._gbdt
        base = getattr(g, "base_model", None)
        return g.iter_ + (base.iter_ if base is not None else 0)

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_class

    def num_feature(self) -> int:
        if self._loaded:
            return int(self._gbdt.num_features)
        return self._gbdt.train_data.num_features

    def feature_name(self) -> List[str]:
        if self._loaded:
            return list(self._gbdt.feature_names)
        td = self._gbdt.train_data
        return td.feature_names or [f"Column_{i}"
                                    for i in range(td.num_features)]

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from .serialization import model_to_string
        if self._loaded:
            return self._gbdt.to_string(num_iteration=num_iteration,
                                        start_iteration=start_iteration)
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
