"""Gradient-boosted decision trees: training and the serving surface.

The port of the single-device training half of the JAX package's
``models/gbdt.py::GBDT`` (reference ``GBDT::TrainOneIter``): boost from
average, then per iteration binary gradients -> leaf-wise growth
(``models/grower.py``) -> shrinkage -> the score update, with the JAX
package's rounding rule (the shrunk leaf values are materialized, then
one add per row).  Under ``use_quantized_grad`` each iteration's
stochastic rounding draws from its own ``torch.Generator`` seeded from
``(seed, iteration)`` (``ops/quantize.py::quant_generator``).  With every
feature at <= 16 bins and ``tpu_4bit_bins`` on (the default) the bins
are stored as 4-bit nibble pairs (``GrowerConfig.packed4``).  Scores,
bins and gradients live on the device; each grown tree becomes a host
``Tree`` at once.  ``torch.profiler`` ranges
(``gbdt/gradients``, ``gbdt/grow``, ``gbdt/score_update``,
``gbdt/host_tree``) mark an iteration's steps.  ``predict_raw`` walks the
fp32 pack (``models/tree.py::forest_scores``) through the serving plan.

A config the slice does not train raises ``NotImplementedError`` naming
its ROADMAP item (``check_supported``); nothing is silently ignored.
``GBDT.from_trees`` builds the serving-only model a JAX booster is
carried across into (``convert.model_from_arrays``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..binning import BinnedData, build_bundles
from ..config import Config, _CANONICAL
from ..dataset import TrainData
from ..objectives import create_objective
from ..ops.quantize import quant_generator
from ..ops.split import SplitConfig
from ..utils.device import resolve_device
from .grower import GrowerConfig, make_grower
from .tree import Tree

#: histogram impls the port trains with
_HIST_IMPLS = ("auto", "pallas", "flat", "flat_bf16", "segment", "onehot")


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to lightgbm_tpu_torch yet (ROADMAP {item})")


def check_supported(cfg: Config, train: Optional[TrainData] = None) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for every
    param value, and every dataset, that the binary-training slice does
    not train."""
    unknown = sorted(k for k in cfg.raw_params if k not in _CANONICAL)
    if unknown:
        raise _todo(f"param(s) {unknown}", "queue A: the rest of the "
                    "param table, A1")
    if cfg.objective != "binary":
        raise _todo(f"training objective={cfg.objective}", "A8.1/A8.2")
    if cfg.num_class != 1:
        raise _todo("num_class > 1", "A8.1")
    if cfg.boosting != "gbdt":
        raise _todo(f"boosting={cfg.boosting}", "A8.9")
    if (cfg.data_sample_strategy != "bagging" or cfg.bagging_fraction < 1.0
            or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0 or cfg.bagging_freq > 0):
        raise _todo("bagging and GOSS", "A8.3")
    if cfg.feature_fraction < 1.0:
        raise _todo("feature_fraction < 1", "A8.3")
    if cfg.feature_fraction_bynode < 1.0 or cfg.extra_trees:
        raise _todo("feature_fraction_bynode and extra_trees", "A8.7")
    if cfg.monotone_constraints and any(int(m) != 0
                                        for m in cfg.monotone_constraints):
        raise _todo("monotone constraints", "A8.7")
    if cfg.forcedsplits_filename:
        raise _todo("forced splits", "A8.7")
    if (cfg.cegb_tradeoff < 1.0 or cfg.cegb_penalty_split > 0.0
            or cfg.cegb_penalty_feature_lazy
            or cfg.cegb_penalty_feature_coupled):
        raise _todo("CEGB penalties", "A8.7")
    if cfg.interaction_constraints or cfg.feature_contri:
        raise _todo("interaction constraints and feature_contri", "A8.7")
    if cfg.linear_tree:
        raise _todo("linear trees", "A8.8")
    if cfg.input_model:
        raise _todo("continued training (input_model)", "A8.9")
    if cfg.tree_learner != "serial" or cfg.num_machines > 1:
        raise _todo(f"tree_learner={cfg.tree_learner} / num_machines",
                    "A10")
    if cfg.early_stopping_round > 0:
        raise _todo("early stopping", "A5c")
    if cfg.tpu_iter_pack > 0:
        raise _todo("iteration packing (tpu_iter_pack)", "A8.11")
    if cfg.max_bin_by_feature or cfg.forcedbins_filename:
        raise _todo("max_bin_by_feature and forced bins", "A1")
    if cfg.tpu_histogram_impl not in _HIST_IMPLS:
        raise ValueError(f"tpu_histogram_impl={cfg.tpu_histogram_impl!r}: "
                         f"expected one of {', '.join(_HIST_IMPLS)}")
    if cfg.tpu_wave_kernel not in ("auto", "fused", "unfused"):
        raise ValueError(f"tpu_wave_kernel={cfg.tpu_wave_kernel!r}: "
                         "expected auto, fused or unfused")
    if train is None:
        return
    b = train.binned
    sorted_cat = b.is_categorical & (b.num_bins_per_feature
                                     > cfg.max_cat_to_onehot)
    if sorted_cat.any():
        raise _todo(
            f"sorted many-vs-many categorical splits (features "
            f"{np.nonzero(sorted_cat)[0].tolist()} have more than "
            f"max_cat_to_onehot={cfg.max_cat_to_onehot} bins)", "A8.4")
    if cfg.enable_bundle and build_bundles(
            b, max_conflict_rate=cfg.max_conflict_rate) is not None:
        raise _todo("EFB bundling of this dataset (pass enable_bundle="
                    "false to train it unbundled)", "A8.6")


def _split_config(cfg: Config, train: Optional[TrainData] = None
                  ) -> SplitConfig:
    facts = {}
    if train is not None:
        b = train.binned
        facts = dict(
            has_nan=bool(np.any(np.asarray(b.nan_bins) < b.max_num_bins)),
            has_categorical=bool(np.any(b.is_categorical)))
    return SplitConfig(
        lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
        min_gain_to_split=cfg.min_gain_to_split,
        max_delta_step=cfg.max_delta_step,
        max_cat_to_onehot=cfg.max_cat_to_onehot,
        path_smooth=cfg.path_smooth, **facts)


class GBDT:
    """A boosted ensemble: ``models[k][i]`` is class ``k``'s tree of
    iteration ``i``.  ``GBDT(cfg, train, device=...)`` trains;
    :meth:`from_trees` wraps trees carried across for serving."""

    def __init__(self, cfg: Config, train: TrainData, device=None):
        check_supported(cfg, train)
        self.cfg = cfg
        self.train_data = train
        self.device = resolve_device(device)
        self.num_class = 1
        self.models: List[List[Tree]] = [[]]
        self.objective = create_objective(cfg)
        self.objective.init(train.label, train.weight, self.device)
        # 4-bit bin storage (reference DenseBin IS_4BIT; the JAX package's
        # gate without its EFB and feature-parallel exclusions, which the
        # port refuses or lacks): every feature at <= 16 bins.
        packed4 = bool(cfg.tpu_4bit_bins
                       and train.binned.max_num_bins <= 16)
        self.grower_cfg = GrowerConfig(
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth,
            num_bins=train.binned.max_num_bins,
            split=_split_config(cfg, train),
            histogram_impl=cfg.tpu_histogram_impl,
            rows_block=cfg.tpu_rows_block, leaf_batch=cfg.tpu_leaf_batch,
            wave_kernel=cfg.tpu_wave_kernel,
            quantized=cfg.use_quantized_grad,
            num_grad_quant_bins=cfg.num_grad_quant_bins,
            stochastic_rounding=cfg.stochastic_rounding,
            quant_renew_leaf=cfg.quant_train_renew_leaf, packed4=packed4)
        self.grow = make_grower(self.grower_cfg)
        self.bins_dev = train.bins_device(self.device, packed4=packed4)
        self.meta_dev = train.feature_meta_device(self.device)
        self.init_scores = np.zeros(1, np.float64)
        if cfg.boost_from_average and train.init_score is None:
            self.init_scores[0] = self.objective.boost_from_score(0)
        self.scores = self._init_scores_array(train)
        n, f = train.num_data, train.num_features
        self._full_mask = torch.ones(n, dtype=torch.float32,
                                     device=self.device)
        self._fmask = torch.ones(f, dtype=torch.bool, device=self.device)

    @classmethod
    def from_trees(cls, cfg: Config, binned: BinnedData,
                   models: List[List[Tree]], init_scores) -> "GBDT":
        """The serving-only model of trees trained elsewhere."""
        self = cls.__new__(cls)
        self.cfg = cfg
        self.num_class = int(cfg.num_class)
        if len(models) != self.num_class:
            raise ValueError(f"{len(models)} tree lists for num_class="
                             f"{self.num_class}")
        if len({len(m) for m in models}) > 1:
            raise ValueError("every class needs the same number of trees")
        self.train_data = TrainData(binned=binned, label=np.zeros(0))
        self.models = [list(m) for m in models]
        self.init_scores = np.asarray(init_scores, np.float64).reshape(
            self.num_class).copy()
        self.objective = create_objective(cfg)
        return self

    # ---------------------------------------------------------- training
    def _init_scores_array(self, data: TrainData) -> torch.Tensor:
        """(N,) f32 start scores: the init score in f32, plus the data's
        own init_score (added in f32, as the JAX package adds them)."""
        n = data.num_data
        base = np.tile(self.init_scores[None, :], (n, 1)).astype(np.float32)
        if data.init_score is not None:
            base = base + np.asarray(data.init_score, np.float32).reshape(
                n, -1)
        return torch.from_numpy(np.ascontiguousarray(base[:, 0])).to(
            self.device)

    def _grow_apply(self, grad, hess, shrink: float):
        """``grow_apply``: grow one tree, shrink it, and add its leaf
        values to the scores."""
        meta = self.meta_dev
        qgen = (quant_generator(self.cfg.seed, self.iter_, self.device)
                if self.cfg.use_quantized_grad else None)
        with record_function("gbdt/grow"):
            arrays, row_leaf = self.grow(
                self.bins_dev, grad, hess, self._full_mask, self._fmask,
                meta["num_bins_per_feature"], meta["nan_bins"],
                meta["is_categorical"], quant_generator=qgen)
        with record_function("gbdt/score_update"):
            s = torch.tensor(np.float32(shrink))
            lv = (arrays.leaf_value * s if arrays.num_leaves > 1
                  else torch.zeros_like(arrays.leaf_value))
            arrays = arrays._replace(leaf_value=lv,
                                     internal_value=arrays.internal_value * s)
            lv_dev = lv.to(self.device)
            self.scores = self.scores + lv_dev[row_leaf.long()]
        return arrays

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; ``grad``/``hess`` (N,) override the
        objective's.  Returns True when the tree could not split (the
        caller stops)."""
        with record_function("gbdt/gradients"):
            if grad is None:
                grad, hess = self.objective.get_gradients(self.scores)
            else:
                grad = torch.as_tensor(np.asarray(grad, np.float32),
                                       device=self.device).reshape(-1)
                hess = torch.as_tensor(np.asarray(hess, np.float32),
                                       device=self.device).reshape(-1)
        arrays = self._grow_apply(grad, hess, self.cfg.learning_rate)
        with record_function("gbdt/host_tree"):
            self.models[0].append(Tree.from_arrays(
                arrays, self.train_data.binned.upper_bounds_padded))
        return arrays.num_leaves <= 1

    # ---------------------------------------------------- model surface
    @property
    def iter_(self) -> int:
        return len(self.models[0]) if self.models else 0

    @property
    def num_trees(self) -> int:
        return sum(len(m) for m in self.models)

    def host_trees(self, start: int = 0,
                   end: Optional[int] = None) -> List[List[Tree]]:
        """Per-class host trees of iterations ``[start, end)``."""
        n = self.iter_
        start = max(int(start), 0)
        end = n if end is None else min(int(end), n)
        return [self.models[k][start:end] for k in range(self.num_class)]

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0, device=None) -> np.ndarray:
        """(N,) f64 raw scores (init score included) through the fp32
        serving plan on ``device`` (default: the training device)."""
        from ..serve.plan import plan_for_model
        dev = getattr(self, "device", None) if device is None else device
        plan = plan_for_model(self, num_iteration, start_iteration,
                              quantize="off", device=dev)
        if hasattr(X, "tocsc"):
            raw = plan.raw_scores_binned(self.train_data.binned.apply(X))
        else:
            raw = plan.raw_scores(np.asarray(X, np.float64))
        return raw[:, 0] if self.num_class == 1 else raw

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Split counts (or summed gains) per feature (reference
        ``GBDT::FeatureImportance``)."""
        imp = np.zeros(self.train_data.num_features, np.float64)
        for cls_models in self.models:
            for tree in cls_models:
                k = tree.num_splits()
                if importance_type == "split":
                    np.add.at(imp, tree.split_feature[:k], 1.0)
                else:
                    np.add.at(imp, tree.split_feature[:k],
                              tree.split_gain[:k].astype(np.float64))
        return imp
