"""Gradient-boosted decision trees: training and the serving surface.

The port of the single-device training half of the JAX package's
``models/gbdt.py::GBDT`` (reference ``GBDT::TrainOneIter``): boost from
average, then per iteration the objective's gradients -> for each of the
K trees of the iteration (K = the objective's
``num_model_per_iteration``; scores are (N, K) for the multiclass
objectives, (N,) otherwise) leaf-wise growth (``models/grower.py``) on
the class's gradient column -> the objective's percentile leaf renewal
where it has one (host numpy, as in the JAX package) -> shrinkage -> the
score update, with the JAX package's rounding rule (the shrunk leaf
values are materialized, then one add per row).  Each stored tree also
adds its f32 prediction to every valid set's scores (a one-tree fp32
walk over the valid bins, kept on the device), and ``eval_set`` scores
the training and valid sets with the config's metrics on the host.
Under ``use_quantized_grad`` each tree's stochastic rounding draws from
its own ``torch.Generator`` seeded from ``(seed, iteration)``, and the
class too when K > 1 (``ops/quantize.py::quant_generator``).  With every
feature at <= 16 bins and ``tpu_4bit_bins`` on (the default) the bins
are stored as 4-bit nibble pairs (``GrowerConfig.packed4``).  With
``enable_bundle`` on (the default) and a dataset whose sparse exclusive
columns bundle (``TrainData.build_bundles``), the grower trains on the
(N, G) bundled matrix (with the bundles' tables, built once); trees
stay in the
original feature space.  Scores,
bins and gradients live on the device; each grown tree becomes a host
``Tree`` at once.  ``torch.profiler`` ranges
(``gbdt/gradients``, ``gbdt/grow``, ``gbdt/score_update``,
``gbdt/host_tree``) mark an iteration's steps.  ``predict_raw`` walks the
fp32 pack (``models/tree.py::forest_scores``) through the serving plan.

Row and feature sampling (``sampling.py``): bagging (plain, balanced,
by query) and ``feature_fraction`` draw their masks on the host from the
JAX package's ``RandomState`` streams; GOSS scores each row by
``|sum_k g * sum_k h|`` (one mask serves the K trees of an iteration) and
samples on the device under ``tpu_device_goss`` ``on``, and under
``auto`` wherever the JAX package's fused iteration would (an objective
without leaf renewal or host-stochastic gradients), else on the host
(``off``, and custom gradients).  A sampled-out row keeps gradient,
hessian and count 0 in every histogram.  The ranking objectives read the
training data's query groups and positions, and every dataset hands its
groups to the metrics.

Continued training: ``base_model`` (a loaded model text,
``serialization.LoadedModel``) whose raw scores the caller folded into
the datasets' init scores (so boost-from-average stays off); its trees
come first in ``predict_raw``'s iterations, ``num_trees``, the feature
importances and the model text, while ``iter_``, the stump rule and early
stopping count the booster's own iterations.

``check_supported`` refuses by value: a key at its default trains, the
keys of ``_NO_OP_KEYS`` (which change nothing the port trains) train at
any value, and a config the port does not train raises
``NotImplementedError`` naming its ROADMAP item; nothing that would change
the JAX package's result is silently ignored.  ``GBDT.from_trees`` builds
the serving-only model a JAX booster is carried across into
(``convert.model_from_arrays``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..binning import BinnedData
from ..config import Config, _CANONICAL
from ..dataset import TrainData
from ..metrics import metrics_for_config
from ..objectives import RANKING, create_objective
from ..ops.bundle import bundle_tables
from ..ops.quantize import quant_generator
from ..ops.split import SplitConfig
from ..sampling import (FeatureSampler, SampleStrategy, goss_generator,
                        goss_mask_device)
from ..utils.device import resolve_device
from ..utils.log import Log
from .grower import GrowerConfig, make_grower, node_generator
from .tree import Tree, tree_scores

#: histogram impls the port trains with
_HIST_IMPLS = ("auto", "pallas", "flat", "flat_bf16", "segment", "onehot")


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to lightgbm_tpu_torch yet (ROADMAP {item})")


#: keys that change nothing the port trains, accepted at any value: host
#: threading and layout hints, the device choice (the port's comes from
#: its ``device`` argument), the predict-time keys, and keys that tune
#: only a feature the port refuses by that feature's own key
_NO_OP_KEYS = frozenset((
    "num_threads", "deterministic", "force_col_wise", "force_row_wise",
    "is_enable_sparse", "feature_pre_filter", "gpu_platform_id",
    "gpu_device_id", "gpu_use_dp", "num_gpu", "output_model",
    "precise_float_parser", "device_type",
    "start_iteration_predict", "num_iteration_predict", "predict_raw_score",
    "predict_leaf_index", "predict_contrib", "predict_disable_shape_check",
    "pred_early_stop", "pred_early_stop_freq", "pred_early_stop_margin",
    "drop_rate", "max_drop", "skip_drop", "xgboost_dart_mode",
    "uniform_drop", "drop_seed", "linear_lambda",
    "top_k", "monotone_constraints_method", "monotone_penalty",
    "refit_decay_rate", "tpu_hist_comm"))

#: keys refused at a non-default value, with the ROADMAP item that ports
#: them
_REFUSED_KEYS = {
    "two_round": "A1c", "save_binary": "A1c", "parser_config_file": "A1c",
    "pre_partition": "A10", "local_listen_port": "A10", "time_out": "A10",
    "machine_list_filename": "A10", "machines": "A10",
    "snapshot_freq": "A11", "checkpoint_interval": "A11",
    "checkpoint_dir": "A11", "checkpoint_keep": "A11",
    "tpu_probe_timeout": "A11", "tpu_telemetry": "A11",
    "tpu_telemetry_log": "A11", "tpu_profile_iters": "A11",
    "tpu_profile_dir": "A11", "tpu_telemetry_memory": "A11",
    "tpu_stream_budget_mb": "A11", "tpu_stream_residency": "A11",
    "tpu_stream_rows_per_shard": "A11", "tpu_stream_prefetch": "A11",
    "serve_max_queue": "A7c", "serve_deadline_ms": "A7c",
    "tpu_native_predict_max_rows": "A7d", "tpu_serve_compile_cache": "A7e",
    "tpu_serve_request_log": "A7f", "tpu_serve_request_sample": "A7f",
    "tpu_serve_slow_ms": "A7f", "tpu_serve_slo_p99_ms": "A7f",
}
_REFUSED_KEYS.update({k: "A11" for k in _CANONICAL
                      if k.startswith("tpu_health_")})


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for every
    param value that the port does not train yet.
    Keys are refused by value, not by name: a key at its default trains,
    and the keys of ``_NO_OP_KEYS`` train at any value.  A key outside
    the param table is kept and ignored, as the JAX package does."""
    unknown = sorted(k for k in cfg.raw_params if k not in _CANONICAL)
    if unknown:
        Log.warning(f"unknown parameter(s) {unknown} are ignored")
    for key, item in _REFUSED_KEYS.items():
        if getattr(cfg, key) != _CANONICAL[key][2]:
            raise _todo(f"{key}={getattr(cfg, key)!r}", item)
    if cfg.input_model:
        raise _todo("input_model in train's params (the command-line "
                    "interface reads it; pass init_model= to train)", "A9")
    if cfg.boosting != "gbdt":
        raise _todo(f"boosting={cfg.boosting}", "A8.9")
    if cfg.data_sample_strategy not in ("bagging", "goss"):
        raise ValueError(f"data_sample_strategy={cfg.data_sample_strategy!r}"
                         ": expected bagging or goss")
    if cfg.tpu_device_goss not in ("auto", "on", "off"):
        raise ValueError(f"tpu_device_goss={cfg.tpu_device_goss!r}: "
                         "expected auto, on or off")
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
    if cfg.tree_learner != "serial" or cfg.num_machines > 1:
        raise _todo(f"tree_learner={cfg.tree_learner} / num_machines",
                    "A10")
    if cfg.tpu_iter_pack > 0:
        raise _todo("iteration packing (tpu_iter_pack)", "A8.11")
    if cfg.tpu_histogram_impl not in _HIST_IMPLS:
        raise ValueError(f"tpu_histogram_impl={cfg.tpu_histogram_impl!r}: "
                         f"expected one of {', '.join(_HIST_IMPLS)}")
    if cfg.tpu_wave_kernel not in ("auto", "fused", "unfused"):
        raise ValueError(f"tpu_wave_kernel={cfg.tpu_wave_kernel!r}: "
                         "expected auto, fused or unfused")


def _split_config(cfg: Config, train: Optional[TrainData] = None
                  ) -> SplitConfig:
    facts = {}
    if train is not None:
        b = train.binned
        is_cat = np.asarray(b.is_categorical)
        facts = dict(
            has_nan=bool(np.any(np.asarray(b.nan_bins) < b.max_num_bins)),
            has_categorical=bool(np.any(is_cat)),
            use_sorted_categorical=bool(np.any(
                is_cat & (np.asarray(b.num_bins_per_feature)
                          > cfg.max_cat_to_onehot))))
    return SplitConfig(
        lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
        min_gain_to_split=cfg.min_gain_to_split,
        max_delta_step=cfg.max_delta_step, cat_l2=cfg.cat_l2,
        cat_smooth=cfg.cat_smooth, max_cat_threshold=cfg.max_cat_threshold,
        max_cat_to_onehot=cfg.max_cat_to_onehot,
        min_data_per_group=cfg.min_data_per_group,
        path_smooth=cfg.path_smooth, scan_tile=cfg.tpu_split_tile, **facts)


class GBDT:
    """A boosted ensemble: ``models[k][i]`` is class ``k``'s tree of
    iteration ``i``.  ``GBDT(cfg, train, valids, device=...)`` trains
    (``valids``: ``(name, TrainData)`` pairs binned with the training
    mappers); :meth:`from_trees` wraps trees carried across for
    serving."""

    def __init__(self, cfg: Config, train: TrainData, valids=(),
                 device=None, base_model=None):
        check_supported(cfg)
        self.cfg = cfg
        self.train_data = train
        self.device = resolve_device(device)
        # continued training: a LoadedModel whose raw scores the caller
        # folded into every dataset's init_score; its trees come first in
        # predictions, model text, tree counts and importances
        self.base_model = base_model
        self.num_class = cfg.num_model_per_iteration
        self.models: List[List[Tree]] = [[] for _ in range(self.num_class)]
        self.objective = create_objective(cfg)
        if self.objective is not None:
            ranking = ({"group": train.group, "position": train.position}
                       if cfg.objective in RANKING else {})
            self.objective.init(train.label, train.weight, self.device,
                                **ranking)
        self.metrics = metrics_for_config(cfg)
        # EFB (reference FindGroups / FeatureGroup): histograms and row
        # partitions run on the bundled columns, split scans on each
        # feature's rebuilt histogram (ops/bundle.py)
        self.bundles = train.build_bundles(cfg)
        if self.bundles is not None:
            Log.info(f"EFB: bundled {train.num_features} features into "
                     f"{self.bundles.num_groups} columns")
        # 4-bit bin storage (reference DenseBin IS_4BIT; the JAX package's
        # gate without its feature-parallel exclusion, which the port
        # lacks): every feature at <= 16 bins, and no bundles (their bins
        # pass 4 bits)
        packed4 = bool(cfg.tpu_4bit_bins and self.bundles is None
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
            quant_renew_leaf=cfg.quant_train_renew_leaf, packed4=packed4,
            histogram_pool_size=cfg.histogram_pool_size,
            extra_trees=cfg.extra_trees,
            feature_fraction_bynode=cfg.feature_fraction_bynode)
        self.grow = make_grower(self.grower_cfg)
        self.meta_dev = train.feature_meta_device(self.device)
        if self.bundles is not None:
            self.bins_dev = train.bundled_bins_device(self.device)
            self._bundle_args = {"bundle": bundle_tables(
                self.bundles, train.binned.num_bins_per_feature,
                self.grower_cfg.num_bins, self.device)}
        else:
            self.bins_dev = train.bins_device(self.device, packed4=packed4)
            self._bundle_args = {}
        self.init_scores = np.zeros(self.num_class, np.float64)
        # reference gbdt.cpp:319: boost from average only when the data
        # carries no init score
        if (cfg.boost_from_average and self.objective is not None
                and train.init_score is None):
            for k in range(self.num_class):
                self.init_scores[k] = self.objective.boost_from_score(k)
        # (N, K) scores: config refuses a multiclass objective at K = 1
        self._shape_k = self.num_class > 1
        self.scores = self._init_scores_array(train)
        self.valids, self.valid_bins, self.valid_scores = [], [], []
        for name, data in valids:
            self.add_valid(name, data)
        n, f = train.num_data, train.num_features
        self._full_mask = torch.ones(n, dtype=torch.float32,
                                     device=self.device)
        self.sample_strategy = SampleStrategy(
            cfg, n, train.label, train.query_boundaries())
        self.feature_sampler = FeatureSampler(cfg, f)
        self._bag_mask_dev = None
        self._fmask_static = (torch.ones(f, dtype=torch.bool,
                                         device=self.device)
                              if cfg.feature_fraction >= 1.0 else None)

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
        self.base_model = None
        self.models = [list(m) for m in models]
        self.init_scores = np.asarray(init_scores, np.float64).reshape(
            self.num_class).copy()
        self.objective = create_objective(cfg)
        return self

    # ---------------------------------------------------------- training
    def _init_scores_array(self, data: TrainData) -> torch.Tensor:
        """(N,) or (N, K) f32 start scores: the init scores in f32, plus
        the data's own init_score (added in f32, as the JAX package adds
        them)."""
        n = data.num_data
        base = np.tile(self.init_scores[None, :], (n, 1)).astype(np.float32)
        if data.init_score is not None:
            base = base + np.asarray(data.init_score, np.float32).reshape(
                n, -1)
        if self.num_class == 1:
            base = base[:, 0]
        return torch.from_numpy(np.ascontiguousarray(base)).to(self.device)

    def goss_on_device(self, custom_grads: bool = False) -> bool:
        """Does GOSS sample on the device this run?  ``on`` does (but for
        custom gradients, which arrive from the host), ``off`` does not,
        and ``auto`` does wherever the JAX package's fused iteration
        would: an objective without leaf renewal or host-stochastic
        gradients.  False when the run does not sample with GOSS."""
        mode = self.cfg.tpu_device_goss
        obj = self.objective
        if custom_grads or mode == "off" or not self.sample_strategy.is_goss:
            return False
        return mode == "on" or (
            obj is not None and not obj.need_renew_tree_output
            and not obj.stochastic_gradients)

    def _iter_masks(self, grad, hess, custom_grads: bool):
        """This iteration's (N,) f32 row mask and (F,) bool feature mask
        (the JAX package's ``_iter_masks`` / ``_tree_fmask``)."""
        strategy = self.sample_strategy
        it = self.iter_
        n = self.train_data.num_data
        with record_function("gbdt/sample"):
            if strategy.is_goss:
                if strategy.goss_warmup(it):
                    mask = self._full_mask
                elif self.goss_on_device(custom_grads):
                    mask = goss_mask_device(
                        grad.reshape(n, -1).sum(dim=1),
                        hess.reshape(n, -1).sum(dim=1),
                        goss_generator(self.cfg.bagging_seed, it,
                                       self.device),
                        *strategy.goss_constants())
                else:
                    gm = grad.cpu().numpy().reshape(n, -1)
                    hm = hess.cpu().numpy().reshape(n, -1)
                    mask = torch.from_numpy(strategy.mask(
                        it, gm.sum(axis=1), hm.sum(axis=1))).to(self.device)
            elif strategy.is_bagging:
                if (strategy.needs_resample(it)
                        or self._bag_mask_dev is None):
                    self._bag_mask_dev = torch.from_numpy(
                        strategy.mask(it)).to(self.device)
                mask = self._bag_mask_dev
            else:
                mask = self._full_mask
            fmask = (self._fmask_static if self._fmask_static is not None
                     else torch.from_numpy(self.feature_sampler.tree_mask(
                         it)).to(self.device))
        return mask, fmask

    def _grow(self, grad, hess, iteration: int, class_id: Optional[int],
              mask, fmask):
        """Grow one tree of ``iteration`` on (N,) gradients under the row
        and feature masks; ``class_id`` seeds its own stochastic rounding
        and per-node draws when the iteration grows K trees.  The per-node
        draws come from a host generator seeded from ``extra_seed * 92821
        + feature_fraction_seed`` (the JAX package's per-training key)."""
        meta = self.meta_dev
        cfg = self.cfg
        qgen = (quant_generator(cfg.seed, iteration, self.device, class_id)
                if cfg.use_quantized_grad else None)
        ngen = (node_generator(
            cfg.extra_seed * 92821 + cfg.feature_fraction_seed, iteration,
            class_id) if self.grower_cfg.node_draws else None)
        with record_function("gbdt/grow"):
            return self.grow(
                self.bins_dev, grad, hess, mask, fmask,
                meta["num_bins_per_feature"], meta["nan_bins"],
                meta["is_categorical"], quant_generator=qgen,
                node_generator=ngen, **self._bundle_args)

    def _shrink(self, arrays, shrink: float):
        """Shrunk leaf values (zero for a stump) and internal values."""
        s = torch.tensor(np.float32(shrink))
        lv = (arrays.leaf_value * s if arrays.num_leaves > 1
              else torch.zeros_like(arrays.leaf_value))
        return arrays._replace(leaf_value=lv,
                               internal_value=arrays.internal_value * s)

    def _renew_and_shrink(self, arrays, row_leaf, scores_k, shrink: float):
        """Host percentile leaf renewal (reference ``RenewTreeOutput``:
        L1, Huber, Quantile, MAPE), then shrinkage: ``row_leaf`` and the
        class's scores go to the host, as in the JAX package."""
        nl = int(arrays.num_leaves)
        if nl <= 1:
            return arrays._replace(
                leaf_value=torch.zeros_like(arrays.leaf_value))
        with record_function("gbdt/renew"):
            rl = row_leaf.cpu().numpy()
            sc = scores_k.cpu().numpy()
            renewed = self.objective.renew_leaf_values(sc, rl, nl)
        lv = np.zeros(arrays.leaf_value.shape[0], np.float32)
        lv[:nl] = renewed * shrink
        return arrays._replace(
            leaf_value=torch.from_numpy(lv),
            internal_value=arrays.internal_value
            * torch.tensor(np.float32(shrink)))

    def _grow_apply(self, grad, hess, shrink: float, iteration: int,
                    masks, class_id: Optional[int] = None):
        """``grow_apply``: grow one tree under ``masks`` (row, feature),
        shrink it (renewing its leaves first where the objective refits
        them), and add its leaf values to the scores (column ``class_id``
        of (N, K) scores)."""
        arrays, row_leaf = self._grow(grad, hess, iteration, class_id,
                                      *masks)
        k = 0 if class_id is None else class_id
        scores_k = self.scores[:, k] if self._shape_k else self.scores
        renew = (self.objective is not None
                 and self.objective.need_renew_tree_output)
        if renew:
            arrays = self._renew_and_shrink(arrays, row_leaf, scores_k,
                                            shrink)
        with record_function("gbdt/score_update"):
            if not renew:
                arrays = self._shrink(arrays, shrink)
            new_k = scores_k + arrays.leaf_value.to(self.device)[
                row_leaf.long()]
            if self._shape_k:
                self.scores[:, k] = new_k
            else:
                self.scores = new_k
        return arrays

    def _add_to_valid(self, i: int, k: int, tree: Tree) -> None:
        """Add ``tree``'s f32 prediction to column ``k`` of valid set
        ``i``'s scores."""
        pred = tree_scores(tree, self.valid_bins[i], self.meta_dev["nan_bins"],
                           self.cfg.num_leaves,
                           self.train_data.binned.max_num_bins)
        if self._shape_k:
            self.valid_scores[i][:, k] += pred
        else:
            self.valid_scores[i] = self.valid_scores[i] + pred

    def add_valid(self, name: str, data: TrainData) -> None:
        """Score ``data`` (binned with the training mappers) as a valid
        set: its bins go to the device as (N, F) int32 (the fp32 walk's
        input), and its scores start at the model's so far, every tree
        added in training order."""
        self.valids.append((name, data))
        self.valid_bins.append(torch.from_numpy(
            data.binned.bins.astype(np.int32)).to(self.device))
        self.valid_scores.append(self._init_scores_array(data))
        i = len(self.valids) - 1
        for it in range(self.iter_):
            for k in range(self.num_class):
                self._add_to_valid(i, k, self.models[k][it])

    def _store_tree(self, k: int, arrays) -> None:
        """Keep class ``k``'s new tree on the host and add its f32
        prediction to every valid set's scores."""
        with record_function("gbdt/host_tree"):
            tree = Tree.from_arrays(
                arrays, self.train_data.binned.upper_bounds_padded)
            self.models[k].append(tree)
        if self.valids:
            with record_function("gbdt/valid_scores"):
                for i in range(len(self.valids)):
                    self._add_to_valid(i, k, tree)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; ``grad``/``hess`` (N,) or (N, K)
        override the objective's.  Returns True when no tree of the
        iteration could split (the caller stops)."""
        custom = grad is not None
        with record_function("gbdt/gradients"):
            if grad is None:
                if self.objective is None:
                    raise ValueError(
                        "objective='custom' needs gradients: call "
                        "update(fobj=...)")
                grad, hess = self.objective.get_gradients(self.scores)
            else:
                shape = self.scores.shape
                grad = torch.as_tensor(np.asarray(grad, np.float32),
                                       device=self.device).reshape(shape)
                hess = torch.as_tensor(np.asarray(hess, np.float32),
                                       device=self.device).reshape(shape)
        it, lr = self.iter_, self.cfg.learning_rate
        masks = self._iter_masks(grad, hess, custom)
        leaves = []
        for k in range(self.num_class):
            if self._shape_k:
                arrays = self._grow_apply(grad[:, k], hess[:, k], lr, it,
                                          masks, k)
            else:
                arrays = self._grow_apply(grad, hess, lr, it, masks)
            self._store_tree(k, arrays)
            leaves.append(arrays.num_leaves)
        return all(nl <= 1 for nl in leaves)

    # -------------------------------------------------------- evaluation
    def eval_set(self):
        """``[(data name, metric name, value, higher_better)]`` for the
        valid sets, and the training set under
        ``is_provide_training_metric`` (reference ``GBDT::OutputMetric``)."""
        out = []
        datasets = [("training", self.train_data, self.scores)]
        datasets += [(name, data, self.valid_scores[i])
                     for i, (name, data) in enumerate(self.valids)]
        for name, data, scores in datasets:
            if (name == "training"
                    and not self.cfg.is_provide_training_metric):
                continue
            with record_function("gbdt/eval"):
                sc = scores.cpu().numpy().astype(np.float64)
                for m in self.metrics:
                    out.append((name, m.name,
                                m(data.label, sc, data.weight, data.group),
                                m.higher_better))
        return out

    def eval_valid(self):
        return [e for e in self.eval_set() if e[0] != "training"]

    # ---------------------------------------------------- model surface
    @property
    def iter_(self) -> int:
        return len(self.models[0]) if self.models else 0

    @property
    def num_trees(self) -> int:
        own = sum(len(m) for m in self.models)
        return own + (self.base_model.num_trees if self.base_model else 0)

    def host_trees(self, start: int = 0,
                   end: Optional[int] = None) -> List[List[Tree]]:
        """Per-class host trees of iterations ``[start, end)``."""
        n = self.iter_
        start = max(int(start), 0)
        end = n if end is None else min(int(end), n)
        return [self.models[k][start:end] for k in range(self.num_class)]

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0, device=None) -> np.ndarray:
        """(N,) or (N, K) f64 raw scores (init score included).
        Iterations index the combined model: a continuation's base model
        (walked by :class:`~..serialization.LoadedModel`) first, then this
        booster's own trees through the fp32 serving plan on ``device``
        (default: the training device)."""
        start_iteration = max(int(start_iteration), 0)
        if self.base_model is None:
            return self._predict_raw_own(X, num_iteration, start_iteration,
                                         device)
        nb = self.base_model.iter_
        end = (None if num_iteration is None
               else start_iteration + num_iteration)
        b_start = min(start_iteration, nb)
        b_num = (nb if end is None else max(min(end, nb), b_start)) - b_start
        base = self.base_model.predict_raw(X, num_iteration=b_num,
                                           start_iteration=b_start)
        own_start = max(start_iteration - nb, 0)
        own_num = None if end is None else max(end - nb - own_start, 0)
        return base + self._predict_raw_own(X, own_num, own_start, device)

    def _predict_raw_own(self, X, num_iteration: Optional[int],
                         start_iteration: int, device=None) -> np.ndarray:
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
        ``GBDT::FeatureImportance``), the base model's included."""
        imp = np.zeros(self.train_data.num_features, np.float64)
        if self.base_model is not None:
            base_imp = self.base_model.feature_importance(importance_type)
            imp[: len(base_imp)] += base_imp
        for cls_models in self.models:
            for tree in cls_models:
                k = tree.num_splits()
                if importance_type == "split":
                    np.add.at(imp, tree.split_feature[:k], 1.0)
                else:
                    np.add.at(imp, tree.split_feature[:k],
                              tree.split_gain[:k].astype(np.float64))
        return imp
