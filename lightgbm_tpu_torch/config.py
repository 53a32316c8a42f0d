"""Typed configuration with LightGBM-compatible parameter names and aliases.

The port's copy of the JAX package's ``config.py``: every row of its
param table, with its names, types, defaults, aliases and bounds.
``models/gbdt.py::check_supported`` sorts the keys by what training does
with them: read, accepted at any value since they change nothing the
port trains, or refused at a non-default value naming their ROADMAP
item.  Alias resolution follows ``ParameterAlias::KeyAliasTransform``
semantics (first write wins, aliases mapped onto the canonical name);
unknown keys are kept in ``raw_params``, as the JAX package keeps them
(the model text prints ``raw_params``), and training refuses them rather
than ignore a key it does not know.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

# (name, type, default, aliases, check)
#   type is one of: bool, int, float, str, "list_int", "list_float", "list_str"
#   check is an optional (lo, hi) inclusive bound for numeric params.
_PARAMS: List[Tuple[str, Any, Any, Tuple[str, ...], Optional[Tuple[Any, Any]]]] = [
    # ---- core
    ("objective", str, "regression",
     ("objective_type", "app", "application", "loss"), None),
    ("boosting", str, "gbdt", ("boosting_type", "boost"), None),
    ("data_sample_strategy", str, "bagging", (), None),
    ("num_iterations", int, 100,
     ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
      "num_rounds", "nrounds", "num_boost_round", "n_estimators",
      "max_iter"), (0, None)),
    ("learning_rate", float, 0.1, ("shrinkage_rate", "eta"), (0.0, None)),
    ("num_leaves", int, 31,
     ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"), (2, 131072)),
    ("tree_learner", str, "serial",
     ("tree", "tree_type", "tree_learner_type"), None),
    ("num_threads", int, 0,
     ("num_thread", "nthread", "nthreads", "n_jobs"), None),
    ("device_type", str, "tpu", ("device",), None),
    ("seed", int, 0, ("random_seed", "random_state"), None),
    ("deterministic", bool, False, (), None),
    # ---- learning control
    ("force_col_wise", bool, False, (), None),
    ("force_row_wise", bool, False, (), None),
    ("histogram_pool_size", float, -1.0, ("hist_pool_size",), None),
    ("max_depth", int, -1, (), None),
    ("min_data_in_leaf", int, 20,
     ("min_data_per_leaf", "min_data", "min_child_samples",
      "min_samples_leaf"), (0, None)),
    ("min_sum_hessian_in_leaf", float, 1e-3,
     ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian",
      "min_child_weight"), (0.0, None)),
    ("bagging_fraction", float, 1.0,
     ("sub_row", "subsample", "bagging"), (0.0, 1.0)),
    ("pos_bagging_fraction", float, 1.0,
     ("pos_sub_row", "pos_subsample", "pos_bagging"), (0.0, 1.0)),
    ("neg_bagging_fraction", float, 1.0,
     ("neg_sub_row", "neg_subsample", "neg_bagging"), (0.0, 1.0)),
    ("bagging_freq", int, 0, ("subsample_freq",), None),
    ("bagging_seed", int, 3, ("bagging_fraction_seed",), None),
    ("bagging_by_query", bool, False, (), None),
    ("feature_fraction", float, 1.0,
     ("sub_feature", "colsample_bytree"), (0.0, 1.0)),
    ("feature_fraction_bynode", float, 1.0,
     ("sub_feature_bynode", "colsample_bynode"), (0.0, 1.0)),
    ("feature_fraction_seed", int, 2, (), None),
    ("extra_trees", bool, False, ("extra_tree",), None),
    ("extra_seed", int, 6, (), None),
    ("early_stopping_round", int, 0,
     ("early_stopping_rounds", "early_stopping", "n_iter_no_change"), None),
    ("early_stopping_min_delta", float, 0.0, (), (0.0, None)),
    ("first_metric_only", bool, False, (), None),
    ("max_delta_step", float, 0.0, ("max_tree_output", "max_leaf_output"),
     None),
    ("lambda_l1", float, 0.0, ("reg_alpha", "l1_regularization"), (0.0, None)),
    ("lambda_l2", float, 0.0, ("reg_lambda", "lambda", "l2_regularization"),
     (0.0, None)),
    ("linear_lambda", float, 0.0, (), (0.0, None)),
    ("min_gain_to_split", float, 0.0, ("min_split_gain",), (0.0, None)),
    ("drop_rate", float, 0.1, ("rate_drop",), (0.0, 1.0)),
    ("max_drop", int, 50, (), None),
    ("skip_drop", float, 0.5, (), (0.0, 1.0)),
    ("xgboost_dart_mode", bool, False, (), None),
    ("uniform_drop", bool, False, (), None),
    ("drop_seed", int, 4, (), None),
    ("top_rate", float, 0.2, (), (0.0, 1.0)),
    ("other_rate", float, 0.1, (), (0.0, 1.0)),
    ("min_data_per_group", int, 100, (), (1, None)),
    ("max_cat_threshold", int, 32, (), (1, None)),
    ("cat_l2", float, 10.0, (), (0.0, None)),
    ("cat_smooth", float, 10.0, (), (0.0, None)),
    ("max_cat_to_onehot", int, 4, (), (1, None)),
    ("top_k", int, 20, ("topk",), (1, None)),
    ("monotone_constraints", "list_int", None,
     ("mc", "monotone_constraint", "monotonic_cst"), None),
    ("monotone_constraints_method", str, "basic",
     ("monotone_constraining_method", "mc_method"), None),
    ("monotone_penalty", float, 0.0,
     ("monotone_splits_penalty", "ms_penalty", "mc_penalty"), (0.0, None)),
    ("feature_contri", "list_float", None,
     ("feature_contrib", "fc", "fp", "feature_penalty"), None),
    ("forcedsplits_filename", str,
     "", ("fs", "forced_splits_filename", "forced_splits_file",
     "forced_splits"), None),
    ("refit_decay_rate", float, 0.9, (), (0.0, 1.0)),
    ("input_model", str, "", ("model_input", "model_in"), None),
    ("output_model", str, "LightGBM_model.txt", ("model_output", "model_out"),
     None),
    ("snapshot_freq", int, -1, ("save_period",), None),
    ("cegb_tradeoff", float, 1.0, (), (0.0, None)),
    ("cegb_penalty_split", float, 0.0, (), (0.0, None)),
    ("cegb_penalty_feature_lazy", "list_float", None, (), None),
    ("cegb_penalty_feature_coupled", "list_float", None, (), None),
    ("path_smooth", float, 0.0, (), (0.0, None)),
    ("interaction_constraints", "list_str", None, (), None),
    ("verbosity", int, 1, ("verbose",), None),
    ("use_quantized_grad", bool, False, (), None),
    # Bounded so hessian levels fit int8 (ops/quantize.py).
    ("num_grad_quant_bins", int, 4, (), (2, 128)),
    ("quant_train_renew_leaf", bool, False, (), None),
    ("stochastic_rounding", bool, True, (), None),
    # ---- dataset (and the text-file loader)
    ("linear_tree", bool, False, ("linear_trees",), None),
    ("max_bin", int, 255, ("max_bins",), (2, None)),
    ("max_bin_by_feature", "list_int", None, (), None),
    ("min_data_in_bin", int, 3, (), (1, None)),
    ("bin_construct_sample_cnt", int, 200000, ("subsample_for_bin",),
     (1, None)),
    ("data_random_seed", int, 1, ("data_seed",), None),
    ("is_enable_sparse", bool, True, ("is_sparse", "enable_sparse", "sparse"),
     None),
    ("enable_bundle", bool, True, ("is_enable_bundle", "bundle"), None),
    ("max_conflict_rate", float, 0.0, (), (0.0, 1.0)),
    ("use_missing", bool, True, (), None),
    ("zero_as_missing", bool, False, (), None),
    ("feature_pre_filter", bool, True, (), None),
    ("pre_partition", bool, False, ("is_pre_partition",), None),
    ("two_round", bool, False, ("two_round_loading", "use_two_round_loading"),
     None),
    ("header", bool, False, ("has_header",), None),
    ("label_column", str, "", ("label",), None),
    ("weight_column", str, "", ("weight",), None),
    ("group_column", str, "",
     ("group", "group_id", "query_column", "query", "query_id"), None),
    ("ignore_column", str, "", ("ignore_feature", "blacklist"), None),
    ("categorical_feature", str,
     "", ("cat_feature", "categorical_column", "cat_column",
     "categorical_features"), None),
    ("forcedbins_filename", str, "", (), None),
    ("save_binary", bool, False, ("is_save_binary", "is_save_binary_file"),
     None),
    ("saved_feature_importance_type", int, 0, (), (0, 1)),
    ("precise_float_parser", bool, False, (), None),
    ("parser_config_file", str, "", (), None),
    # ---- predict
    ("start_iteration_predict", int, 0, (), None),
    ("num_iteration_predict", int, -1, (), None),
    ("predict_raw_score", bool, False,
     ("is_predict_raw_score", "predict_rawscore", "raw_score"), None),
    ("predict_leaf_index", bool, False,
     ("is_predict_leaf_index", "leaf_index"), None),
    ("predict_contrib", bool, False, ("is_predict_contrib", "contrib"), None),
    ("predict_disable_shape_check", bool, False, (), None),
    ("pred_early_stop", bool, False, (), None),
    ("pred_early_stop_freq", int, 10, (), None),
    ("pred_early_stop_margin", float, 10.0, (), None),
    # ---- objective
    ("objective_seed", int, 5, (), None),
    ("num_class", int, 1, ("num_classes",), (1, None)),
    ("is_unbalance", bool, False, ("unbalance", "unbalanced_sets"), None),
    ("scale_pos_weight", float, 1.0, (), (0.0, None)),
    ("sigmoid", float, 1.0, (), (0.0, None)),
    ("boost_from_average", bool, True, (), None),
    ("reg_sqrt", bool, False, (), None),
    ("alpha", float, 0.9, (), (0.0, None)),
    ("fair_c", float, 1.0, (), (0.0, None)),
    ("poisson_max_delta_step", float, 0.7, (), (0.0, None)),
    ("tweedie_variance_power", float, 1.5, (), (1.0, 2.0)),
    ("lambdarank_truncation_level", int, 30, (), (1, None)),
    ("lambdarank_norm", bool, True, (), None),
    ("label_gain", "list_float", None, (), None),
    ("lambdarank_position_bias_regularization", float, 0.0, (), (0.0, None)),
    # ---- metric
    ("metric", "list_str", None, ("metrics", "metric_types"), None),
    ("metric_freq", int, 1, ("output_freq",), (1, None)),
    ("is_provide_training_metric", bool, False,
     ("training_metric", "is_training_metric", "train_metric"), None),
    ("eval_at", "list_int", None,
     ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"), None),
    ("multi_error_top_k", int, 1, (), (1, None)),
    ("auc_mu_weights", "list_float", None, (), None),
    # ---- network
    ("num_machines", int, 1, ("num_machine",), (1, None)),
    ("local_listen_port", int, 12400, ("local_port", "port"), None),
    ("time_out", int, 120, (), (1, None)),
    ("machine_list_filename", str, "",
     ("machine_list_file", "machine_list", "mlist"), None),
    ("machines", str, "", ("workers", "nodes"), None),
    # ---- devices; the JAX package's own knobs
    ("gpu_platform_id", int, -1, (), None),
    ("gpu_device_id", int, -1, (), None),
    ("gpu_use_dp", bool, False, (), None),
    ("num_gpu", int, 1, (), (1, None)),
    ("tpu_histogram_impl", str, "auto", (), None),
    ("tpu_rows_block", int, 16384, (), (256, None)),
    ("tpu_4bit_bins", bool, True, (), None),
    ("tpu_leaf_batch", int, 1, (), (1, 128)),
    # Fused wave kernel: auto|fused|unfused.  On a CUDA device auto means
    # the hand-written wave kernel (ops/csrc/wave.cu), as it means the
    # Pallas kernel on a TPU; on the CPU auto keeps the unfused step.
    ("tpu_wave_kernel", str, "auto", (), None),
    ("tpu_hist_comm", str, "auto", (), None),
    ("tpu_split_tile", int, 0, (), (0, None)),
    ("tpu_iter_pack", int, 0, (), (0, 4096)),
    ("tpu_device_goss", str, "auto", (), None),
    ("tpu_native_predict_max_rows", int, 262144, (), (0, None)),
    # Quantized serving packs: off|int16|int8 (off = the fp32 pack).
    ("tpu_serve_quantize", str, "off", (), None),
    # Traversal kernel: auto|fused|unfused.  In the port auto and fused
    # both mean the hand-written CUDA traversal kernel.
    ("tpu_traverse_kernel", str, "auto", (), None),
    ("tpu_serve_compile_cache", str, "", ("serve_compile_cache",), None),
    # ---- serve request tracing
    ("tpu_serve_request_log", str, "off", (), None),
    ("tpu_serve_request_sample", float, 0.01, (), (0.0, 1.0)),
    ("tpu_serve_slow_ms", float, 100.0, (), (0.0, None)),
    ("tpu_serve_slo_p99_ms", float, 0.0, (), (0.0, None)),
    # ---- checkpoints and serve admission
    ("checkpoint_interval", int, 0, ("ckpt_interval",), (0, None)),
    ("checkpoint_dir", str, "", ("ckpt_dir",), None),
    ("checkpoint_keep", int, 2, (), (1, None)),
    ("tpu_probe_timeout", float, 60.0, (), (0.0, None)),
    ("serve_max_queue", int, 0, (), (0, None)),
    ("serve_deadline_ms", float, 0.0, (), (0.0, None)),
    # ---- training-health sentinel
    ("tpu_health_policy", str, "off", ("health_policy",), None),
    ("tpu_health_spike_factor", float, 10.0, (), (1.0, None)),
    ("tpu_health_window", int, 5, (), (2, None)),
    ("tpu_health_score_limit", float, 1e30, (), (0.0, None)),
    ("tpu_health_max_rollbacks", int, 2, (), (0, None)),
    ("tpu_health_lr_backoff", float, 0.5, (), (0.0, 1.0)),
    ("tpu_health_recovery_salt", int, 0, (), (0, None)),
    # ---- telemetry
    ("tpu_telemetry", str, "on", (), None),
    ("tpu_telemetry_log", str, "", ("telemetry_log",), None),
    ("tpu_profile_iters", int, 0, (), (0, None)),
    ("tpu_profile_dir", str, "", (), None),
    ("tpu_telemetry_memory", str, "off", ("telemetry_memory",), None),
    # ---- out-of-core streaming
    ("tpu_stream_budget_mb", float, 256.0, ("stream_budget_mb",),
     (0.01, None)),
    ("tpu_stream_residency", str, "auto", (), None),
    ("tpu_stream_rows_per_shard", int, 65536, (), (256, None)),
    ("tpu_stream_prefetch", bool, True, (), None),
]

_CANONICAL: Dict[str, Tuple[str, Any, Any, Optional[Tuple[Any, Any]]]] = {}
_ALIASES: Dict[str, str] = {}
for _name, _typ, _default, _aliases, _check in _PARAMS:
    _CANONICAL[_name] = (_name, _typ, _default, _check)
    for _a in _aliases:
        _ALIASES[_a] = _name

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "custom": "custom", "none": "custom", "null": "custom", "na": "custom",
}

_LOWERCASED = ("objective", "boosting", "tree_learner", "device_type",
               "monotone_constraints_method", "data_sample_strategy",
               "tpu_histogram_impl", "tpu_hist_comm", "tpu_wave_kernel",
               "tpu_serve_quantize", "tpu_serve_request_log",
               "tpu_traverse_kernel", "tpu_health_policy", "tpu_telemetry",
               "tpu_telemetry_memory", "tpu_stream_residency")


def _coerce(name: str, typ: Any, value: Any) -> Any:
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "+")
        return bool(value)
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return (str(value).strip().lower() if name in _LOWERCASED
                else str(value))
    if typ in ("list_int", "list_float", "list_str"):
        if value is None:
            return None
        if isinstance(value, str):
            if "[" in value:
                parts = re.findall(r"\[([^\]]*)\]", value)
            else:
                parts = [p for p in value.replace(";", ",").split(",")
                         if p != ""]
        elif isinstance(value, (list, tuple)):
            parts = list(value)
        else:
            parts = [value]
        if typ == "list_int":
            return [int(p) for p in parts]
        if typ == "list_float":
            return [float(p) for p in parts]
        return [str(p) for p in parts]
    raise TypeError(f"unknown param type for {name}")


class Config:
    """Resolved configuration (all canonical parameter names)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None, **kwargs: Any):
        merged = dict(params or {})
        merged.update(kwargs)
        for name, (_, _typ, default, _) in _CANONICAL.items():
            object.__setattr__(self, name, default)
        self.raw_params: Dict[str, Any] = {}
        self.update(merged)

    def update(self, params: Dict[str, Any]) -> None:
        """Apply a param dict; aliases resolve to canonical names (an
        explicit canonical key beats its aliases)."""
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            canon = _ALIASES.get(key, key)
            if canon in resolved and key in _ALIASES:
                continue  # canonical (or earlier alias) already set
            resolved[canon] = value
        for key, value in resolved.items():
            if value is None and key not in _CANONICAL:
                continue
            if key not in _CANONICAL:
                self.raw_params[key] = value
                continue
            _, typ, _, check = _CANONICAL[key]
            coerced = _coerce(key, typ, value)
            if (check is not None and coerced is not None
                    and not isinstance(coerced, list)):
                lo, hi = check
                if lo is not None and coerced < lo:
                    raise ValueError(f"{key}={coerced} < minimum {lo}")
                if hi is not None and coerced > hi:
                    raise ValueError(f"{key}={coerced} > maximum {hi}")
            object.__setattr__(self, key, coerced)
            self.raw_params[key] = value
        self._post_process()

    def _post_process(self) -> None:
        obj = self.objective
        if obj in _OBJECTIVE_ALIASES:
            object.__setattr__(self, "objective", _OBJECTIVE_ALIASES[obj])
        elif obj.startswith("quantile:") or obj.startswith("alpha:"):
            object.__setattr__(self, "alpha", float(obj.split(":")[1]))
            object.__setattr__(self, "objective", "quantile")
        if self.boosting in ("gbrt", "gbdt"):
            object.__setattr__(self, "boosting", "gbdt")
        elif self.boosting in ("rf", "random_forest"):
            object.__setattr__(self, "boosting", "rf")
        if self.data_sample_strategy == "goss" or self.boosting == "goss":
            object.__setattr__(self, "data_sample_strategy", "goss")
            if self.boosting == "goss":
                object.__setattr__(self, "boosting", "gbdt")
        if self.objective in ("multiclass", "multiclassova") and self.num_class <= 1:
            raise ValueError("num_class must be >1 for multiclass objectives")
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            raise ValueError("is_unbalance and scale_pos_weight cannot both be set")

    @property
    def num_model_per_iteration(self) -> int:
        """Trees an iteration: ``num_class`` for the multiclass objectives
        (and ``custom``, as the reference's null objective), else 1."""
        if self.objective in ("multiclass", "multiclassova", "custom"):
            return self.num_class
        return 1
