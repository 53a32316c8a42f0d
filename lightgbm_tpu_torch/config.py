"""Typed configuration with LightGBM-compatible parameter names and aliases.

The serving slice of the JAX package's ``config.py``: only the keys the
port reads today, with the JAX package's names, defaults, aliases and
bounds.  Later slices add their keys to ``_PARAMS``.  Alias resolution
follows ``ParameterAlias::KeyAliasTransform`` semantics (first write wins,
aliases mapped onto the canonical name); unknown keys are kept in
``raw_params``, as the JAX package keeps them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# (name, type, default, aliases, check)
#   check is an optional (lo, hi) inclusive bound for numeric params.
_PARAMS: List[Tuple[str, Any, Any, Tuple[str, ...], Optional[Tuple[Any, Any]]]] = [
    ("objective", str, "regression",
     ("objective_type", "app", "application", "loss"), None),
    ("num_leaves", int, 31,
     ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"), (2, 131072)),
    ("num_class", int, 1, ("num_classes",), (1, None)),
    ("sigmoid", float, 1.0, (), (0.0, None)),
    # Quantized serving packs: off|int16|int8.  The port serves the
    # quantized packs only; off (the fp32 pack) is still to be ported.
    ("tpu_serve_quantize", str, "off", (), None),
    # Traversal kernel: auto|fused|unfused.  In the port auto and fused
    # both mean the hand-written CUDA traversal kernel.
    ("tpu_traverse_kernel", str, "auto", (), None),
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

_LOWERCASED = ("objective", "tpu_serve_quantize", "tpu_traverse_kernel")


def _coerce(name: str, typ: Any, value: Any) -> Any:
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return (str(value).strip().lower() if name in _LOWERCASED
                else str(value))
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
            if check is not None:
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
        if self.objective in ("multiclass", "multiclassova") and self.num_class <= 1:
            raise ValueError("num_class must be >1 for multiclass objectives")
