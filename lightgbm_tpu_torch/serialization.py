"""Model text, in the reference's model-file layout.

The port's copy of the JAX package's ``serialization.py`` writer
(``model_to_string`` with ``_tree_to_string``, ``_objective_to_string``
and ``_feature_info``): header key=value lines, ``Tree=i`` blocks with the
reference's ``decision_type`` bit layout (bit 0 categorical, bit 1
default-left, bits 2-3 missing type), ``end of trees``, feature
importances and the parameters.  With ``fold_bias`` the boost-from-average
init score is folded into the first iteration's leaf values, so the text
is byte for byte the JAX package's and loads in it (and in the reference
binary).  Loading model text into the port is later work (ROADMAP A5b).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

_CAT_MASK = 1
_DEFAULT_LEFT_MASK = 2


def _fmt_arr(arr, fmt="%.17g") -> str:
    return " ".join(fmt % v for v in np.asarray(arr).ravel())


def _tree_to_string(tree, index: int, mappers, bias: float = 0.0) -> str:
    """One tree (reference ``Tree::ToString``); ``bias`` is added to the
    leaf and internal values."""
    m = tree.num_splits()
    lines = [f"Tree={index}", f"num_leaves={tree.num_leaves}"]
    cat_nodes = np.nonzero(tree.is_cat[:m])[0]
    lines.append(f"num_cat={len(cat_nodes)}")
    decision_type = np.zeros(m, np.int64)
    decision_type[tree.is_cat[:m]] |= _CAT_MASK
    decision_type[tree.default_left[:m]] |= _DEFAULT_LEFT_MASK
    for i in range(m):
        mt = mappers[tree.split_feature[i]].missing_type
        decision_type[i] |= (mt & 3) << 2
    # categorical thresholds: bitsets over raw category values, concatenated
    # with per-node boundaries (reference cat_boundaries_/cat_threshold_)
    cat_boundaries = [0]
    cat_threshold: List[int] = []
    threshold = tree.threshold.astype(np.float64).copy()
    for ci, node in enumerate(cat_nodes):
        f = int(tree.split_feature[node])
        cats = mappers[f].categories
        vals = [int(cats[b]) for b in np.nonzero(tree.cat_mask[node])[0]
                if b < len(cats)]
        nwords = (max(vals) // 32 + 1) if vals else 1
        words = [0] * nwords
        for v in vals:
            words[v // 32] |= 1 << (v % 32)
        cat_threshold.extend(words)
        cat_boundaries.append(len(cat_threshold))
        threshold[node] = ci            # categorical nodes store the set index
    lines.append("split_feature=" + _fmt_arr(tree.split_feature[:m], "%d"))
    lines.append("split_gain=" + _fmt_arr(tree.split_gain[:m], "%g"))
    lines.append("threshold=" + _fmt_arr(threshold[:m]))
    lines.append("decision_type=" + _fmt_arr(decision_type, "%d"))
    lines.append("left_child=" + _fmt_arr(tree.left_child[:m], "%d"))
    lines.append("right_child=" + _fmt_arr(tree.right_child[:m], "%d"))
    lines.append("leaf_value=" + _fmt_arr(
        np.asarray(tree.leaf_value[: tree.num_leaves], np.float64) + bias))
    lines.append("leaf_weight="
                 + _fmt_arr(tree.leaf_weight[: tree.num_leaves], "%g"))
    lines.append("leaf_count=" + _fmt_arr(
        tree.leaf_count[: tree.num_leaves].astype(np.int64), "%d"))
    lines.append("internal_value=" + _fmt_arr(
        np.asarray(tree.internal_value[:m], np.float64) + bias, "%g"))
    lines.append("internal_count=" + _fmt_arr(
        tree.internal_count[:m].astype(np.int64), "%d"))
    if len(cat_nodes):
        lines.append("cat_boundaries=" + _fmt_arr(cat_boundaries, "%d"))
        lines.append("cat_threshold=" + _fmt_arr(cat_threshold, "%d"))
    lines.append(f"shrinkage={tree.shrinkage:g}")
    lines.append("")
    return "\n".join(lines)


def _objective_to_string(cfg, num_class: int) -> str:
    """Reference ``ObjectiveFunction::ToString`` parameter suffixes, which
    the reference binary needs to reload the model."""
    name = cfg.objective
    if name == "binary":
        return f"binary sigmoid:{cfg.sigmoid:g}"
    if name == "multiclass":
        return f"multiclass num_class:{num_class}"
    if name == "multiclassova":
        return (f"multiclassova num_class:{num_class} "
                f"sigmoid:{cfg.sigmoid:g}")
    if name == "regression" and cfg.reg_sqrt:
        return "regression sqrt"
    if name == "quantile":
        return f"quantile alpha:{cfg.alpha:g}"
    return name


def _feature_info(m) -> str:
    if m.is_categorical:
        return ":".join(str(int(c)) for c in (m.categories if m.categories is not
                                              None else [])) or "none"
    if m.is_trivial or m.upper_bounds is None or len(m.upper_bounds) <= 1:
        return "none"
    return f"[{m.upper_bounds[0]:g}:{m.upper_bounds[-2]:g}]"


def model_to_string(gbdt, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    fold_bias: bool = True) -> str:
    """The model text of a trained :class:`~.models.gbdt.GBDT`.
    ``fold_bias`` writes reference-compatible files: the init scores
    folded into the first iteration's values and the ``init_scores`` line
    zeroed."""
    cfg = gbdt.cfg
    td = gbdt.train_data
    mappers = td.binned.mappers
    init_scores = np.asarray(gbdt.init_scores, np.float64).copy()
    names = td.feature_names or [f"Column_{i}"
                                 for i in range(td.num_features)]
    out = ["tree", "version=v4",
           f"num_class={gbdt.num_class}",
           f"num_tree_per_iteration={gbdt.num_class}",
           "label_index=0",
           f"max_feature_idx={td.num_features - 1}",
           f"objective={_objective_to_string(cfg, gbdt.num_class)}",
           "feature_names=" + " ".join(names),
           "feature_infos=" + " ".join(_feature_info(m) for m in mappers),
           "init_scores=" + _fmt_arr(
               np.zeros_like(init_scores)
               if (fold_bias and start_iteration == 0) else init_scores),
           ""]
    end = None if num_iteration is None else start_iteration + num_iteration
    n_own = min(len(m) for m in gbdt.models) if gbdt.models else 0
    idx = 0
    # trees interleave per iteration (iter0/class0, iter0/class1, ...)
    for t in range(start_iteration, n_own if end is None
                   else min(end, n_own)):
        for k in range(gbdt.num_class):
            bias = (float(init_scores[k])
                    if (fold_bias and t == 0 and start_iteration == 0)
                    else 0.0)
            out.append(_tree_to_string(gbdt.models[k][t], idx, mappers,
                                       bias))
            idx += 1
    out.append("end of trees")
    out.append("")
    imp = gbdt.feature_importance("split")
    pairs = sorted(zip(imp, names), reverse=True)
    out.append("feature_importances:")
    out.extend(f"{n}={int(v)}" for v, n in pairs if v > 0)
    out.append("")
    out.append("parameters:")
    for key, val in sorted(cfg.raw_params.items()):
        out.append(f"[{key}: {val}]")
    out.append("end of parameters")
    return "\n".join(out)
