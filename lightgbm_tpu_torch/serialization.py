"""Model text, in the reference's model-file layout: the writer and the
loader.

The port's copy of the JAX package's ``serialization.py``.  The writer
(``model_to_string`` with ``_tree_to_string``, ``_objective_to_string``
and ``_feature_info``) writes header key=value lines, ``Tree=i`` blocks
with the reference's ``decision_type`` bit layout (bit 0 categorical, bit
1 default-left, bits 2-3 missing type), ``end of trees``, feature
importances and the parameters.  With ``fold_bias`` the boost-from-average
init score is folded into the first iteration's leaf values, so the text
is byte for byte the JAX package's and loads in it (and in the reference
binary).  A continuation's base model (``GBDT.base_model``) adds its init
scores, and its trees are written first, verbatim.

The loader (``load_model_string`` -> :class:`LoadedModel` of
:class:`LoadedTree`) reads a genuine LightGBM file, a JAX package file or
the port's own.  ``LoadedModel`` keeps its trees as float64 / int32 / int64
tensors on its device and walks them on raw feature values level by
level in torch ops, every tree of a request at once, as the JAX
package's ``LoadedTree._walk`` does in numpy: comparisons in float64 and
each tree added to the sum in the JAX order, so raw scores are the JAX
walk's bit for bit (linear leaves' ``x . coeff`` may sum in another
order).  The walk is not a Pallas kernel in the JAX package, so it has no
CUDA kernel here.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .utils.device import resolve_device
from .utils.timer import FunctionTimer

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


def _rest_bin_left(tree, mappers) -> int:
    """Categorical nodes of ``tree`` whose left set holds their feature's
    rest bin (the last bin: rare, unseen and negative categories, NaN)."""
    m = tree.num_splits()
    return sum(bool(np.any(tree.cat_mask[node][
        len(mappers[int(tree.split_feature[node])].categories):]))
        for node in np.nonzero(tree.is_cat[:m])[0])


def model_to_string(gbdt, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    fold_bias: bool = True) -> str:
    """The model text of a trained :class:`~.models.gbdt.GBDT`.
    ``fold_bias`` writes reference-compatible files: the init scores
    folded into the first iteration's values and the ``init_scores`` line
    zeroed.  Iterations index the combined model: a continuation's base
    model first (its trees verbatim), then the booster's own.  The text's
    category sets hold category values only, as the JAX package's do: a
    split that sends its feature's rest bin left sends those rows right
    once the text is loaded, and writing such a model warns of it (the
    text stays as it is)."""
    cfg = gbdt.cfg
    td = gbdt.train_data
    mappers = td.binned.mappers
    base = getattr(gbdt, "base_model", None)
    init_scores = np.asarray(gbdt.init_scores, np.float64).copy()
    if base is not None:
        init_scores[: len(base.init_scores)] += base.init_scores
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
    n_base = base.iter_ if base is not None else 0
    n_own = min(len(m) for m in gbdt.models) if gbdt.models else 0
    n_total = n_base + n_own
    idx = rest_left = 0
    # trees interleave per iteration (iter0/class0, iter0/class1, ...)
    for t in range(start_iteration, n_total if end is None
                   else min(end, n_total)):
        for k in range(gbdt.num_class):
            bias = (float(init_scores[k])
                    if (fold_bias and t == 0 and start_iteration == 0)
                    else 0.0)
            if t < n_base:
                out.append(_loaded_tree_to_string(
                    base.trees[t * gbdt.num_class + k], idx, bias))
            else:
                tree = gbdt.models[k][t - n_base]
                out.append(_tree_to_string(tree, idx, mappers, bias))
                rest_left += _rest_bin_left(tree, mappers)
            idx += 1
    if rest_left:
        warnings.warn(
            f"{rest_left} categorical split(s) send their feature's rest "
            "bin (rare, unseen and negative categories, NaN) left; the "
            "model text holds category values only, so a model loaded "
            "from it sends those rows right", stacklevel=3)
    out.append("end of trees")
    out.append("")
    # saved_feature_importance_type=1 writes gain importances
    by_gain = cfg.saved_feature_importance_type == 1
    imp = gbdt.feature_importance("gain" if by_gain else "split")
    pairs = sorted(zip(imp, names), reverse=True)
    out.append("feature_importances:")
    out.extend((f"{n}={v:g}" if by_gain else f"{n}={int(v)}")
               for v, n in pairs if v > 0)
    out.append("")
    out.append("parameters:")
    for key, val in sorted(cfg.raw_params.items()):
        out.append(f"[{key}: {val}]")
    out.append("end of parameters")
    return "\n".join(out)


def _loaded_tree_to_string(t: "LoadedTree", index: int,
                           bias: float = 0.0) -> str:
    """A loaded (raw-threshold) tree written back verbatim: a
    continuation's base trees, and :meth:`LoadedModel.to_string`."""
    m = max(t.num_leaves - 1, 0)
    lines = [f"Tree={index}", f"num_leaves={t.num_leaves}"]
    n_cat = (int(np.count_nonzero(t.decision_type[:m] & _CAT_MASK)) if m
             else 0)
    lines.append(f"num_cat={n_cat}")
    lines.append("split_feature=" + _fmt_arr(t.split_feature[:m], "%d"))
    lines.append("split_gain=" + _fmt_arr(t.split_gain[:m], "%g"))
    lines.append("threshold=" + _fmt_arr(t.threshold[:m]))
    lines.append("decision_type=" + _fmt_arr(t.decision_type[:m], "%d"))
    lines.append("left_child=" + _fmt_arr(t.left_child[:m], "%d"))
    lines.append("right_child=" + _fmt_arr(t.right_child[:m], "%d"))
    lines.append("leaf_value=" + _fmt_arr(
        np.asarray(t.leaf_value[: t.num_leaves], np.float64) + bias))
    if t.internal_value is not None:
        lines.append("internal_value=" + _fmt_arr(
            np.asarray(t.internal_value[:m], np.float64) + bias, "%g"))
    if t.internal_count is not None:
        lines.append("internal_count=" + _fmt_arr(t.internal_count[:m], "%d"))
    if t.cat_boundaries is not None:
        lines.append("cat_boundaries=" + _fmt_arr(t.cat_boundaries, "%d"))
        lines.append("cat_threshold=" + _fmt_arr(t.cat_threshold, "%d"))
    if t.is_linear:
        nl = t.num_leaves
        lines.append("is_linear=1")
        lines.append("leaf_const=" + _fmt_arr(
            np.asarray(t.leaf_const[:nl], np.float64) + bias))
        lines.append("num_features=" + _fmt_arr(
            [len(f) for f in t.leaf_features[:nl]], "%d"))
        lines.append("leaf_features=" + _fmt_arr(
            [int(v) for f in t.leaf_features[:nl] for v in f], "%d"))
        lines.append("leaf_coeff=" + _fmt_arr(
            [float(v) for c in t.leaf_coeff[:nl] for v in c]))
    lines.append(f"shrinkage={t.shrinkage:g}")
    lines.append("")
    return "\n".join(lines)


# ------------------------------------------------------------------- load
@dataclasses.dataclass
class LoadedTree:
    """A raw-threshold tree read from model text (host numpy arrays)."""

    num_leaves: int
    split_feature: np.ndarray
    threshold: np.ndarray
    decision_type: np.ndarray
    left_child: np.ndarray
    right_child: np.ndarray
    leaf_value: np.ndarray
    split_gain: np.ndarray
    cat_boundaries: Optional[np.ndarray] = None
    cat_threshold: Optional[np.ndarray] = None
    internal_value: Optional[np.ndarray] = None
    internal_count: Optional[np.ndarray] = None
    shrinkage: float = 1.0
    is_linear: bool = False
    leaf_const: Optional[np.ndarray] = None
    leaf_features: Optional[list] = None
    leaf_coeff: Optional[list] = None

    def depth(self) -> int:
        """Splits on the longest root-to-leaf path (0 for a stump)."""
        if self.num_leaves <= 1:
            return 0
        best, todo = 0, [(0, 1)]
        while todo:
            node, d = todo.pop()
            best = max(best, d)
            for child in (self.left_child[node], self.right_child[node]):
                if child >= 0:
                    todo.append((int(child), d + 1))
        return best


def _pad(rows: List[np.ndarray], width: int, dtype, fill=0) -> np.ndarray:
    out = np.full((len(rows), max(width, 1)), fill, dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class _TreeStack:
    """Every tree of a model as padded (T, M) node and (T, L) leaf
    tensors on one device, for a walk of all trees at once."""

    def __init__(self, trees: List[LoadedTree], device: torch.device):
        t_n = len(trees)
        m = max([max(t.num_leaves - 1, 0) for t in trees] + [1])
        nl = max([max(t.num_leaves, 1) for t in trees] + [1])
        self.depth = max([t.depth() for t in trees] + [0])
        internal = [max(t.num_leaves - 1, 0) for t in trees]
        dt = _pad([t.decision_type[:k] for t, k in zip(trees, internal)], m,
                  np.int64)
        # categorical nodes: each node's [lo, hi) words in one flat bitset
        cat_lo = np.zeros((t_n, m), np.int64)
        cat_hi = np.zeros((t_n, m), np.int64)
        words: List[np.ndarray] = []
        base = 0
        for i, t in enumerate(trees):
            k = internal[i]
            cat_nodes = np.nonzero(dt[i, :k] & _CAT_MASK)[0]
            if len(cat_nodes) and t.cat_boundaries is not None:
                bounds = np.asarray(t.cat_boundaries, np.int64)
                ci = t.threshold[cat_nodes].astype(np.int64)
                cat_lo[i, cat_nodes] = base + bounds[ci]
                cat_hi[i, cat_nodes] = base + bounds[ci + 1]
                words.append(np.asarray(t.cat_threshold, np.int64))
                base += len(t.cat_threshold)
        self.has_cat = base > 0
        as_t = lambda a, dtype: torch.as_tensor(a, dtype=dtype,
                                                device=device)
        self.split_feature = as_t(_pad([t.split_feature[:k] for t, k in
                                        zip(trees, internal)], m, np.int64),
                                  torch.int64)
        self.threshold = as_t(_pad([t.threshold[:k] for t, k in
                                    zip(trees, internal)], m, np.float64),
                              torch.float64)
        self.left = as_t(_pad([t.left_child[:k] for t, k in
                               zip(trees, internal)], m, np.int64),
                         torch.int64)
        self.right = as_t(_pad([t.right_child[:k] for t, k in
                                zip(trees, internal)], m, np.int64),
                          torch.int64)
        self.is_cat = as_t((dt & _CAT_MASK) > 0, torch.bool)
        self.default_left = as_t((dt & _DEFAULT_LEFT_MASK) > 0, torch.bool)
        self.missing_type = as_t((dt >> 2) & 3, torch.int64)
        self.cat_lo = as_t(cat_lo, torch.int64)
        self.cat_hi = as_t(cat_hi, torch.int64)
        self.cat_words = as_t(np.concatenate(words) if words
                              else np.zeros(1, np.int64), torch.int64)
        self.leaf_value = as_t(_pad([t.leaf_value[: max(t.num_leaves, 1)]
                                     for t in trees], nl, np.float64),
                               torch.float64)
        # a stump starts at its leaf 0 (encoded ~0 = -1)
        self.start = as_t(np.where(np.array(internal) > 0, 0, -1),
                          torch.int64)
        self.m = m
        self.is_linear = any(t.is_linear for t in trees)
        if self.is_linear:
            self._linear(trees, nl, device)

    def _linear(self, trees, nl, device) -> None:
        """Linear leaves as (T, L, W) feature indices, coefficients and a
        mask of the used slots, and (T, L) constants."""
        w = max([len(f) for t in trees if t.is_linear
                 for f in t.leaf_features] + [1])
        t_n = len(trees)
        feat = np.zeros((t_n, nl, w), np.int64)
        coef = np.zeros((t_n, nl, w), np.float64)
        used = np.zeros((t_n, nl, w), bool)
        const = np.zeros((t_n, nl), np.float64)
        lin = np.zeros(t_n, bool)
        for i, t in enumerate(trees):
            if not t.is_linear:
                continue
            lin[i] = True
            const[i, : len(t.leaf_const)] = t.leaf_const
            for j, (f, c) in enumerate(zip(t.leaf_features, t.leaf_coeff)):
                feat[i, j, : len(f)] = f
                coef[i, j, : len(c)] = c
                used[i, j, : len(f)] = True
        self.lin_tree = torch.as_tensor(lin, device=device)
        self.lin_feat = torch.as_tensor(feat, device=device)
        self.lin_coef = torch.as_tensor(coef, device=device)
        self.lin_used = torch.as_tensor(used, device=device)
        self.lin_const = torch.as_tensor(const, device=device)

    def values(self, X: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
        """(N, len(sel)) float64 outputs of trees ``sel`` on raw rows X."""
        n = X.shape[0]
        t_n = sel.shape[0]
        cur = self.start[sel][None, :].expand(n, t_n).clone()
        rows = torch.arange(n, device=X.device)[:, None]
        base = (sel * self.m)[None, :]
        flat = lambda a: a.reshape(-1)
        for _ in range(self.depth):
            inner = cur >= 0
            idx = base + cur.clamp(min=0)
            f = flat(self.split_feature)[idx]
            v = X[rows, f]
            mt = flat(self.missing_type)[idx]
            nan = torch.isnan(v)
            # reference missing types: None -> NaN goes left; Zero ->
            # |v| <= kZeroThreshold and NaN follow the default direction;
            # NaN -> NaN follows it
            missing = torch.where(mt == 1, nan | (v.abs() <= 1e-35), nan)
            go_left = v <= flat(self.threshold)[idx]
            is_cat = flat(self.is_cat)[idx]
            if self.has_cat:
                go_left = torch.where(is_cat, self._cat_left(idx, v),
                                      go_left)
            default_dir = (mt == 0) | flat(self.default_left)[idx]
            go_left = torch.where(missing & ~is_cat, default_dir, go_left)
            nxt = torch.where(go_left, flat(self.left)[idx],
                              flat(self.right)[idx])
            cur = torch.where(inner, nxt, cur)
        leaf = ~cur
        out = self.leaf_value[sel[None, :], leaf]
        if self.is_linear:
            out = self._linear_values(X, sel, leaf, out)
        return out

    def _cat_left(self, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Categorical decisions: the category's bit in the node's set;
        NaN, infinite and negative values go right."""
        lo = self.cat_lo.reshape(-1)[idx]
        hi = self.cat_hi.reshape(-1)[idx]
        ok = torch.isfinite(v) & (v >= 0)
        iv = torch.where(ok, v, torch.zeros_like(v)).clamp(
            max=2.0 ** 40).long()
        word = lo + iv // 32
        ok = ok & (word < hi)
        w = self.cat_words[word.clamp(max=self.cat_words.shape[0] - 1)]
        return ok & (((w >> (iv % 32)) & 1) == 1)

    def _linear_values(self, X, sel, leaf, out):
        """Linear leaves: const + x . coeff over the leaf's features, the
        leaf value where one of them is NaN."""
        tsel = sel[None, :]
        feat = self.lin_feat[tsel, leaf]            # (N, T, W)
        used = self.lin_used[tsel, leaf]
        xv = torch.gather(X[:, None, :].expand(-1, feat.shape[1], -1), 2,
                          feat)
        nan = (torch.isnan(xv) & used).any(dim=2)
        dot = torch.where(used, xv * self.lin_coef[tsel, leaf],
                          torch.zeros_like(xv)).sum(dim=2)
        vals = self.lin_const[tsel, leaf] + dot
        vals = torch.where(nan, out, vals)
        return torch.where(self.lin_tree[tsel], vals, out)


class LoadedModel:
    """A prediction-only model read from model text (reference
    ``GBDT::LoadModelFromString`` + ``Predictor``), its trees walked on
    ``device``."""

    #: rows x trees of one walk (bounds the walk's device memory)
    WALK_CELLS = 1 << 24

    def __init__(self, num_class: int, objective: str,
                 trees: List[LoadedTree], init_scores: np.ndarray,
                 feature_names: List[str], params: Dict[str, str],
                 header: Optional[Dict[str, str]] = None, device=None):
        from .objectives import RANKING, create_objective
        self.num_class = num_class
        self.objective_name = objective
        self.trees = trees
        self.init_scores = init_scores
        self.feature_names = feature_names
        self.num_features = int(
            (header or {}).get("max_feature_idx", len(feature_names) - 1)
        ) + 1 if (header or feature_names) else len(feature_names)
        self.params = params
        self.header = dict(header or {})
        self.device = resolve_device(device)
        obj_extra = {}
        for tok in objective.split(" ")[1:]:
            # reference ToString suffixes: "sigmoid:1", "num_class:3", "sqrt"
            if ":" in tok:
                key, val = tok.split(":", 1)
                if key in ("sigmoid", "alpha", "num_class"):
                    obj_extra[key] = val
        cfg_dict = {"objective": objective.split(" ")[0], **obj_extra}
        if num_class > 1:
            cfg_dict["num_class"] = num_class
        if "sqrt" in objective.split():
            cfg_dict["reg_sqrt"] = True
        self.cfg = Config(cfg_dict)
        # ranking scores are raw margins
        self.objective = (None if self.cfg.objective in RANKING
                          else create_objective(self.cfg))
        self._stack: Optional[_TreeStack] = None

    @property
    def iter_(self) -> int:
        return len(self.trees) // self.num_class

    @property
    def num_trees(self) -> int:
        return len(self.trees)

    def _tree_stack(self) -> _TreeStack:
        if self._stack is None:
            self._stack = _TreeStack(self.trees, self.device)
        return self._stack

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0, pred_early_stop: bool = False,
                    pred_early_stop_freq: int = 10,
                    pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """(N,) or (N, K) float64 raw scores: the init scores plus each
        iteration's trees, in order; with ``pred_early_stop`` a row stops
        adding trees once its margin (binary: |score|; multiclass: top
        two apart) passes ``pred_early_stop_margin``, checked every
        ``pred_early_stop_freq`` iterations (reference
        ``prediction_early_stop.cpp``)."""
        k = self.num_class
        start_iteration = max(int(start_iteration), 0)
        end = (self.iter_ if num_iteration is None
               else min(self.iter_, start_iteration + num_iteration))
        n_it = max(end - start_iteration, 0)
        n = X.shape[0]
        out = np.tile(np.asarray(self.init_scores, np.float64)[None, :],
                      (n, 1))
        if n_it and n:
            step = max(1, self.WALK_CELLS // max(n_it * k, 1))
            for lo in range(0, n, step):
                out[lo: lo + step] = self._raw_rows(
                    _dense_rows(X, lo, lo + step), out[lo: lo + step],
                    start_iteration, n_it, pred_early_stop,
                    max(int(pred_early_stop_freq), 1),
                    float(pred_early_stop_margin))
        return out[:, 0] if k == 1 else out

    def _raw_rows(self, X: np.ndarray, init: np.ndarray, start: int,
                  n_it: int, early_stop: bool, freq: int,
                  margin: float) -> np.ndarray:
        k = self.num_class
        dev = self.device
        Xd = torch.as_tensor(np.ascontiguousarray(X, np.float64), device=dev)
        sel = torch.arange(start * k, (start + n_it) * k, device=dev)
        vals = self._tree_stack().values(Xd, sel)     # (N, n_it * K)
        out = torch.as_tensor(init, device=dev).clone()
        active = torch.ones(X.shape[0], dtype=torch.bool, device=dev)
        for step in range(n_it):
            for kk in range(k):
                col = out[:, kk] + vals[:, step * k + kk]
                out[:, kk] = (torch.where(active, col, out[:, kk])
                              if early_stop else col)
            if early_stop and (step + 1) % freq == 0:
                if k == 1:
                    m = out[:, 0].abs()
                else:
                    top = torch.topk(out, 2, dim=1).values
                    m = top[:, 0] - top[:, 1]
                active = active & (m <= margin)
        return out.cpu().numpy()

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                start_iteration: int = 0, **kwargs) -> np.ndarray:
        """Raw scores, or the objective's outputs of them in float32 (as
        ``Booster.predict`` converts a trained model's)."""
        raw = self.predict_raw(
            X, num_iteration, start_iteration,
            pred_early_stop=bool(kwargs.get("pred_early_stop", False)),
            pred_early_stop_freq=int(kwargs.get("pred_early_stop_freq", 10)),
            pred_early_stop_margin=float(
                kwargs.get("pred_early_stop_margin", 10.0)))
        if raw_score or self.objective is None:
            return raw
        score = torch.from_numpy(np.asarray(raw)).to(torch.float32).to(
            self.device)
        return self.objective.convert_output(score).cpu().numpy()

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        imp = np.zeros(len(self.feature_names), np.float64)
        for t in self.trees:
            if importance_type == "split":
                np.add.at(imp, t.split_feature, 1.0)
            else:
                np.add.at(imp, t.split_feature, t.split_gain)
        return imp

    def to_string(self, num_iteration: Optional[int] = None,
                  start_iteration: int = 0) -> str:
        """The model text again (the JAX package's layout for a loaded
        model: its header lines, the trees verbatim, the parameters)."""
        hdr = dict(self.header)
        hdr.setdefault("num_class", str(self.num_class))
        hdr.setdefault("num_tree_per_iteration", str(self.num_class))
        hdr.setdefault("objective", self.objective_name)
        hdr.setdefault("feature_names", " ".join(self.feature_names))
        hdr["init_scores"] = _fmt_arr(self.init_scores)
        out = ["tree"]
        for key in ("version", "num_class", "num_tree_per_iteration",
                    "label_index", "max_feature_idx", "objective",
                    "feature_names", "feature_infos", "init_scores"):
            if key in hdr:
                out.append(f"{key}={hdr[key]}")
        out.append("")
        end_it = (self.iter_ if num_iteration is None
                  else min(self.iter_, start_iteration + num_iteration))
        lo = start_iteration * self.num_class
        hi = end_it * self.num_class
        for i, t in enumerate(self.trees[lo:hi]):
            out.append(_loaded_tree_to_string(t, i))
        out.append("end of trees")
        out.append("")
        out.append("parameters:")
        for key, val in sorted(self.params.items()):
            out.append(f"[{key}: {val}]")
        out.append("end of parameters")
        return "\n".join(out)


def _dense_rows(X, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of a dense array or a scipy sparse matrix, dense."""
    part = X[lo:hi]
    if hasattr(part, "toarray"):
        return np.asarray(part.toarray(), np.float64)
    return np.asarray(part, np.float64)


def load_model_string(s: str, device=None) -> LoadedModel:
    """Read model text (a genuine LightGBM file, a JAX package file or
    the port's own) into a :class:`LoadedModel` on ``device`` (the CUDA
    card unless ``"cpu"``)."""
    with FunctionTimer("model/load"):
        lines = s.splitlines()
        header: Dict[str, str] = {}
        i = 0
        while i < len(lines) and not lines[i].startswith("Tree="):
            line = lines[i].strip()
            if "=" in line:
                key, _, val = line.partition("=")
                header[key] = val
            i += 1
        num_class = int(header.get("num_class", 1))
        init_scores = np.array(
            [float(v) for v in header.get("init_scores", "0").split()])
        if len(init_scores) < num_class:
            init_scores = np.zeros(num_class)
        trees: List[LoadedTree] = []
        while i < len(lines):
            if not lines[i].startswith("Tree="):
                if lines[i].startswith("end of trees"):
                    break
                i += 1
                continue
            block: Dict[str, str] = {}
            i += 1
            while (i < len(lines) and lines[i].strip()
                   and not lines[i].startswith("Tree=")
                   and not lines[i].startswith("end of trees")):
                key, _, val = lines[i].partition("=")
                block[key] = val
                i += 1
            trees.append(_loaded_tree(block))
        params: Dict[str, str] = {}
        for line in lines[i:]:
            line = line.strip()
            if line.startswith("[") and ":" in line:
                key, _, val = line[1:-1].partition(": ")
                params[key] = val
        return LoadedModel(
            num_class=num_class,
            objective=header.get("objective", "regression"), trees=trees,
            init_scores=init_scores,
            feature_names=header.get("feature_names", "").split(),
            params=params, header=header, device=device)


def _loaded_tree(block: Dict[str, str]) -> LoadedTree:
    """One ``Tree=`` block's key=value lines as a :class:`LoadedTree`."""
    nl = int(block["num_leaves"])

    def geti(key, default=None, dtype=np.int32):
        if key not in block:
            return default
        return np.array([int(float(x)) for x in block[key].split()], dtype)

    def getf(key, default=None):
        if key not in block:
            return default
        return np.array([float(x) for x in block[key].split()])

    m = max(nl - 1, 0)
    is_linear = block.get("is_linear", "0").strip() == "1"
    leaf_const = leaf_features = leaf_coeff = None
    if is_linear:
        leaf_const = getf("leaf_const", np.zeros(max(nl, 1)))
        counts = geti("num_features", np.zeros(max(nl, 1), np.int32))
        flat_f = geti("leaf_features", np.zeros(0, np.int32))
        flat_c = getf("leaf_coeff", np.zeros(0))
        leaf_features, leaf_coeff, pos = [], [], 0
        for c in counts:
            leaf_features.append(np.asarray(flat_f[pos: pos + c]))
            leaf_coeff.append(np.asarray(flat_c[pos: pos + c]))
            pos += int(c)
    return LoadedTree(
        num_leaves=nl,
        split_feature=geti("split_feature", np.zeros(m, np.int32)),
        threshold=getf("threshold", np.zeros(m)),
        decision_type=geti("decision_type", np.zeros(m, np.int32)),
        left_child=geti("left_child", np.zeros(m, np.int32)),
        right_child=geti("right_child", np.zeros(m, np.int32)),
        leaf_value=getf("leaf_value", np.zeros(max(nl, 1))),
        split_gain=getf("split_gain", np.zeros(m)),
        cat_boundaries=geti("cat_boundaries"),
        # bitset words are uint32 in the reference's text: int64 holds them
        cat_threshold=geti("cat_threshold", dtype=np.int64),
        internal_value=getf("internal_value"),
        internal_count=geti("internal_count"),
        shrinkage=float(block.get("shrinkage", 1.0)),
        is_linear=is_linear, leaf_const=leaf_const,
        leaf_features=leaf_features, leaf_coeff=leaf_coeff)
