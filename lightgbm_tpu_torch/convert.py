"""Carry a trained model across into the port, as plain numpy arrays.

``model_from_arrays(state)`` builds the port's :class:`GBDT` from a
dictionary of numpy arrays and Python scalars; it never sees an object of
another package.  ``state`` holds:

- ``mappers``: the bin mappers as ``binning.mappers_to_arrays`` encodes
  them (the JAX package's encoding, byte for byte);
- ``trees``: one list per class of per-tree dicts with ``split_feature``,
  ``split_bin``, ``default_left``, ``is_cat``, ``cat_mask`` (M, B),
  ``left_child``, ``right_child`` (M,), ``leaf_value`` (L,) and
  ``num_leaves``;
- ``init_scores`` (num_class,), ``num_class``, ``objective``, ``sigmoid``
  and ``num_leaves`` (the configured maximum, which sizes the pack).

From a JAX ``Booster`` ``bst``: ``mappers_to_arrays(
bst._gbdt.train_data.binned.mappers)`` and the fields of each
``bst._gbdt.host_trees()[k][i]`` (see tests/test_torch_serve.py).
"""

from __future__ import annotations

import numpy as np

from .binning import BinnedData, bins_dtype, mappers_from_arrays
from .config import Config
from .models.gbdt import GBDT
from .models.tree import Tree

TREE_FIELDS = ("split_feature", "split_bin", "default_left", "is_cat",
               "cat_mask", "left_child", "right_child", "leaf_value",
               "num_leaves")


def _tree(d: dict, num_features: int, num_bins: int,
          max_leaves: int) -> Tree:
    """One host tree from its field dict, checked: the kernel indexes the
    bins and the pack with these values, so a feature, child or leaf out
    of range, or a node with two parents, is refused here."""
    missing = [k for k in TREE_FIELDS if k not in d]
    if missing:
        raise ValueError(f"tree dict lacks {missing}")
    nl = int(d["num_leaves"])
    if not 1 <= nl <= max_leaves:
        raise ValueError(f"tree has {nl} leaves; num_leaves={max_leaves}")
    m = nl - 1
    tree = Tree(
        split_feature=np.asarray(d["split_feature"], np.int32),
        split_bin=np.asarray(d["split_bin"], np.int32),
        default_left=np.asarray(d["default_left"], bool),
        is_cat=np.asarray(d["is_cat"], bool),
        cat_mask=np.asarray(d["cat_mask"], bool),
        left_child=np.asarray(d["left_child"], np.int32),
        right_child=np.asarray(d["right_child"], np.int32),
        leaf_value=np.asarray(d["leaf_value"], np.float64),
        num_leaves=nl,
    )
    shapes = [getattr(tree, k).shape for k in TREE_FIELDS[:8]]
    if (any(s != (m,) for s in shapes[:4] + shapes[5:7])
            or tree.cat_mask.ndim != 2 or tree.cat_mask.shape[0] != m
            or -(-tree.cat_mask.shape[1] // 8) > -(-num_bins // 8)
            or shapes[7] != (nl,)):
        raise ValueError(f"tree with {nl} leaves has field shapes {shapes}")
    if m and not (0 <= tree.split_feature.min()
                  and tree.split_feature.max() < num_features):
        raise ValueError(f"split_feature outside [0, {num_features})")
    kids = np.concatenate([tree.left_child, tree.right_child])
    if (not np.array_equal(np.sort(kids[kids >= 0]), np.arange(1, m))
            or not np.array_equal(np.sort(~kids[kids < 0]),
                                  np.arange(nl if m else 0))):
        raise ValueError("child arrays do not form a tree: every node but "
                         "the root and every leaf needs exactly one parent")
    return tree


def model_from_arrays(state: dict) -> GBDT:
    """The port's serving model from plain arrays (see module docstring)."""
    cfg = Config({"objective": state["objective"],
                  "num_class": int(state["num_class"]),
                  "sigmoid": float(state.get("sigmoid", 1.0)),
                  "num_leaves": int(state["num_leaves"])})
    mappers = mappers_from_arrays(state["mappers"])
    binned = BinnedData.from_prebinned(
        np.zeros((0, len(mappers)), bins_dtype(mappers)), mappers)
    models = [[_tree(d, len(mappers), binned.max_num_bins, cfg.num_leaves)
               for d in cls] for cls in state["trees"]]
    return GBDT.from_trees(cfg, binned, models,
                           np.asarray(state["init_scores"]))
