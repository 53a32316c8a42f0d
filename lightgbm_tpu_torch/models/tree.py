"""Host tree model, the serving packs, and the plain PyTorch walks.

The port of the JAX package's ``models/tree.py``: the host ``Tree``
(``Tree.from_arrays`` turns a grown ``TreeArrays`` into one), the fp32
pack (``stack_trees``) with its torch walk (``_tree_walk``,
``forest_scores``: XLA glue in the JAX package, torch ops here on every
device), the quantized pack (``quantize_stack_trees``: int16 node arrays,
bit-packed categorical masks, int16/int8 leaf quanta with one per-class
scale), and the plain version of the traversal kernel (``_tree_walk_q`` /
``_ensemble_sum_q``).  On a CUDA tensor ``forest_scores_quantized`` goes
through the hand-written kernel (``ops/traverse.py``); on a CPU tensor
through the plain walk here.

Only leaf VALUES quantize; routing decisions stay exact (bins and split
thresholds are integers in bin space).  Leaf quanta accumulate in int32,
which is associative, so every traversal order over the same pack gives
the same integers — the kernel, this walk and the JAX package agree bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Tree:
    """One fitted decision tree: the fields serving reads, and the fields
    the model text prints (None on a tree carried across without them)."""

    split_feature: np.ndarray    # (M,) i32
    split_bin: np.ndarray        # (M,) i32
    default_left: np.ndarray     # (M,) bool
    is_cat: np.ndarray           # (M,) bool
    cat_mask: np.ndarray         # (M, B) bool — bins routed left
    left_child: np.ndarray       # (M,) i32 (negative = ~leaf)
    right_child: np.ndarray      # (M,) i32
    leaf_value: np.ndarray       # (L,) f64
    num_leaves: int
    threshold: Optional[np.ndarray] = None       # (M,) f64 real-valued
    split_gain: Optional[np.ndarray] = None      # (M,) f32
    internal_value: Optional[np.ndarray] = None  # (M,) f32
    internal_count: Optional[np.ndarray] = None  # (M,) f32
    leaf_count: Optional[np.ndarray] = None      # (L,) f32
    leaf_weight: Optional[np.ndarray] = None     # (L,) f32
    shrinkage: float = 1.0

    @classmethod
    def from_arrays(cls, arrays, upper_bounds_padded: np.ndarray) -> "Tree":
        """Host tree from a grown ``TreeArrays`` (the JAX package's
        ``Tree.from_arrays``): the first ``num_leaves - 1`` nodes, and the
        real-valued threshold of each split bin."""
        a = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
             for k, v in arrays._asdict().items()}
        nl = int(a["num_leaves"])
        m = max(nl - 1, 0)
        sf = np.asarray(a["split_feature"][:m], np.int32)
        sb = np.asarray(a["split_bin"][:m], np.int32)
        thr = (upper_bounds_padded[sf, sb].astype(np.float64) if m
               else sb.astype(np.float64))
        b = a["cat_mask"].shape[1]
        return cls(
            split_feature=sf, split_bin=sb, threshold=thr,
            default_left=np.asarray(a["default_left"][:m], bool),
            is_cat=np.asarray(a["is_cat"][:m], bool),
            cat_mask=np.asarray(a["cat_mask"][:m], bool).reshape(m, b),
            left_child=np.asarray(a["left_child"][:m], np.int32),
            right_child=np.asarray(a["right_child"][:m], np.int32),
            split_gain=np.asarray(a["split_gain"][:m], np.float32),
            internal_value=np.asarray(a["internal_value"][:m], np.float32),
            internal_count=np.asarray(a["internal_count"][:m], np.float32),
            leaf_value=np.asarray(a["leaf_value"][:nl], np.float64),
            leaf_count=np.asarray(a["leaf_count"][:nl], np.float32),
            leaf_weight=np.asarray(a["leaf_weight"][:nl], np.float32),
            num_leaves=nl)

    def num_splits(self) -> int:
        return max(self.num_leaves - 1, 0)


# ------------------------------------------------------------ fp32 pack
_PACK_ARRAYS = ("split_feature", "split_bin", "default_left", "is_cat",
                "cat_mask", "left_child", "right_child", "leaf_value")


def stack_trees(trees: List[Tree], max_leaves: int, num_bins: int,
                device="cpu"):
    """Stack per-tree arrays into the fp32 pack (the JAX package's
    ``stack_trees``) as (T, ...) tensors on ``device``, plus host lists of
    each tree's leaf count and depth (the walk's trip count)."""
    t = len(trees)
    m = max(max_leaves - 1, 1)
    out = {
        "split_feature": np.zeros((t, m), np.int32),
        "split_bin": np.zeros((t, m), np.int32),
        "default_left": np.zeros((t, m), bool),
        "is_cat": np.zeros((t, m), bool),
        "cat_mask": np.zeros((t, m, num_bins), bool),
        "left_child": np.zeros((t, m), np.int32),
        "right_child": np.zeros((t, m), np.int32),
        "leaf_value": np.zeros((t, max_leaves), np.float32),
    }
    depth = []
    for i, tr in enumerate(trees):
        k = tr.num_splits()
        out["split_feature"][i, :k] = tr.split_feature
        out["split_bin"][i, :k] = tr.split_bin
        out["default_left"][i, :k] = tr.default_left
        out["is_cat"][i, :k] = tr.is_cat
        out["cat_mask"][i, :k, : tr.cat_mask.shape[1]] = tr.cat_mask
        out["left_child"][i, :k] = tr.left_child
        out["right_child"][i, :k] = tr.right_child
        out["leaf_value"][i, : tr.num_leaves] = tr.leaf_value
        depth.append(tree_max_depth(tr.left_child, tr.right_child)
                     if k else 0)
    pack = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    pack["num_leaves"] = [int(tr.num_leaves) for tr in trees]
    pack["depth"] = depth
    return pack


def _tree_walk(tree: dict, bins: torch.Tensor, nan_bins: torch.Tensor,
               num_leaves: int, depth: int) -> torch.Tensor:
    """Single-tree traversal over one fp32 pack slice -> (N,) f32 leaf
    values (the JAX package's ``_tree_walk``, op for op): a categorical
    node goes left iff its ``cat_mask`` holds the bin, a numerical node
    sends the NaN bin by ``default_left`` and otherwise ``bin <=
    split_bin`` left.  ``depth`` hops reach every leaf, so the walk runs a
    fixed trip count with no host sync; a finished row parks at its leaf."""
    n = bins.shape[0]
    if num_leaves <= 1:
        return tree["leaf_value"][0].expand(n).clone()
    rows = torch.arange(n, device=bins.device)
    bmax = tree["cat_mask"].shape[1] - 1
    node = torch.zeros(n, dtype=torch.int32, device=bins.device)
    done = torch.zeros(n, dtype=torch.bool, device=bins.device)
    for _ in range(depth):
        cur = torch.where(done, 0, node).long()
        f = tree["split_feature"][cur].long()
        col = bins[rows, f].to(torch.int32)
        isnan = col == nan_bins[f]
        iscat = tree["is_cat"][cur]
        gl = torch.where(
            iscat, tree["cat_mask"][cur, torch.clamp(col, max=bmax).long()],
            col <= tree["split_bin"][cur])
        gl = torch.where(isnan & ~iscat, tree["default_left"][cur], gl)
        nxt = torch.where(gl, tree["left_child"][cur],
                          tree["right_child"][cur])
        is_leaf = nxt < 0
        node = torch.where(is_leaf | done, node, nxt)
        node = torch.where(is_leaf & ~done, nxt, node)
        done = done | is_leaf
    leaf_idx = torch.where(node < 0, ~node, 0).long()
    return tree["leaf_value"][leaf_idx]


def _ensemble_sum(pack: dict, bins: torch.Tensor,
                  nan_bins: torch.Tensor) -> torch.Tensor:
    """(N,) f32 sum of the pack's trees, added tree by tree in order (the
    JAX package's sequential f32 scan, so the sums round alike)."""
    acc = torch.zeros(bins.shape[0], dtype=torch.float32, device=bins.device)
    for t, (nl, depth) in enumerate(zip(pack["num_leaves"], pack["depth"])):
        acc = acc + _tree_walk({k: pack[k][t] for k in _PACK_ARRAYS}, bins,
                               nan_bins, nl, depth)
    return acc


def forest_scores(packs_by_class, bins: torch.Tensor,
                  nan_bins: torch.Tensor) -> torch.Tensor:
    """(N, K) f32 per-class sums of fp32 packs (None: a class with no
    trees)."""
    cols = [torch.zeros(bins.shape[0], dtype=torch.float32,
                        device=bins.device) if p is None
            else _ensemble_sum(p, bins, nan_bins) for p in packs_by_class]
    return torch.stack(cols, dim=1)


def tree_scores(tree: Tree, bins: torch.Tensor, nan_bins: torch.Tensor,
                max_leaves: int, num_bins: int) -> torch.Tensor:
    """(N,) f32 leaf values of one tree over (N, F) int32 bins on their
    device: the fp32 walk of a one-tree pack (the JAX package's
    ``predict_tree_bins_device``, which adds each new tree to the valid
    sets' scores)."""
    pack = stack_trees([tree], max_leaves, num_bins, bins.device)
    return _tree_walk({k: pack[k][0] for k in _PACK_ARRAYS}, bins, nan_bins,
                      pack["num_leaves"][0], pack["depth"][0])


def fp32_pack_nbytes(pack) -> int:
    """Device bytes of one fp32 pack's arrays."""
    return sum(pack[k].numel() * pack[k].element_size() for k in _PACK_ARRAYS)


# ------------------------------------------------------- quantized pack
#: quantize mode -> (leaf dtype, max quantum)
QUANT_BITS = {"int16": (np.int16, 32767), "int8": (np.int8, 127)}

#: node-array width: every index (feature, bin, child, leaf) must fit i16
QUANT_INDEX_MAX = 32767

_QPACK_ARRAYS = ("split_feature", "split_bin", "default_left", "is_cat",
                 "cat_bits", "left_child", "right_child", "leaf_q")


def tree_max_depth(left_child: np.ndarray, right_child: np.ndarray) -> int:
    """Longest root->leaf hop count of one tree's child arrays."""
    if len(left_child) == 0:
        return 1
    depth = 1
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        for nxt in (int(left_child[node]), int(right_child[node])):
            if nxt >= 0:
                stack.append((nxt, d + 1))
    return depth


def quantize_stack_trees(trees: List[Tree], max_leaves: int, num_bins: int,
                         mode: str, device="cpu"):
    """Stack per-tree arrays into the quantized serving pack, as tensors on
    ``device``: i16 node arrays, bit-packed categorical masks, int8/int16
    leaf quanta with ONE scale.  Returns None when the shape exceeds the
    narrow encodings.

    Degenerate trees (num_leaves <= 1) are encoded with sentinel children
    ``-1`` at split row 0, routing every row to leaf 0."""
    leaf_dt, qmax = QUANT_BITS[mode]
    if (max_leaves > QUANT_INDEX_MAX or num_bins > QUANT_INDEX_MAX
            or any(int(tr.split_feature.max(initial=0)) > QUANT_INDEX_MAX
                   for tr in trees)):
        return None
    t = len(trees)
    m = max(max_leaves - 1, 1)
    bb = -(-num_bins // 8)                  # bit-packed cat-mask bytes
    max_abs = max((float(np.abs(tr.leaf_value).max(initial=0.0))
                   for tr in trees), default=0.0)
    scale = (max_abs / qmax) if max_abs > 0 else 1.0
    out = {
        "split_feature": np.zeros((t, m), np.int16),
        "split_bin": np.zeros((t, m), np.int16),
        "default_left": np.zeros((t, m), bool),
        "is_cat": np.zeros((t, m), bool),
        "cat_bits": np.zeros((t, m, bb), np.uint8),
        "left_child": np.zeros((t, m), np.int16),
        "right_child": np.zeros((t, m), np.int16),
        "leaf_q": np.zeros((t, max_leaves), leaf_dt),
    }
    depth = 1
    for i, tr in enumerate(trees):
        k = tr.num_splits()
        if k == 0:
            out["left_child"][i, 0] = -1     # sentinel: everything -> leaf 0
            out["right_child"][i, 0] = -1
        else:
            out["split_feature"][i, :k] = tr.split_feature
            out["split_bin"][i, :k] = tr.split_bin
            out["default_left"][i, :k] = tr.default_left
            out["is_cat"][i, :k] = tr.is_cat
            packed = np.packbits(tr.cat_mask, axis=1, bitorder="little")
            out["cat_bits"][i, :k, : packed.shape[1]] = packed
            out["left_child"][i, :k] = tr.left_child
            out["right_child"][i, :k] = tr.right_child
            depth = max(depth,
                        tree_max_depth(tr.left_child, tr.right_child))
        if tr.num_leaves:
            q = np.clip(np.rint(tr.leaf_value[: tr.num_leaves] / scale),
                        -qmax, qmax)
            out["leaf_q"][i, : tr.num_leaves] = q.astype(leaf_dt)
    pack = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    # the CUDA traversal kernel's layout of the same trees, built once
    pack["walk_table"] = torch.from_numpy(walk_table(out)).to(device)
    # host metadata, never device operands
    pack["scale"] = float(scale)
    pack["bits"] = 8 if mode == "int8" else 16
    pack["depth"] = int(depth)
    pack["num_bins"] = int(num_bins)
    return pack


def table_nodes(m: int) -> int:
    """Node records a tree's walk table holds for m nodes: m rounded up
    to even, so each tree's table is a whole number of 16-byte blocks."""
    return m + (m & 1)


def walk_table(arrays) -> np.ndarray:
    """The quantized pack's trees as the CUDA traversal kernel walks them
    (``ops/csrc/traverse.cu``): (T, words) int32, per tree its
    ``table_nodes(M)`` node records of two words each, then its leaf
    quanta widened to int32 (int16 and int8 packs alike), ``words`` a
    multiple of 4.  A node's record is

    - word 0: ``split_feature | default_left << 15 | split_bin << 16 |
      is_cat << 31`` (feature and bin are at most QUANT_INDEX_MAX, 15
      bits; a categorical node's split bin is not read and is stored 0);
    - word 1: ``left_child & 0xFFFF | right_child << 16`` (the int16
      children, leaves as ~leaf).

    ``arrays`` holds the pack's node arrays and ``leaf_q`` (numpy arrays
    or tensors)."""
    a = {k: np.asarray(arrays[k].cpu() if torch.is_tensor(arrays[k])
                       else arrays[k]) for k in
         ("split_feature", "split_bin", "default_left", "is_cat",
          "left_child", "right_child", "leaf_q")}
    t, m = a["split_feature"].shape
    sf = a["split_feature"].astype(np.int64)
    sb = a["split_bin"].astype(np.int64)
    ic = a["is_cat"].astype(bool)
    if ((sf < 0) | (sf > QUANT_INDEX_MAX)).any() or (
            ~ic & ((sb < 0) | (sb > QUANT_INDEX_MAX))).any():
        raise ValueError("walk_table: split features and numerical split "
                         f"bins must lie in [0, {QUANT_INDEX_MAX}]")
    sb = np.where(ic, 0, sb)
    w0 = (sf | a["default_left"].astype(np.int64) << 15 | sb << 16
          | ic.astype(np.int64) << 31)
    w1 = ((a["left_child"].astype(np.int64) & 0xFFFF)
          | (a["right_child"].astype(np.int64) & 0xFFFF) << 16)
    mp = table_nodes(m)
    leaves = a["leaf_q"].shape[1]
    words = -(-(2 * mp + leaves) // 4) * 4
    table = np.zeros((t, words), np.uint32)
    table[:, 0:2 * m:2] = w0
    table[:, 1:2 * m:2] = w1
    table[:, 2 * mp:2 * mp + leaves] = (a["leaf_q"].astype(np.int64)
                                        & 0xFFFFFFFF)
    return table.view(np.int32)


def quantize_error_bound(pack) -> float:
    """Worst-case |quantized - fp32| raw-score gap for one class: each
    tree's leaf rounds by at most scale/2."""
    t = int(pack["leaf_q"].shape[0])
    return t * pack["scale"] * 0.5


def pack_nbytes(pack) -> int:
    """Device bytes of one pack's arrays (its walk table included)."""
    keys = _QPACK_ARRAYS + (("walk_table",) if "walk_table" in pack else ())
    return sum(pack[k].numel() * pack[k].element_size() for k in keys)


def _tree_walk_q(tree: dict, bins: torch.Tensor,
                 nan_bins: torch.Tensor) -> torch.Tensor:
    """Single-tree traversal over one quantized pack slice -> (N,) int32
    leaf quanta (the plain version of the CUDA kernel's walk).  Decision
    logic, op for op as in the JAX package:

    - a categorical node goes left iff bit ``col & 7`` of
      ``cat_bits[node, min(col >> 3, bb - 1)]`` is set;
    - otherwise the NaN bin follows ``default_left``;
    - otherwise the row goes left iff ``col <= split_bin``;
    - a child < 0 is leaf ``~child``."""
    n = bins.shape[0]
    bb = tree["cat_bits"].shape[1]
    rows = torch.arange(n, device=bins.device)
    node = torch.zeros(n, dtype=torch.int32, device=bins.device)
    done = torch.zeros(n, dtype=torch.bool, device=bins.device)
    while not bool(done.all()):
        cur = torch.where(done, 0, node).long()     # finished rows idle at 0
        f = tree["split_feature"][cur].long()
        col = bins[rows, f].to(torch.int32)
        isnan = col == nan_bins[f]
        iscat = tree["is_cat"][cur]
        byte = tree["cat_bits"][cur, torch.clamp(col >> 3, max=bb - 1).long()]
        catbit = ((byte.to(torch.int32) >> (col & 7)) & 1) > 0
        gl = torch.where(iscat, catbit,
                         col <= tree["split_bin"][cur].to(torch.int32))
        gl = torch.where(isnan & ~iscat, tree["default_left"][cur], gl)
        nxt = torch.where(gl, tree["left_child"][cur],
                          tree["right_child"][cur]).to(torch.int32)
        is_leaf = nxt < 0
        node = torch.where(is_leaf | done, node, nxt)
        node = torch.where(is_leaf & ~done, nxt, node)
        done = done | is_leaf
    leaf_idx = torch.where(node < 0, ~node, 0).long()
    return tree["leaf_q"][leaf_idx].to(torch.int32)


def _ensemble_sum_q(pack: dict, bins: torch.Tensor,
                    nan_bins: torch.Tensor) -> torch.Tensor:
    """(N,) int32 sum of leaf quanta across the stacked pack, tree by tree
    (int32 addition is associative: any order gives these integers)."""
    acc = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    for t in range(int(pack["leaf_q"].shape[0])):
        acc += _tree_walk_q({k: pack[k][t] for k in _QPACK_ARRAYS},
                            bins, nan_bins)
    return acc


def forest_scores_quantized(packs_by_class, bins: torch.Tensor,
                            nan_bins: torch.Tensor) -> torch.Tensor:
    """(N, K) f32 per-class scores from quantized packs: int32 quanta sums
    (the CUDA traversal kernel on the card, the plain walk on the host)
    followed by ONE dequantizing multiply per class, in float32."""
    from ..ops.traverse import fused_class_sums
    cols = []
    for pack in packs_by_class:
        if pack is None:
            cols.append(torch.zeros(bins.shape[0], dtype=torch.float32,
                                    device=bins.device))
            continue
        acc = fused_class_sums(pack, bins, nan_bins)
        scale = torch.tensor(np.float32(pack["scale"]), device=bins.device)
        cols.append(acc.to(torch.float32) * scale)
    return torch.stack(cols, dim=1)
