"""Leaf-wise tree growth: the main-path layouts of the JAX package's
``models/grower.py``.

- **Wave layout** (more than ``_MIN_BUCKET`` rows): a row permutation kept
  grouped by leaf; each step splits the top-W-gain leaves (``leaf_batch``;
  W = 1 gives the JAX package's strictly best-first perm layout).  Per
  wave: a stable partition of each chosen leaf's segment, then either the
  fused wave kernel (``ops/wave.py``: smaller-sibling histograms, sibling
  subtraction, split scan and selection in one launch) or the unfused
  step (the kernel's plain version ``wave_plain``, each smaller sibling
  through the configured histogram impl).
- **Mask layout** (up to ``_MIN_BUCKET`` rows): a ``row_leaf`` vector;
  one full-row masked histogram per split.

Bins are the (N, F) uint8 matrix, the (N, F) uint16 one above 256 bins
(read through ``ops/histogram.py::read_bins``: torch has no uint16
compares, nor uint16 indexing on CUDA; the wave kernel reads them
itself), or, with ``packed4`` (every feature at <= 16 bins), its (N,
ceil(F/2)) 4-bit nibble pairs: the partition reads the split feature's
nibble, the kernels and the histogram impls unpack themselves, and the
mask layout unpacks once (small data, small cost).  Every one of them
goes through the fused wave on a CUDA device (``wave_fused_for``).
Under ``histogram_impl="flat_bf16"`` (f32 training) the channel values
are rounded to bf16 once per tree, so every histogram and wave runs the
kernels' bf16 mode on them without a cast of its own.

Under quantized training (``quantized``, the JAX package's
``use_quantized_grad`` path) the gradients become int8 levels under
per-tree scales (``ops/quantize.py``), every histogram is int32 (the
kernels' int8 modes) and each scan reads it rescaled to f32
(``ops/wave.py::scale_hist``); ``quant_renew_leaf`` recomputes the leaf
outputs from the true f32 gradients.

The big arrays (bins, values, the permutation, the per-leaf histograms)
live on the device; the O(num_leaves) decision state lives on the host in
float32 CPU tensors, and the growth loop reads two small host copies per
wave (the partition counts, the split payload).  Every float op on the
decision state runs in float32 in the JAX package's order, so with
exactly representable histogram sums the trees are the JAX package's bit
for bit.  ``torch.profiler`` ranges (``grower/root``,
``grower/partition``, ``grower/wave``, ``grower/sorted_cat``,
``grower/efb_scan``, ``grower/payload_read``, ``grower/row_leaf``) mark
the steps of wave growth.

Sorted many-vs-many categorical splits (a categorical feature with more
than ``max_cat_to_onehot`` bins): the root and the mask layout search
through ``best_split`` / ``best_split_batch``, which merge the sorted
scan; the wave step, fused or not, gives such a feature no candidate, so
each wave's 2W children are scanned and merged into its payload on the
device (``grower/sorted_cat``) before the one payload read.  The JAX
package keeps these datasets off its fused wave; the port fuses them
(the fused and unfused steps give one payload).

Exclusive feature bundling (``binning.py::FeatureBundles``, the grower
given its ``ops/bundle.py::BundleTables``): the bins are the (N, G)
bundled matrix, every histogram and the leaf carry ``leaf_hist`` are
(G, HB, 3) over ``hist_bins`` bins, and the
partitions read the split feature's bundle column and decode it
(``ops/bundle.py::decode_bins``).  Every scan runs in feature space on
histograms rebuilt by ``ops/bundle.py::expand_hist`` from the leaf's own
totals: at the root, on the mask layout, and for each wave's 2W
children at once (the fused kernel, or the unfused step, gives only
their bundle-space histograms; one ``best_split_batch`` scans them and
one read brings the winners to the host, ``grower/efb_scan``).  The JAX
package keeps bundled data off its fused wave; the port fuses it on the
card (the fused and unfused steps give the same histograms).

The histogram pool (``histogram_pool_size`` >= 0, the reference's
``HistogramPool``; ``pool_active_for``, ``Grower.pool_slots``): the wave
layout keeps its leaf histograms in P slots (``leaf_hist`` (P, G, HB,
3)) rather than one a leaf, P from the size in MB, at least ``2W + 1``
(one wave always fits) and at most L (P = L is the unpooled carry).
Which leaf owns which slot is host bookkeeping in numpy beside
``_State`` (``leaf_slot``, ``slot_leaf``, ``slot_tick``, ``tick``: the
JAX package's LRU stamps, claimed in its ``argmin`` order: free slots
first, then the least recently stamped, the lower slot on a tie; the
wave's parents are pinned).  Per split the smaller child takes a fresh
slot and the larger one its parent's (a second fresh slot where the
parent was evicted).  An evicted parent (a miss) is rebuilt before the
partition reorders its rows: one ``_hist`` (``histogram_flat`` on the
card) over its perm segment in creation-time row order
(``grower/pool_miss``).  A rebuilt histogram is a fresh sum where the
stored one came through sibling subtraction, so pooled trees equal
unpooled ones bit for bit only where the sums are exact (exact-sum f32
gradients, integer quantized histograms); ``pool_counts`` counts hits,
misses and evictions.  The mask layout keeps every leaf's histogram, as
the JAX package does.

Not ported here: monotone constraints, CEGB, forced splits, interaction
constraints, voting and device meshes (ROADMAP A8.7, A10).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.bundle import decode_bins, expand_hist
from ..ops.histogram import (histogram_from_vals, read_bins, resolve_impl,
                             unpack_bins4)
from ..ops.quantize import discretize_gradients, gradient_scales, max_level
from ..ops.split import (BestSplit, SplitConfig, best_split, best_split_batch,
                         first_argmax, leaf_output, smoothed_output,
                         sorted_feature_index)
from ..ops.wave import (best_to_payload, fused_wave_call,
                        merge_sorted_payload, payload_to_best, scale_hist,
                        split_payload, wave_children, wave_meta, wave_plain,
                        wave_stats)

_NEG_INF = float("-inf")
_MIN_BUCKET = 2048


@dataclasses.dataclass(frozen=True)
class GrowerConfig:
    num_leaves: int = 31
    max_depth: int = -1
    num_bins: int = 256          # bin axis B
    split: SplitConfig = dataclasses.field(default_factory=SplitConfig)
    histogram_impl: str = "auto"
    rows_block: int = 16384
    # Wave growth: split up to this many leaves per step (best-first set,
    # interleaved in waves).
    leaf_batch: int = 1
    # Fused wave kernel: auto|fused|unfused (see wave_fused_for).
    wave_kernel: str = "auto"
    # Quantized training (reference GradientDiscretizer): int8 levels,
    # int32 histograms, per-tree scales; see ops/quantize.py.
    quantized: bool = False
    num_grad_quant_bins: int = 4
    stochastic_rounding: bool = True
    quant_renew_leaf: bool = False
    # 4-bit bin storage (reference DenseBin IS_4BIT): the bins are
    # (N, ceil(F/2)) nibble pairs.  Set by GBDT when every feature has
    # <= 16 bins and tpu_4bit_bins is on.
    packed4: bool = False
    # the leaf histograms' memory bound in MB (reference HistogramPool);
    # < 0: every leaf's histogram stays resident
    histogram_pool_size: float = -1.0


class TreeArrays(NamedTuple):
    """Fixed-shape tree (reference ``Tree``, ``tree.h:26``), host tensors.

    ``left_child``/``right_child`` >= 0 index internal nodes; negative
    values are ``~leaf_index``."""

    split_feature: torch.Tensor   # (M,) i32
    split_bin: torch.Tensor       # (M,) i32
    default_left: torch.Tensor    # (M,) bool
    is_cat: torch.Tensor          # (M,) bool
    cat_mask: torch.Tensor        # (M, B) bool — bins routed LEFT
    left_child: torch.Tensor      # (M,) i32
    right_child: torch.Tensor     # (M,) i32
    split_gain: torch.Tensor      # (M,) f32
    internal_value: torch.Tensor  # (M,) f32
    internal_count: torch.Tensor  # (M,) f32
    leaf_value: torch.Tensor      # (L,) f32
    leaf_count: torch.Tensor      # (L,) f32
    leaf_weight: torch.Tensor     # (L,) f32 (sum of hessians)
    num_leaves: int

    @property
    def max_leaves(self) -> int:
        return self.leaf_value.shape[0]


def wave_fused_for(cfg: GrowerConfig, device: torch.device) -> bool:
    """Does wave growth go through the fused wave kernel?  ``fused``
    forces it (its plain version on the CPU); ``auto`` takes it where the
    histogram kernel is the live impl — on a CUDA device, as the JAX
    package takes it on a TPU — at every bin count and feature count the
    kernel takes (up to 65,536 bins).  The JAX package fuses only where
    its TPU VMEM model ``wave_layout`` fits (at F = 28, f32 up to 512
    bins); that model means nothing for the CUDA kernel, and the trees are
    the same either way (the unfused step is the fused one's plain
    version)."""
    if cfg.wave_kernel not in ("auto", "fused", "unfused"):
        raise ValueError(f"wave_kernel={cfg.wave_kernel!r}: expected auto, "
                         "fused or unfused")
    if cfg.wave_kernel == "unfused":
        return False
    if cfg.wave_kernel == "fused":
        return True
    return (device.type == "cuda"
            and resolve_impl(cfg.histogram_impl, device) in ("pallas", "flat"))


def pool_active_for(cfg: GrowerConfig) -> bool:
    """May the grower bound its leaf histograms by the slot pool
    (``histogram_pool_size`` >= 0)?  The JAX package also keeps full
    residency for its GSPMD mask layout, voting and the
    intermediate / advanced monotone refresh, none of which the port
    trains.  The slot count depends on the histogram's shape
    (``Grower.pool_slots``): a pool that holds all L leaves is the
    unpooled carry."""
    return cfg.histogram_pool_size >= 0


class _Pool:
    """The host bookkeeping of a P-slot histogram pool (the JAX
    package's ``_pool_ops``): ``leaf_slot`` (L,) the slot of each leaf (-1
    evicted), ``slot_leaf`` (P,) the owner of each slot (-1 free),
    ``slot_tick`` (P,) the LRU stamp of each slot.  The root owns slot
    0."""

    def __init__(self, L: int, P: int):
        self.P = P
        self.leaf_slot = np.full(L, -1, np.int64)
        self.slot_leaf = np.full(P, -1, np.int64)
        self.slot_tick = np.zeros(P, np.int64)
        self.tick = 1
        self.leaf_slot[0] = 0
        self.slot_leaf[0] = 0

    def claim(self, sp: np.ndarray):
        """Slots for the children of k splitting leaves whose slots are
        ``sp`` (-1: a miss): the smaller child takes a fresh slot, the
        larger one the parent's, or a second fresh slot on a miss.  Free
        slots go first, then the least recently stamped (the lower slot
        on a tie); the parents' slots and the slots claimed are pinned.
        Evicted leaves lose their slot.  Returns (slot_small (k,),
        slot_big (k,), evictions)."""
        imax = np.iinfo(np.int64).max
        pin = np.zeros(self.P, bool)
        pin[sp[sp >= 0]] = True
        base = np.where(self.slot_leaf < 0, -1, self.slot_tick)
        small = np.empty(len(sp), np.int64)
        big = np.empty(len(sp), np.int64)
        evicted = []
        for j, parent_slot in enumerate(sp):
            fresh = []
            for _ in range(1 if parent_slot >= 0 else 2):
                v = int(np.argmin(np.where(pin, imax, base)))
                pin[v] = True
                fresh.append(v)
                if self.slot_leaf[v] >= 0:
                    evicted.append(self.slot_leaf[v])
            small[j] = fresh[0]
            big[j] = fresh[1] if parent_slot < 0 else parent_slot
        self.leaf_slot[np.asarray(evicted, np.int64)] = -1
        return small, big, len(evicted)

    def assign(self, leaves: np.ndarray, slots: np.ndarray) -> None:
        """Record the owners and LRU stamps of a wave's children."""
        self.leaf_slot[leaves] = slots
        self.slot_leaf[slots] = leaves
        self.slot_tick[slots] = self.tick
        self.tick += 1


class _State:
    """Host decision state of one tree (the JAX ``_GrowState`` minus the
    device arrays)."""

    def __init__(self, L: int, B: int):
        M = max(L - 1, 1)
        f32 = dict(dtype=torch.float32)
        i32 = dict(dtype=torch.int32)
        self.num_leaves = 1
        self.leaf_start = np.zeros(L, np.int64)
        self.leaf_rows = np.zeros(L, np.int64)
        self.leaf_sum_grad = torch.zeros(L, **f32)
        self.leaf_sum_hess = torch.zeros(L, **f32)
        self.leaf_count = torch.zeros(L, **f32)
        self.leaf_depth = torch.zeros(L, **i32)
        self.leaf_parent = torch.full((L,), -1, **i32)
        self.leaf_is_left = torch.zeros(L, dtype=torch.bool)
        self.leaf_out = torch.zeros(L, **f32)
        self.best_gain = torch.full((L,), _NEG_INF, **f32)
        self.best_feature = torch.zeros(L, **i32)
        self.best_bin = torch.zeros(L, **i32)
        self.best_default_left = torch.zeros(L, dtype=torch.bool)
        self.best_is_cat = torch.zeros(L, dtype=torch.bool)
        self.best_cat_mask = torch.zeros(L, B, dtype=torch.bool)
        self.best_gl = torch.zeros(L, **f32)
        self.best_hl = torch.zeros(L, **f32)
        self.best_cl = torch.zeros(L, **f32)
        self.split_feature = torch.zeros(M, **i32)
        self.split_bin = torch.zeros(M, **i32)
        self.default_left = torch.zeros(M, dtype=torch.bool)
        self.is_cat = torch.zeros(M, dtype=torch.bool)
        self.cat_mask = torch.zeros(M, B, dtype=torch.bool)
        self.left_child = torch.zeros(M, **i32)
        self.right_child = torch.zeros(M, **i32)
        self.split_gain = torch.zeros(M, **f32)
        self.internal_value = torch.zeros(M, **f32)
        self.internal_count = torch.zeros(M, **f32)

    def store_best(self, idx, bs: BestSplit, depth_ok) -> None:
        self.best_gain[idx] = torch.where(depth_ok, bs.gain, _NEG_INF)
        self.best_feature[idx] = bs.feature
        self.best_bin[idx] = bs.bin
        self.best_default_left[idx] = bs.default_left
        self.best_is_cat[idx] = bs.is_cat
        self.best_cat_mask[idx] = bs.cat_mask
        self.best_gl[idx] = bs.sum_grad_left
        self.best_hl[idx] = bs.sum_hess_left
        self.best_cl[idx] = bs.count_left

    def finish(self, L: int) -> TreeArrays:
        active = torch.arange(L) < self.num_leaves
        return TreeArrays(
            split_feature=self.split_feature, split_bin=self.split_bin,
            default_left=self.default_left, is_cat=self.is_cat,
            cat_mask=self.cat_mask, left_child=self.left_child,
            right_child=self.right_child, split_gain=self.split_gain,
            internal_value=self.internal_value,
            internal_count=self.internal_count,
            leaf_value=torch.where(active, self.leaf_out, 0.0),
            leaf_count=torch.where(active, self.leaf_count, 0.0),
            leaf_weight=torch.where(active, self.leaf_sum_hess, 0.0),
            num_leaves=int(self.num_leaves))


def _to_host(bs: BestSplit) -> BestSplit:
    return BestSplit(*(t.cpu() for t in bs))


class Grower:
    """``grow(bins, grad, hess, sample_mask, feature_mask, nbpf, nan_bins,
    is_cat, quant_generator=None, bundle=None)`` -> ``(TreeArrays,
    row_leaf)``; the JAX ``make_grower``'s callable (``quant_generator``, a
    ``torch.Generator`` on the rows' device, takes the place of its
    ``quant_key``; ``bundle``, the ``ops/bundle.py::BundleTables`` of
    bundled bins, that of its ``feat_group`` / ``feat_offset``: the grower
    is bundled when it is given them, with HB their ``hist_bins``).
    ``row_leaf`` stays on the rows' device."""

    def __init__(self, cfg: GrowerConfig):
        self.cfg = cfg
        # the largest int8 level a quantized row holds (int32 bound)
        self.max_level = max_level(cfg.num_grad_quant_bins)
        # the histogram pool's hits, misses (rebuilt parents) and
        # evictions over every tree this grower grew
        self.pool_counts = dict.fromkeys(("hits", "misses", "evictions"), 0)

    def pool_slots(self, hist_cols: int, hist_bins: int = 0) -> int:
        """Slots of the histogram pool over (``hist_cols``, ``hist_bins``
        (default ``num_bins``), 3) 4-byte slots (the JAX package's
        ``_pool_slots``): ``histogram_pool_size`` MB of them, at least
        ``2W + 1`` (W parents pinned while up to 2W children take slots)
        and at most L; L is the unpooled carry."""
        cfg = self.cfg
        L = cfg.num_leaves
        if not pool_active_for(cfg):
            return L
        slot_bytes = hist_cols * (hist_bins or cfg.num_bins) * 3 * 4
        p = int(float(cfg.histogram_pool_size) * (1 << 20)
                // max(slot_bytes, 1))
        floor = min(2 * min(cfg.leaf_batch, max(L - 1, 1)) + 1, L)
        return min(max(p, floor), L)

    def __call__(self, bins, grad, hess, sample_mask, feature_mask,
                 num_bins_per_feature, nan_bins, is_categorical,
                 quant_generator=None, bundle=None):
        cfg = self.cfg
        dev = bins.device
        g = grad * sample_mask
        h = hess * sample_mask
        in_bag = sample_mask > 0.0
        self.scale3 = None
        if cfg.quantized:
            if quant_generator is None:
                quant_generator = torch.Generator(device=dev)
                quant_generator.manual_seed(0)
            g_scale, h_scale = gradient_scales(g, h, cfg.num_grad_quant_bins)
            gq, hq = discretize_gradients(g, h, g_scale, h_scale,
                                          quant_generator,
                                          cfg.stochastic_rounding)
            vals = torch.stack([gq, hq, in_bag.to(torch.int8)], dim=-1)
            self.scale3 = torch.stack([g_scale, h_scale,
                                       torch.ones((), device=dev)])
        else:
            vals = torch.stack([g, h, in_bag.to(torch.float32)], dim=-1)
            if cfg.histogram_impl == "flat_bf16":
                vals = vals.to(torch.bfloat16)
        self.nf = int(num_bins_per_feature.shape[0])
        self._bundle_setup(bins, bundle)
        self.packed4 = cfg.packed4 and bins.shape[0] > _MIN_BUCKET
        if cfg.packed4 and not self.packed4:
            bins = unpack_bins4(bins, self.nf)
        self.bins = bins
        self.vals = vals
        self.dev = dev
        self.meta_dev = (num_bins_per_feature.to(dev, torch.int32),
                         nan_bins.to(dev, torch.int32),
                         is_categorical.to(dev, torch.bool),
                         feature_mask.to(dev, torch.bool))
        self.nan_bins_host = nan_bins.cpu().numpy().astype(np.int64)
        # the features the sorted categorical scan reads (empty: no merge)
        self.sorted_features = sorted_feature_index(
            num_bins_per_feature.cpu(), is_categorical.cpu(),
            cfg.split).to(dev)
        if bins.shape[0] > _MIN_BUCKET:
            tree, row_leaf = self._grow_wave()
        else:
            tree, row_leaf = self._grow_mask()
        # the leaf histograms live for one tree: the next root's carry is
        # allocated beside no earlier one
        self.leaf_hist = None
        if cfg.quantized and cfg.quant_renew_leaf:
            tree = self._renew_leaves(tree, row_leaf, g, h)
        return tree, row_leaf

    def _bundle_setup(self, bins, bundle) -> None:
        """The EFB tables (``self.bundle`` None when unbundled), built once
        a training by ``ops/bundle.py::bundle_tables``."""
        cfg = self.cfg
        self.bundle = bundle
        self.hb = cfg.num_bins
        if bundle is None:
            if not cfg.packed4 and bins.shape[1] != self.nf:
                raise ValueError(
                    f"{bins.shape[1]} bin columns for {self.nf} features: "
                    "bundled bins need their bundle tables")
            return
        if cfg.packed4:
            raise ValueError("bundled bins are never 4-bit packed")
        if (bundle.meta.shape[0] != bins.shape[1]
                or bundle.index.device != bins.device
                or bundle.num_bins != cfg.num_bins):
            raise ValueError("bundle tables do not fit the bins or config")
        self.hb = bundle.hist_bins

    def _mask_col(self, feat: int):
        """Every row's bin (int64) of feature ``feat``; under EFB read
        from its bundle column and decoded."""
        if self.bundle is None:
            return read_bins(self.bins, slice(None), feat)
        g, off, nb = (int(v) for v in self.bundle.decode[feat])
        return decode_bins(read_bins(self.bins, slice(None), g), off, nb)

    def _scan_hists(self, hists, totals):
        """(K, G, HB, 3) raw histograms as the scan reads them: scaled,
        and under EFB rebuilt per feature from the (K, 3) f32 ``totals``
        -> (K, F, B, 3)."""
        hists = scale_hist(hists, self.scale3)
        if self.bundle is None:
            return hists
        return expand_hist(hists, totals.to(self.dev), self.bundle)

    def _renew_leaves(self, tree: TreeArrays, row_leaf, g, h) -> TreeArrays:
        """``quant_train_renew_leaf``: leaf outputs from the true f32
        gradients (reference ``RenewIntGradTreeOutput``).  The per-leaf
        sums run on the host in row order, the JAX package's
        ``segment_sum`` order, so they repeat bit for bit on any device."""
        L = self.cfg.num_leaves
        rl = row_leaf.cpu().long()
        g_leaf = torch.zeros(L).index_add_(0, rl, g.cpu())
        h_leaf = torch.zeros(L).index_add_(0, rl, h.cpu())
        renewed = leaf_output(g_leaf, h_leaf, self.cfg.split)
        active = torch.arange(L) < tree.num_leaves
        return tree._replace(
            leaf_value=torch.where(active, renewed, 0.0),
            leaf_weight=torch.where(active, h_leaf, 0.0))

    # ------------------------------------------------------------ shared
    def _hist(self, bins, vals) -> torch.Tensor:
        """RAW (F, B, 3) histogram through the configured impl ((G, HB,
        3) under EFB)."""
        return histogram_from_vals(bins, vals, num_bins=self.hb,
                                   impl=self.cfg.histogram_impl,
                                   rows_block=self.cfg.rows_block,
                                   packed4=self.packed4, features=self.nf,
                                   max_level=self.max_level)

    def _best(self, hist, pg, ph, pc, pout) -> BestSplit:
        nbpf, nanb, iscat, fmask = self.meta_dev
        d = lambda t: t.to(self.dev)
        return _to_host(best_split(
            hist, d(pg), d(ph), d(pc), num_bins_per_feature=nbpf,
            nan_bins=nanb, is_categorical=iscat, feature_mask=fmask,
            cfg=self.cfg.split, parent_output=d(pout),
            sorted_features=self.sorted_features))

    def _best_batch(self, hists, pg, ph, pc, pout) -> BestSplit:
        nbpf, nanb, iscat, fmask = self.meta_dev
        d = lambda t: t.to(self.dev)
        return _to_host(best_split_batch(
            hists, d(pg), d(ph), d(pc), d(pout), num_bins_per_feature=nbpf,
            nan_bins=nanb, is_categorical=iscat, feature_mask=fmask,
            cfg=self.cfg.split, sorted_features=self.sorted_features))

    def _root(self, n: int, slots: int = 0):
        """Root histogram, state and best split (``_perm_setup`` /
        ``_root_best``); ``leaf_hist`` holds ``slots`` histograms (default
        one a leaf), the root's first."""
        cfg = self.cfg
        L, B = cfg.num_leaves, cfg.num_bins
        root_hist = self._hist(self.bins, self.vals)
        # the JAX package's form: scale the first feature, then sum its bins
        root_tot = scale_hist(root_hist[0:1], self.scale3)[0].sum(dim=0)
        root_tot = root_tot.cpu()
        st = _State(L, B)
        st.leaf_rows[0] = n
        st.leaf_sum_grad[0] = root_tot[0]
        st.leaf_sum_hess[0] = root_tot[1]
        st.leaf_count[0] = root_tot[2]
        st.leaf_out[0] = leaf_output(root_tot[0], root_tot[1], cfg.split)
        self.leaf_hist = torch.zeros((slots or L,) + tuple(root_hist.shape),
                                     dtype=root_hist.dtype, device=self.dev)
        self.leaf_hist[0] = root_hist
        bs = self._best(self._scan_hists(root_hist[None], root_tot[None])[0],
                        root_tot[0], root_tot[1], root_tot[2], st.leaf_out[0])
        st.store_best(0, bs, torch.tensor(True))
        return st

    def _depth_ok(self, depth: torch.Tensor) -> torch.Tensor:
        if self.cfg.max_depth <= 0:
            return torch.ones(depth.shape, dtype=torch.bool)
        return depth < self.cfg.max_depth

    # -------------------------------------------------------- wave layout
    def _partition(self, perm, starts, cnts, feats, sbins, dlefts, scats,
                   cmasks) -> np.ndarray:
        """Stable two-way partition of k disjoint perm segments at once
        (``_partition_scatter`` per segment); returns the left counts."""
        dev = self.dev
        k = len(starts)
        total = int(cnts.sum())
        base = np.cumsum(cnts) - cnts
        nanb = self.nan_bins_host[feats]
        cols = [starts, cnts, base, feats, sbins, nanb,
                dlefts.astype(np.int64), scats.astype(np.int64)]
        if self.bundle is not None:
            # the split feature's bundle column, offset and bins
            cols += list(self.bundle.decode[feats].T)
        info = torch.from_numpy(np.stack(cols, axis=1)).to(dev)
        seg_id = torch.repeat_interleave(
            torch.arange(k, device=dev), info[:, 1], output_size=total)
        si = info[seg_id]                            # (total, 8; EFB 11)
        off = torch.arange(total, device=dev) - si[:, 2]
        pos = si[:, 0] + off
        rows = perm[pos]
        feat = si[:, 3]
        if self.packed4:
            byte = self.bins[rows.long(), feat // 2].long()
            col = (byte >> ((feat % 2) * 4)) & 15
        elif self.bundle is not None:
            col = decode_bins(read_bins(self.bins, rows.long(), si[:, 8]),
                              si[:, 9], si[:, 10])
        else:
            col = read_bins(self.bins, rows.long(), feat)
        go_left = col <= si[:, 4]
        is_cat = si[:, 7] > 0
        go_left = torch.where((col == si[:, 5]) & ~is_cat, si[:, 6] > 0,
                              go_left)
        if scats.any():
            cm = torch.from_numpy(cmasks).to(dev)
            go_left = torch.where(is_cat, cm[seg_id, col], go_left)
        gl = go_left.long()
        excl = torch.cumsum(gl, 0) - gl
        base_t = info[:, 2]
        lbase = excl[base_t]
        last = base_t + info[:, 1] - 1
        nl = excl[last] + gl[last] - lbase                  # (k,)
        lpos = excl - lbase[seg_id]
        rpos = nl[seg_id] + off - lpos
        new_pos = si[:, 0] + torch.where(go_left, lpos, rpos)
        perm[new_pos] = rows
        return nl.cpu().numpy()

    def _grow_wave(self):
        cfg = self.cfg
        L = cfg.num_leaves
        M = max(L - 1, 1)
        n = self.bins.shape[0]
        W = min(cfg.leaf_batch, max(L - 1, 1))
        dev = self.dev
        bundled = self.bundle is not None
        meta_w = self.bundle.meta if bundled else wave_meta(*self.meta_dev)
        if wave_fused_for(cfg, dev):
            wave = functools.partial(fused_wave_call, scale3=self.scale3,
                                     packed4=self.packed4,
                                     max_level=self.max_level)
        elif bundled:
            def wave(bins, vals, perm, small_start, small_cnt, parent,
                     stats, *_):
                """The siblings' histograms only (no payload): the scan
                runs in feature space."""
                return wave_children(bins, vals, perm, small_start,
                                     small_cnt, parent, stats,
                                     self._hist), None
        else:
            wave = functools.partial(wave_plain, histogram=self._hist,
                                     scale3=self.scale3)
        perm = torch.arange(n, dtype=torch.int32, device=dev)
        P = self.pool_slots(self.nf if self.packed4 else self.bins.shape[1],
                            self.hb)
        pool = _Pool(L, P) if P < L else None
        with record_function("grower/root"):
            st = self._root(n, P)
        while st.num_leaves < L and float(st.best_gain.max()) > _NEG_INF:
            budget = L - st.num_leaves
            order = torch.sort(st.best_gain, descending=True, stable=True)
            top_g, top_l = order.values[:W], order.indices[:W]
            active = (top_g > _NEG_INF) & (torch.arange(W) < budget)
            k = int(active.sum())
            top_g, top_l = top_g[:k], top_l[:k]
            lv = top_l.numpy()
            rank = torch.arange(k, dtype=torch.int32)
            node_j = st.num_leaves - 1 + rank
            newleaf_j = st.num_leaves + rank
            starts = st.leaf_start[lv]
            cnts = st.leaf_rows[lv]
            feats = st.best_feature[top_l]
            sbins = st.best_bin[top_l]
            dlefts = st.best_default_left[top_l]
            scats = st.best_is_cat[top_l]
            cmasks = st.best_cat_mask[top_l]
            if pool is None:
                parent_hist = self.leaf_hist[top_l.to(dev)]
            else:
                # before the partition reorders the missed parents' rows
                sp = pool.leaf_slot[lv]
                parent_hist = self._pool_parents(pool, perm, lv, sp, starts,
                                                 cnts)
            with record_function("grower/partition"):
                nl = self._partition(perm, starts, cnts,
                                     feats.numpy().astype(np.int64),
                                     sbins.numpy().astype(np.int64),
                                     dlefts.numpy(), scats.numpy(),
                                     cmasks.numpy())
            small_left = nl <= cnts - nl
            small_start = np.where(small_left, starts, starts + nl)
            small_cnt = np.where(small_left, nl, cnts - nl)

            pg = st.leaf_sum_grad[top_l]
            ph = st.leaf_sum_hess[top_l]
            pc = st.leaf_count[top_l]
            gl, hl, cl = st.best_gl[top_l], st.best_hl[top_l], st.best_cl[top_l]
            gr, hr, cr = pg - gl, ph - hl, pc - cl
            pout = st.leaf_out[top_l]
            out_l = smoothed_output(gl, hl, cl, pout, cfg.split)
            out_r = smoothed_output(gr, hr, cr, pout, cfg.split)
            stats = wave_stats(
                torch.stack([gl, gr], 1), torch.stack([hl, hr], 1),
                torch.stack([cl, cr], 1), torch.stack([out_l, out_r], 1),
                torch.from_numpy(small_left), torch.ones(k, dtype=torch.bool))
            with record_function("grower/wave"):
                stats = stats.to(dev)
                hists, payload = wave(
                    self.bins, self.vals, perm, small_start.tolist(),
                    small_cnt.tolist(), parent_hist, stats, meta_w,
                    cfg.split, self.hb)
            if bundled:
                with record_function("grower/efb_scan"):
                    bs = self._efb_scan(hists, stats)
            else:
                pay = split_payload(payload)
                if self.sorted_features.numel():
                    with record_function("grower/sorted_cat"):
                        pay = self._merge_sorted(hists, pay, stats)
                with record_function("grower/payload_read"):
                    bs = payload_to_best(pay.cpu())
            hist_left, hist_right = hists[:, 0], hists[:, 1]

            # ---- tree updates (W nodes)
            parent = st.leaf_parent[top_l]
            was_left = st.leaf_is_left[top_l]
            for j in range(k):
                p = int(parent[j])
                if p >= 0:
                    (st.left_child if bool(was_left[j])
                     else st.right_child)[p] = node_j[j]
            nj = node_j.long()
            st.split_feature[nj] = feats
            st.split_bin[nj] = sbins
            st.default_left[nj] = dlefts
            st.is_cat[nj] = scats
            st.cat_mask[nj] = cmasks
            st.left_child[nj] = ~top_l.to(torch.int32)
            st.right_child[nj] = ~newleaf_j
            st.split_gain[nj] = top_g
            st.internal_value[nj] = pout
            st.internal_count[nj] = pc

            # ---- per-leaf state (2W children: lefts, then rights)
            idx2 = torch.cat([top_l, newleaf_j.long()])
            depth = st.leaf_depth[top_l] + 1
            nlv = newleaf_j.numpy()
            st.leaf_start[nlv] = starts + nl
            st.leaf_rows[lv] = nl
            st.leaf_rows[nlv] = cnts - nl
            slots2 = idx2
            if pool is not None:
                small_slot, big_slot, evicted = pool.claim(sp)
                slots = np.concatenate([
                    np.where(small_left, small_slot, big_slot),
                    np.where(small_left, big_slot, small_slot)])
                pool.assign(idx2.numpy(), slots)
                self.pool_counts["evictions"] += evicted
                slots2 = torch.from_numpy(slots)
            self.leaf_hist[slots2.to(dev)] = torch.cat([hist_left,
                                                        hist_right])
            st.leaf_sum_grad[idx2] = torch.cat([gl, gr])
            st.leaf_sum_hess[idx2] = torch.cat([hl, hr])
            st.leaf_count[idx2] = torch.cat([cl, cr])
            st.leaf_depth[idx2] = torch.cat([depth, depth])
            st.leaf_parent[idx2] = torch.cat([node_j, node_j])
            st.leaf_is_left[idx2] = torch.cat([torch.ones(k, dtype=torch.bool),
                                               torch.zeros(k, dtype=torch.bool)])
            st.leaf_out[idx2] = torch.cat([out_l, out_r])
            st.num_leaves += k
            st.store_best(idx2, bs, self._depth_ok(torch.cat([depth, depth])))
        with record_function("grower/row_leaf"):
            row_leaf = self._row_leaf_from_perm(st, perm, n)
        return st.finish(L), row_leaf

    def _pool_parents(self, pool: _Pool, perm, lv, sp, starts, cnts):
        """The (k, G, HB, 3) histograms of a wave's parents ``lv`` whose
        slots are ``sp``: a copy of each resident slot, and each evicted
        parent rebuilt by one ``_hist`` over its perm segment (its rows in
        creation-time order), gathered a miss at a time so that the
        rebuild holds no more than one leaf's rows."""
        miss = sp < 0
        hit = ~miss
        if np.any(pool.slot_leaf[sp[hit]] != lv[hit]):
            raise RuntimeError("histogram pool: a parent's slot is owned "
                               "by another leaf")
        self.pool_counts["hits"] += int(hit.sum())
        self.pool_counts["misses"] += int(miss.sum())
        idx = torch.from_numpy(np.where(miss, 0, sp)).to(self.dev)
        parent = self.leaf_hist.index_select(0, idx)
        if miss.any():
            with record_function("grower/pool_miss"):
                for j in np.flatnonzero(miss):
                    rows = perm[starts[j]:starts[j] + cnts[j]].long()
                    parent[j] = self._hist(self.bins.index_select(0, rows),
                                           self.vals.index_select(0, rows))
        return parent

    def _efb_scan(self, hists, stats) -> BestSplit:
        """A bundled wave's 2W children (lefts, then rights): rebuilt per
        feature from their stats lanes' sums, scanned in one
        ``best_split_batch`` (the sorted categorical merge included), the
        winners read to the host in one copy."""
        nbpf, nanb, iscat, fmask = self.meta_dev
        st2 = torch.cat([stats[:, 0], stats[:, 1]])
        full = self._scan_hists(torch.cat([hists[:, 0], hists[:, 1]]),
                                st2[:, :3])
        bs = best_split_batch(
            full, st2[:, 0], st2[:, 1], st2[:, 2], st2[:, 3],
            num_bins_per_feature=nbpf, nan_bins=nanb, is_categorical=iscat,
            feature_mask=fmask, cfg=self.cfg.split,
            sorted_features=self.sorted_features)
        return payload_to_best(best_to_payload(bs).cpu())

    def _merge_sorted(self, hists, pay, stats):
        """The sorted categorical scan on a wave's 2W children (lefts, then
        rights, as ``split_payload`` orders them), merged into their
        payload on the device; only the sorted columns are copied and
        scaled."""
        nbpf, fmask = self.meta_dev[0], self.meta_dev[3]
        feats = self.sorted_features
        sub = hists.index_select(2, feats)
        return merge_sorted_payload(
            pay, scale_hist(torch.cat([sub[:, 0], sub[:, 1]]), self.scale3),
            torch.cat([stats[:, 0], stats[:, 1]]), features=feats,
            num_bins_per_feature=nbpf, feature_mask=fmask, cfg=self.cfg.split)

    def _row_leaf_from_perm(self, st: _State, perm, n: int):
        """row -> leaf from the final grouped permutation (zero-row leaves
        hold no position)."""
        leaves = np.arange(st.num_leaves)
        leaves = leaves[st.leaf_rows[leaves] > 0]
        leaves = leaves[np.argsort(st.leaf_start[leaves], kind="stable")]
        reps = torch.from_numpy(st.leaf_rows[leaves]).to(self.dev)
        pos_leaf = torch.repeat_interleave(
            torch.from_numpy(leaves.astype(np.int32)).to(self.dev), reps,
            output_size=n)
        row_leaf = torch.empty(n, dtype=torch.int32, device=self.dev)
        row_leaf[perm.long()] = pos_leaf
        return row_leaf

    # -------------------------------------------------------- mask layout
    def _grow_mask(self):
        """Mask-layout growth (``_grow_mask``): one masked full-row
        histogram per split."""
        cfg = self.cfg
        L, B = cfg.num_leaves, cfg.num_bins
        n = self.bins.shape[0]
        dev = self.dev
        row_leaf = torch.zeros(n, dtype=torch.int32, device=dev)
        st = self._root(n)
        while st.num_leaves < L and float(st.best_gain.max()) > _NEG_INF:
            leaf = int(first_argmax(st.best_gain))
            node = st.num_leaves - 1
            new_leaf = st.num_leaves
            feat = int(st.best_feature[leaf])
            col = self._mask_col(feat)
            if bool(st.best_is_cat[leaf]):
                go_left = st.best_cat_mask[leaf].to(dev)[col]
            else:
                go_left = col <= int(st.best_bin[leaf])
                go_left = torch.where(
                    col == int(self.nan_bins_host[feat]),
                    bool(st.best_default_left[leaf]), go_left)
            mine = row_leaf == leaf
            row_leaf = torch.where(mine & ~go_left, new_leaf, row_leaf)

            pg = st.leaf_sum_grad[leaf]
            ph = st.leaf_sum_hess[leaf]
            pc = st.leaf_count[leaf]
            gl, hl, cl = st.best_gl[leaf], st.best_hl[leaf], st.best_cl[leaf]
            gr, hr, cr = pg - gl, ph - hl, pc - cl
            small_is_left = bool(cl <= cr)
            target = leaf if small_is_left else new_leaf
            masked = torch.where((row_leaf == target)[:, None], self.vals,
                                 torch.zeros((), dtype=self.vals.dtype,
                                             device=dev))
            hist_small = self._hist(self.bins, masked)
            hist_big = self.leaf_hist[leaf] - hist_small
            hist_left, hist_right = ((hist_small, hist_big) if small_is_left
                                     else (hist_big, hist_small))

            # _update_tree
            parent = int(st.leaf_parent[leaf])
            if parent >= 0:
                (st.left_child if bool(st.leaf_is_left[leaf])
                 else st.right_child)[parent] = node
            st.split_feature[node] = st.best_feature[leaf]
            st.split_bin[node] = st.best_bin[leaf]
            st.default_left[node] = st.best_default_left[leaf]
            st.is_cat[node] = st.best_is_cat[leaf]
            st.cat_mask[node] = st.best_cat_mask[leaf]
            st.left_child[node] = ~leaf
            st.right_child[node] = ~new_leaf
            st.split_gain[node] = st.best_gain[leaf]
            st.internal_value[node] = st.leaf_out[leaf]
            st.internal_count[node] = pc

            # _children_updates
            depth = st.leaf_depth[leaf] + 1
            parent_out = st.leaf_out[leaf]
            out_l = smoothed_output(gl, hl, cl, parent_out, cfg.split)
            out_r = smoothed_output(gr, hr, cr, parent_out, cfg.split)
            pair = [leaf, new_leaf]
            st.num_leaves += 1
            self.leaf_hist[leaf] = hist_left
            self.leaf_hist[new_leaf] = hist_right
            st.leaf_sum_grad[pair] = torch.stack([gl, gr])
            st.leaf_sum_hess[pair] = torch.stack([hl, hr])
            st.leaf_count[pair] = torch.stack([cl, cr])
            st.leaf_depth[pair] = depth
            st.leaf_parent[pair] = node
            st.leaf_is_left[pair] = torch.tensor([True, False])
            st.leaf_out[pair] = torch.stack([out_l, out_r])
            bs2 = self._best_batch(
                self._scan_hists(torch.stack([hist_left, hist_right]),
                                 torch.stack([torch.stack([gl, hl, cl]),
                                              torch.stack([gr, hr, cr])])),
                torch.stack([gl, gr]),
                torch.stack([hl, hr]), torch.stack([cl, cr]),
                torch.stack([out_l, out_r]))
            st.store_best(pair, bs2, self._depth_ok(depth.expand(2)))
        return st.finish(L), row_leaf


def make_grower(cfg: GrowerConfig) -> Grower:
    return Grower(cfg)
