"""Best-split search over histograms, as torch ops.

The port of the host half of the JAX package's ``ops/split.py``: every
(feature, threshold, missing-direction) candidate of an (F, B) histogram
block is evaluated at once from cumulative sums, invalid candidates are
masked to ``-inf``, and the winner is the maximum gain with ties going to
the lowest flat index ``feature * B + bin``.  ``scan_tables`` +
``select_payload`` are the plain version of the scan stage of the wave
kernel (``ops/csrc/wave.cu``); ``best_split`` is the untiled host search
(``_select_from_tables``' gather form).  Both selectors pick the same
winner.

Categorical features with more than ``max_cat_to_onehot`` bins have no
candidate in those tables: ``sorted_categorical`` scans them (the sorted
many-vs-many split, bins ordered by ``G / (H + cat_smooth)``) and
``merge_sorted_categorical`` takes its winner where it is strictly
better, batched over a leading axis of leaves.  ``best_split`` and
``best_split_batch`` merge it; the wave kernel does not, so the grower
merges its payload (``models/grower.py``).

The feature-tiled scan (``SplitConfig.scan_tile``, the JAX package's
``tpu_split_tile``): ``best_split`` / ``best_split_batch`` take the bins'
cumulative sums once over every feature (three (K, F, B) tables, the
untiled scan's own call, whose rounding on a CUDA device follows the
call's shape), then scan blocks of ``block_width`` columns one after
another, so the rest of the scan's (K, F, B) tables peak at one block's
width, and keep the winner across blocks with the untiled tie-break:
the larger gain, on a tie a numeric or one-hot winner over a sorted
categorical one, then the lower block.  Every other op of a block's scan
is elementwise, so the tiled result is the untiled one bit for bit.
The block width is the JAX package's ``_resolve_tile`` but for auto on a
CUDA device, which tiles only a scan whose untiled stats table would
pass ``AUTO_TILE_BYTES``: each block repeats the scan's launches, and
below that size the blocks cost more time than the memory they save.

Every float op runs in float32 in the JAX package's order, so gains and
leaf outputs round as the JAX package rounds them.  The cumulative sums
are ``torch.cumsum`` (double accumulation on the CPU, a parallel scan on a
CUDA device); where histogram sums are exactly representable (the
exact-sum tests) any order gives the same bits.

Not ported here: monotone constraints, CEGB penalties, extra_trees and
feature_contri (ROADMAP A8.7) — the trainer refuses those configs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

_EPS = 1e-15
_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Split hyper-parameters and static dataset facts."""

    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    path_smooth: float = 0.0
    # Static dataset facts; True = "may be present" (safe).
    has_nan: bool = True
    has_categorical: bool = True
    # a categorical feature with more than max_cat_to_onehot bins (the
    # sorted many-vs-many scan runs)
    use_sorted_categorical: bool = True
    # feature blocks of the host scan (tpu_split_tile): 0 auto, 1
    # untiled, >= 2 the block width (_resolve_tile)
    scan_tile: int = 0


class BestSplit(NamedTuple):
    """Split decision (reference ``SplitInfo``); scalar or batched (K,)."""

    gain: torch.Tensor          # f32; -inf when no valid split
    feature: torch.Tensor       # i32
    bin: torch.Tensor           # i32 threshold bin (numerical: left if bin <= t)
    default_left: torch.Tensor  # bool: NaN direction
    is_cat: torch.Tensor        # bool
    cat_mask: torch.Tensor      # (B,) bool: bins going LEFT (categorical)
    sum_grad_left: torch.Tensor
    sum_hess_left: torch.Tensor
    count_left: torch.Tensor
    sum_grad_right: torch.Tensor
    sum_hess_right: torch.Tensor
    count_right: torch.Tensor


def threshold_l1(s, l1: float):
    """ThresholdL1 (reference ``feature_histogram.hpp``)."""
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(g, h, cfg: SplitConfig, l2_extra: float = 0.0):
    """-ThresholdL1(G, l1) / (H + l2), clamped by ``max_delta_step``."""
    out = -threshold_l1(g, cfg.lambda_l1) / (h + cfg.lambda_l2 + l2_extra
                                             + _EPS)
    if cfg.max_delta_step > 0.0:
        out = torch.clamp(out, -cfg.max_delta_step, cfg.max_delta_step)
    return out


def leaf_gain(g, h, cfg: SplitConfig, l2_extra: float = 0.0):
    t = threshold_l1(g, cfg.lambda_l1)
    return (t * t) / (h + cfg.lambda_l2 + l2_extra + _EPS)


def smoothed_output(g, h, count, parent_output, cfg: SplitConfig,
                    l2_extra: float = 0.0):
    """Leaf output with path smoothing:
    ``w*(n/s)/(n/s+1) + parent/(n/s+1)``."""
    w = leaf_output(g, h, cfg, l2_extra)
    if cfg.path_smooth <= 0.0:
        return w
    ratio = count / cfg.path_smooth
    return w * ratio / (ratio + 1.0) + parent_output / (ratio + 1.0)


def gain_given_output(g, h, out, cfg: SplitConfig, l2_extra: float = 0.0):
    """``-(2*TL1(g)*w + (h+l2)*w^2)``."""
    t = threshold_l1(g, cfg.lambda_l1)
    return -(2.0 * t * out + (h + cfg.lambda_l2 + l2_extra) * out * out)


def child_gain(g, h, count, parent_output, cfg: SplitConfig,
               l2_extra: float = 0.0):
    """Per-child gain: closed form without smoothing, output-based with."""
    if cfg.path_smooth <= 0.0:
        return leaf_gain(g, h, cfg, l2_extra)
    w = smoothed_output(g, h, count, parent_output, cfg, l2_extra)
    return gain_given_output(g, h, w, cfg, l2_extra)


def _parent_gain(parent_grad, parent_hess, parent_output, cfg: SplitConfig):
    """The parent gain shift: closed form without smoothing, output-based
    with, always with plain ``lambda_l2``."""
    if cfg.path_smooth > 0.0:
        return gain_given_output(parent_grad, parent_hess, parent_output, cfg)
    return leaf_gain(parent_grad, parent_hess, cfg)


class ScanTables(NamedTuple):
    """Candidate tables of one (F, B) scan block."""

    gain_fb: torch.Tensor           # (F, B) masked candidate gains
    num_default_left: torch.Tensor  # (F, B) bool NaN direction
    parent_gain: torch.Tensor
    parent_output: torch.Tensor
    # the six child stats (GL, HL, CL, GR, HR, CR) of the D evaluated
    # directions, (6, D, F, B), and the index in D of NaN -> right,
    # NaN -> left and one-hot "bin == k goes left"
    stats: torch.Tensor
    dirs: tuple


def _bin_masks(num_bins_per_feature, nan_bins, b: int):
    """(F, B) bool masks of each feature's bins: in the feature, its NaN
    bin, its value bins."""
    f = num_bins_per_feature.reshape(-1).shape[0]
    biota = torch.arange(b, device=nan_bins.device,
                         dtype=torch.int32).reshape(1, b)
    in_feature = biota < num_bins_per_feature.reshape(f, 1)
    nan_pos = biota == nan_bins.reshape(f, 1)
    return in_feature, nan_pos, in_feature & ~nan_pos


def _bin_cumsums(G, H, C, value_mask):
    """The value bins' cumulative sums of (..., F, B) channels, one
    ``torch.cumsum`` a channel along the bins.  On a CUDA device torch
    blocks that scan by the call's row count, so its sums round by the
    call's shape: the tiled scan takes them once over every feature, as
    the untiled one does."""
    return tuple(torch.cumsum(torch.where(value_mask, x, 0.0), dim=-1)
                 for x in (G, H, C))


def scan_tables(G, H, C, parent_grad, parent_hess, parent_count, *,
                num_bins_per_feature, nan_bins, is_categorical, feature_mask,
                cfg: SplitConfig, parent_output=None,
                cums=None) -> ScanTables:
    """Evaluate every candidate of (..., F, B) histogram blocks into masked
    gain/stat tables (the JAX package's ``scan_tables`` without monotone,
    CEGB, extra_trees and feature_contri).  ``parent_*`` are f32 tensors
    of the blocks' leading shape (0-dim for one block) on the
    histogram's device; every op but the cumulative sums
    (``cums``, :func:`_bin_cumsums` of the blocks, taken here where the
    caller did not) is elementwise.  The candidate directions (NaN right, NaN left, one-hot)
    are evaluated as one stacked batch."""
    f, b = G.shape[-2:]
    dev = G.device
    nbpf_c = num_bins_per_feature.reshape(f, 1)
    nanb_c = nan_bins.reshape(f, 1)
    in_feature, nan_pos, value_mask = _bin_masks(num_bins_per_feature,
                                                 nan_bins, b)
    if parent_output is None:
        parent_output = leaf_output(parent_grad, parent_hess, cfg)
    cell = lambda t: t.reshape(t.shape + (1, 1))
    parent_grad, parent_hess, parent_count, parent_output = (
        cell(t) for t in (parent_grad, parent_hess, parent_count,
                          parent_output))
    zero = torch.zeros((), dtype=G.dtype, device=dev)
    neg_inf = torch.full((), _NEG_INF, dtype=G.dtype, device=dev)

    # the six child stats of every direction (NaN right, NaN left,
    # one-hot "bin == k goes left") in one (6, D, .., F, B) tensor, the
    # left sums written in place: each direction is evaluated in the same
    # batched ops, and the winner's stats come out in one gather
    i_ml = 1 if cfg.has_nan else 0
    i_cat = i_ml + 1 if cfg.has_categorical else 0
    stats = torch.empty((6, 1 + i_ml + int(cfg.has_categorical))
                        + tuple(G.shape), dtype=G.dtype, device=dev)
    GL, HL, CL, GR, HR, CR = stats.unbind(0)
    if cums is None:
        cums = _bin_cumsums(G, H, C, value_mask)
    for c, x in enumerate((G, H, C)):
        left = stats[c]
        left[0].copy_(cums[c])
        if cfg.has_nan:
            torch.add(left[0], torch.where(nan_pos, x, zero).sum(
                dim=-1, keepdim=True), out=left[i_ml])
        if cfg.has_categorical:
            left[i_cat].copy_(x)

    parent_gain = _parent_gain(parent_grad, parent_hess, parent_output, cfg)
    min_count = float(max(cfg.min_data_in_leaf, 1))
    torch.sub(parent_grad, GL, out=GR)
    torch.sub(parent_hess, HL, out=HR)
    torch.sub(parent_count, CL, out=CR)
    valid = ((CL >= min_count) & (CR >= min_count)
             & (HL >= cfg.min_sum_hessian_in_leaf)
             & (HR >= cfg.min_sum_hessian_in_leaf))
    gain = (child_gain(GL, HL, CL, parent_output, cfg)
            + child_gain(GR, HR, CR, parent_output, cfg)
            - parent_gain)
    gain = torch.where(valid & (gain > cfg.min_gain_to_split + _EPS),
                       gain, neg_inf)
    del valid

    gain_mr = gain[0]
    if cfg.has_nan:
        gain_ml = torch.where(nanb_c < b, gain[i_ml], neg_inf)
        num_gain = torch.maximum(gain_mr, gain_ml)
        num_default_left = gain_ml > gain_mr
    else:
        num_gain = gain_mr
        num_default_left = torch.zeros_like(gain_mr, dtype=torch.bool)
    num_gain = torch.where(value_mask, num_gain, neg_inf)

    if cfg.has_categorical:
        cat_gain = torch.where(in_feature, gain[i_cat], neg_inf)
        is_cat_col = is_categorical.reshape(f, 1)
        sorted_eligible = is_cat_col & (nbpf_c > cfg.max_cat_to_onehot)
        gain_fb = torch.where(is_cat_col, cat_gain, num_gain)
        gain_fb = torch.where(sorted_eligible, neg_inf, gain_fb)
    else:
        gain_fb = num_gain
    gain_fb = torch.where(feature_mask.reshape(f, 1), gain_fb, neg_inf)
    return ScanTables(gain_fb=gain_fb, num_default_left=num_default_left,
                      parent_gain=parent_gain, parent_output=parent_output,
                      stats=stats, dirs=(0, i_ml, i_cat))


def _select_from_tables(t: ScanTables, is_categorical,
                        cfg: SplitConfig) -> BestSplit:
    """Argmax + winner-stat gather over the last two axes of (..., F, B)
    tables: the lowest flat (feature, bin) index wins ties.  Fields have
    the tables' leading shape ((..., B) cat_mask)."""
    gain_fb = t.gain_fb
    lead = gain_fb.shape[:-2]
    f, b = gain_fb.shape[-2:]
    dev = gain_fb.device
    flat = first_argmax(gain_fb.reshape(lead + (f * b,)))
    bf, bb = flat // b, flat % b

    def at(a):
        a = a.expand(gain_fb.shape).reshape(lead + (f * b,))
        return torch.gather(a, -1, flat[..., None])[..., 0]

    bgain = at(gain_fb)
    bis_cat = (is_categorical[bf] if cfg.has_categorical
               else torch.zeros(lead, dtype=torch.bool, device=dev))
    bdefault_left = torch.where(bis_cat, torch.zeros_like(bis_cat),
                                at(t.num_default_left))
    # every direction's six stats at the winner in one gather: (6, D, ...)
    stats = t.stats.reshape(t.stats.shape[:2] + lead + (f * b,))
    won = torch.gather(stats, -1, flat[None, None, ..., None].expand(
        stats.shape[:-1] + (1,)))[..., 0]
    i_mr, i_ml, i_cat = t.dirs
    picked = torch.where(bis_cat, won[:, i_cat],
                         torch.where(bdefault_left, won[:, i_ml],
                                     won[:, i_mr]))
    GL, HL, CL, GR, HR, CR = picked.unbind(0)
    cat_mask = ((torch.arange(b, device=dev) == bb[..., None])
                & bis_cat[..., None])
    return BestSplit(gain=bgain, feature=bf.to(torch.int32),
                     bin=bb.to(torch.int32), default_left=bdefault_left,
                     is_cat=bis_cat, cat_mask=cat_mask,
                     sum_grad_left=GL, sum_hess_left=HL, count_left=CL,
                     sum_grad_right=GR, sum_hess_right=HR, count_right=CR)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (``jnp.argmax``'s
    tie-break; ``torch.argmax`` does not promise one)."""
    mx = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == mx, idx, x.shape[-1]).min(dim=-1).values


def select_payload(t: ScanTables, is_categorical, cfg: SplitConfig):
    """The kernel's selection: full-block max, the lowest flat key among
    the ties, and masked sums that each extract one element.  Picks the
    same winner as :func:`_select_from_tables`.  Returns the scalar tuple
    ``(gain, feature, bin, default_left, is_cat, GL, HL, CL, GR, HR, CR)``."""
    gain_fb = t.gain_fb
    f, b = gain_fb.shape
    dev = gain_fb.device
    keys = (torch.arange(f, device=dev, dtype=torch.int32)[:, None] * b
            + torch.arange(b, device=dev, dtype=torch.int32)[None, :])
    imax = torch.iinfo(torch.int32).max
    mx = gain_fb.max()
    tie = gain_fb == mx
    kwin = torch.where(tie, keys, imax).min()
    sel = tie & (keys == kwin)
    bf = kwin // b
    bb = kwin % b
    bgain = torch.where(sel, gain_fb, _NEG_INF).max()
    if cfg.has_categorical:
        bis_cat = (sel & is_categorical.reshape(f, 1)).any()
    else:
        bis_cat = torch.zeros((), dtype=torch.bool, device=dev)
    bdefault_left = torch.where(bis_cat, torch.zeros_like(bis_cat),
                                (sel & t.num_default_left).any())
    # every direction's six stats at the winner, each a masked sum of
    # one element: (6, D)
    won = torch.where(sel, t.stats, 0.0).sum(dim=(-2, -1))
    i_mr, i_ml, i_cat = t.dirs
    picked = torch.where(bis_cat, won[:, i_cat],
                         torch.where(bdefault_left, won[:, i_ml],
                                     won[:, i_mr]))
    GL, HL, CL, GR, HR, CR = picked.unbind(0)
    return bgain, bf, bb, bdefault_left, bis_cat, GL, HL, CL, GR, HR, CR


def _resolve_tile(scan_tile: int, f: int) -> int:
    """Columns a block of a scan over ``f`` columns (0: untiled): an
    explicit width of 2 or more below ``f``; auto (0) takes 128-wide
    blocks past 256 columns; 1 never tiles."""
    if scan_tile >= 2:
        return 0 if scan_tile >= f else scan_tile
    if scan_tile == 1:
        return 0
    return 128 if f > 256 else 0


#: the bytes of the untiled scan's (6, D, K, F, B) float32 stats table
#: past which auto (``scan_tile`` 0) tiles on a CUDA device
AUTO_TILE_BYTES = 1 << 30


def block_width(cfg: SplitConfig, k: int, f: int, b: int,
                cuda: bool) -> int:
    """Columns a block of the scan of ``k`` (f, b) histograms (0:
    untiled): :func:`_resolve_tile`, but auto on a CUDA device tiles only
    where the untiled stats table would pass ``AUTO_TILE_BYTES``."""
    t = _resolve_tile(cfg.scan_tile, f)
    if t and cfg.scan_tile == 0 and cuda:
        d = 1 + int(cfg.has_nan) + int(cfg.has_categorical)
        if 6 * d * k * f * b * 4 <= AUTO_TILE_BYTES:
            return 0
    return t


def best_split(hist, parent_grad, parent_hess, parent_count, *,
               cfg: SplitConfig, parent_output=None, **meta) -> BestSplit:
    """Every candidate of an (F, B, 3) leaf histogram, then the argmax,
    the sorted categorical scan merged; ``meta``: the per-feature
    ``num_bins_per_feature``, ``nan_bins``, ``is_categorical`` and
    ``feature_mask``."""
    if parent_output is None:
        parent_output = leaf_output(parent_grad, parent_hess, cfg)
    one = lambda t: t.reshape(1)
    bs = best_split_batch(hist[None], one(parent_grad), one(parent_hess),
                          one(parent_count), one(parent_output), cfg=cfg,
                          **meta)
    return BestSplit(*(t[0] for t in bs))


def best_split_batch(hists, pg, ph, pc, pout, *, num_bins_per_feature,
                     nan_bins, is_categorical, feature_mask,
                     cfg: SplitConfig, sorted_features=None) -> BestSplit:
    """:func:`best_split` for K leaves: (K, F, B, 3) histograms and (K,)
    parent stats -> a BestSplit of (K,) fields ((K, B) cat_mask), in one
    pass over the leading child axis; one sorted categorical merge serves
    the K leaves.  ``sorted_features``: :func:`sorted_feature_index` of
    the meta, where the caller holds it (None: found here).  Blocks of
    :func:`block_width` features are scanned in turn."""
    if sorted_features is None:
        sorted_features = sorted_feature_index(num_bins_per_feature,
                                               is_categorical, cfg)
    meta = (num_bins_per_feature, nan_bins, is_categorical, feature_mask)
    k, f, b = hists.shape[:3]
    t = block_width(cfg, k, f, b, hists.is_cuda)
    cums = _bin_cumsums(hists[..., 0], hists[..., 1], hists[..., 2],
                        _bin_masks(num_bins_per_feature, nan_bins, b)[2])
    if t == 0:
        return _scan_block(hists, pg, ph, pc, pout, meta, cfg,
                           sorted_features, cums)[0]
    # the sorted columns of each block, cut on the host (one read)
    sf_host = sorted_features.cpu()
    blocks = []
    for lo in range(0, f, t):
        hi = min(lo + t, f)
        sf = sf_host[(sf_host >= lo) & (sf_host < hi)] - lo
        blk, src = _scan_block(hists[:, lo:hi], pg, ph, pc, pout,
                               tuple(m.reshape(-1)[lo:hi] for m in meta),
                               cfg, sf.to(sorted_features.device),
                               tuple(c[:, lo:hi] for c in cums))
        blocks.append((blk._replace(feature=blk.feature + lo), src))
    # the untiled tie-break across blocks: the largest gain, then a
    # numeric or one-hot winner before a sorted categorical one (which
    # the untiled merge takes only on a strictly larger gain), then the
    # lowest block
    nb = len(blocks)
    gains = torch.stack([b.gain for b, _ in blocks])           # (nb, K)
    srcs = torch.stack([src for _, src in blocks])
    iota = torch.arange(nb, device=gains.device)[:, None]
    key = torch.where(gains == gains.max(dim=0).values,
                      srcs.long() * nb + iota, 2 * nb)
    win = key.min(dim=0).indices
    rows = torch.arange(win.shape[0], device=win.device)
    return BestSplit(*(torch.stack(field)[win, rows]
                       for field in zip(*(b for b, _ in blocks))))


def _scan_block(hists, pg, ph, pc, pout, meta, cfg: SplitConfig,
                sorted_features, cums):
    """The untiled scan of (K, F, B, 3) ``hists`` over their ``meta``
    (``num_bins_per_feature``, ``nan_bins``, ``is_categorical``,
    ``feature_mask``) and their bins' cumulative sums ``cums`` with the
    sorted categorical merge -> (BestSplit of (K,) fields, (K,) bool: the
    winner is a sorted categorical one)."""
    nbpf, nanb, iscat, fmask = meta
    t = scan_tables(hists[..., 0], hists[..., 1], hists[..., 2], pg, ph, pc,
                    num_bins_per_feature=nbpf, nan_bins=nanb,
                    is_categorical=iscat, feature_mask=fmask, cfg=cfg,
                    parent_output=pout, cums=cums)
    best = _select_from_tables(t, iscat, cfg)
    if not sorted_features.numel():
        return best, torch.zeros_like(best.is_cat)
    return merge_sorted_categorical(
        best, hists.index_select(1, sorted_features), pg, ph, pc, pout,
        features=sorted_features, num_bins_per_feature=nbpf,
        feature_mask=fmask, cfg=cfg)


# ------------------------------------------------ sorted many-vs-many scan
def sorted_categorical(hists, parent_grad, parent_hess, parent_count,
                       parent_output, in_feature, cfg: SplitConfig):
    """The sorted many-vs-many scan (reference
    ``FindBestThresholdCategoricalInner``'s sorted branch; the JAX
    package's ``_sorted_categorical``) over K leaves at once: ``hists``
    (K, F, B, 3) f32, ``parent_*`` (K,), ``in_feature`` (F, B) bool.  Bins
    with at least ``cat_smooth`` rows are ordered by ``G / (H +
    cat_smooth)`` (a stable sort, the rest after them); prefixes of at
    most ``max_cat_threshold`` bins are scanned from both ends, a
    candidate each time ``min_data_per_group`` rows have gathered since
    the last; children use ``lambda_l2 + cat_l2``.  Returns per (leaf,
    feature) ``(gain, cat_mask (K, F, B), gl, hl, cl)``; gain is the
    children's sum (the caller subtracts the parent's).

    The JAX package's grouping scan is a sequential float32 running sum
    of counts.  Counts are integers (exact in float32 below 2**24), so
    the rows gathered from position s to i are ``cum[i] - cum[s - 1]``
    exactly, every start's next candidate is found at once, and the chain
    of candidates from position 0 follows by pointer doubling: a few
    launches in place of one step a position."""
    k_, f, b, _ = hists.shape
    dev = hists.device
    K = min(b, max(int(cfg.max_cat_threshold), 1))
    mdpg = float(cfg.min_data_per_group)
    min_count = float(max(cfg.min_data_in_leaf, 1))
    G, H, C = hists[..., 0], hists[..., 1], hists[..., 2]
    valid = in_feature & (C >= cfg.cat_smooth)
    # + 0.0 makes -0.0 +0.0: any stable sort then orders as jnp.argsort
    # (NaN, from 0 / 0 at cat_smooth 0, last on both devices)
    key = torch.where(valid, G / (H + cfg.cat_smooth), float("inf")) + 0.0
    order = torch.argsort(key, dim=-1, stable=True)
    used = valid.sum(dim=-1, keepdim=True)                     # (K, F, 1)
    vs = torch.gather(valid, -1, order)
    srt = torch.gather(hists, 2, order[..., None].expand(k_, f, b, 3))
    srt = torch.where(vs[..., None], srt, 0.0)
    max_num_cat = torch.clamp((used + 1) // 2, max=int(cfg.max_cat_threshold))
    iidx = torch.arange(K, device=dev)
    # the backward direction starts at the last used position
    bidx = torch.clamp(used - 1 - iidx, 0, b - 1)              # (K, F, K)
    back = torch.gather(srt, 2, bidx[..., None].expand(k_, f, K, 3))
    back = torch.where((iidx < used)[..., None], back, 0.0)
    # both directions at once: (K, F, 2, K, 3) = [forward, backward]
    dirs = torch.stack([srt[:, :, :K], back], dim=2)
    cum = torch.cumsum(dirs, dim=3)
    cg, cc, cnt = cum[..., 0], cum[..., 2], dirs[..., 2]
    ch = cum[..., 1] + _EPS
    pg, ph, pc, po = (t.reshape(k_, 1, 1, 1) for t in (
        parent_grad, parent_hess, parent_count, parent_output))
    pos_ok = ((iidx < used) & (iidx < max_num_cat))[:, :, None, :]
    left_ok = (cc >= min_count) & (ch >= cfg.min_sum_hessian_in_leaf)
    rc = pc - cc
    right_ok = ((rc >= min_count) & (rc >= mdpg)
                & (ph - ch >= cfg.min_sum_hessian_in_leaf))
    ok = pos_ok & left_ok & right_ok                            # (K, F, 2, K)
    # the grouping scan: from start s the next candidate is the first i
    # >= s where ok and the rows of s..i reach min_data_per_group
    seg = cc[..., None, :] - (cc - cnt)[..., :, None]          # (.., s, i)
    tri = iidx[None, :] >= iidx[:, None]
    nxt = torch.where(ok[..., None, :] & (seg >= mdpg) & tri, iidx,
                      K).amin(dim=-1)                           # (.., s)
    # states 0..K (K: done); a candidate at i restarts the scan at i + 1
    nxt = torch.cat([nxt, torch.full_like(nxt[..., :1], K)], dim=-1)
    jump = torch.clamp(nxt + 1, max=K)
    seen = torch.zeros_like(nxt)
    seen[..., 0] = 1
    # after j steps ``seen`` holds the chain's first 2**j states, and the
    # chain has at most K + 1 <= 2**K.bit_length() of them
    for step in range(K.bit_length()):
        seen = seen.scatter_reduce(-1, jump, seen, "amax")
        if step + 1 < K.bit_length():
            jump = torch.gather(jump, -1, jump)
    emit = torch.zeros_like(nxt).scatter_(
        -1, torch.where(seen > 0, nxt, K), 1)[..., :K] > 0
    gain = (child_gain(cg, ch, cc, po, cfg, cfg.cat_l2)
            + child_gain(pg - cg, ph - ch, pc - cc, po, cfg, cfg.cat_l2))
    gain = torch.where(emit, gain, _NEG_INF).reshape(k_, f, 2 * K)
    flat = first_argmax(gain)[..., None]                      # (K, F, 1)
    take = lambda a: torch.gather(a.reshape(k_, f, 2 * K), -1, flat)[..., 0]
    best_i = flat % K
    biota = torch.arange(b, device=dev)
    left = torch.where(flat < K, biota <= best_i, biota >= used - 1 - best_i)
    cat_mask = torch.zeros_like(vs).scatter_(-1, order, left & vs)
    return take(gain), cat_mask, take(cg), take(ch), take(cc)


def sorted_feature_index(num_bins_per_feature, is_categorical,
                         cfg: SplitConfig) -> torch.Tensor:
    """The columns the sorted categorical scan reads: the categorical
    features with more than ``max_cat_to_onehot`` bins, ascending int64
    indices on the meta's device (empty: nothing to merge).  One read of
    the meta to the host; a grower finds them once a tree."""
    eligible = (is_categorical.reshape(-1)
                & (num_bins_per_feature.reshape(-1) > cfg.max_cat_to_onehot)
                & (cfg.has_categorical and cfg.use_sorted_categorical))
    return torch.nonzero(eligible)[:, 0]


def sorted_winner(hists, parent_grad, parent_hess, parent_count,
                  parent_output, *, features, num_bins_per_feature,
                  feature_mask, cfg: SplitConfig):
    """Each leaf's best sorted categorical split: ``hists`` (K, S, B, 3)
    f32 are the histograms of the S columns ``features``
    (:func:`sorted_feature_index`), the per-feature meta is the full
    (F,) one.  Returns ``(gain, feature, cat_mask (K, B), gl, hl, cl)``,
    gain net of the parent shift (plain ``lambda_l2``: the reference
    computes it before adding ``cat_l2``) and ``-inf`` below
    ``min_gain_to_split`` or outside ``feature_mask``; the lowest feature
    wins ties."""
    nbpf, fmask = (t.reshape(-1).index_select(0, features)
                   for t in (num_bins_per_feature, feature_mask))
    b = hists.shape[2]
    in_feature = torch.arange(b, device=hists.device) < nbpf[:, None]
    s_gain, s_mask, s_gl, s_hl, s_cl = sorted_categorical(
        hists, parent_grad, parent_hess, parent_count, parent_output,
        in_feature, cfg)
    s_gain = s_gain - _parent_gain(parent_grad, parent_hess, parent_output,
                                   cfg)[:, None]
    s_gain = torch.where((s_gain > cfg.min_gain_to_split + _EPS) & fmask,
                         s_gain, _NEG_INF)
    sf = first_argmax(s_gain)                                  # (K,)
    at = lambda a: torch.gather(a, 1, sf[:, None])[:, 0]
    mask = torch.gather(s_mask, 1, sf[:, None, None].expand(-1, 1, b))[:, 0]
    return at(s_gain), features[sf], mask, at(s_gl), at(s_hl), at(s_cl)


def merge_sorted_categorical(best: BestSplit, hists, parent_grad,
                             parent_hess, parent_count, parent_output,
                             **kw):
    """:func:`sorted_winner` on K leaves' (K, S, B, 3) histograms of the
    sorted columns, taken where it beats ``best`` (a BestSplit of (K,)
    fields) strictly: the JAX package's ``_merge_sorted_categorical``
    without its CEGB, feature_contri and extra_trees branches.  Returns
    (the merged BestSplit, (K,) bool: where the sorted winner was
    taken)."""
    sg, sf, mask, gl, hl, cl = sorted_winner(
        hists, parent_grad, parent_hess, parent_count, parent_output, **kw)
    better = sg > best.gain
    pick = lambda new, old: torch.where(better, new, old)
    return BestSplit(
        gain=pick(sg, best.gain),
        feature=pick(sf.to(torch.int32), best.feature),
        bin=pick(torch.zeros_like(best.bin), best.bin),
        default_left=best.default_left & ~better,
        is_cat=best.is_cat | better,
        cat_mask=torch.where(better[:, None], mask, best.cat_mask),
        sum_grad_left=pick(gl, best.sum_grad_left),
        sum_hess_left=pick(hl, best.sum_hess_left),
        count_left=pick(cl, best.count_left),
        sum_grad_right=pick(parent_grad - gl, best.sum_grad_right),
        sum_hess_right=pick(parent_hess - hl, best.sum_hess_right),
        count_right=pick(parent_count - cl, best.count_right)), better
