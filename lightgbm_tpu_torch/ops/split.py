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

Every float op runs in float32 in the JAX package's order, so gains and
leaf outputs round as the JAX package rounds them.  The cumulative sums
are ``torch.cumsum`` (double accumulation on the CPU, a parallel scan on a
CUDA device); where histogram sums are exactly representable (the
exact-sum tests) any order gives the same bits.

Not ported here: monotone constraints, CEGB penalties, extra_trees,
feature_contri, the sorted many-vs-many categorical scan and the tiled
scan (ROADMAP A8.4, A8.5, A8.7) — the trainer refuses those configs.
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
    max_cat_to_onehot: int = 4
    path_smooth: float = 0.0
    # Static dataset facts; True = "may be present" (safe).
    has_nan: bool = True
    has_categorical: bool = True


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


class ScanTables(NamedTuple):
    """Candidate tables of one (F, B) scan block."""

    gain_fb: torch.Tensor           # (F, B) masked candidate gains
    num_default_left: torch.Tensor  # (F, B) bool NaN direction
    stats_mr: tuple                 # 6x (F, B) child stats, NaN -> right
    stats_ml: tuple                 # 6x (F, B) child stats, NaN -> left
    cat_stats: tuple                # 6x (F, B) child stats, one-hot cat.
    parent_gain: torch.Tensor
    parent_output: torch.Tensor


def scan_tables(G, H, C, parent_grad, parent_hess, parent_count, *,
                num_bins_per_feature, nan_bins, is_categorical, feature_mask,
                cfg: SplitConfig, parent_output=None) -> ScanTables:
    """Evaluate every candidate of one (F, B) histogram block into masked
    gain/stat tables (the JAX package's ``scan_tables`` without monotone,
    CEGB, extra_trees and feature_contri).  ``parent_*`` are 0-dim f32
    tensors on the histogram's device."""
    f, b = G.shape
    dev = G.device
    nbpf_c = num_bins_per_feature.reshape(f, 1)
    nanb_c = nan_bins.reshape(f, 1)
    biota = torch.arange(b, device=dev, dtype=torch.int32).reshape(1, b)
    in_feature = biota < nbpf_c
    nan_pos = biota == nanb_c
    value_mask = in_feature & ~nan_pos
    if parent_output is None:
        parent_output = leaf_output(parent_grad, parent_hess, cfg)
    zero = torch.zeros((), dtype=G.dtype, device=dev)
    neg_inf = torch.full((), _NEG_INF, dtype=G.dtype, device=dev)

    Gv = torch.where(value_mask, G, zero)
    Hv = torch.where(value_mask, H, zero)
    Cv = torch.where(value_mask, C, zero)
    Gn = torch.where(nan_pos, G, zero).sum(dim=1, keepdim=True)
    Hn = torch.where(nan_pos, H, zero).sum(dim=1, keepdim=True)
    Cn = torch.where(nan_pos, C, zero).sum(dim=1, keepdim=True)
    cumG = torch.cumsum(Gv, dim=1)
    cumH = torch.cumsum(Hv, dim=1)
    cumC = torch.cumsum(Cv, dim=1)

    if cfg.path_smooth > 0.0:
        parent_gain = gain_given_output(parent_grad, parent_hess,
                                        parent_output, cfg)
    else:
        parent_gain = leaf_gain(parent_grad, parent_hess, cfg)
    min_count = float(max(cfg.min_data_in_leaf, 1))

    def eval_dir(GL, HL, CL):
        GR = parent_grad - GL
        HR = parent_hess - HL
        CR = parent_count - CL
        valid = ((CL >= min_count) & (CR >= min_count)
                 & (HL >= cfg.min_sum_hessian_in_leaf)
                 & (HR >= cfg.min_sum_hessian_in_leaf))
        gain = (child_gain(GL, HL, CL, parent_output, cfg)
                + child_gain(GR, HR, CR, parent_output, cfg)
                - parent_gain)
        gain = torch.where(valid & (gain > cfg.min_gain_to_split + _EPS),
                           gain, neg_inf)
        return gain, (GL, HL, CL, GR, HR, CR)

    gain_mr, stats_mr = eval_dir(cumG, cumH, cumC)            # NaN -> right
    if cfg.has_nan:
        gain_ml, stats_ml = eval_dir(cumG + Gn, cumH + Hn, cumC + Cn)
        gain_ml = torch.where(nanb_c < b, gain_ml, neg_inf)
        num_gain = torch.maximum(gain_mr, gain_ml)
        num_default_left = gain_ml > gain_mr
    else:
        stats_ml = stats_mr
        num_gain = gain_mr
        num_default_left = torch.zeros_like(gain_mr, dtype=torch.bool)
    num_gain = torch.where(value_mask, num_gain, neg_inf)

    if cfg.has_categorical:
        # One-hot categorical: "bin == k goes left".
        cat_gain, cat_stats = eval_dir(G, H, C)
        cat_gain = torch.where(in_feature, cat_gain, neg_inf)
        is_cat_col = is_categorical.reshape(f, 1)
        sorted_eligible = is_cat_col & (nbpf_c > cfg.max_cat_to_onehot)
        gain_fb = torch.where(is_cat_col, cat_gain, num_gain)
        gain_fb = torch.where(sorted_eligible, neg_inf, gain_fb)
    else:
        cat_stats = stats_mr
        gain_fb = num_gain
    gain_fb = torch.where(feature_mask.reshape(f, 1), gain_fb, neg_inf)
    return ScanTables(gain_fb=gain_fb, num_default_left=num_default_left,
                      stats_mr=stats_mr, stats_ml=stats_ml,
                      cat_stats=cat_stats, parent_gain=parent_gain,
                      parent_output=parent_output)


def _select_from_tables(t: ScanTables, is_categorical,
                        cfg: SplitConfig) -> BestSplit:
    """Argmax + winner-stat gather: the lowest flat (feature, bin) index
    wins ties."""
    gain_fb = t.gain_fb
    f, b = gain_fb.shape
    flat = first_argmax(gain_fb.reshape(-1))
    bf, bb = flat // b, flat % b
    bgain = gain_fb[bf, bb]
    bis_cat = (is_categorical[bf] if cfg.has_categorical
               else torch.zeros((), dtype=torch.bool, device=gain_fb.device))
    bdefault_left = torch.where(bis_cat, torch.zeros_like(bis_cat),
                                t.num_default_left[bf, bb])

    def pick(i):
        return torch.where(bis_cat, t.cat_stats[i][bf, bb],
                           torch.where(bdefault_left, t.stats_ml[i][bf, bb],
                                       t.stats_mr[i][bf, bb]))

    GL, HL, CL, GR, HR, CR = (pick(i) for i in range(6))
    cat_mask = ((torch.arange(b, device=gain_fb.device) == bb) & bis_cat)
    return BestSplit(gain=bgain, feature=bf.to(torch.int32),
                     bin=bb.to(torch.int32), default_left=bdefault_left,
                     is_cat=bis_cat, cat_mask=cat_mask,
                     sum_grad_left=GL, sum_hess_left=HL, count_left=CL,
                     sum_grad_right=GR, sum_hess_right=HR, count_right=CR)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of a 1-D tensor (``jnp.argmax``'s
    tie-break; ``torch.argmax`` does not promise one)."""
    mx = x.max()
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == mx, idx, x.shape[0]).min()


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
    zero = torch.zeros((), dtype=gain_fb.dtype, device=dev)

    def take(a):
        return torch.where(sel, a, zero).sum()

    def pick(i):
        return torch.where(bis_cat, take(t.cat_stats[i]),
                           torch.where(bdefault_left, take(t.stats_ml[i]),
                                       take(t.stats_mr[i])))

    GL, HL, CL, GR, HR, CR = (pick(i) for i in range(6))
    return bgain, bf, bb, bdefault_left, bis_cat, GL, HL, CL, GR, HR, CR


def best_split(hist, parent_grad, parent_hess, parent_count, *,
               num_bins_per_feature, nan_bins, is_categorical, feature_mask,
               cfg: SplitConfig, parent_output=None) -> BestSplit:
    """Every candidate of an (F, B, 3) leaf histogram, then the argmax."""
    G, H, C = hist[..., 0], hist[..., 1], hist[..., 2]
    t = scan_tables(G, H, C, parent_grad, parent_hess, parent_count,
                    num_bins_per_feature=num_bins_per_feature,
                    nan_bins=nan_bins, is_categorical=is_categorical,
                    feature_mask=feature_mask, cfg=cfg,
                    parent_output=parent_output)
    return _select_from_tables(t, is_categorical, cfg)


def best_split_batch(hists, pg, ph, pc, pout, **kw) -> BestSplit:
    """:func:`best_split` for K leaves: (K, F, B, 3) histograms and (K,)
    parent stats -> a BestSplit of (K,) fields ((K, B) cat_mask)."""
    outs = [best_split(hists[k], pg[k], ph[k], pc[k], parent_output=pout[k],
                       **kw) for k in range(hists.shape[0])]
    return BestSplit(*(torch.stack([getattr(o, fld) for o in outs])
                       for fld in BestSplit._fields))
