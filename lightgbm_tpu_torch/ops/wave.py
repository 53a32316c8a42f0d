"""Fused wave step: the wrapper of the hand-written CUDA kernel
``ops/csrc/wave.cu`` (the port of the JAX package's
``ops/pallas_wave.py::fused_wave_call``, every mode).

For each of the W leaves of a wave: the smaller sibling's histogram over
its rows of the permutation, the larger sibling by subtraction from the
parent, the pair ordered (left, right), both children scanned and the
winner selected.  On a CUDA tensor ``fused_wave_call`` launches the kernel
on PyTorch's current stream, or raises; on a CPU tensor it runs the plain
version, ``wave_plain`` — exactly the unfused step, which the grower's
unfused branch runs too: the plain histogram of each smaller sibling, the
subtraction, the (left, right) order, then ``scan_tables`` +
``select_payload``.

int8 mode (quantized training): int8 values, int32 parent and child
histograms, and ``scale3``, the (3,) f32 device tensor of channel scales
[grad, hess, 1]; the scan sees each cell as ``float(h) * scale[c]`` (the
JAX package's ``_scale_hist``).

bf16 mode (``tpu_histogram_impl=flat_bf16``): bf16 values, f32
histograms; the siblings' sums are f32 sums of the bf16 values.  packed4
(``packed4=True``): the bins are the (N, ceil(F/2)) nibble pairs of
``ops/histogram.py::pack_bins4``, F being the parents' feature count.
uint16 bins (more than 256 bins, up to 65,536): the (N, F) uint16 matrix,
in each value type (never packed).  The nine modes are those of
``ops/histogram_flat.py::MODES``; the uint16 ones launch their own entry
points, whose scan cuts the bin axis into tiles where it does not fit
the block's shared memory.

Exclusive feature bundling: the grower passes the (N, G) bundled matrix,
(W, G, HB, 3) parents and the (G, 4) meta of the bundle columns (their
bins, no NaN bin, not categorical, feature mask 0).  The scan then offers
no candidate and the payload is not read: the grower takes the child
histograms and scans them in feature space (``ops/bundle.py``); the
unfused step builds the histograms alone (``wave_children``).

The TPU kernel's VMEM layout (``wave_layout``), lane padding, the
gathered ``(W, S, ct)`` row copy and the packed4 nibble-plane order with
its original-order tie-break keys have no counterpart: the kernel reads
the bins through the permutation, and each child histogram stays in the
(F, B, 3) original-order layout the grower stores.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .histogram import histogram_segment, segment_histograms_chunked
# MAX_CHUNKS and MIN_CHUNK_ROWS name the wave's chunking too (it is the
# histogram kernel's)
from .histogram_flat import (MAX_CHUNKS, MIN_CHUNK_ROWS,  # noqa: F401
                             MIN_CHUNK_ROWS_INT8, MODES, check_int8_rows,
                             check_layout, chunking, int8_chunk_rows,
                             int8_shape, mode_name)
from .split import (BestSplit, SplitConfig, _EPS, scan_tables,
                    select_payload, sorted_winner)

#: scalar lanes ahead of the cat one-hot in the per-child payload:
#: [gain, feature, bin, default_left, is_cat, GL, HL, CL, GR, HR, CR] + pad
PAYLOAD_SCALARS = 16
#: per-child stat lanes: [pg, ph, pc, parent_out, small_left, active, 0, 0]
STAT_LANES = 8

#: kernel launches made by ``fused_wave_call`` (one per wave; plain
#: ints), per mode
launches = dict.fromkeys(MODES, 0)


def wave_meta(num_bins_per_feature, nan_bins, is_categorical,
              feature_mask) -> torch.Tensor:
    """(F, 4) int32 ``[num_bins, nan_bin, is_cat, feature_mask]``."""
    return torch.stack([num_bins_per_feature.to(torch.int32),
                        nan_bins.to(torch.int32),
                        is_categorical.to(torch.int32),
                        feature_mask.to(torch.int32)], dim=1).contiguous()


def wave_stats(g2, h2, c2, o2, small_left, active) -> torch.Tensor:
    """(W, 2, STAT_LANES) f32 from (W, 2) child sums/outputs and (W,)
    flags."""
    w = g2.shape[0]
    sl = small_left.to(torch.float32)[:, None].expand(w, 2)
    act = active.to(torch.float32)[:, None].expand(w, 2)
    z = torch.zeros_like(g2)
    return torch.stack([g2, h2, c2, o2, sl, act, z, z], dim=-1).contiguous()


def payload_to_best(pay: torch.Tensor) -> BestSplit:
    """(K, PAYLOAD_SCALARS + B) payload -> batched BestSplit (the f32
    lanes carry counts and sums losslessly: one writer per lane)."""
    col = lambda i: pay[:, i]
    return BestSplit(
        gain=col(0), feature=torch.round(col(1)).to(torch.int32),
        bin=torch.round(col(2)).to(torch.int32), default_left=col(3) > 0.5,
        is_cat=col(4) > 0.5, cat_mask=pay[:, PAYLOAD_SCALARS:] > 0.5,
        sum_grad_left=col(5), sum_hess_left=col(6), count_left=col(7),
        sum_grad_right=col(8), sum_hess_right=col(9), count_right=col(10))


def best_to_payload(bs: BestSplit) -> torch.Tensor:
    """A batched BestSplit -> its (K, PAYLOAD_SCALARS + B) f32 payload
    (:func:`payload_to_best`'s inverse; every field is exact in f32), so
    that K winners come to the host in one copy."""
    scalars = torch.stack([t.to(torch.float32) for t in (
        bs.gain, bs.feature, bs.bin, bs.default_left, bs.is_cat,
        bs.sum_grad_left, bs.sum_hess_left, bs.count_left,
        bs.sum_grad_right, bs.sum_hess_right, bs.count_right)], dim=1)
    pad = scalars.new_zeros(scalars.shape[0],
                            PAYLOAD_SCALARS - scalars.shape[1])
    return torch.cat([scalars, pad, bs.cat_mask.to(torch.float32)], dim=1)


def merge_sorted_payload(pay: torch.Tensor, hists: torch.Tensor,
                         stats: torch.Tensor, **kw) -> torch.Tensor:
    """The sorted categorical scan merged into K children's (K,
    PAYLOAD_SCALARS + B) payload: ``hists`` (K, S, B, 3) f32 of the
    sorted columns as the scan sees them, ``stats`` (K, STAT_LANES);
    ``kw`` as ``ops/split.py::sorted_winner`` takes them.  A child takes
    the sorted winner where it is active and strictly better (``bin`` 0,
    ``default_left`` false, ``is_cat`` true, its set in the one-hot
    lanes): ``merge_sorted_categorical``'s rule, written on the payload
    so that the wave's winners stay one tensor and one read to the host.
    The kernel and ``wave_plain`` give a sorted-eligible feature no
    candidate; this is the step that does."""
    pg, ph, pc, pout = stats[:, 0], stats[:, 1], stats[:, 2], stats[:, 3]
    sg, sf, mask, gl, hl, cl = sorted_winner(hists, pg, ph, pc, pout, **kw)
    zero = torch.zeros_like(sg)
    scalars = torch.stack([sg, sf.to(torch.float32), zero, zero,
                           torch.ones_like(sg), gl, hl, cl, pg - gl, ph - hl,
                           pc - cl], dim=1)
    cand = torch.cat([scalars, pay[:, scalars.shape[1]:PAYLOAD_SCALARS],
                      mask.to(torch.float32)], dim=1)
    better = (sg > pay[:, 0]) & (stats[:, 5] > 0.5)
    return torch.where(better[:, None], cand, pay)


def _child_payload(hist, st, meta, cfg: SplitConfig, num_bins: int):
    G, H, C = hist[..., 0], hist[..., 1], hist[..., 2]
    t = scan_tables(G, H, C, st[0], st[1], st[2],
                    num_bins_per_feature=meta[:, 0], nan_bins=meta[:, 1],
                    is_categorical=meta[:, 2] > 0,
                    feature_mask=meta[:, 3] > 0, cfg=cfg,
                    parent_output=st[3])
    (gain, bf, bb, dl, ic, GL, HL, CL, GR, HR,
     CR) = select_payload(t, meta[:, 2] > 0, cfg)
    gain = torch.where(st[5] > 0.5, gain, float("-inf"))
    dev = hist.device
    scalars = torch.stack([v.to(torch.float32).reshape(()) for v in (
        gain, bf, bb, dl, ic, GL, HL, CL, GR, HR, CR)])
    cat = ((torch.arange(num_bins, device=dev) == bb) & ic).to(torch.float32)
    pad = torch.zeros(PAYLOAD_SCALARS - scalars.shape[0], dtype=torch.float32,
                      device=dev)
    return torch.cat([scalars, pad, cat])


def scale_hist(hist: torch.Tensor, scale3) -> torch.Tensor:
    """A raw histogram as the split scan sees it: int32 (quantized) cells
    times their channel's scale in f32 (the JAX package's
    ``_scale_hist``); f32 as it is when ``scale3`` is None."""
    if scale3 is None:
        return hist
    return hist.to(torch.float32) * scale3


def wave_children(bins, vals, perm, small_start: Sequence[int],
                  small_cnt: Sequence[int], parent, stats, histogram):
    """The plain version's child histograms (W, 2, F, B, 3): each smaller
    sibling by ``histogram(bins, vals)`` over its rows, the larger one as
    parent - smaller, the pair in (left, right) order by ``stats[w, 0,
    4]``."""
    hists = []
    for w in range(parent.shape[0]):
        s0, cnt = int(small_start[w]), int(small_cnt[w])
        rows = perm[s0:s0 + cnt].long()
        small = histogram(bins.index_select(0, rows), vals[rows])
        big = parent[w] - small
        sl = bool(stats[w, 0, 4] > 0.5)
        hists.append(torch.stack([small, big] if sl else [big, small]))
    return torch.stack(hists)


def wave_plain(bins, vals, perm, small_start: Sequence[int],
               small_cnt: Sequence[int], parent, stats, meta,
               cfg: SplitConfig, num_bins: int, histogram=None,
               scale3=None, packed4: bool = False):
    """The plain version: returns ``(child_hists (W, 2, F, B, 3),
    payload (W, 2, PAYLOAD_SCALARS + B))``.  ``histogram(bins, vals)``
    builds each smaller sibling from its rows of ``bins`` (default: the
    plain ``histogram_segment``, which unpacks ``packed4`` bins; the
    grower's unfused step passes its histogram impl, which knows its
    layout).  With int8 ``vals`` the histograms are int32 and the scan
    sees them through ``scale3``; bf16 ``vals`` sum in f32."""
    if histogram is None:
        histogram = lambda b, v: histogram_segment(
            b, v, num_bins=num_bins, packed4=packed4,
            features=parent.shape[1])
    hists = wave_children(bins, vals, perm, small_start, small_cnt, parent,
                          stats, histogram)
    pays = [torch.stack([_child_payload(scale_hist(hists[w, c], scale3),
                                        stats[w, c], meta, cfg, num_bins)
                         for c in range(2)])
            for w in range(parent.shape[0])]
    return hists, torch.stack(pays)


def segment_table(small_cnt: Sequence[int], f: int, num_bins: int,
                  int8: bool = False, wide: bool = False):
    """(chunk_rows, chunk offsets (W + 1,)) for one wave: in int8 mode
    the histogram kernel's ``int8_chunk_rows`` of all its rows (blocks
    enough to fill the card whatever W; ``wide``: over uint16 bins;
    integer sums do not depend on it); in f32 and bf16 modes the
    histogram kernel's ``chunking`` of all its rows, no more partials than
    its SCRATCH_BYTES holds, but at least one chunk for each non-empty
    sibling: W * F * B * 12 bytes at least, past SCRATCH_BYTES only at
    uint16 widths, e.g. 352 MB at W = 16, F = 28, B = 65,536."""
    total = int(sum(small_cnt))
    if int8:
        chunk_rows = int8_chunk_rows(total, f, num_bins, wide)
    else:
        chunk_rows, _ = chunking(total, f * num_bins)
    per = [-(-int(c) // chunk_rows) for c in small_cnt]
    return chunk_rows, np.concatenate([[0], np.cumsum(per)]).astype(np.int64)


def wave_hists_chunked(bins, vals, perm, small_start: Sequence[int],
                       small_cnt: Sequence[int], parent, stats,
                       num_bins: int, packed4: bool = False):
    """The f32 / bf16 wave kernel's child histograms in its own summation
    order (for tests and ``chip_smoke.py``): each smaller sibling summed
    over its perm range in chunks of ``segment_table``'s rows (row order,
    then chunk order), the larger one as parent - smaller, the pair in
    (left, right) order by ``stats[w, 0, 4]``.  Returns (W, 2, F, B, 3)."""
    f = parent.shape[1]
    chunk_rows, _ = segment_table(small_cnt, f, num_bins)
    small = segment_histograms_chunked(
        bins, vals, perm, small_start, small_cnt, num_bins=num_bins,
        chunk_rows=chunk_rows, packed4=packed4, features=f)
    big = parent - small
    left = (stats[:, 0, 4] > 0.5)[:, None, None, None]
    return torch.stack([torch.where(left, small, big),
                        torch.where(left, big, small)], dim=1)


def fused_wave_call(bins: torch.Tensor, vals: torch.Tensor,
                    perm: torch.Tensor, small_start: Sequence[int],
                    small_cnt: Sequence[int], parent: torch.Tensor,
                    stats: torch.Tensor, meta: torch.Tensor,
                    cfg: SplitConfig, num_bins: int, scale3=None,
                    packed4: bool = False, max_level: int = 127):
    """One wave of W leaves -> ``(child_hists, payload)``.

    ``bins`` (N, F) uint8 (at most 256 bins) or uint16 (at most 65,536),
    or (N, ceil(F/2)) nibble pairs with ``packed4``; ``vals`` (N, 3) f32,
    bf16 (bf16 mode), or int8 levels of at most ``max_level`` with
    ``scale3``; ``perm`` (>= N,) int32 rows grouped by leaf;
    ``small_start``/``small_cnt`` host ints of each smaller sibling's perm
    range; ``parent`` (W, F, B, 3) f32 (int32 in int8 mode); ``stats``
    (W, 2, STAT_LANES) f32; ``meta`` (F, 4) int32 (``wave_meta``);
    ``scale3`` (3,) f32 channel scales, int8 mode only."""
    w = parent.shape[0]
    f = meta.shape[0]
    if (parent.shape != (w, f, num_bins, 3) or stats.shape != (w, 2, STAT_LANES)
            or meta.shape != (f, 4) or bins.dim() != 2
            or len(small_start) != w or len(small_cnt) != w
            or (scale3 is not None and scale3.shape != (3,))
            or check_layout(bins, num_bins, packed4, f) != f):
        raise ValueError(
            f"wave shapes: bins {tuple(bins.shape)}, parent "
            f"{tuple(parent.shape)}, stats {tuple(stats.shape)}, meta "
            f"{tuple(meta.shape)}, {w} slots, {f} features, {num_bins} bins")
    int8 = vals.dtype == torch.int8
    if int8 != (scale3 is not None):
        raise ValueError("int8 values go with scale3, f32 values without")
    for t in (vals, perm, parent, stats, meta) + ((scale3,) if int8 else ()):
        if t.device != bins.device:
            raise ValueError("wave operands must share one device")
    if int8:
        check_int8_rows(bins.shape[0], max_level)
    if bins.device.type == "cpu":
        return wave_plain(bins, vals, perm, small_start, small_cnt, parent,
                          stats, meta, cfg, num_bins, scale3=scale3,
                          packed4=packed4)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(bins, vals, perm, small_start, small_cnt, parent, stats,
                   meta, cfg, num_bins, scale3, packed4)


def _launch(bins, vals, perm, small_start, small_cnt, parent, stats, meta,
            cfg: SplitConfig, num_bins: int, scale3, packed4: bool):
    from ._build import load_library
    int8 = scale3 is not None
    hist_t = torch.int32 if int8 else torch.float32
    val_ok = (vals.dtype == torch.int8 if int8
              else vals.dtype in (torch.float32, torch.bfloat16))
    if bins.dtype not in (torch.uint8, torch.uint16) or not val_ok \
            or perm.dtype != torch.int32 or parent.dtype != hist_t \
            or stats.dtype != torch.float32 or meta.dtype != torch.int32 \
            or (int8 and scale3.dtype != torch.float32):
        raise ValueError("wave kernel dtypes: uint8 or uint16 bins, f32 or "
                         "bf16 vals with f32 parent (int8 vals, int32 parent "
                         "and f32 scale3 in int8 mode), f32 stats, int32 "
                         "perm/meta")
    lib = load_library()
    w = parent.shape[0]
    f = meta.shape[0]
    dev = bins.device
    mode = mode_name(vals.dtype, packed4, bins.dtype)
    wide = bins.dtype == torch.uint16
    chunk_rows, offs = segment_table(small_cnt, f, num_bins, int8, wide)
    total_chunks = int(offs[-1])
    seg = torch.from_numpy(np.concatenate([
        np.asarray(small_start, np.int64), np.asarray(small_cnt, np.int64),
        offs]).astype(np.int32)).to(dev)
    # the chunk partials (f32, or int32 in int8 mode)
    scratch = torch.empty(max(total_chunks, 1), f, num_bins, 3, dtype=hist_t,
                          device=dev)
    out_hist = torch.empty(w, 2, f, num_bins, 3, dtype=hist_t, device=dev)
    payload = torch.empty(w, 2, PAYLOAD_SCALARS + num_bins,
                          dtype=torch.float32, device=dev)
    tensors = [t.contiguous() for t in (bins, vals, perm, parent, stats, meta)]
    bins, vals, perm, parent, stats, meta = tensors
    scan = (cfg.lambda_l1, cfg.lambda_l2,
            float(max(cfg.min_data_in_leaf, 1)), cfg.min_sum_hessian_in_leaf,
            cfg.min_gain_to_split + _EPS, cfg.max_delta_step,
            cfg.path_smooth, int(cfg.has_nan), int(cfg.has_categorical),
            int(cfg.max_cat_to_onehot))
    head = (bins.data_ptr(), vals.data_ptr(), perm.data_ptr(), f, num_bins,
            seg.data_ptr(), w, total_chunks, chunk_rows, parent.data_ptr(),
            stats.data_ptr(), meta.data_ptr())
    tail = (scratch.data_ptr(), out_hist.data_ptr(), payload.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if int8:
            fpb, _, tile, _ = int8_shape(f, num_bins, wide)
            head = (*head[:9], fpb, tile, *head[9:])
            scale3 = scale3.contiguous()
            mid = (scale3.data_ptr(), *scan)
            err = (lib.lgbt_wave_i8_u16(*head, *mid, *tail) if wide
                   else lib.lgbt_wave_i8(*head, *mid, int(packed4), *tail))
        else:
            bf16 = int(vals.dtype == torch.bfloat16)
            err = (lib.lgbt_wave_u16(*head, *scan, bf16, *tail) if wide
                   else lib.lgbt_wave(*head, *scan, int(packed4), bf16,
                                      *tail))
    if err != 0:
        raise RuntimeError(f"wave kernel launch failed ({mode} mode): CUDA "
                           f"error {err}")
    launches[mode] += 1
    return out_hist, payload


def split_payload(payload: torch.Tensor) -> torch.Tensor:
    """(W, 2, P) -> the (2W, P) batch of children, lefts then rights: the
    order the grower stores them in."""
    return torch.cat([payload[:, 0], payload[:, 1]], dim=0)
