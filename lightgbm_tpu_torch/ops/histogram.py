"""Gradient/hessian histograms: the torch ops and the dispatch.

The port of the JAX package's ``ops/histogram.py``:

    hist[f, b, c] = sum_n  vals[n, c] * (bins[n, f] == b)     c in {grad, hess, count}

``histogram_segment`` is the scatter-add form (``index_add_`` over flat
``feature * B + bin`` ids) and the plain version of the hand-written CUDA
histogram kernel (``ops/histogram_flat.py``): f32 and bf16 values sum in
f32, int8 values (quantized training) in int32.  ``histogram_chunked``
(and ``segment_histograms_chunked``, its permuted multi-segment form for
the wave kernel's stage 1) repeats the kernel's summation order, row
chunks in row order then the chunk sums in chunk order, so the kernel
equals it bit for bit on any values; only tests and ``chip_smoke.py``
call it.  ``histogram_from_vals``
dispatches: on a CUDA tensor ``auto``/``pallas``/``flat`` launch the
kernel and ``flat_bf16`` its bf16 mode (integer values take its int8
mode under every one of them, as the JAX package routes them); on a CPU
tensor they run the plain version.  ``segment`` and ``onehot`` are torch
ops everywhere, as they are XLA ops in the JAX package.

Bins are (N, F) uint8, or uint16 above 256 bins.  Torch has no ordering
compares on uint16 tensors, and on a CUDA tensor no advanced indexing
either: every op here widens the ids with ``.long()`` as it reads them,
and reads rows of uint16 bins through ``read_bins`` (``index_select``
keeps the uint16 rows themselves).

4-bit bins (``packed4``): when every feature has at most 16 bins, the
(N, F) matrix is stored as (N, ceil(F/2)) uint8, feature 2j in the low
nibble of column j and 2j+1 in the high one (``pack_bins4``, the JAX
package's layout byte for byte).  The torch ops unpack per block of
rows; the kernel reads the nibbles itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def pack_bins4(bins: torch.Tensor) -> torch.Tensor:
    """(N, F) bins that all fit 4 bits -> (N, ceil(F/2)) uint8 nibble
    pairs; an odd F gets a phantom high nibble of 0."""
    n, f = bins.shape
    b = bins.to(torch.uint8)
    if f % 2:
        b = torch.cat([b, torch.zeros(n, 1, dtype=torch.uint8,
                                      device=b.device)], dim=1)
    b = b.reshape(n, b.shape[1] // 2, 2)
    return (b[:, :, 0] | (b[:, :, 1] << 4)).contiguous()


def unpack_bins4(packed: torch.Tensor, num_features: int) -> torch.Tensor:
    """Inverse of :func:`pack_bins4` (drops the phantom odd-F column)."""
    low = packed & 15
    high = (packed >> 4) & 15
    n, cols = packed.shape
    full = torch.stack([low, high], dim=-1).reshape(n, 2 * cols)
    return full[:, :num_features]


def read_bins(bins: torch.Tensor, *index) -> torch.Tensor:
    """``bins[index]`` as int64 bin ids.  uint16 bins are indexed through
    their int16 view (torch indexes no uint16 CUDA tensor), whose ids
    above 32,767 read negative and are masked back to 16 bits."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16)[index].long() & 0xFFFF
    return bins[index].long()


def pack_values(grad: torch.Tensor, hess: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Stack (grad, hess, ones) into the (N, 3) channel matrix, pre-masked."""
    vals = torch.stack([grad, hess, torch.ones_like(grad)], dim=-1)
    if mask is not None:
        vals = vals * mask.to(vals.dtype)[:, None]
    return vals


def acc_dtype(vals: torch.Tensor) -> torch.dtype:
    """int32 sums for integer (quantized) values, f32 for bf16 values
    (the kernel's bf16 mode accumulates in f32), else the values' type."""
    if not vals.dtype.is_floating_point:
        return torch.int32
    return torch.float32 if vals.dtype == torch.bfloat16 else vals.dtype


def histogram_segment(bins: torch.Tensor, vals: torch.Tensor, *,
                      num_bins: int, packed4: bool = False,
                      features: int = 0) -> torch.Tensor:
    """Scatter-add histogram: (N, F) integer bins (or (N, ceil(F/2))
    nibble pairs with ``packed4`` and the real F in ``features``), (N, 3)
    f32, bf16 or int8 values -> (F, num_bins, 3) f32 or int32."""
    if packed4:
        bins = unpack_bins4(bins, features)
    n, f = bins.shape
    flat = (bins.long() + torch.arange(f, device=bins.device)[None, :]
            * num_bins).reshape(-1)
    acc = acc_dtype(vals)
    hist = torch.zeros(f * num_bins, 3, dtype=acc, device=vals.device)
    src = vals.to(acc)[:, None, :].expand(n, f, 3).reshape(-1, 3)
    hist.index_add_(0, flat, src)
    return hist.reshape(f, num_bins, 3)


def segment_histograms_chunked(bins: torch.Tensor, vals: torch.Tensor,
                               perm: Optional[torch.Tensor], starts, counts,
                               *, num_bins: int, chunk_rows: int,
                               packed4: bool = False,
                               features: int = 0) -> torch.Tensor:
    """The CUDA kernel's f32 sums in its own order, for tests and
    ``chip_smoke.py`` (nothing on the training path calls it): segment w
    is the rows at positions ``starts[w] .. starts[w] + counts[w] - 1``
    (through ``perm`` when given), cut into chunks of ``chunk_rows`` from
    its start; each chunk is summed in row order, one f32 add per row and
    cell from 0, and the chunk sums in chunk order from 0.  (N, F) bins
    (or ``packed4`` nibble pairs of ``features`` features), (N, 3) f32 or
    bf16 values (widened) -> (W, F, num_bins, 3) f32; a bin id >=
    num_bins is dropped.

    Step k adds, to every (chunk, feature, bin) cell at once, the value
    of the cell's k-th row (its rank among the chunk's rows in that cell,
    from a stable sort): no cell repeats within a step, and the steps are
    as many as the fullest cell has rows."""
    if packed4:
        bins = unpack_bins4(bins, features)
    dev = bins.device
    f = bins.shape[1]
    vals = vals.to(torch.float32)
    counts = np.asarray(counts, np.int64)
    per = -(-counts // chunk_rows)
    offs = np.concatenate([[0], np.cumsum(per)])
    out = torch.zeros(len(counts), f, num_bins, 3, dtype=torch.float32,
                      device=dev)
    if offs[-1] == 0:
        return out
    # every row of every segment in position order, and its chunk
    seg = np.repeat(np.arange(len(counts)), counts)
    local = np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    pos = torch.as_tensor(np.asarray(starts, np.int64)[seg] + local,
                          device=dev)
    chunk = torch.as_tensor(offs[seg] + local // chunk_rows, device=dev)
    rows = perm[pos].long() if perm is not None else pos
    b = read_bins(bins, rows)                               # (R, F)
    keep = b < num_bins
    cell = ((chunk[:, None] * f + torch.arange(f, device=dev)) * num_bins
            + b)[keep]                     # row-major: row order per cell
    src = rows[:, None].expand_as(b)[keep]
    cell, order = torch.sort(cell, stable=True)
    src = src[order]
    first = torch.ones_like(cell, dtype=torch.bool)
    first[1:] = cell[1:] != cell[:-1]
    idx = torch.arange(cell.numel(), device=dev)
    rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    rank, by_rank = torch.sort(rank, stable=True)
    sizes = torch.bincount(rank).tolist()
    cell, src = cell[by_rank], src[by_rank]
    part = torch.zeros(int(offs[-1]) * f * num_bins, 3, dtype=torch.float32,
                       device=dev)
    lo = 0
    for size in sizes:
        ids = cell[lo:lo + size]
        part[ids] = part[ids] + vals[src[lo:lo + size]]
        lo += size
    part = part.reshape(int(offs[-1]), f, num_bins, 3)
    for j in range(int(per.max())):
        has = np.flatnonzero(per > j)
        out[has] = out[has] + part[torch.as_tensor(offs[has] + j,
                                                   device=dev)]
    return out


def histogram_chunked(bins: torch.Tensor, vals: torch.Tensor, *,
                      num_bins: int, chunk_rows: Optional[int] = None,
                      packed4: bool = False, features: int = 0
                      ) -> torch.Tensor:
    """The f32 / bf16 histogram kernel's sums in its own order (the plain
    twin of its summation, for tests): rows in storage order cut into
    chunks of ``chunk_rows`` (default: the wrapper's
    ``ops/histogram_flat.py::chunking`` of N rows and F * num_bins
    cells), each summed in row order, then the chunk sums in chunk order.
    Returns (F, num_bins, 3) f32."""
    if chunk_rows is None:
        from .histogram_flat import chunking
        f = features if packed4 else bins.shape[1]
        chunk_rows = chunking(bins.shape[0], f * num_bins)[0]
    return segment_histograms_chunked(
        bins, vals, None, [0], [bins.shape[0]], num_bins=num_bins,
        chunk_rows=chunk_rows, packed4=packed4, features=features)[0]


def histogram_onehot(bins: torch.Tensor, vals: torch.Tensor, *,
                     num_bins: int, rows_block: int = 16384,
                     packed4: bool = False, features: int = 0
                     ) -> torch.Tensor:
    """One-hot contraction, blockwise over rows (the JAX package's
    ``histogram_onehot``; ``packed4`` bins unpack per block).  Integer
    values contract in float64, exact for any int32 sum, and come back as
    int32."""
    n = bins.shape[0]
    f = features if packed4 else bins.shape[1]
    acc = acc_dtype(vals)
    work = torch.float64 if acc == torch.int32 else acc
    iota = torch.arange(num_bins, device=bins.device)
    hist = torch.zeros(f, num_bins, 3, dtype=work, device=vals.device)
    for s in range(0, n, rows_block):
        b = bins[s:s + rows_block]
        b = (unpack_bins4(b, f) if packed4 else b).long()
        oh = (b[:, :, None] == iota[None, None, :]).to(work)
        hist += torch.einsum("nfb,nc->fbc", oh,
                             vals[s:s + rows_block].to(work))
    return hist.to(acc)


def resolve_impl(impl: str, device: torch.device) -> str:
    """``auto`` is the kernel on a CUDA device and the scatter-add on the
    CPU (the JAX package resolves it to its kernel on a TPU and to
    ``segment`` elsewhere)."""
    if impl != "auto":
        return impl
    return "flat" if device.type == "cuda" else "segment"


def histogram_from_vals(bins: torch.Tensor, vals: torch.Tensor, *,
                        num_bins: int, impl: str = "auto",
                        rows_block: int = 16384, packed4: bool = False,
                        features: int = 0,
                        max_level: int = 127) -> torch.Tensor:
    """Histogram from pre-packed (N, 3) channel values (int8 values:
    levels of at most ``max_level`` in magnitude)."""
    layout = dict(packed4=packed4, features=features)
    if impl in ("auto", "pallas", "flat", "flat_bf16"):
        from .histogram_flat import histogram_flat
        return histogram_flat(bins, vals, num_bins=num_bins,
                              dtype="bf16" if impl == "flat_bf16" else "f32",
                              max_level=max_level, **layout)
    if impl == "onehot":
        return histogram_onehot(bins, vals, num_bins=num_bins,
                                rows_block=rows_block, **layout)
    if impl == "segment":
        return histogram_segment(bins, vals, num_bins=num_bins, **layout)
    raise ValueError(f"unknown histogram impl: {impl}")


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram via subtraction (reference
    ``FeatureHistogram::Subtract``)."""
    return parent - child
