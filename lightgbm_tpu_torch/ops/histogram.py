"""Gradient/hessian histograms: the torch ops and the dispatch.

The port of the JAX package's ``ops/histogram.py``:

    hist[f, b, c] = sum_n  vals[n, c] * (bins[n, f] == b)     c in {grad, hess, count}

``histogram_segment`` is the scatter-add form (``index_add_`` over flat
``feature * B + bin`` ids) and the plain version of the hand-written CUDA
histogram kernel (``ops/histogram_flat.py``): f32 values sum in f32, int8
values (quantized training) in int32.  ``histogram_from_vals``
dispatches: on a CUDA tensor ``auto``/``pallas``/``flat`` launch the
kernel (its int8 mode for integer values, as the JAX package routes
them); on a CPU tensor they run the plain version.  ``segment`` and
``onehot`` are torch ops everywhere, as they are XLA ops in the JAX
package.  ``flat_bf16`` (the kernel's bf16 mode) is not ported yet; with
integer values it means the int8 mode, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

_BF16_TODO = ("tpu_histogram_impl=flat_bf16 (the bf16 mode of the histogram "
              "kernel) is not ported yet (ROADMAP queue B, item B1b)")


def pack_values(grad: torch.Tensor, hess: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Stack (grad, hess, ones) into the (N, 3) channel matrix, pre-masked."""
    vals = torch.stack([grad, hess, torch.ones_like(grad)], dim=-1)
    if mask is not None:
        vals = vals * mask.to(vals.dtype)[:, None]
    return vals


def acc_dtype(vals: torch.Tensor) -> torch.dtype:
    """int32 sums for integer (quantized) values, else the values' type."""
    return vals.dtype if vals.dtype.is_floating_point else torch.int32


def histogram_segment(bins: torch.Tensor, vals: torch.Tensor, *,
                      num_bins: int) -> torch.Tensor:
    """Scatter-add histogram: (N, F) integer bins, (N, 3) f32 or int8
    values -> (F, num_bins, 3) f32 or int32."""
    n, f = bins.shape
    flat = (bins.long() + torch.arange(f, device=bins.device)[None, :]
            * num_bins).reshape(-1)
    acc = acc_dtype(vals)
    hist = torch.zeros(f * num_bins, 3, dtype=acc, device=vals.device)
    src = vals.to(acc)[:, None, :].expand(n, f, 3).reshape(-1, 3)
    hist.index_add_(0, flat, src)
    return hist.reshape(f, num_bins, 3)


def histogram_onehot(bins: torch.Tensor, vals: torch.Tensor, *,
                     num_bins: int, rows_block: int = 16384) -> torch.Tensor:
    """One-hot contraction, blockwise over rows (the JAX package's
    ``histogram_onehot``).  Integer values contract in float64, exact for
    any int32 sum, and come back as int32."""
    n, f = bins.shape
    acc = acc_dtype(vals)
    work = torch.float64 if acc == torch.int32 else acc
    iota = torch.arange(num_bins, device=bins.device)
    hist = torch.zeros(f, num_bins, 3, dtype=work, device=vals.device)
    for s in range(0, n, rows_block):
        b = bins[s:s + rows_block].long()
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
                        rows_block: int = 16384) -> torch.Tensor:
    """Histogram from pre-packed (N, 3) channel values."""
    if impl == "flat_bf16" and vals.dtype.is_floating_point:
        raise NotImplementedError(_BF16_TODO)
    if impl in ("auto", "pallas", "flat", "flat_bf16"):
        from .histogram_flat import histogram_flat
        return histogram_flat(bins, vals, num_bins=num_bins)
    if impl == "onehot":
        return histogram_onehot(bins, vals, num_bins=num_bins,
                                rows_block=rows_block)
    if impl == "segment":
        return histogram_segment(bins, vals, num_bins=num_bins)
    raise ValueError(f"unknown histogram impl: {impl}")


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram via subtraction (reference
    ``FeatureHistogram::Subtract``)."""
    return parent - child
