"""Histogram of one row set: the wrapper of the hand-written CUDA kernel
``ops/csrc/histogram.cu`` (the port of the JAX package's
``ops/pallas_histogram.py::histogram_flat``, f32 mode).

On a CUDA tensor ``histogram_flat`` launches the kernel on PyTorch's
current stream, or raises.  On a CPU tensor it runs the kernel's plain
version, ``ops/histogram.py::histogram_segment``.  The TPU kernel's VMEM
tile picker, 128-lane bin padding and feature chunking have no
counterpart.
"""

from __future__ import annotations

import torch

from .histogram import histogram_segment

#: kernel launches made by ``histogram_flat`` in this process (a plain
#: int; chip_smoke.py zeroes it before driving the training path)
launches = 0

#: rows per chunk at least / chunks at most: each chunk's partial
#: histogram is F * B * 3 floats of scratch, summed in chunk order
MIN_CHUNK_ROWS = 1024
MAX_CHUNKS = 1024
#: the kernel runs one thread per bin
MAX_BINS = 256


def chunking(n: int):
    """(chunk_rows, nchunks) for n rows: a function of n only, so the
    order of every sum depends on nothing but the input."""
    chunk_rows = max(MIN_CHUNK_ROWS, -(-n // MAX_CHUNKS))
    return chunk_rows, -(-n // chunk_rows)


def check_inputs(bins: torch.Tensor, vals: torch.Tensor,
                 num_bins: int) -> None:
    if bins.dim() != 2 or vals.dim() != 2 or vals.shape != (bins.shape[0], 3):
        raise ValueError(f"bins must be (N, F) and vals (N, 3), got "
                         f"{tuple(bins.shape)} and {tuple(vals.shape)}")
    if vals.dtype != torch.float32:
        raise ValueError(f"vals must be float32, got {vals.dtype}")
    if vals.device != bins.device:
        raise ValueError("bins and vals must be on one device")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins={num_bins}: the kernel takes 1..{MAX_BINS}")


def histogram_flat(bins: torch.Tensor, vals: torch.Tensor, *,
                   num_bins: int) -> torch.Tensor:
    """(N, F) bins, (N, 3) f32 values -> (F, num_bins, 3) f32."""
    check_inputs(bins, vals, num_bins)
    if bins.device.type == "cpu":
        return histogram_segment(bins, vals, num_bins=num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(bins, vals, num_bins)


def _launch(bins: torch.Tensor, vals: torch.Tensor,
            num_bins: int) -> torch.Tensor:
    global launches
    from ._build import load_library
    if bins.dtype != torch.uint8:
        raise ValueError(f"the histogram kernel takes uint8 bins, got "
                         f"{bins.dtype}")
    lib = load_library()
    n, f = bins.shape
    if n == 0 or f == 0:
        return torch.zeros(f, num_bins, 3, dtype=torch.float32,
                           device=bins.device)
    bins = bins.contiguous()
    vals = vals.contiguous()
    chunk_rows, nchunks = chunking(n)
    partial = torch.empty(nchunks, f, num_bins, 3, dtype=torch.float32,
                          device=bins.device)
    out = torch.empty(f, num_bins, 3, dtype=torch.float32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        err = lib.lgbt_histogram(bins.data_ptr(), vals.data_ptr(), n, f,
                                 num_bins, chunk_rows, nchunks,
                                 partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {err}")
    launches += 1
    return out
