"""Histogram of one row set: the wrapper of the hand-written CUDA kernel
``ops/csrc/histogram.cu`` (the port of the JAX package's
``ops/pallas_histogram.py::histogram_flat``, f32 and int8 modes).

f32 values give an f32 histogram; int8 values (quantized training) give
an int32 one.  On a CUDA tensor ``histogram_flat`` launches the kernel
on PyTorch's current stream, or raises.  On a CPU tensor it runs the
kernel's plain version, ``ops/histogram.py::histogram_segment``.  The TPU
kernel's VMEM tile picker and 128-lane bin padding have no counterpart.
"""

from __future__ import annotations

import torch

from .histogram import histogram_segment

#: kernel launches made by ``histogram_flat`` in this process, f32 mode
#: and int8 mode (plain ints; chip_smoke.py zeroes them before driving
#: the training path)
launches = 0
launches_int8 = 0

#: rows per chunk at least / chunks at most: each chunk's partial
#: histogram is F * B * 3 floats of scratch, summed in chunk order
MIN_CHUNK_ROWS = 1024
MAX_CHUNKS = 1024
#: the kernel runs one thread per bin
MAX_BINS = 256


#: int8 mode: rows per block at least (each block flushes its shared
#: histogram with up to F * B * 3 global atomics) and blocks at most
MIN_CHUNK_ROWS_INT8 = 2048
MAX_CHUNKS_INT8 = 264
#: int8 mode: the most rows whose int32 sums cannot overflow (127 * N)
MAX_ROWS_INT8 = (2 ** 31 - 1) // 127


def chunking(n: int, min_rows: int = MIN_CHUNK_ROWS,
             max_chunks: int = MAX_CHUNKS):
    """(chunk_rows, nchunks) for n rows: a function of n only, so the
    order of every sum depends on nothing but the input."""
    chunk_rows = max(min_rows, -(-n // max_chunks))
    return chunk_rows, -(-n // chunk_rows)


def check_int8_rows(n: int) -> None:
    """int32 sums of int8 levels stay exact only up to MAX_ROWS_INT8 rows."""
    if n > MAX_ROWS_INT8:
        raise ValueError(f"{n} rows of int8 levels could overflow the int32 "
                         f"histogram (127 * N > 2^31 - 1 above "
                         f"{MAX_ROWS_INT8} rows)")


def check_inputs(bins: torch.Tensor, vals: torch.Tensor,
                 num_bins: int) -> None:
    if bins.dim() != 2 or vals.dim() != 2 or vals.shape != (bins.shape[0], 3):
        raise ValueError(f"bins must be (N, F) and vals (N, 3), got "
                         f"{tuple(bins.shape)} and {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"vals must be float32 or int8, got {vals.dtype}")
    if vals.dtype == torch.int8:
        check_int8_rows(bins.shape[0])
    if vals.device != bins.device:
        raise ValueError("bins and vals must be on one device")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins={num_bins}: the kernel takes 1..{MAX_BINS}")


def histogram_flat(bins: torch.Tensor, vals: torch.Tensor, *,
                   num_bins: int) -> torch.Tensor:
    """(N, F) bins, (N, 3) f32 or int8 values -> (F, num_bins, 3) f32 or
    int32."""
    check_inputs(bins, vals, num_bins)
    if bins.device.type == "cpu":
        return histogram_segment(bins, vals, num_bins=num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(bins, vals, num_bins)


def _launch(bins: torch.Tensor, vals: torch.Tensor,
            num_bins: int) -> torch.Tensor:
    global launches, launches_int8
    from ._build import load_library
    if bins.dtype != torch.uint8:
        raise ValueError(f"the histogram kernel takes uint8 bins, got "
                         f"{bins.dtype}")
    lib = load_library()
    n, f = bins.shape
    int8 = vals.dtype == torch.int8
    out_dtype = torch.int32 if int8 else torch.float32
    if n == 0 or f == 0:
        return torch.zeros(f, num_bins, 3, dtype=out_dtype,
                           device=bins.device)
    bins = bins.contiguous()
    vals = vals.contiguous()
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    if int8:
        chunk_rows, nchunks = chunking(n, MIN_CHUNK_ROWS_INT8,
                                       MAX_CHUNKS_INT8)
        out = torch.empty(f, num_bins, 3, dtype=torch.int32,
                          device=bins.device)
        with torch.cuda.device(bins.device):
            err = lib.lgbt_histogram_i8(bins.data_ptr(), vals.data_ptr(), n,
                                        f, num_bins, chunk_rows, nchunks,
                                        out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"int8 histogram kernel launch failed: CUDA "
                               f"error {err}")
        launches_int8 += 1
        return out
    chunk_rows, nchunks = chunking(n)
    partial = torch.empty(nchunks, f, num_bins, 3, dtype=torch.float32,
                          device=bins.device)
    out = torch.empty(f, num_bins, 3, dtype=torch.float32, device=bins.device)
    with torch.cuda.device(bins.device):
        err = lib.lgbt_histogram(bins.data_ptr(), vals.data_ptr(), n, f,
                                 num_bins, chunk_rows, nchunks,
                                 partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {err}")
    launches += 1
    return out
