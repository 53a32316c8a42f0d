"""Histogram of one row set: the wrapper of the hand-written CUDA kernel
``ops/csrc/histogram.cu`` (the port of the JAX package's
``ops/pallas_histogram.py::histogram_flat``, every mode).

Values: f32 (f32 sums), bf16 (``dtype="bf16"``: the values rounded to
bf16 once, summed in f32 — the TPU kernel's bf16 operands with f32
accumulation) or int8 (quantized training: int32 sums; integer values
take this mode whatever ``dtype`` says, as in the JAX package).  Bins:
(N, F) uint8, or with ``packed4`` the (N, ceil(F/2)) nibble pairs of
``ops/histogram.py::pack_bins4`` and the real F in ``features``.  The six
combinations are the kernel's modes (``MODES``).

On a CUDA tensor ``histogram_flat`` launches the kernel on PyTorch's
current stream, or raises.  On a CPU tensor it runs the kernel's plain
version, ``ops/histogram.py::histogram_segment`` (on the bf16-rounded
values in bf16 mode).  The TPU kernel's VMEM tile picker, 128-lane bin
padding and packed4 nibble planes have no counterpart: the kernel writes
the (F, B, 3) histogram in original feature order.
"""

from __future__ import annotations

import torch

from .histogram import histogram_segment

#: the kernel's modes: value type, then ``_packed4`` for 4-bit bins
MODES = ("f32", "bf16", "int8", "f32_packed4", "bf16_packed4",
         "int8_packed4")

#: kernel launches made by ``histogram_flat`` in this process, per mode
#: (plain ints; chip_smoke.py zeroes them before driving a training path)
launches = dict.fromkeys(MODES, 0)

#: rows per chunk at least / chunks at most: each chunk's partial
#: histogram is F * B * 3 floats of scratch, summed in chunk order
MIN_CHUNK_ROWS = 1024
MAX_CHUNKS = 1024
#: bins a feature may have (uint8 bin ids); 4-bit bins hold 16
MAX_BINS = 256
MAX_BINS_PACKED4 = 16


#: int8 mode: rows per block at least (each block flushes its shared
#: histogram with up to F * B * 3 global atomics) and blocks at most
MIN_CHUNK_ROWS_INT8 = 2048
MAX_CHUNKS_INT8 = 264
#: int8 mode: the most rows whose int32 sums cannot overflow (127 * N)
MAX_ROWS_INT8 = (2 ** 31 - 1) // 127


def mode_name(vals_dtype: torch.dtype, packed4: bool) -> str:
    """The kernel mode of values of ``vals_dtype`` (int8, bf16, else f32)
    over unpacked or ``packed4`` bins."""
    kind = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(vals_dtype,
                                                           "f32")
    return kind + ("_packed4" if packed4 else "")


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


def check_layout(bins: torch.Tensor, num_bins: int, packed4: bool,
                 features: int) -> int:
    """The real feature count F of ``bins``; raises on a bin layout the
    kernel does not take (more than 256 bins, or more than 16 packed)."""
    cols = bins.shape[1]
    if packed4:
        if features < 1 or cols != (features + 1) // 2:
            raise ValueError(f"packed4 bins of {features} features need "
                             f"{(features + 1) // 2} columns, got {cols}")
        if num_bins > MAX_BINS_PACKED4:
            raise ValueError(f"num_bins={num_bins}: 4-bit bins hold at most "
                             f"{MAX_BINS_PACKED4}")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins={num_bins}: the kernel takes 1..{MAX_BINS}")
    return features if packed4 else cols


def check_inputs(bins: torch.Tensor, vals: torch.Tensor, num_bins: int,
                 packed4: bool = False, features: int = 0) -> int:
    """Returns the real feature count F."""
    if bins.dim() != 2 or vals.dim() != 2 or vals.shape != (bins.shape[0], 3):
        raise ValueError(f"bins must be (N, F) and vals (N, 3), got "
                         f"{tuple(bins.shape)} and {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"vals must be float32, bfloat16 or int8, got "
                         f"{vals.dtype}")
    if vals.dtype == torch.int8:
        check_int8_rows(bins.shape[0])
    if vals.device != bins.device:
        raise ValueError("bins and vals must be on one device")
    return check_layout(bins, num_bins, packed4, features)


def histogram_flat(bins: torch.Tensor, vals: torch.Tensor, *,
                   num_bins: int, dtype: str = "f32", packed4: bool = False,
                   features: int = 0) -> torch.Tensor:
    """(N, F) bins (``packed4``: (N, ceil(F/2)) nibble pairs of ``features``
    features), (N, 3) f32, bf16 or int8 values -> (F, num_bins, 3) f32 or
    int32.  ``dtype="bf16"`` rounds f32 values to bf16 (bf16 values are
    taken as they are)."""
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"dtype={dtype!r}: expected f32 or bf16")
    f = check_inputs(bins, vals, num_bins, packed4, features)
    if dtype == "bf16" and vals.dtype == torch.float32:
        vals = vals.to(torch.bfloat16)
    if bins.device.type == "cpu":
        return histogram_segment(bins, vals, num_bins=num_bins,
                                 packed4=packed4, features=f)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(bins, vals, num_bins, packed4, f)


def _launch(bins: torch.Tensor, vals: torch.Tensor, num_bins: int,
            packed4: bool, f: int) -> torch.Tensor:
    from ._build import load_library
    if bins.dtype != torch.uint8:
        raise ValueError(f"the histogram kernel takes uint8 bins, got "
                         f"{bins.dtype}")
    lib = load_library()
    n = bins.shape[0]
    mode = mode_name(vals.dtype, packed4)
    int8 = vals.dtype == torch.int8
    out_dtype = torch.int32 if int8 else torch.float32
    if n == 0 or f == 0:
        return torch.zeros(f, num_bins, 3, dtype=out_dtype,
                           device=bins.device)
    bins = bins.contiguous()
    vals = vals.contiguous()
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    out = torch.empty(f, num_bins, 3, dtype=out_dtype, device=bins.device)
    if int8:
        chunk_rows, nchunks = chunking(n, MIN_CHUNK_ROWS_INT8,
                                       MAX_CHUNKS_INT8)
        with torch.cuda.device(bins.device):
            err = lib.lgbt_histogram_i8(bins.data_ptr(), vals.data_ptr(), n,
                                        f, num_bins, chunk_rows, nchunks,
                                        int(packed4), out.data_ptr(), stream)
    else:
        chunk_rows, nchunks = chunking(n)
        partial = torch.empty(nchunks, f, num_bins, 3, dtype=torch.float32,
                              device=bins.device)
        with torch.cuda.device(bins.device):
            err = lib.lgbt_histogram(
                bins.data_ptr(), vals.data_ptr(), n, f, num_bins, chunk_rows,
                nchunks, int(packed4), int(vals.dtype == torch.bfloat16),
                partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed ({mode} mode): "
                           f"CUDA error {err}")
    launches[mode] += 1
    return out
