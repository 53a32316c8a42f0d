"""Histogram of one row set: the wrapper of the hand-written CUDA kernel
``ops/csrc/histogram.cu`` (the port of the JAX package's
``ops/pallas_histogram.py::histogram_flat``, every mode).

Values: f32 (f32 sums), bf16 (``dtype="bf16"``: the values rounded to
bf16 once, summed in f32 — the TPU kernel's bf16 operands with f32
accumulation) or int8 (quantized training: int32 sums; integer values
take this mode whatever ``dtype`` says, as in the JAX package).  Bins:
(N, F) uint8 (up to 256 bins), (N, F) uint16 (up to 65,536 bins: the
JAX package's storage above 256 bins), or with ``packed4`` the (N,
ceil(F/2)) nibble pairs of ``ops/histogram.py::pack_bins4`` and the real
F in ``features``.  The nine combinations are the kernel's modes
(``MODES``).

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

#: the kernel's modes over uint8 and packed4 bins, then over uint16 bins
#: (the fused wave kernel has the same nine, ops/wave.py): value type,
#: then the bin layout
BYTE_MODES = ("f32", "bf16", "int8", "f32_packed4", "bf16_packed4",
              "int8_packed4")
MODES = BYTE_MODES + ("f32_uint16", "bf16_uint16", "int8_uint16")

#: kernel launches made by ``histogram_flat`` in this process, per mode
#: (plain ints; chip_smoke.py zeroes them before driving a training path)
launches = dict.fromkeys(MODES, 0)

#: rows per chunk at least / chunks at most: each chunk's partial
#: histogram is F * B * 3 floats of scratch, summed in chunk order; the
#: partials of one launch (or one wave, ops/wave.py) take at most
#: SCRATCH_BYTES, which caps the chunks where F * B is large
MIN_CHUNK_ROWS = 1024
MAX_CHUNKS = 1024
SCRATCH_BYTES = 256 << 20
#: bins a feature may have: uint8 bin ids, uint16 ones, 4-bit ones
MAX_BINS = 256
MAX_BINS_UINT16 = 65536
MAX_BINS_PACKED4 = 16


#: int8 mode (``ops/csrc/hist_common.cuh``, hist_accumulate_i8_kernel),
#: whose block layout is set here and passed to the kernel: features a
#: block over byte or nibble bins and over uint16 bins (the widest group
#: the kernel takes, kI8Group / kI8GroupWide, which its launcher checks;
#: over uint16 bins the cells at B = 1,023 then take 48 KB, four blocks
#: an SM), and the shared memory a block's int32 cells may take
INT8_GROUP = 8
INT8_GROUP_UINT16 = 4
INT8_SMEM_BUDGET = 96 * 1024
#: int8 mode: blocks a launch aims for (four an SM of an H100), in chunks
#: of at least MIN_CHUNK_ROWS_INT8 rows whose int32 partials (F * B * 12
#: bytes a chunk, summed by the int8 combine) take at most
#: INT8_PARTIAL_BYTES (L2-resident) unless every sibling of a wave needs
#: its own chunk
INT8_BLOCKS = 528
MIN_CHUNK_ROWS_INT8 = 512
INT8_PARTIAL_BYTES = 16 << 20
#: the largest int32 sum a histogram cell may hold exactly
INT32_MAX = 2 ** 31 - 1


def mode_name(vals_dtype: torch.dtype, packed4: bool,
              bins_dtype: torch.dtype = torch.uint8) -> str:
    """The kernel mode of values of ``vals_dtype`` (int8, bf16, else f32)
    over unpacked, ``packed4`` or uint16 bins."""
    kind = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(vals_dtype,
                                                           "f32")
    if packed4:
        return kind + "_packed4"
    return kind + ("_uint16" if bins_dtype == torch.uint16 else "")


def chunking(n: int, feature_bins: int = 0, *,
             min_rows: int = MIN_CHUNK_ROWS, max_chunks: int = MAX_CHUNKS):
    """(chunk_rows, nchunks) for n rows whose chunk partials hold
    ``feature_bins`` = F * B cells of 3 floats each (0: no partials): at
    most ``max_chunks``, and no more than SCRATCH_BYTES of partials.  A
    function of n and F * B only, so the order of every sum depends on
    nothing but the input's shape."""
    if feature_bins:
        max_chunks = max(1, min(max_chunks,
                                SCRATCH_BYTES // (feature_bins * 12)))
    chunk_rows = max(min_rows, -(-n // max_chunks))
    return chunk_rows, -(-n // chunk_rows)


def int8_shape(f: int, num_bins: int, wide: bool = False):
    """(features a block, feature groups, bins a tile, bin tiles) of the
    int8 accumulation, whose wrappers pass the first and third to the
    kernel (``hist_common.cuh::launch_accumulate_i8``): groups of
    INT8_GROUP features (INT8_GROUP_UINT16 over uint16 bins, ``wide``);
    every bin in one tile where the block's int32 cells (12 bytes a bin)
    fit INT8_SMEM_BUDGET, else the fewest equal tiles that fit."""
    fpb = min(f, INT8_GROUP_UINT16 if wide else INT8_GROUP)
    fit = INT8_SMEM_BUDGET // (fpb * 12)
    tile = -(-num_bins // -(-num_bins // fit))
    return fpb, -(-f // fpb), tile, -(-num_bins // tile)


def int8_chunk_rows(rows: int, f: int, num_bins: int,
                    wide: bool = False) -> int:
    """Rows a chunk of the int8 accumulation over ``rows`` rows (one
    histogram's, or all the smaller siblings' of one wave): chunks enough
    to put INT8_BLOCKS blocks on the card across ``int8_shape``'s feature
    groups and bin tiles, but no more partials than INT8_PARTIAL_BYTES,
    and at least MIN_CHUNK_ROWS_INT8 rows.  Integer sums do not depend on
    it."""
    _, groups, _, tiles = int8_shape(f, num_bins, wide)
    chunks = -(-INT8_BLOCKS // (groups * tiles))
    chunks = max(1, min(chunks, INT8_PARTIAL_BYTES // (f * num_bins * 12)))
    return max(MIN_CHUNK_ROWS_INT8, -(-rows // chunks))


def check_int8_rows(n: int, max_level: int = 127) -> None:
    """int32 sums of n rows of int8 levels, none above ``max_level`` in
    magnitude (quantized training's ``ops/quantize.py::max_level``; 127
    for any int8), stay exact while n * max_level <= 2^31 - 1."""
    if n * max_level > INT32_MAX:
        raise ValueError(f"{n} rows of int8 levels up to {max_level} could "
                         f"overflow the int32 histogram ({max_level} * N > "
                         f"2^31 - 1 above {INT32_MAX // max_level} rows)")


def check_layout(bins: torch.Tensor, num_bins: int, packed4: bool,
                 features: int) -> int:
    """The real feature count F of ``bins``; raises on a bin layout the
    kernel does not take: more than 65,536 bins over uint16 bins, 256
    over other bins, or 16 packed."""
    cols = bins.shape[1]
    wide = bins.dtype == torch.uint16
    if packed4:
        if wide:
            raise ValueError("packed4 bins are uint8 nibble pairs, got "
                             "uint16 bins")
        if features < 1 or cols != (features + 1) // 2:
            raise ValueError(f"packed4 bins of {features} features need "
                             f"{(features + 1) // 2} columns, got {cols}")
        if num_bins > MAX_BINS_PACKED4:
            raise ValueError(f"num_bins={num_bins}: 4-bit bins hold at most "
                             f"{MAX_BINS_PACKED4}")
    most = MAX_BINS_UINT16 if wide else MAX_BINS
    if not 1 <= num_bins <= most:
        raise ValueError(f"num_bins={num_bins}: the kernel takes 1..{most} "
                         f"over {bins.dtype} bins")
    return features if packed4 else cols


def check_inputs(bins: torch.Tensor, vals: torch.Tensor, num_bins: int,
                 packed4: bool = False, features: int = 0,
                 max_level: int = 127) -> int:
    """Returns the real feature count F."""
    if bins.dim() != 2 or vals.dim() != 2 or vals.shape != (bins.shape[0], 3):
        raise ValueError(f"bins must be (N, F) and vals (N, 3), got "
                         f"{tuple(bins.shape)} and {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"vals must be float32, bfloat16 or int8, got "
                         f"{vals.dtype}")
    if vals.dtype == torch.int8:
        check_int8_rows(bins.shape[0], max_level)
    if vals.device != bins.device:
        raise ValueError("bins and vals must be on one device")
    return check_layout(bins, num_bins, packed4, features)


def histogram_flat(bins: torch.Tensor, vals: torch.Tensor, *,
                   num_bins: int, dtype: str = "f32", packed4: bool = False,
                   features: int = 0, max_level: int = 127) -> torch.Tensor:
    """(N, F) uint8 or uint16 bins (``packed4``: (N, ceil(F/2)) nibble
    pairs of ``features`` features), (N, 3) f32, bf16 or int8 values ->
    (F, num_bins, 3) f32 or int32.  ``dtype="bf16"`` rounds f32 values to
    bf16 (bf16 values are taken as they are); int8 values are levels of
    at most ``max_level`` in magnitude."""
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"dtype={dtype!r}: expected f32 or bf16")
    f = check_inputs(bins, vals, num_bins, packed4, features, max_level)
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
    if bins.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"the histogram kernel takes uint8 or uint16 bins, "
                         f"got {bins.dtype}")
    lib = load_library()
    n = bins.shape[0]
    mode = mode_name(vals.dtype, packed4, bins.dtype)
    wide = bins.dtype == torch.uint16
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
        chunk_rows = int8_chunk_rows(n, f, num_bins, wide)
        nchunks = -(-n // chunk_rows)
        partial = torch.empty(nchunks, f, num_bins, 3, dtype=torch.int32,
                              device=bins.device)
        fpb, _, tile, _ = int8_shape(f, num_bins, wide)
        head = (bins.data_ptr(), vals.data_ptr(), n, f, num_bins, chunk_rows,
                nchunks, fpb, tile)
        tail = (partial.data_ptr(), out.data_ptr(), stream)
        with torch.cuda.device(bins.device):
            if wide:
                err = lib.lgbt_histogram_i8_u16(*head, *tail)
            else:
                err = lib.lgbt_histogram_i8(*head, int(packed4), *tail)
    else:
        chunk_rows, nchunks = chunking(n, f * num_bins)
        partial = torch.empty(nchunks, f, num_bins, 3, dtype=torch.float32,
                              device=bins.device)
        head = (bins.data_ptr(), vals.data_ptr(), n, f, num_bins, chunk_rows,
                nchunks)
        tail = (int(vals.dtype == torch.bfloat16), partial.data_ptr(),
                out.data_ptr(), stream)
        with torch.cuda.device(bins.device):
            if wide:
                err = lib.lgbt_histogram_u16(*head, *tail)
            else:
                err = lib.lgbt_histogram(*head, int(packed4), *tail)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed ({mode} mode): "
                           f"CUDA error {err}")
    launches[mode] += 1
    return out
