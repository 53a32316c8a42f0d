"""Quantized tree-ensemble traversal: the wrapper of the hand-written CUDA
kernel ``ops/csrc/traverse.cu`` (the port of the JAX package's
``ops/pallas_traverse.py::fused_class_sums``).

On a CUDA tensor ``fused_class_sums`` launches the kernel on PyTorch's
current stream, or raises.  On a CPU tensor it runs the kernel's plain
version, ``models/tree._ensemble_sum_q``, over the pack's node arrays.  The
kernel walks the pack's ``walk_table`` (``models/tree.py::walk_table``,
built once per pack by ``quantize_stack_trees``): one 8-byte record a
node, then the leaves.  The TPU kernel's VMEM fit gate and lane padding
have no counterpart.
"""

from __future__ import annotations

import torch

from ..models.tree import _QPACK_ARRAYS, _ensemble_sum_q, table_nodes

#: kernel launches made by ``fused_class_sums`` in this process (a plain
#: int; chip_smoke.py zeroes it before driving the serving path)
launches = 0

#: rows a block walks (traverse.cu: a thread per row)
ROWS_PER_BLOCK = 256
#: blocks per multiprocessor the tree-axis split aims for on small batches
BLOCKS_PER_SM = 32
#: a block stages its rows' bins in shared memory where they fit
#: ROW_STAGE_BYTES and it walks at least ROW_STAGE_MIN_TREES trees (the
#: copy then pays for itself)
ROW_STAGE_BYTES = 48 * 1024
ROW_STAGE_MIN_TREES = 16
_MAX_GRID_Y = 65535

_DTYPES = {
    "split_feature": (torch.int16,), "split_bin": (torch.int16,),
    "default_left": (torch.bool,), "is_cat": (torch.bool,),
    "cat_bits": (torch.uint8,), "left_child": (torch.int16,),
    "right_child": (torch.int16,), "leaf_q": (torch.int16, torch.int8),
}


def _check(pack: dict, bins: torch.Tensor, nan_bins: torch.Tensor) -> None:
    if bins.dim() != 2 or bins.dtype != torch.int32:
        raise ValueError(f"bins must be (N, F) int32, got {tuple(bins.shape)} "
                         f"{bins.dtype}")
    if (nan_bins.dim() != 1 or nan_bins.dtype != torch.int32
            or nan_bins.shape[0] != bins.shape[1]):
        raise ValueError(f"nan_bins must be ({bins.shape[1]},) int32, got "
                         f"{tuple(nan_bins.shape)} {nan_bins.dtype}")
    t, m = pack["split_feature"].shape
    for k in _QPACK_ARRAYS:
        a = pack[k]
        if a.dtype not in _DTYPES[k]:
            raise ValueError(f"pack[{k!r}] has dtype {a.dtype}, expected "
                             f"{_DTYPES[k]}")
        if a.device != bins.device or not a.is_contiguous():
            raise ValueError(f"pack[{k!r}] must be contiguous on {bins.device}")
        if a.shape[0] != t or (k != "leaf_q" and a.shape[1] != m):
            raise ValueError(f"pack[{k!r}] has shape {tuple(a.shape)}, "
                             f"expected ({t}, {m}, ...)")
    if pack["cat_bits"].dim() != 3:
        raise ValueError("pack['cat_bits'] must be (T, M, ceil(B/8))")
    for name, a in (("bins", bins), ("nan_bins", nan_bins)):
        if a.device != bins.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {bins.device}")


def fused_class_sums(pack: dict, bins: torch.Tensor,
                     nan_bins: torch.Tensor) -> torch.Tensor:
    """(N,) int32 sums of leaf quanta for one quantized pack."""
    _check(pack, bins, nan_bins)
    if bins.device.type == "cpu":
        return _ensemble_sum_q(pack, bins, nan_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(pack, bins, nan_bins)


def _launch(pack: dict, bins: torch.Tensor,
            nan_bins: torch.Tensor) -> torch.Tensor:
    global launches
    from ._build import load_library
    table = pack.get("walk_table")
    t, m = pack["split_feature"].shape
    if (table is None or table.dtype != torch.int32
            or table.device != bins.device or not table.is_contiguous()
            or table.dim() != 2 or table.shape[0] != t
            or table.data_ptr() % 16 != 0):
        raise ValueError("the pack's walk_table must be a contiguous, "
                         f"16-byte aligned ({t}, words) int32 tensor on "
                         f"{bins.device} (models/tree.py::walk_table)")
    lib = load_library()
    n, f = bins.shape
    if n == 0 or t == 0:
        return torch.zeros(n, dtype=torch.int32, device=bins.device)
    words = int(table.shape[1])
    mp = table_nodes(m)
    trees_per_block, stage_rows = launch_shape(
        n, t, f,
        torch.cuda.get_device_properties(bins.device).multi_processor_count)
    split = -(-t // trees_per_block)
    out = (torch.zeros if split > 1 else torch.empty)(
        n, dtype=torch.int32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        err = lib.lgbt_traverse_table(
            bins.data_ptr(), nan_bins.data_ptr(), table.data_ptr(),
            pack["cat_bits"].data_ptr(), out.data_ptr(), n, f, t, m,
            int(pack["cat_bits"].shape[2]), words, mp, int(pack["depth"]),
            trees_per_block, int(stage_rows), stream)
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def launch_shape(n: int, t: int, f: int, sms: int):
    """(trees a block, whether a block stages its rows' bins) of a launch
    over n rows of f features and t trees: blocks of ROWS_PER_BLOCK rows;
    where they are fewer than BLOCKS_PER_SM a multiprocessor, the tree
    axis is split until they are (a 1-row request spreads over the card);
    a block walking ROW_STAGE_MIN_TREES trees or more stages its rows'
    bins (at an odd stride) and the NaN bins where they fit
    ROW_STAGE_BYTES."""
    row_blocks = -(-n // ROWS_PER_BLOCK)
    split = max(1, min(t, -(-sms * BLOCKS_PER_SM // max(row_blocks, 1))))
    trees_per_block = max(-(-t // split), -(-t // _MAX_GRID_Y), 1)
    stage = (trees_per_block >= ROW_STAGE_MIN_TREES and
             (ROWS_PER_BLOCK * (f | 1) + f) * 4 <= ROW_STAGE_BYTES)
    return trees_per_block, stage
